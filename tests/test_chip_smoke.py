"""``chip_smoke.py``: its phases at a tiny size, its output contract, and
its refusal to run without a GPU.

The phases run on the CPU through ``chip_smoke.rehearse``; the ``gpu``
cases run the same phases on a card (``DA_TEST_PLATFORM=gpu``).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("phase", chip_smoke.SINGLE_CARD)
def test_phase_rehearsal(phase, capsys):
    chip_smoke.rehearse(phases=(phase,))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and all(line.startswith(f"[{phase}]") for line in lines)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", chip_smoke.SINGLE_CARD)
def test_phase_on_card(phase, gpu_device, capsys):
    assert gpu_device.platform == "gpu"
    chip_smoke.rehearse(phases=(phase,))
    assert capsys.readouterr().out.startswith(f"[{phase}]")


def test_mesh_stages_rehearsal(capsys):
    import __graft_entry__

    __graft_entry__._dryrun_body(4, platform="cpu", multislice=False, card="test card")
    out = capsys.readouterr().out.splitlines()
    stages = {line.split("]")[0] for line in out if line.startswith("[multi ")}
    assert stages == {"[multi flagship", "[multi relayout", "[multi map_overlap auto",
                      "[multi map_overlap shard", "[multi reductions", "[multi tsqr_svd",
                      "[multi shard lane"}
    assert all(line.endswith("| card test card") for line in out if line.startswith("[multi"))


def test_last_lines_format(monkeypatch, capsys):
    import jax

    ran = []
    monkeypatch.setattr(chip_smoke, "rehearse", lambda seed=0: ran.append(seed))
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert chip_smoke.main(["--rehearse", "--seed", "3"]) == 0
    assert ran == [3]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"
    dev = jax.devices()[0]
    want = {"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                   "count": len(jax.devices())}}
    assert lines[-1] == json.dumps(want)
    assert json.loads(lines[-1]) == want


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_refuses_without_gpu(args):
    r = _run(args, ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_refuses_without_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
