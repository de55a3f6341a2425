"""The entry points: the flagship step and the dry run over a virtual mesh.

``dryrun_multichip`` runs its body in a child process whose environment
pins the CPU backend and the virtual device count, which must be set
before JAX starts.  These tests pin that contract without paying for a
full dry run.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as graft  # noqa: E402


def test_child_env_pins_cpu_and_device_count():
    base = {
        "JAX_PLATFORMS": "cuda,cpu",
        "XLA_FLAGS": "--xla_foo=1 --xla_force_host_platform_device_count=2",
        "PATH": "/usr/bin",
    }
    env = graft._dryrun_child_env(8, base)
    assert env["JAX_PLATFORMS"] == "cpu"
    assert "--xla_force_host_platform_device_count=8" in env["XLA_FLAGS"]
    assert "--xla_force_host_platform_device_count=2" not in env["XLA_FLAGS"]
    assert "--xla_foo=1" in env["XLA_FLAGS"]  # unrelated flags survive
    assert env["_DA_DRYRUN_CHILD"] == "1"
    assert env["PATH"] == "/usr/bin"
    assert base["JAX_PLATFORMS"] == "cuda,cpu"  # caller env untouched


def test_dryrun_spawns_cpu_pinned_subprocess(monkeypatch):
    # dryrun_multichip routes through a child built from _dryrun_child_env:
    # the device count only takes effect in a process that has not
    # started JAX yet
    import subprocess

    calls = {}

    def fake_run(cmd, env=None, **kw):
        calls["cmd"] = cmd
        calls["env"] = env

        class P:
            returncode = 0
            stdout = ""
            stderr = ""

        return P()

    monkeypatch.delenv("_DA_DRYRUN_CHILD", raising=False)
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    monkeypatch.setattr(subprocess, "run", fake_run)
    graft.dryrun_multichip(8)
    assert calls["cmd"][0] == sys.executable
    assert calls["cmd"][1].endswith("__graft_entry__.py")
    assert calls["cmd"][2:] == ["--dryrun-child", "8"]
    assert calls["env"]["JAX_PLATFORMS"] == "cpu"
    assert calls["env"]["XLA_FLAGS"] == "--xla_force_host_platform_device_count=8"


def test_dryrun_child_marker_runs_body_in_process(monkeypatch):
    # inside the child the marker short-circuits straight to the body
    monkeypatch.setenv("_DA_DRYRUN_CHILD", "1")
    ran = {}
    monkeypatch.setattr(graft, "_dryrun_body", lambda n: ran.setdefault("n", n))
    graft.dryrun_multichip(4)
    assert ran["n"] == 4


def test_dryrun_child_failure_is_loud(monkeypatch):
    import subprocess

    def fake_run(cmd, env=None, **kw):
        class P:
            returncode = 1
            stdout = ""
            stderr = "boom: mesh stage out of tolerance"

        return P()

    monkeypatch.delenv("_DA_DRYRUN_CHILD", raising=False)
    monkeypatch.setattr(subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="mesh stage out of tolerance"):
        graft.dryrun_multichip(8)


def test_entry_compiles_on_cpu():
    # the single-device compile check: jit the flagship forward step
    import jax

    fn, args = graft.entry()
    y = jax.jit(fn)(*args)
    assert y.shape == (512,)
    rng = np.random.default_rng(0)  # entry()'s own seeds
    a_np = rng.standard_normal((512, 512)).astype(np.float32)
    b_np = rng.standard_normal((256, 512)).astype(np.float32)
    want = graft._pipeline(a_np, b_np)
    np.testing.assert_allclose(np.asarray(y), want, rtol=2e-3, atol=2e-3)
