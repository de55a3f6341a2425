"""Cross-process program-cache proof, and where the cache lives.

The planrec grammar is the process-stable program key (the reference's
records-protocol role) and the jax persistent compile cache is the
executable store: the SAME pipeline built in a SECOND process must
(a) produce an identical plan fingerprint and (b) be served from the
on-disk cache — no new cache entry is written.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import dask_array_tpu as da  # honours JAX_COMPILATION_CACHE_DIR
import jax
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
from dask_array_tpu._materialize import optimize_expr
from dask_array_tpu._planrec import plan_fingerprint

x = da.random.default_rng(0).standard_normal((256, 256), chunks=64)
y = (x @ x.T).sum(axis=0) + x.mean(axis=1)
lowered = optimize_expr(y.expr)
fp = plan_fingerprint(lowered)
t0 = time.time()
out = y.compute()
wall = time.time() - t0
cache_dir = jax.config.jax_compilation_cache_dir
print(json.dumps({
    "fingerprint": fp[0] if isinstance(fp, tuple) else str(fp),
    "entries": len(os.listdir(cache_dir)),
    "wall": wall,
    "checksum": float(np.asarray(out).sum()),
}))
"""


def _run(cache_dir):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    r = subprocess.run(
        [sys.executable, "-c", _WORKER, ROOT],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
    )
    assert r.returncode == 0, r.stderr[-800:]
    return json.loads([l for l in r.stdout.splitlines() if l.startswith("{")][-1])


def test_second_process_compile_is_a_cache_hit(tmp_path):
    cache = str(tmp_path / "xla-cache")
    os.makedirs(cache)
    a = _run(cache)
    assert a["entries"] >= 1  # first process compiled and persisted
    b = _run(cache)
    # process-stable plan key: identical fingerprint across processes
    assert b["fingerprint"] == a["fingerprint"]
    # the second process's compile was served from disk: nothing new written
    assert b["entries"] == a["entries"]
    assert b["checksum"] == pytest.approx(a["checksum"], rel=1e-12)


_FROM_ARRAY_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import dask_array_tpu as da
import jax
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
from dask_array_tpu._materialize import optimize_expr
from dask_array_tpu._executor import structural_key

# a BIG (> content-hash limit) plain from_array leaf, rebuilt identically
# in each process: the default sample token policy makes its expression
# name — and therefore the plan fingerprint — process-stable (VERDICT r3
# #6: no tokenize.big-arrays opt-in)
src = np.random.default_rng(7).standard_normal((512, 512))
x = da.from_array(src, chunks=128)
y = (x + x.T).sum(axis=0)
lowered = optimize_expr(y.expr)
t0 = time.time()
out = y.compute()
wall = time.time() - t0
cache_dir = jax.config.jax_compilation_cache_dir
print(json.dumps({
    "skey": structural_key(lowered),
    "name": y.name,
    "entries": len(os.listdir(cache_dir)),
    "wall": wall,
    "checksum": float(np.asarray(out).sum()),
}))
"""


def test_from_array_leaf_cache_hit_without_opt_in(tmp_path):
    # VERDICT r3 #6: plain from_array leaves get process-stable tokens BY
    # DEFAULT, so the second process's plan key matches and its compile is
    # served from the on-disk cache
    cache = str(tmp_path / "xla-cache-fa")
    os.makedirs(cache)
    env_worker = globals()["_FROM_ARRAY_WORKER"]

    def run():
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["JAX_COMPILATION_CACHE_DIR"] = cache
        r = subprocess.run(
            [sys.executable, "-c", env_worker, ROOT],
            capture_output=True, text=True, timeout=300, env=env,
        )
        assert r.returncode == 0, r.stderr[-800:]
        return json.loads([l for l in r.stdout.splitlines() if l.startswith("{")][-1])

    a = run()
    b = run()
    assert b["name"] == a["name"]  # content-stable collection identity
    assert b["skey"] == a["skey"]  # process-stable program key
    assert a["entries"] >= 1
    assert b["entries"] == a["entries"]  # second compile served from disk
    assert b["checksum"] == pytest.approx(a["checksum"], rel=1e-12)


_DIR_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import dask_array_tpu
import jax
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("case", ["env", "unset", "unset-other-cwd"])
def test_compile_cache_directory(tmp_path, case):
    # JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed,
    # git-ignored directory inside the checkout
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(ROOT, ".jax_cache")
    if case == "env":
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    r = subprocess.run(
        [sys.executable, "-c", _DIR_WORKER, ROOT],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=tmp_path if case == "unset-other-cwd" else None,
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.strip().splitlines()[-1] == want
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
