"""Probe: does the executor's compile path hit JAX's persistent cache?

The parent stays off JAX.  It empties ``<repo>/.jax_cache/probe``, then
runs the same child twice, one after the other, with
``JAX_COMPILATION_CACHE_DIR`` pointing there and no minimum compile time.
Each child computes a few lazy expressions through ``compute()`` (the
executor's ``lower().compile()`` path) and prints JAX's own cache
counters: compile requests that consulted the cache, hits, misses, and
the wall time of the first compute.  A second child whose requests are
all hits shows that the persistent cache serves the executor across
processes.

    python bench/probe_compile_cache.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child():
    sys.path.insert(0, ROOT)
    import jax
    from jax import monitoring

    counts = {"requests": 0, "hits": 0, "misses": 0}
    names = {
        "/jax/compilation_cache/compile_requests_use_cache": "requests",
        "/jax/compilation_cache/cache_hits": "hits",
        "/jax/compilation_cache/cache_misses": "misses",
    }

    def on_event(event, **kw):
        if event in names:
            counts[names[event]] += 1

    monitoring.register_event_listener(on_event)

    import dask_array_tpu as da
    from dask_array_tpu.models import pipelines as P

    t0 = time.perf_counter()
    x = da.random.default_rng(0).standard_normal((4096, 4096), dtype="float32", chunks=1024)
    outs = da.compute(x.sum(axis=0), x.std(), (x @ x.T).mean(axis=1))
    P.stencil2d(n=2048, chunk=512, form="slices").compute()
    first = time.perf_counter() - t0
    assert all(o is not None for o in outs)
    print(json.dumps({
        "cache_dir": jax.config.jax_compilation_cache_dir,
        "first_compute_s": first,
        **counts,
    }), flush=True)


def main():
    cache = os.path.join(ROOT, ".jax_cache", "probe")
    shutil.rmtree(cache, ignore_errors=True)
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cache,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    for run in (1, 2):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"],
            env=env, capture_output=True, text=True, timeout=600, check=True,
        )
        files = sum(len(f) for _, _, f in os.walk(cache))
        print(f"run {run}: {out.stdout.strip()} | files in cache {files}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        main()
