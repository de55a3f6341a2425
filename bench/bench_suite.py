"""End-to-end timings of the BASELINE.md workloads on one device.

The parent stays off JAX and runs each workload in its own child, one
after another, so one process holds the card at a time and each child's
``peak_bytes_in_use`` is its workload's own.  Every timed loop ends in
``block_until_ready``.  Memory-bound rows also report their rate as a
share of a copy of 8192^2 f32 measured in the same child.

    python bench/bench_suite.py

Sizes are those of the BASELINE.md configurations; no H100 number has
been recorded for them yet.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_WORKER = r"""
import os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax

label = sys.argv[2]
from dask_array_tpu.models import pipelines as P

BUILDERS = {
    "readme_slice_pushdown": lambda: P.readme_example(),
    "reduction_tree_10k": lambda: P.reduction_tree(),
    "reduction_tree_10k_persisted": lambda: _persisted_reduction_tree(),
    "blocked_matmul_8192": lambda: _persisted_matmul(),
    "stencil2d_4096": lambda: P.stencil2d(persist=True),
    "tsqr_svd_1e6x128": lambda: P.tall_skinny_svd(),
    "rechunk_relayout_8192": lambda: P.rechunk_relayout(persist=True),
}

def _persisted_reduction_tree():
    # the reductions themselves vs the HBM roofline: the input persists
    # on-device (same discipline as the matmul/relayout rows), so steady
    # state measures ONE read of the 400 MB array feeding all four fused
    # accumulations (colsum, rowmean, and the one-pass var's two sums)
    import dask_array_tpu as da
    x = da.random.default_rng(0).standard_normal((10000, 10000), dtype="float32", chunks=1000).persist()
    return (x.sum(axis=0, split_every=4), x.mean(axis=1, split_every=4), x.std(split_every=4))


def _persisted_matmul():
    out = P.blocked_matmul()
    # persist the leaves on-device (steady state measures the GEMM, not the
    # host->device transfer)
    from dask_array_tpu._collection import Array
    from dask_array_tpu.ops._from_array import FromArray
    import dask_array_tpu as da
    expr = out.expr
    for leaf in expr.find(FromArray):
        expr = expr.substitute(leaf, Array(leaf).persist().expr)
    return Array(expr)

t0 = time.perf_counter(); out = BUILDERS[label]() ; t_build = time.perf_counter() - t0
arrs = out if isinstance(out, tuple) else (out,)
t0 = time.perf_counter(); [a.optimize() for a in arrs]; t_opt = time.perf_counter() - t0
from dask_array_tpu._executor import execute_many as _em
from dask_array_tpu._materialize import optimize_expr as _oe

t0 = time.perf_counter()
_low0 = [_oe(a.expr) for a in arrs]
devs = _em(_low0) if len(_low0) > 1 else [arrs[0].compute_device()]
jax.block_until_ready(devs)
t_first = time.perf_counter() - t0

from dask_array_tpu._executor import execute_many
from dask_array_tpu._materialize import optimize_expr

_lowered = [optimize_expr(a.expr) for a in arrs]

def _run_once():
    # multi-output workloads run as ONE program (da.compute semantics)
    return execute_many(_lowered) if len(_lowered) > 1 else [arrs[0].compute_device()]

def _loop(iters):
    t0 = time.perf_counter()
    for _i in range(iters):
        ds = _run_once()
    jax.block_until_ready(ds)
    return (time.perf_counter() - t0) / iters

# grow the loop until it holds >= 1 s of steady work
iters = 5
t_steady = _loop(iters)
while t_steady * iters < 1.0 and iters < 400:
    iters = min(400, max(iters * 4, int(1.5 / max(t_steady, 1e-4))))
    t_steady = _loop(iters)
extra = ""
# roofline framing: bytes each workload must move through HBM per run
_ROOFLINE_BYTES = {
    # relayout: read + write every element (f32 8192^2)
    "rechunk_relayout_8192": 2 * 8192 * 8192 * 4,
    # tree reduction: one read of the 10000^2 f32 input
    "reduction_tree_10k": 10000 * 10000 * 4,
    "reduction_tree_10k_persisted": 10000 * 10000 * 4,
    # depth-1 stencil: read input (+halo ~0) and write output (f32 4096^2)
    "stencil2d_4096": 2 * 4096 * 4096 * 4,
}
if label in _ROOFLINE_BYTES:
    import jax.numpy as jnp

    _buf = jnp.asarray(np.zeros((8192, 8192), dtype="f4"))
    _copy = jax.jit(lambda v: v * jnp.float32(1.0000001))  # non-unit: no alias
    _copy(_buf).block_until_ready()

    def _copy_loop(n):
        t0 = time.perf_counter()
        o = _buf
        for _i in range(n):
            o = _copy(o)  # carry-dependent: dispatches cannot collapse
        o.block_until_ready()
        return (time.perf_counter() - t0) / n

    _it = 10
    _tc = _copy_loop(_it)
    while _tc * _it < 1.0 and _it < 4000:
        _it = min(4000, max(_it * 4, int(1.5 / max(_tc, 1e-5))))
        _tc = _copy_loop(_it)
    copy_gbps = 2 * _buf.nbytes / _tc / 1e9
    gbps = _ROOFLINE_BYTES[label] / t_steady / 1e9
    extra = (f" | {gbps:7.1f} GB/s effective | copy {copy_gbps:6.0f} GB/s"
             f" | share of copy {gbps/copy_gbps:5.2f}")
peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", "n/a")
print(f"{label:24s} build {t_build*1e3:8.2f} ms | optimize {t_opt*1e3:8.2f} ms | "
      f"first(run+compile) {t_first:7.2f} s | steady {t_steady*1e3:9.2f} ms{extra}"
      f" | peak_bytes_in_use {peak} | {jax.devices()[0].device_kind}", flush=True)
"""


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for label in (
        "readme_slice_pushdown",
        "reduction_tree_10k",
        "reduction_tree_10k_persisted",
        "blocked_matmul_8192",
        "stencil2d_4096",
        "tsqr_svd_1e6x128",
        "rechunk_relayout_8192",
    ):
        try:
            r = subprocess.run(
                [sys.executable, "-u", "-c", _WORKER, root, label],
                timeout=900,
                capture_output=True,
                text=True,
            )
            out = [l for l in r.stdout.splitlines() if l.strip()]
            print(out[-1] if out else f"{label:24s} FAILED:\n{r.stderr[-400:]}", flush=True)
        except subprocess.TimeoutExpired:
            print(f"{label:24s} TIMEOUT (>900 s)", flush=True)


if __name__ == "__main__":
    main()
