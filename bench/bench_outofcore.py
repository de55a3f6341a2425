"""Out-of-core streaming lane on one device.

Two workloads, each with a host dataset LARGER than device memory (or than
an explicit budget), computed correctly with bounded device residency:

* ``oc_sum``     — reduce-stream: f32 ``x.sum()`` of an N-GB host array.
* ``oc_matmul``  — map-stream panel sweep: ``A @ B`` with A huge (row
  panels stream, C assembles on host) and B pinned device-resident once.

Usage: ``python bench/bench_outofcore.py [GB [budget_bytes]]``.

Default size: 24 GB with the automatic budget (the device's memory limit
less headroom, ``_streaming._budget``).  Pass a larger GB than the device
holds to prove bounded-memory execution: the analytic checksum is that
proof.  A smaller GB with an explicit budget proves the same relative to
the budget.

Values are verified analytically: row i of A is the constant
``(i % 7) * 0.25 + 0.5``, so the sum and every GEMM row follow in closed
form without holding a second 24-GB reference.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fill_rows(n_rows, n_cols):
    a = np.empty((n_rows, n_cols), dtype=np.float32)
    pattern = ((np.arange(n_rows) % 7) * 0.25 + 0.5).astype(np.float32)
    a[:] = pattern[:, None]
    return a, pattern


def main():
    gb = float(sys.argv[1]) if len(sys.argv) > 1 else 24.0
    budget = int(sys.argv[2]) if len(sys.argv) > 2 else None

    import dask_array_tpu as da
    from dask_array_tpu import config
    from dask_array_tpu._streaming import STREAMED

    n_cols = 4096
    n_rows = int(gb * 1e9 / 4 / n_cols)
    # chunk rows: ~128 chunks along the streamed axis
    chunk = max(1, n_rows // 128)
    n_rows = (n_rows // chunk) * chunk  # exact multiple: uniform grid

    t0 = time.perf_counter()
    a, pattern = _fill_rows(n_rows, n_cols)
    print(
        f"host fill: {a.nbytes/1e9:.1f} GB in {time.perf_counter()-t0:.1f} s",
        flush=True,
    )

    cfg = {"tpu.out-of-core": "auto"}
    if budget is not None:
        cfg["tpu.memory-budget"] = budget

    # --- oc_sum: reduce-stream ---------------------------------------
    x = da.from_array(a, chunks=(chunk, n_cols))
    with config.set(cfg):
        before = dict(STREAMED)
        t0 = time.perf_counter()
        got = float(x.sum().compute())
        wall = time.perf_counter() - t0
    dd = {k: STREAMED[k] - before[k] for k in STREAMED}
    want = float(pattern.astype(np.float64).sum() * n_cols)
    rel = abs(got - want) / abs(want)
    ok = rel < 1e-5
    print(
        f"oc_sum    {a.nbytes/1e9:6.1f} GB  wall {wall:7.1f} s  "
        f"{a.nbytes/wall/1e9:6.3f} GB/s  panels {dd['panels']:3d}  "
        f"engaged {dd['count']}  checksum {'OK' if ok else f'FAIL rel={rel:.2e}'}",
        flush=True,
    )

    # --- oc_matmul: map-stream panel sweep, B pinned -------------------
    rng = np.random.default_rng(0)
    b = rng.standard_normal((n_cols, 256)).astype(np.float32)
    with config.set(cfg):
        before = dict(STREAMED)
        t0 = time.perf_counter()
        c = (x @ b).compute()
        wall = time.perf_counter() - t0
    dd = {k: STREAMED[k] - before[k] for k in STREAMED}
    colsum = b.sum(axis=0)
    sample = np.linspace(0, n_rows - 1, 97, dtype=int)
    want_rows = pattern[sample, None] * colsum[None, :]
    ok = np.allclose(np.asarray(c)[sample], want_rows, rtol=1e-3, atol=1e-3)
    flops = 2.0 * n_rows * n_cols * 256
    print(
        f"oc_matmul {a.nbytes/1e9:6.1f} GB  wall {wall:7.1f} s  "
        f"{a.nbytes/wall/1e9:6.3f} GB/s  {flops/wall/1e12:6.3f} TFLOP/s  "
        f"panels {dd['panels']:3d}  pinned {dd['pinned']}  "
        f"engaged {dd['count']}  values {'OK' if ok else 'FAIL'}",
        flush=True,
    )


if __name__ == "__main__":
    main()
