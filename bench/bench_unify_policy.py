"""Unify-policy decision benchmark (reference: bench/bench_unify_policy.py).

Shapes mirroring the reference cases:
- nested_merge: a big coarsely-chunked operand + small finely-chunked ones;
  auto should adopt the coarse layout (small transfer), refine shatters.
- shatter_guard: many misaligned fine layouts; refine explodes the block
  count, auto caps it.

In this framework the unification choice only changes METADATA cost (the dense executor moves no bytes at alignment), so
the relevant number is the optimizer wall + the resulting block count that
downstream per-block consumers would see.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np


def case_nested_merge(policy):
    import dask_array_tpu as da
    from dask_array_tpu import config

    with config.set({"array.unify-chunks-policy": policy}):
        rng = np.random.default_rng(0)
        big = da.from_array(rng.standard_normal((8000, 1000)), chunks=(2000, 1000))
        small1 = da.from_array(rng.standard_normal((8000, 1000)), chunks=(250, 500))
        small2 = da.from_array(rng.standard_normal((8000, 1000)), chunks=(125, 250))
        t0 = time.perf_counter()
        out = (big + small1 + small2).optimize()
        wall = time.perf_counter() - t0
        return wall, out.npartitions, out.chunksize


def case_shatter_guard(policy):
    import dask_array_tpu as da
    from dask_array_tpu import config

    with config.set({"array.unify-chunks-policy": policy}):
        rng = np.random.default_rng(1)
        arrs = [
            da.from_array(rng.standard_normal((6000,)), chunks=c)
            for c in (777, 1000, 1250, 600)
        ]
        t0 = time.perf_counter()
        out = sum(arrs[1:], arrs[0]).optimize()
        wall = time.perf_counter() - t0
        return wall, out.npartitions, out.chunksize


if __name__ == "__main__":
    for case in (case_nested_merge, case_shatter_guard):
        for policy in ("auto", "coarse", "refine"):
            wall, nblocks, csize = case(policy)
            print(
                f"{case.__name__:20s} {policy:7s} optimize {wall * 1e3:7.2f} ms | "
                f"blocks {nblocks:6d} | chunksize {csize}"
            )
