"""Differential probe: device results vs numpy over a workload matrix."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import dask_array_tpu as da

    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 512)).astype("f4")
    d = da.from_array(x, chunks=128)

    cases = {
        "normalize": (lambda v: (v - v.mean(0)) / (v.std(0) + 1e-6),) * 2,
        "matmul_t": (lambda v: v @ v.T,) * 2,
        "slice_mix": (lambda v: v[::3, 10:500:2].T,) * 2,
        "reduce": (lambda v: v.sum(axis=1),) * 2,
        "stack": None,
    }
    for name, fns in cases.items():
        if name == "stack":
            got = np.asarray(da.stack([d, d * 2]).sum(axis=0).compute())
            want = np.stack([x, x * 2]).sum(axis=0)
        else:
            fn, _ = fns
            got = np.asarray(fn(d).compute())
            want = fn(x)
        ok = np.allclose(got.astype("f8"), np.asarray(want, "f8"), rtol=2e-2, atol=2e-3)
        print(f"{name:12s} match={ok}  max|d|={np.abs(got.astype('f8') - np.asarray(want, 'f8')).max():.2e}")
        if not ok:
            raise SystemExit(f"DIFFERENTIAL FAILURE in {name}")


if __name__ == "__main__":
    main()
