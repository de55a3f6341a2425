"""Collection spine, second batch: scenarios from the reference
``tests/test_collection.py`` without a counterpart here — the dunder
arithmetic grid, pickle cache-dropping, existing-zarr write alignment (warn
+ rechunk contract), masked from_array in a fresh process, and
construction-never-computes discipline.
"""

import subprocess
import sys
import warnings

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu._test_utils import assert_eq


@pytest.fixture
def arr():
    return da.from_array(np.random.default_rng(7).random((10, 10)), chunks=(5, 6))


@pytest.mark.parametrize(
    "op",
    ["__add__", "__sub__", "__mul__", "__truediv__", "__floordiv__", "__pow__",
     "__radd__", "__rsub__", "__rmul__", "__rtruediv__", "__rfloordiv__",
     "__rpow__", "__mod__", "__rmod__"],
)
def test_arithmetic_ops(arr, op):
    result = getattr(arr, op)(2)
    expected = getattr(np.asarray(arr.compute()), op)(2)
    assert_eq(result, expected)


def test_array_pickle_drops_caches_and_keeps_values():
    import pickle

    x = da.from_array(np.arange(12).reshape(3, 4), chunks=(1, 2)) + 1
    name = x.name
    y = pickle.loads(pickle.dumps(x))
    assert y.name == name
    assert_eq(y, np.arange(12).reshape(3, 4) + 1)


def test_masked_from_array_tokenizes_in_fresh_process():
    code = (
        "import numpy as np, dask_array_tpu as da\n"
        "arr = np.ma.array(np.arange(100).reshape(10, 10), mask=False)\n"
        "arr.mask[5, 5] = True\n"
        "x = da.from_array(arr, chunks=(3, 3))\n"
        "out = x[4:7, 4:7].compute()\n"
        "assert out[1, 1] is np.ma.masked, out\n"
    )
    import os
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-800:]


# ---------------------------------------------------------------------------
# to_zarr into an EXISTING array: granule-alignment contract
# (reference io/_zarr.py:229-265, test_to_zarr_rechunk_warning_...)
# ---------------------------------------------------------------------------


def _open_zarr(path, shape, chunks, dtype="f8"):
    from dask_array_tpu.io._zarr import _require_zarr

    zarr = _require_zarr()
    return zarr.open_array(str(path), mode="w", shape=shape, dtype=dtype,
                           chunks=chunks)


def test_to_zarr_existing_misaligned_warns_and_rechunks(tmp_path):
    z = _open_zarr(tmp_path / "z1.zarr", (20,), (10,))
    x = da.from_array(np.arange(20.0), chunks=(7, 7, 6))  # 7 % 10 != 0
    with pytest.warns(da.PerformanceWarning, match="rechunked along axis"):
        da.to_zarr(x, z)
    np.testing.assert_array_equal(np.asarray(z[:]), np.arange(20.0))


def test_to_zarr_existing_aligned_writes_as_is(tmp_path):
    z = _open_zarr(tmp_path / "z2.zarr", (40,), (10,))
    x = da.from_array(np.arange(40.0), chunks=(20, 10, 10))  # granule multiples
    with warnings.catch_warnings():
        warnings.simplefilter("error", da.PerformanceWarning)
        da.to_zarr(x, z)
    np.testing.assert_array_equal(np.asarray(z[:]), np.arange(40.0))


def test_to_zarr_existing_interior_boundary_misalignment_detected(tmp_path):
    # nominal chunk divisible but an interior boundary is not: (10, 7, 13)
    # has boundaries 10, 17 — 17 is mid-granule, must still warn+rechunk
    z = _open_zarr(tmp_path / "z3.zarr", (30,), (5,))
    x = da.from_array(np.arange(30.0), chunks=(10, 7, 13))
    with pytest.warns(da.PerformanceWarning):
        da.to_zarr(x, z)
    np.testing.assert_array_equal(np.asarray(z[:]), np.arange(30.0))


def test_to_zarr_existing_region_aligns_to_window(tmp_path):
    z = _open_zarr(tmp_path / "z4.zarr", (30,), (10,))
    z[:] = 0.0
    patch = da.from_array(np.arange(12.0), chunks=(5, 7))
    da.to_zarr(patch, z, region=(slice(9, 21),))
    expected = np.zeros(30)
    expected[9:21] = np.arange(12.0)
    np.testing.assert_array_equal(np.asarray(z[:]), expected)


def test_conversion_does_not_compute():
    # building expressions must never trigger host loads (the reference's
    # is_dask_collection_doesnt_materialize discipline)
    calls = []

    def spy(i):
        calls.append(i)
        return np.full((4,), i, dtype="f8")

    from dask_array_tpu.io._from_map import from_map

    x = from_map(spy, [0, 1, 2], chunks=((4, 4, 4),), dtype="f8")
    y = ((x + 1) * 2)[:6].rechunk((3, 3))
    y.optimize()
    assert calls == []
    np.testing.assert_array_equal(
        np.asarray(y.compute()), ((np.repeat([0.0, 1.0], 4) + 1) * 2)[:6][:8]
    )
    assert sorted(set(calls)) == [0, 1]
