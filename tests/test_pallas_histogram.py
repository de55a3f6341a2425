"""Histogram and bincount through ``da.histogram`` / ``da.bincount``.

The histogram runs a compare-accumulate scan (``kernels/histogram.py``)
chosen by dtype, and falls back to ``jnp.histogram`` where the scan
declines; bincount runs ``jnp.bincount``.  Every case compares with numpy
through the public API.
"""

import numpy as np
import pytest

import dask_array_tpu as da
import dask_array_tpu.kernels.histogram as K
from dask_array_tpu._test_utils import assert_eq


def khist(x, edges, weights=None, chunks=None):
    """``da.histogram`` counts of ``x`` over ``edges``, as numpy."""
    x = np.asarray(x)
    d = da.from_array(x, chunks=chunks or max(1, -(-x.size // 3)))
    w = None if weights is None else da.from_array(np.asarray(weights), chunks=d.chunks)
    h, _ = da.histogram(d, bins=np.asarray(edges), weights=w)
    return np.asarray(h.compute())


@pytest.fixture
def scan_calls(monkeypatch):
    """Record every call of the scan, and whether it answered."""
    calls = []
    orig = K.histogram

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(K, "histogram", spy)
    return calls


@pytest.fixture
def rng():
    return np.random.default_rng(37)


@pytest.mark.parametrize("n", [1, 100, 5000])
@pytest.mark.parametrize("nbins", [1, 7, 129, 300])
def test_kernel_matches_numpy(rng, n, nbins):
    x = rng.standard_normal(n).astype("f4") * 2
    edges = np.linspace(-4, 4, nbins + 1, dtype="f4")
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


def test_kernel_nonuniform_edges(rng):
    x = rng.standard_normal(3000).astype("f4")
    edges = np.array([-3, -0.7, -0.1, 0.0, 0.25, 1.0, 2.75], dtype="f4")
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


def test_kernel_edge_semantics():
    # values ON edges go right; last bin is CLOSED; NaN/out-of-range drop
    edges = np.array([0.0, 1.0, 2.0, 3.0], dtype="f4")
    x = np.array([0.0, 1.0, 2.0, 3.0, -0.5, 3.5, np.nan], dtype="f4")
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


def test_kernel_weighted(rng):
    x = rng.standard_normal(4000).astype("f4")
    w = rng.uniform(0, 3, 4000).astype("f4")
    edges = np.linspace(-3, 3, 33, dtype="f4")
    exp, _ = np.histogram(x, bins=edges, weights=w.astype("f8"))
    np.testing.assert_allclose(khist(x, edges, w), exp, rtol=1e-5)


def test_da_histogram_routes_to_pallas(rng, scan_calls):
    x = rng.standard_normal(2048).astype("f4")
    d = da.from_array(x, chunks=512)
    h, edges = da.histogram(d, bins=np.linspace(-3, 3, 17))
    eh, _ = np.histogram(x, bins=np.linspace(-3, 3, 17))
    assert_eq(h, eh, check_dtype=False)
    assert scan_calls == [True]  # the scan answered


def test_da_histogram_density_pallas(rng, scan_calls):
    x = rng.standard_normal(4096).astype("f4")
    d = da.from_array(x, chunks=1024)
    h, edges = da.histogram(d, bins=np.linspace(-3, 3, 11), density=True)
    eh, _ = np.histogram(x, bins=np.linspace(-3, 3, 11), density=True)
    np.testing.assert_allclose(np.asarray(h.compute()), eh, rtol=1e-5)
    assert scan_calls == [True]


def test_da_bincount_routes_to_pallas(rng, scan_calls):
    # bincount stays on jnp.bincount: the scan is never asked
    ints = rng.integers(0, 50, size=3000)
    d = da.from_array(ints, chunks=750)
    got = np.asarray(da.bincount(d, minlength=60).compute())
    np.testing.assert_array_equal(got, np.bincount(ints, minlength=60))
    assert scan_calls == []


def test_da_bincount_weighted_pallas(rng):
    ints = rng.integers(0, 20, size=1000)
    w = rng.uniform(0, 1, size=1000).astype("f4")
    d = da.from_array(ints, chunks=250)
    dw = da.from_array(w, chunks=250)
    got = np.asarray(da.bincount(d, weights=dw).compute())
    np.testing.assert_allclose(got, np.bincount(ints, weights=w), rtol=1e-6)


def test_xla_route_on_cpu_by_default(rng, scan_calls):
    # the lane follows the dtypes, on every backend: float64 WEIGHTS are
    # not float32-exact, so the scan declines and jnp.histogram answers
    x = rng.standard_normal(1000).astype("f4")
    w = rng.uniform(0, 1, size=1000)
    edges = np.linspace(-3, 3, 9)
    exp, _ = np.histogram(x, bins=edges, weights=w)
    np.testing.assert_allclose(khist(x, edges, w), exp, rtol=1e-12)
    assert scan_calls == [False]
    assert K.compare_dtype(np.dtype("f4"), np.dtype("f4")) == np.dtype("f4")
    assert K.compare_dtype(np.dtype("f4"), np.dtype("f8")) == np.dtype("f8")
    assert K.compare_dtype(np.dtype("i8"), np.dtype("i8")) == np.dtype("i8")
    assert K.compare_dtype(np.dtype("i8"), np.dtype("f8")) == np.dtype("f8")
    assert K.compare_dtype(np.dtype("c8"), np.dtype("f4")) is None


# -- float64 data -------------------------------------------------------------


def test_kernel_f64_matches_numpy(rng):
    data = rng.standard_normal(100_000)
    edges = np.linspace(-3, 3, 65)
    ref, _ = np.histogram(data, bins=edges)
    np.testing.assert_array_equal(khist(data, edges), ref)


def test_kernel_f64_edge_exactness(rng):
    """Values exactly ON f64 edges (and one-f64-ulp neighbors beyond f32
    resolution) bin like numpy."""
    edges = np.linspace(-3, 3, 65)
    tricky = np.concatenate(
        [
            edges.repeat(7),
            edges + 1e-12,
            edges - 1e-12,
            np.array([np.nan, np.inf, -np.inf, edges[-1]]),
        ]
    )
    ref, _ = np.histogram(tricky, bins=edges)
    np.testing.assert_array_equal(khist(tricky, edges), ref)


def test_kernel_f64_sub_f32_resolution():
    base = 1.0
    vals = np.array([base + k * 2**-40 for k in range(-50, 50)])
    edges = np.array([base - 2**-41, base + 2**-41, base + 10 * 2**-40])
    ref, _ = np.histogram(vals, bins=edges)
    np.testing.assert_array_equal(khist(vals, edges), ref)


def test_kernel_f64_inf_edges():
    edges = np.array([0.0, 1.0, np.inf])
    vals = np.array([0.5, 2.0, np.inf, np.nan, -1.0])
    ref, _ = np.histogram(vals, bins=edges)
    np.testing.assert_array_equal(khist(vals, edges), ref)


def test_kernel_f64_weighted(rng):
    data = rng.standard_normal(20_000)
    w = rng.uniform(0, 1, size=20_000).astype("f4")
    edges = np.linspace(-3, 3, 33)
    ref, _ = np.histogram(data, bins=edges, weights=w.astype("f8"))
    np.testing.assert_allclose(khist(data, edges, w), ref, rtol=1e-6)


def test_da_histogram_f64_routes_to_pallas(rng, scan_calls):
    data = rng.standard_normal(4096)  # f64 default
    d = da.from_array(data, chunks=1024)
    got, edges = (np.asarray(v.compute()) for v in da.histogram(d, bins=32, range=(-3, 3)))
    ref, redges = np.histogram(data, bins=32, range=(-3, 3))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(edges, redges)
    assert scan_calls == [True]


# -- integer data -------------------------------------------------------------


def test_kernel_int32_exact_past_2_24(rng):
    # values straddling 2^24: a bare f32 cast would merge adjacent bins
    base = 1 << 24
    x = (base + rng.integers(-8, 8, size=4000)).astype(np.int32)
    edges = np.arange(base - 8, base + 9, dtype=np.int64)
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


@pytest.mark.parametrize("dt", ["i1", "i2", "u2", "bool"])
def test_kernel_small_int_dtypes(rng, dt):
    x = rng.integers(0, 2 if dt == "bool" else 100, size=3000).astype(dt)
    edges = np.linspace(0, 100, 11)
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


def test_histogram_int_routing(rng, scan_calls):
    x = (1 << 24) + rng.integers(-50, 50, size=5000).astype(np.int32)
    d = da.from_array(x, chunks=1300)
    h, e = da.histogram(d, bins=10, range=(x.min(), x.max()))
    got = np.asarray(h.compute())
    exp, _ = np.histogram(x, bins=10, range=(x.min(), x.max()))
    np.testing.assert_array_equal(got, exp)
    assert scan_calls == [True]
    assert K.compare_dtype(np.dtype("u8"), np.dtype("u8")) == np.dtype("u8")
    assert K.compare_dtype(np.dtype("i8"), np.dtype("u8")) == np.dtype("f8")


def test_kernel_int64_int_edges_exact_past_2_48(rng):
    # adjacent int64 values around 2^56: anything but an integer compare
    # mis-bins here
    base = np.int64(1) << 56
    x = base + rng.integers(-8, 8, size=4000).astype(np.int64)
    edges = (base + np.arange(-8, 9)).astype(np.int64)
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


def test_kernel_int64_negative_and_full_range(rng):
    x = rng.integers(-(2**62), 2**62, size=10000, dtype=np.int64)
    edges = np.linspace(-(2**62), 2**62, 17).astype(np.int64)
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


def test_kernel_uint64_exact(rng):
    x = rng.integers(0, 2**63, size=5000, dtype=np.uint64) + np.uint64(2**63)
    step = np.uint64((2**63 - 2) // 8)
    edges = np.uint64(2**63) + np.arange(9, dtype=np.uint64) * step
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


def test_kernel_int64_last_edge_inclusive():
    edges = np.array([0, 10, 20], dtype=np.int64)
    x = np.array([0, 10, 20, 21, -1], dtype=np.int64)
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)  # 20 counts in the last bin


def test_kernel_int64_float_edges_numpy_parity(rng):
    # int64 vs FLOAT edges: numpy promotes both to f64 (lossy past 2^53),
    # and so does the scan
    base = np.int64(1) << 55
    x = base + rng.integers(-1000, 1000, size=4000).astype(np.int64)
    edges = np.linspace(float(base - 1000), float(base + 1000), 33)
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges), exp)


def test_kernel_int64_max_edge_declines(scan_calls):
    # a last edge at the int64 maximum equals the scan's padding value: the
    # padding must not count, and a real value there must
    big = np.iinfo(np.int64).max
    edges = np.array([0, big], dtype=np.int64)
    x = np.array([1, 2, 3, big], dtype=np.int64)
    exp, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(khist(x, edges, chunks=2), exp)
    assert scan_calls == [True]


def test_histogram_int_edges_dtype_parity(rng):
    # numpy returns the caller's integer edges dtype; so do we
    x = rng.integers(0, 100, size=500).astype(np.int64)
    edges = np.arange(0, 101, 10, dtype=np.int64)
    d = da.from_array(x, chunks=130)
    h, e = da.histogram(d, bins=edges)
    exp_h, exp_e = np.histogram(x, bins=edges)
    assert np.asarray(e.compute()).dtype == exp_e.dtype
    np.testing.assert_array_equal(np.asarray(h.compute()), exp_h)
