"""The bit-level float ufuncs on float64: numpy parity through ``da.*``.

``signbit``, ``copysign``, ``ldexp``, ``frexp``, ``nextafter`` and
``spacing`` call the ``jax.numpy`` natives on every backend.  These cases
pin their float64 behaviour at the special values (signed zeros, the
extremes of the normal range, infinities, NaN) through the lazy API.
"""

import numpy as np

import dask_array_tpu as da


def _vals():
    return np.array(
        [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 1.5, -1.5,
         3.7, -3.7, 1e300, -1e300, 1e-300, -1e-300, np.inf, -np.inf, np.nan,
         123.456, -0.001, 4.0, 8.0, 0.25]
    )


def _lazy(v, chunks=6):
    return da.from_array(v, chunks=chunks)


def test_signbit_arith_matches_numpy():
    v = _vals()
    got = np.asarray(da.signbit(_lazy(v)).compute())
    ok = ~np.isnan(v)  # the sign bit of a NaN is not part of the contract
    np.testing.assert_array_equal(got[ok], np.signbit(v)[ok])


def test_copysign_arith_matches_numpy():
    x = _vals()
    for y in (np.float64(3.0), np.float64(-3.0), np.float64(-0.0), -x):
        yy = _lazy(y) if np.ndim(y) else y
        got = np.asarray(da.copysign(_lazy(x), yy).compute())
        exp = np.copysign(x, y)
        ok = ~np.isnan(np.broadcast_to(y, x.shape))
        np.testing.assert_array_equal(got[ok], exp[ok])
        assert np.array_equal(np.signbit(got[ok]), np.signbit(exp[ok]))


def test_ldexp_arith_matches_numpy():
    x = np.array([1.0, -1.5, 0.75, 3.141592653589793, 0.0, -0.0, np.inf])
    for n in (-1000, -600, -53, -1, 0, 1, 53, 600, 1000):
        got = np.asarray(da.ldexp(_lazy(x, 3), np.int64(n)).compute())
        np.testing.assert_array_equal(got, np.ldexp(x, n))


def test_ldexp_arith_vector_exponent():
    x = np.linspace(-2.0, 2.0, 9)
    n = np.arange(-4, 5)
    got = da.ldexp(_lazy(x, 4), _lazy(n, 4)).compute()
    np.testing.assert_array_equal(np.asarray(got), np.ldexp(x, n))


def test_frexp_arith_matches_numpy():
    v = _vals()
    m, e = da.frexp(_lazy(v))
    m_got, e_got = np.asarray(m.compute()), np.asarray(e.compute())
    m_exp, e_exp = np.frexp(v)
    ok = np.isfinite(v)
    np.testing.assert_array_equal(m_got[ok], m_exp[ok])
    np.testing.assert_array_equal(e_got[ok], e_exp[ok])
    np.testing.assert_array_equal(np.ldexp(m_got[ok], e_got[ok]), v[ok])
    bad = ~np.isfinite(v)  # non-finite mantissas pass through
    np.testing.assert_array_equal(m_got[bad], v[bad])


def test_nextafter_f32_granularity():
    # one ulp of the input's own dtype: float64 here, float32 below
    x = np.array([1.0, -1.0, 1e-30, 2.5, 0.0, -0.0, 1e300])
    got = np.asarray(da.nextafter(_lazy(x, 4), np.float64(np.inf)).compute())
    np.testing.assert_array_equal(got, np.nextafter(x, np.inf))
    assert np.all(got > x)
    x32 = x.astype(np.float32)[:4]
    got32 = np.asarray(da.nextafter(_lazy(x32, 2), np.float32(-np.inf)).compute())
    assert got32.dtype == np.float32
    np.testing.assert_array_equal(got32, np.nextafter(x32, np.float32(-np.inf)))
    sp = np.asarray(da.spacing(_lazy(x, 4)).compute())
    # the sign of spacing(-0.0) differs between numpy and XLA; magnitudes agree
    np.testing.assert_array_equal(np.abs(sp), np.abs(np.spacing(x)))
    nz = x != 0
    np.testing.assert_array_equal(sp[nz], np.spacing(x)[nz])


def test_lazy_array_path_roundtrip(rng):
    xs = rng.standard_normal((4, 6))
    x = da.from_array(xs, chunks=(2, 3))
    np.testing.assert_array_equal(
        np.asarray(da.copysign(x, -x).compute()), np.copysign(xs, -xs)
    )
    np.testing.assert_array_equal(
        np.asarray(da.signbit(-x).compute()), np.signbit(-xs)
    )
    m, e = da.frexp(x)
    m_exp, e_exp = np.frexp(xs)
    np.testing.assert_array_equal(np.asarray(m.compute()), m_exp)
    np.testing.assert_array_equal(np.asarray(e.compute()), e_exp)
    n = da.from_array(np.arange(24).reshape(4, 6) - 12, chunks=(2, 3))
    np.testing.assert_array_equal(
        np.asarray(da.ldexp(x, n).compute()), np.ldexp(xs, np.arange(24).reshape(4, 6) - 12)
    )
    np.testing.assert_array_equal(
        np.asarray(da.nextafter(x, x + 1).compute()), np.nextafter(xs, xs + 1)
    )
