"""Round-3 linalg parity battery, ported from the reference spine
(/root/reference/dask_array/tests/test_linalg.py): tsqr/sfqr/qr grids incl.
error types and uncertain (nan-chunk) inputs, svd numblocks dispatch + dtype
preservation, svd_compressed accuracy/determinism/shapes, lu/solve/cholesky/
lstsq grids, and the norm order/axis/keepdims matrix."""

import warnings

import numpy as np
import pytest
import scipy.linalg

import dask_array_tpu as da
from dask_array_tpu._test_utils import assert_eq
from dask_array_tpu.linalg import qr, sfqr, svd, svd_compressed, svd_flip, tsqr


@pytest.fixture
def rng():
    return np.random.default_rng(23)


# ---------------------------------------------------------------------------
# tsqr / sfqr / qr grids (reference test_tsqr / test_sfqr / test_qr)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,n,chunks,error_type",
    [
        (20, 10, 10, None),                      # tall-skinny regular blocks
        (20, 10, (3, 10), None),                 # regular fat layers
        (20, 10, ((8, 4, 8), 10), None),         # irregular fat layers
        (40, 10, ((15, 5, 5, 8, 7), 10), None),  # non-uniform chunks
        (128, 2, (16, 2), None),                 # thin layers, depth 1
        (129, 2, (16, 2), None),                 # thin layers, depth 2
        (300, 10, (40, 10), None),               # depth 2
        (300, 10, (20, 10), None),               # depth 4
        (10, 5, 10, None),                       # single block tall
        (5, 10, 10, None),                       # single block short
        (10, 10, 10, None),                      # single block square
        (10, 40, (10, 10), ValueError),          # short-fat regular blocks
        (10, 40, (10, 15), ValueError),          # short-fat irregular blocks
        (20, 20, 10, ValueError),                # 2x2 regular blocks
    ],
)
def test_tsqr_grid(rng, m, n, chunks, error_type):
    mat = rng.random((m, n))
    data = da.from_array(mat, chunks=chunks)
    n_q = min(m, n)
    if error_type is None:
        q, r = tsqr(data)
        assert q.shape == (m, n_q)
        assert r.shape == (n_q, n)
        assert_eq(mat, da.dot(q, r), rtol=1e-9)
        assert_eq(np.eye(n_q, n_q), da.dot(q.T, q), atol=1e-9)
        assert_eq(r, da.triu(r.rechunk(r.shape[0])), rtol=1e-12)
        u, s, vh = tsqr(data, compute_svd=True)
        assert_eq(s, np.linalg.svd(mat)[1], rtol=1e-8)
        assert_eq(np.eye(n_q, n_q), da.dot(u.T, u), atol=1e-8)
        assert_eq(mat, da.dot(da.dot(u, da.diag(s)), vh[:n_q]), rtol=1e-8)
    else:
        with pytest.raises(error_type):
            tsqr(data)
        with pytest.raises(error_type):
            tsqr(data, compute_svd=True)


def test_tsqr_uncertain_chunks(rng):
    """tsqr on a boolean-masked (nan-chunk) input (reference test_tsqr_uncertain)."""
    mat = rng.random((80, 5))
    mat[0:40, 0] += 1
    _c0 = mat[:, 0]
    c0 = da.from_array(_c0, chunks=40)
    data = da.from_array(mat, chunks=(10, 5))
    data = data[c0 > 0.5, :]
    mat = mat[_c0 > 0.5, :]
    m, n = mat.shape
    q, r = tsqr(data)
    q = np.asarray(q.compute())
    r = np.asarray(r.compute())
    assert q.shape == (m, min(m, n))
    assert np.allclose(mat, q @ r)
    assert np.allclose(np.eye(min(m, n)), q.T @ q, atol=1e-8)
    assert np.allclose(r, np.triu(r))
    u, s, vh = tsqr(data, compute_svd=True)
    assert np.allclose(np.asarray(s.compute()), np.linalg.svd(mat)[1])
    # u executes through the single-unknown-row-block BlockView path
    un = np.asarray(u.compute())
    assert un.shape == (m, min(m, n))
    assert np.allclose(np.eye(min(m, n)), un.T @ un, atol=1e-7)


def test_tsqr_zero_height_chunks(rng):
    mat = rng.random((10, 5))
    x = da.from_array(mat, chunks=((4, 0, 1, 0, 5), (5,)))
    q, r = da.linalg.qr(x)
    assert q.shape == (10, 5)
    assert_eq(mat, da.dot(q, r), rtol=1e-9)
    assert_eq(np.eye(5, 5), da.dot(q.T, q), atol=1e-9)
    mat2 = np.vstack([mat, -(np.ones((10, 5)))])
    x2 = da.from_array(mat2, chunks=5)
    c = da.from_array(mat2[:, 0], chunks=5)
    xm = x2[c >= 0, :]
    q, r = da.linalg.qr(xm)
    q = np.asarray(q.compute())
    r = np.asarray(r.compute())
    assert q.shape == (10, 5)
    assert np.allclose(mat, q @ r)


@pytest.mark.parametrize(
    "m,n,chunks,error_type",
    [
        (20, 10, 10, ValueError),                 # tall-skinny raises for sfqr
        (20, 10, (3, 10), ValueError),
        (10, 5, 10, None),                        # single block tall
        (5, 10, 10, None),                        # single block short
        (10, 10, 10, None),                       # single block square
        (10, 40, (10, 10), None),                 # short-fat regular
        (10, 40, (10, 15), None),                 # short-fat irregular
        (10, 40, (10, (15, 5, 5, 8, 7)), None),   # short-fat non-uniform
        (20, 20, 10, ValueError),                 # 2x2 blocks
    ],
)
def test_sfqr_grid(rng, m, n, chunks, error_type):
    mat = rng.random((m, n))
    data = da.from_array(mat, chunks=chunks)
    n_q = min(m, n)
    if error_type is None:
        q, r = sfqr(data)
        assert q.shape == (m, n_q)
        assert r.shape == (n_q, n)
        assert_eq(mat, da.dot(q, r), rtol=1e-9)
        assert_eq(np.eye(n_q, n_q), da.dot(q.T, q), atol=1e-9)
    else:
        with pytest.raises(error_type):
            sfqr(data)


@pytest.mark.parametrize(
    "m,n,chunks",
    [
        (20, 10, 10), (20, 10, (3, 10)), (10, 5, 10), (5, 10, 10),
        (10, 10, 10), (10, 40, (10, 10)), (10, 40, (10, 15)),
        (10, 40, (10, (15, 5, 5, 8, 7))),
    ],
)
def test_qr_grid(rng, m, n, chunks):
    mat = rng.random((m, n))
    data = da.from_array(mat, chunks=chunks)
    n_q = min(m, n)
    q, r = qr(data)
    assert q.shape == (m, n_q)
    assert r.shape == (n_q, n)
    assert_eq(mat, da.dot(q, r), rtol=1e-9)
    assert_eq(np.eye(n_q, n_q), da.dot(q.T, q), atol=1e-9)
    assert_eq(r, da.triu(r.rechunk(r.shape[0])), rtol=1e-12)


def test_linalg_consistent_names(rng):
    mat = rng.random((20, 10))
    data = da.from_array(mat, chunks=(10, 10))
    q1, r1 = qr(data)
    q2, r2 = qr(data)
    assert q1.expr._name == q2.expr._name
    assert r1.expr._name == r2.expr._name
    u1, s1, v1 = svd(data)
    u2, s2, v2 = svd(data)
    assert (u1.expr._name, s1.expr._name, v1.expr._name) == (
        u2.expr._name, s2.expr._name, v2.expr._name)


# ---------------------------------------------------------------------------
# svd (reference test_dask_svd_self_consistent + dispatch/dtype tests)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(10, 20), (15, 15), (20, 10)])
def test_svd_self_consistent_row_chunks(rng, m, n):
    """svd dispatches on NUMBLOCKS: row-chunked short matrices go through
    tsqr and are trimmed (reference _svd.py:201-222)."""
    a = rng.random((m, n))
    d_a = da.from_array(a, chunks=(3, n))
    d_u, d_s, d_vt = da.linalg.svd(d_a)
    u, s, vt = da.compute(d_u, d_s, d_vt)
    for d_e, e in zip([d_u, d_s, d_vt], [u, s, vt]):
        assert d_e.shape == np.asarray(e).shape
        assert d_e.dtype == np.asarray(e).dtype
    assert np.allclose(np.asarray(s), np.linalg.svd(a)[1])
    k = min(m, n)
    assert np.asarray(u).shape == (m, k)
    assert np.asarray(vt).shape == (k, n)


@pytest.mark.parametrize("chunks", [(10, 50), (50, 10), (-1, -1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_svd_dtype_preservation(rng, chunks, dtype):
    x = da.from_array(rng.random((50, 50)), chunks=chunks).astype(dtype)
    u, s, v = svd(x)
    assert u.dtype == s.dtype == v.dtype == dtype


def test_svd_unknown_chunks(rng):
    """svd over a boolean-masked input (reference test_no_chunks_svd)."""
    x = rng.random((100, 10))
    u, s, v = np.linalg.svd(x, full_matrices=False)
    y = da.from_array(x, chunks=(10, 10))
    yy = y[da.from_array(np.ones(100, bool), chunks=10)]
    du, ds, dv = da.linalg.svd(yy)
    assert_eq(ds, s, rtol=1e-7)
    assert np.allclose(np.abs(np.asarray(du.compute())), np.abs(u))
    assert np.allclose(np.abs(np.asarray(dv.compute())), np.abs(v))


@pytest.mark.parametrize("input_dtype", [np.float32, np.float64])
def test_svd_compressed_dtype_preservation(rng, input_dtype):
    x = da.from_array(rng.random((50, 50)).astype(input_dtype), chunks=(50, 50))
    u, s, vt = svd_compressed(x, 1, seed=4321)
    assert u.dtype == s.dtype == vt.dtype == input_dtype


@pytest.mark.parametrize("m", [5, 15])
@pytest.mark.parametrize("n", [5, 20])
@pytest.mark.parametrize("chunks", [(5, 10), (10, 5)])
def test_svd_compressed_shapes(rng, m, n, chunks):
    x = da.from_array(rng.random((m, n)), chunks=chunks)
    u, s, v = svd_compressed(x, 5, n_power_iter=1, seed=1)
    u, s, v = da.compute(u, s, v)
    r = min(m, n, 5)
    assert np.asarray(u).shape == (m, r)
    assert np.asarray(s).shape == (r,)
    assert np.asarray(v).shape == (r, n)


@pytest.mark.parametrize("iterator,n_iter", [("power", 2), ("QR", 2)])
def test_svd_compressed_accuracy_bound(iterator, n_iter):
    """Halko et al. eq 1.10/1.11 tail bound (reference test_svd_compressed)."""
    m, n, r = 100, 50, 5
    a = da.random.default_rng(99).random((m, n), chunks=(m, n))
    u, s, vt = svd_compressed(a, 2 * r, iterator=iterator, n_power_iter=n_iter, seed=4321)
    s_true = scipy.linalg.svd(np.asarray(a.compute()), compute_uv=False)
    norm = scipy.linalg.norm(np.asarray((a - (u[:, :r] * s[:r]) @ vt[:r, :]).compute()), 2)
    assert norm / s_true[r + 1] - 1 < 0.4
    assert_eq(np.eye(r, r), da.dot(u[:, :r].T, u[:, :r]), atol=1e-7)


def test_svd_compressed_deterministic():
    x = da.random.default_rng(1234).random(size=(30, 25), chunks=(5, 5))
    u, s, vt = svd_compressed(x, 3, seed=1234)
    u2, s2, vt2 = svd_compressed(x, 3, seed=1234)
    assert all(bool(v) for v in da.compute((u == u2).all(), (s == s2).all(), (vt == vt2).all()))


def test_svd_flip_reconstruction(rng):
    for dtype in [np.float64, np.complex128]:
        for u_based in [True, False]:
            x = rng.random((15, 10)).astype(dtype)
            u, s, v = np.linalg.svd(x, full_matrices=False)
            uf, vf = svd_flip(u, v, u_based_decision=u_based)
            assert np.allclose((uf * s) @ vf, x)


# ---------------------------------------------------------------------------
# lu / solve / cholesky / lstsq (reference test_lu_* / test_solve_* / ...)
# ---------------------------------------------------------------------------


def test_lu_reference_matrices(rng):
    A1 = np.array([[7, 3, -1, 2], [3, 8, 1, -4], [-1, 1, 4, -1], [2, -4, -1, 6]], dtype=float)
    A2 = np.diag([7.0, 8, 4, 6, 3, 5])
    for A, chunk in [(A1, 2), (A2, 2)]:
        dA = da.from_array(A, chunks=(chunk, chunk))
        p, l, u = scipy.linalg.lu(A)
        dp, dl, du = da.linalg.lu(dA)
        assert_eq(p, dp, rtol=1e-12)
        assert_eq(l, dl, rtol=1e-9)
        assert_eq(u, du, rtol=1e-9)
    # pivoting case: P L U must reconstruct even when pivot order differs
    A3 = np.array([
        [7, 3, 2, 1, 4, 1], [7, 11, 5, 2, 5, 2], [21, 25, 16, 10, 16, 5],
        [21, 41, 18, 13, 16, 11], [14, 46, 23, 24, 21, 22], [0, 56, 29, 17, 14, 8],
    ], dtype=float)
    dA = da.from_array(A3, chunks=(2, 2))
    dp, dl, du = da.linalg.lu(dA)
    assert np.allclose(
        np.asarray(dp.compute()) @ np.asarray(dl.compute()) @ np.asarray(du.compute()), A3)
    assert_eq(dl, da.tril(dl), rtol=1e-12)
    assert_eq(du, da.triu(du), rtol=1e-12)


@pytest.mark.parametrize("size,chunk", [(10, 5), (30, 5), (50, 25)])
def test_lu_sizes(rng, size, chunk):
    A = rng.integers(0, 10, (size, size)).astype(float)
    dA = da.from_array(A, chunks=(chunk, chunk))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp, dl, du = da.linalg.lu(dA)
    assert np.allclose(
        np.asarray(dp.compute()) @ np.asarray(dl.compute()) @ np.asarray(du.compute()), A)


def test_lu_errors(rng):
    dA = da.from_array(rng.integers(0, 11, (10, 10, 10)), chunks=(5, 5, 5))
    with pytest.raises(ValueError):
        da.linalg.lu(dA)
    dA = da.from_array(rng.integers(0, 11, (10, 8)), chunks=(5, 4))
    with pytest.raises(ValueError):
        da.linalg.lu(dA)


@pytest.mark.parametrize("shape,chunk", [(20, 10), (50, 10), (70, 20)])
def test_solve_triangular_grids(rng, shape, chunk):
    A = rng.integers(1, 11, (shape, shape)).astype(float)
    b = rng.integers(1, 11, shape).astype(float)
    Au, Al = np.triu(A), np.tril(A)
    dAu = da.from_array(Au, (chunk, chunk))
    dAl = da.from_array(Al, (chunk, chunk))
    db = da.from_array(b, chunk)
    assert_eq(da.linalg.solve_triangular(dAu, db),
              scipy.linalg.solve_triangular(Au, b), rtol=1e-7)
    assert_eq(da.linalg.solve_triangular(dAl, db, lower=True),
              scipy.linalg.solve_triangular(Al, b, lower=True), rtol=1e-7)
    B = rng.integers(1, 11, (shape, shape)).astype(float)
    dB = da.from_array(B, (chunk, chunk))
    assert_eq(da.linalg.solve_triangular(dAu, dB),
              scipy.linalg.solve_triangular(Au, B), rtol=1e-7)


def test_solve_triangular_errors(rng):
    dA = da.from_array(rng.integers(0, 11, (10, 10, 10)), chunks=(5, 5, 5))
    db = da.from_array(rng.integers(1, 11, 10), chunks=5)
    with pytest.raises(ValueError):
        da.linalg.solve_triangular(dA, db)


@pytest.mark.parametrize("shape,chunk", [(20, 10), (50, 10)])
def test_solve_and_inv(rng, shape, chunk):
    A = rng.integers(1, 11, (shape, shape)).astype(float)
    dA = da.from_array(A, (chunk, chunk))
    b = rng.integers(1, 11, shape).astype(float)
    db = da.from_array(b, chunk)
    assert_eq(da.linalg.solve(dA, db), scipy.linalg.solve(A, b), rtol=1e-6, atol=1e-8)
    B = rng.integers(1, 11, (shape, shape)).astype(float)
    dB = da.from_array(B, (chunk, chunk))
    assert_eq(da.linalg.solve(dA, dB), scipy.linalg.solve(A, B), rtol=1e-6, atol=1e-8)
    assert_eq(da.linalg.inv(dA), scipy.linalg.inv(A), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("shape,chunk", [(20, 10), (30, 6)])
def test_solve_assume_a_pos(rng, shape, chunk):
    A = rng.integers(1, 11, (shape, shape)).astype(float)
    A = A @ A.T + shape * np.eye(shape)
    dA = da.from_array(A, (chunk, chunk))
    b = rng.integers(1, 11, shape).astype(float)
    db = da.from_array(b, chunk)
    assert_eq(da.linalg.solve(dA, db, assume_a="pos"),
              scipy.linalg.solve(A, b, assume_a="pos"), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("shape,chunk", [(20, 10), (12, 3), (30, 6)])
def test_cholesky_grids(rng, shape, chunk):
    A = rng.integers(1, 11, (shape, shape)).astype(float)
    A = A @ A.T + shape * np.eye(shape)
    dA = da.from_array(A, (chunk, chunk))
    assert_eq(da.linalg.cholesky(dA), scipy.linalg.cholesky(A), rtol=1e-7)
    assert_eq(da.linalg.cholesky(dA, lower=True),
              scipy.linalg.cholesky(A, lower=True), rtol=1e-7)


@pytest.mark.parametrize("nrow,ncol,chunk", [(20, 10, 5), (100, 10, 10)])
def test_lstsq_grids(rng, nrow, ncol, chunk):
    A = rng.integers(1, 20, (nrow, ncol)).astype(float)
    b = rng.integers(1, 20, nrow).astype(float)
    dA = da.from_array(A, (chunk, ncol))
    db = da.from_array(b, chunk)
    x, r, rank, s = np.linalg.lstsq(A, b, rcond=-1)
    dx, dr, drank, ds = da.linalg.lstsq(dA, db)
    assert_eq(dx, x, rtol=1e-7)
    assert_eq(dr, r, rtol=1e-7)
    assert int(drank.compute()) == rank
    assert_eq(ds, s, rtol=1e-7)
    b2 = rng.integers(1, 20, (nrow, 3)).astype(float)
    db2 = da.from_array(b2, (chunk, 3))
    x, r, rank, s = np.linalg.lstsq(A, b2, rcond=-1)
    dx, dr, drank, ds = da.linalg.lstsq(dA, db2)
    assert_eq(dx, x, rtol=1e-7)
    assert_eq(dr, r, rtol=1e-7)


def test_lstsq_complex_real_singular_values(rng):
    """Residuals and singular values are REAL for complex systems."""
    nrow, ncol, chunk = 20, 10, 5
    A = (rng.integers(1, 20, (nrow, ncol))
         + 1j * rng.integers(1, 20, (nrow, ncol))).astype(np.complex128)
    b = (rng.integers(1, 20, nrow) + 1j * rng.integers(1, 20, nrow)).astype(np.complex128)
    dA = da.from_array(A, (chunk, ncol))
    db = da.from_array(b, chunk)
    x, r, rank, s = np.linalg.lstsq(A, b, rcond=-1)
    dx, dr, drank, ds = da.linalg.lstsq(dA, db)
    assert ds.dtype == np.float64
    assert dr.dtype == np.float64
    assert_eq(dx, x, rtol=1e-7)
    assert_eq(ds, s, rtol=1e-7)


# ---------------------------------------------------------------------------
# norm (reference test_norm_any_ndim / _1dim / _2dim / _implemented_errors)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("shape,chunks", [((5,), 2), ((5, 6), (2, 2)), ((4, 5, 6), (2, 2, 2))])
def test_norm_default_any_ndim(rng, shape, chunks, keepdims):
    x = rng.standard_normal(shape)
    dx = da.from_array(x, chunks=chunks)
    assert_eq(da.linalg.norm(dx, keepdims=keepdims),
              np.asarray(np.linalg.norm(x, keepdims=keepdims)), rtol=1e-9)


@pytest.mark.parametrize("norm", [None, 1, -1, np.inf, -np.inf])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [0, 1, (0, 1), (1, 0)])
def test_norm_axis_grid(rng, norm, keepdims, axis):
    x = rng.standard_normal((5, 6))
    dx = da.from_array(x, chunks=(2, 2))
    try:
        expected = np.linalg.norm(x, ord=norm, axis=axis, keepdims=keepdims)
    except ValueError:
        return
    assert_eq(da.linalg.norm(dx, ord=norm, axis=axis, keepdims=keepdims), expected, rtol=1e-9)


@pytest.mark.parametrize("norm", ["fro", "nuc", 2, -2])
def test_norm_spectral_orders(rng, norm):
    x = rng.standard_normal((5, 6))
    dx = da.from_array(x, chunks=(2, 2))
    expected = np.linalg.norm(x, ord=norm, axis=(0, 1))
    assert_eq(da.linalg.norm(dx, ord=norm, axis=(0, 1)), np.asarray(expected), rtol=1e-8)


def test_norm_vector_orders_1d(rng):
    x = rng.standard_normal((7,))
    dx = da.from_array(x, chunks=3)
    for norm in [None, 0, 1, -1, 2, -2, 0.5, 3, np.inf, -np.inf]:
        expected = np.linalg.norm(x, ord=norm)
        assert_eq(da.linalg.norm(dx, ord=norm), np.asarray(expected), rtol=1e-9)
