"""Linalg parity, fourth batch: scenarios from the reference spine
``/root/reference/dask_array/tests/test_linalg.py`` that had no counterpart
(scipy-checked LU grids, solve_triangular vector/matrix grids, svd_flip
correction/sign, svd shape/chunking support matrix + validation errors,
unknown-chunk svd, norm grids incl. dtype-precision and NotImplemented
errors, svd self-consistency and compute_uv corners).

Divergence noted inline: lu() accepts uneven square chunk grids (the
reference raises; the dense on-device path has no block-grid constraint).
"""

import numpy as np
import pytest
import scipy.linalg

import dask_array_tpu as da
from dask_array_tpu._test_utils import assert_eq
from dask_array_tpu.ops.linalg_decomp import svd_flip

rng = np.random.default_rng(10)


def _check_lu(dp, dl, du, A):
    p, l, u = np.asarray(dp.compute()), np.asarray(dl.compute()), np.asarray(du.compute())
    np.testing.assert_allclose(p @ l @ u, A, atol=1e-9)
    # permutation / triangularity structure
    assert ((p == 0) | (p == 1)).all() and (p.sum(0) == 1).all() and (p.sum(1) == 1).all()
    np.testing.assert_allclose(np.triu(l, 1), 0, atol=1e-12)
    np.testing.assert_allclose(np.diag(l), 1, atol=1e-12)
    np.testing.assert_allclose(np.tril(u, -1), 0, atol=1e-12)


def test_lu_1():
    A1 = np.array([[7, 3, -1, 2], [3, 8, 1, -4], [-1, 1, 4, -1], [2, -4, -1, 6]], dtype="f8")
    A2 = np.diag([7.0, 8, 4, 6, 3, 5])
    for A, chunk in zip([A1, A2], [2, 2]):
        dA = da.from_array(A, chunks=(chunk, chunk))
        p, l, u = scipy.linalg.lu(A)
        dp, dl, du = da.linalg.lu(dA)
        assert_eq(dp, p)
        assert_eq(dl, l)
        assert_eq(du, u)
        _check_lu(dp, dl, du, A)
    # a case that needs row shuffling within panels
    A3 = np.array(
        [[7, 3, 2, 1, 4, 1], [7, 11, 5, 2, 5, 2], [21, 25, 16, 10, 16, 5],
         [21, 41, 18, 13, 16, 11], [14, 46, 23, 24, 21, 22], [0, 56, 29, 17, 14, 8]],
        dtype="f8",
    )
    _check_lu(*da.linalg.lu(da.from_array(A3, chunks=2)), A3)


@pytest.mark.parametrize("size", [10, 20, 30, 50])
def test_lu_2(size):
    A = rng.integers(0, 10, (size, size)).astype("f8")
    _check_lu(*da.linalg.lu(da.from_array(A, chunks=(5, 5))), A)


@pytest.mark.parametrize("size", [50, 100])
def test_lu_3(size):
    A = rng.integers(0, 10, (size, size)).astype("f8")
    _check_lu(*da.linalg.lu(da.from_array(A, chunks=(25, 25))), A)


def test_lu_errors_and_uneven_chunks():
    A = rng.integers(0, 11, (10, 10, 10))
    with pytest.raises(ValueError):
        da.linalg.lu(da.from_array(A, chunks=(5, 5, 5)))
    A = rng.integers(0, 11, (10, 8))
    with pytest.raises(ValueError):
        da.linalg.lu(da.from_array(A, chunks=(5, 4)))
    # DIVERGENCE (stronger): uneven chunks on a SQUARE matrix work here
    # (the reference raises; no block-grid constraint on the dense path)
    A = rng.integers(0, 11, (20, 20)).astype("f8")
    _check_lu(*da.linalg.lu(da.from_array(A, chunks=(5, 4))), A)


@pytest.mark.parametrize(("shape", "chunk"), [(20, 10), (50, 10), (70, 20)])
def test_solve_triangular_vector(shape, chunk):
    r = np.random.default_rng(1)
    A = r.integers(1, 11, (shape, shape))
    b = r.integers(1, 11, shape)
    Au, Al = np.triu(A), np.tril(A)
    for M, lower in [(Au, False), (Al, True)]:
        dM = da.from_array(M, (chunk, chunk))
        db = da.from_array(b, chunk)
        res = da.linalg.solve_triangular(dM, db, lower=lower)
        assert_eq(res, scipy.linalg.solve_triangular(M, b, lower=lower), rtol=1e-8)
        assert_eq(dM.dot(res), b.astype(float), rtol=1e-4)


@pytest.mark.parametrize(("shape", "chunk"), [(20, 10), (50, 10), (50, 20)])
def test_solve_triangular_matrix(shape, chunk):
    r = np.random.default_rng(1)
    A = r.integers(1, 10, (shape, shape))
    b = r.integers(1, 10, (shape, 5))
    for M, lower in [(np.triu(A), False), (np.tril(A), True)]:
        dM = da.from_array(M, (chunk, chunk))
        db = da.from_array(b, (chunk, 5))
        res = da.linalg.solve_triangular(dM, db, lower=lower)
        assert_eq(res, scipy.linalg.solve_triangular(M, b, lower=lower), rtol=1e-8)
        assert_eq(dM.dot(res), b.astype(float), rtol=1e-4)


@pytest.mark.parametrize(("shape", "chunk"), [(20, 10), (50, 20)])
def test_solve_triangular_matrix2(shape, chunk):
    r = np.random.default_rng(1)
    A = r.integers(1, 10, (shape, shape))
    b = r.integers(1, 10, (shape, shape))
    for M, lower in [(np.triu(A), False), (np.tril(A), True)]:
        dM = da.from_array(M, (chunk, chunk))
        db = da.from_array(b, (chunk, chunk))
        res = da.linalg.solve_triangular(dM, db, lower=lower)
        assert_eq(res, scipy.linalg.solve_triangular(M, b, lower=lower), rtol=1e-8)
        assert_eq(dM.dot(res), b.astype(float), rtol=1e-4)


# ---------------------------------------------------------------------------
# svd: shape/chunking support matrix, flip, validation, unknown chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(10, 20), (15, 15), (20, 10)])
def test_dask_svd_self_consistent(m, n):
    a = rng.random((m, n))
    d_a = da.from_array(a, chunks=(3, n), name="A")
    d_u, d_s, d_vt = da.linalg.svd(d_a)
    u, s, vt = da.compute(d_u, d_s, d_vt)
    for d_e, e in zip([d_u, d_s, d_vt], [u, s, vt]):
        assert d_e.shape == np.asarray(e).shape
        assert d_e.dtype == np.asarray(e).dtype


def test_svd_compute_uv_false_ignores_full_matrices():
    a = rng.random((20, 10))
    d_a = da.from_array(a, chunks=(5, 10))
    d_s = da.linalg.svd(d_a, full_matrices=True, compute_uv=False)
    assert_eq(d_s, np.linalg.svd(a, full_matrices=True, compute_uv=False), rtol=1e-9)


@pytest.mark.parametrize("chunks", [(10, -1), (-1, 10), (9, -1), (-1, 9)])
@pytest.mark.parametrize("shape", [(10, 40), (40, 10), (10, 10)])
def test_svd_supported_array_shapes(chunks, shape):
    x = rng.random(shape)
    dx = da.from_array(x, chunks=chunks)
    du, ds, dv = da.linalg.svd(dx)
    du, dv = np.asarray(du.compute()), np.asarray(dv.compute())
    nu, ns, nv = np.linalg.svd(x, full_matrices=False)
    du, dv = svd_flip(du, dv)
    nu, nv = svd_flip(nu, nv)
    np.testing.assert_allclose(du, nu, atol=1e-8)
    np.testing.assert_allclose(np.asarray(ds.compute()), ns, atol=1e-8)
    np.testing.assert_allclose(dv, nv, atol=1e-8)


@pytest.mark.parametrize("shape", [(10, 20), (10, 10), (20, 10)])
@pytest.mark.parametrize("chunks", [(-1, -1), (10, -1), (-1, 10)])
@pytest.mark.parametrize("dtype", ["f4", "f8"])
def test_svd_flip_correction(shape, chunks, dtype):
    local = np.random.default_rng(7)  # fixed draw: f4 tolerance is cond-sensitive
    x = da.from_array(local.random(shape).astype(dtype), chunks=chunks)
    u, s, v = da.linalg.svd(x)
    # f4 runs the matmul-only CholeskyQR2 TSQR whose residual scales with
    # cond^2 * eps_f32 — decimal=4 is the honest tight bound there
    decimal = 9 if np.dtype(dtype).itemsize > 4 else 4
    uf, vf = svd_flip(u, v)
    assert uf.dtype == u.dtype and vf.dtype == v.dtype
    np.testing.assert_almost_equal(
        np.asarray((uf * s).dot(vf).compute()), np.asarray(x.compute()), decimal=decimal
    )
    uc, vc = svd_flip(np.asarray(u.compute()), np.asarray(v.compute()))
    assert uc.dtype == u.dtype and vc.dtype == v.dtype
    np.testing.assert_almost_equal(
        np.dot(uc * np.asarray(s.compute()), vc), np.asarray(x.compute()), decimal=decimal
    )


@pytest.mark.parametrize("dtype", ["f4", "f8"])
@pytest.mark.parametrize("u_based", [True, False])
def test_svd_flip_sign(dtype, u_based):
    x = np.array(
        [[1, -1, 1, -1], [1, -1, 1, -1], [-1, 1, 1, -1], [-1, 1, 1, -1]], dtype=dtype
    )
    u, v = svd_flip(x, x.T, u_based_decision=u_based)
    assert u.dtype == x.dtype and v.dtype == x.dtype
    y = x.copy()
    y[:, -1] *= y.dtype.type(-1)
    np.testing.assert_array_equal(np.asarray(u), y)
    np.testing.assert_array_equal(np.asarray(v), y.T)


def test_no_chunks_svd():
    x = rng.random((100, 10))
    u, s, v = np.linalg.svd(x, full_matrices=False)
    dx = da.from_array(x, chunks=(10, 10))
    masked = dx[da.from_array(np.ones(100, bool), chunks=10)]  # unknown rows
    assert np.isnan(masked.shape[0])
    du, ds, dv = da.linalg.svd(masked)
    np.testing.assert_allclose(np.asarray(ds.compute()), s, atol=1e-8)
    np.testing.assert_allclose(np.abs(np.asarray(dv.compute())), np.abs(v), atol=1e-8)


def test_svd_incompatible_chunking():
    with pytest.raises(NotImplementedError, match="chunked"):
        da.linalg.svd(da.ones((10, 10), chunks=(5, 5)))


@pytest.mark.parametrize("ndim", [0, 1, 3])
def test_svd_incompatible_dimensions(ndim):
    with pytest.raises(ValueError, match="Array must be 2D"):
        da.linalg.svd(da.ones((10,) * ndim, chunks=(-1,) * ndim))


def test_svd_compressed_compute_matches_lazy():
    a = rng.random((60, 60))
    x = da.from_array(a, chunks=(10, 10))
    for iterator in ["power", "QR"]:
        u, s, v = da.linalg.svd_compressed(
            x, k=2, iterator=iterator, n_power_iter=1, compute=True, seed=123
        )
        uu, ss, vv = da.linalg.svd_compressed(
            x, k=2, iterator=iterator, n_power_iter=1, seed=123
        )
        np.testing.assert_allclose(
            np.abs(np.asarray(v.compute())), np.abs(np.asarray(vv.compute())), atol=1e-9
        )


# ---------------------------------------------------------------------------
# norm grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape, chunks, axis",
    [[(5,), (2,), None], [(5,), (2,), 0], [(5,), (2,), (0,)], [(5, 6), (2, 2), None]],
)
@pytest.mark.parametrize("norm", [None, 1, -1, np.inf, -np.inf])
@pytest.mark.parametrize("keepdims", [False, True])
def test_norm_any_ndim(shape, chunks, axis, norm, keepdims):
    a = rng.random(shape)
    d = da.from_array(a, chunks=chunks)
    a_r = np.linalg.norm(a, ord=norm, axis=axis, keepdims=keepdims)
    d_r = da.linalg.norm(d, ord=norm, axis=axis, keepdims=keepdims)
    assert_eq(d_r, a_r, rtol=1e-9)


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("norm", [None, 1, -1, np.inf, -np.inf])
def test_norm_any_prec(norm, keepdims, precision):
    # real dtypes only: complex norms are covered by the ops tests
    dtype = {"single": "float32", "double": "float64"}[precision]
    a = rng.random((5,)).astype(dtype)
    d = da.from_array(a, chunks=(2,))
    d_a = np.linalg.norm(a, ord=norm, axis=None, keepdims=keepdims)
    d_r = da.linalg.norm(d, ord=norm, axis=None, keepdims=keepdims)
    assert d_r.dtype == d_a.dtype


@pytest.mark.parametrize(
    "shape, chunks, axis",
    [[(3, 2, 4), (2, 2, 2), (1, 2)], [(2, 3, 4, 5), (2, 2, 2, 2), (-1, -2)]],
)
@pytest.mark.parametrize("norm", ["nuc", 2, -2])
def test_norm_implemented_errors(shape, chunks, axis, norm):
    d = da.from_array(rng.random(shape), chunks=chunks)
    with pytest.raises(NotImplementedError):
        da.linalg.norm(d, ord=norm, axis=axis)
