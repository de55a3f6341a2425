"""Blocked LU and 2-D-chunked QR (VERDICT round-1 item 6).

Done-criterion: lu/qr on 2-D-chunked grids match scipy/numpy semantics on
the CPU mesh WITHOUT a whole-matrix gather (the factor FLOPs stay blocked).
Parity: reference ``linalg/_lu.py:265``, ``linalg/_qr.py:38-360``.
"""

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu._test_utils import assert_eq


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def _assert_lu(p, l, u, x, atol=1e-9):
    p, l, u = np.asarray(p.compute()), np.asarray(l.compute()), np.asarray(u.compute())
    # reconstruction
    np.testing.assert_allclose(p @ l @ u, x, atol=atol)
    # triangularity + unit diagonal of L
    np.testing.assert_allclose(np.triu(l, 1), 0, atol=atol)
    np.testing.assert_allclose(np.diag(l), 1.0, atol=atol)
    np.testing.assert_allclose(np.tril(u, -1), 0, atol=atol)
    # P is a permutation matrix
    np.testing.assert_allclose(p @ p.T, np.eye(len(p)), atol=atol)
    assert set(np.unique(p)) <= {0.0, 1.0}


def test_blocked_lu_reconstruction(rng):
    x = rng.standard_normal((64, 64))
    d = da.from_array(x, chunks=16)
    p, l, u = da.linalg.lu(d)
    from dask_array_tpu.ops.linalg_decomp import BlockedLU

    assert isinstance(p.expr, BlockedLU)  # blocked path engaged
    assert p.chunks == ((16,) * 4, (16,) * 4)
    _assert_lu(p, l, u, x)


def test_blocked_lu_uneven_blocks(rng):
    x = rng.standard_normal((50, 50))
    d = da.from_array(x, chunks=((20, 20, 10), (20, 20, 10)))
    p, l, u = da.linalg.lu(d)
    _assert_lu(p, l, u, x)


def test_lu_single_block_fallback(rng):
    x = rng.standard_normal((24, 24))
    d = da.from_array(x, chunks=24)
    p, l, u = da.linalg.lu(d)
    _assert_lu(p, l, u, x)


def test_lu_misaligned_grid_rechunks(rng):
    x = rng.standard_normal((40, 40))
    d = da.from_array(x, chunks=(20, 10))
    p, l, u = da.linalg.lu(d)
    _assert_lu(p, l, u, x)


def test_lu_non_square_raises(rng):
    d = da.from_array(rng.standard_normal((8, 4)), chunks=4)
    with pytest.raises(ValueError, match="square"):
        da.linalg.lu(d)


def test_blocked_lu_solve_pipeline(rng):
    # use the factors downstream: solve P L U x = b
    x = rng.standard_normal((32, 32)) + 8 * np.eye(32)
    b = rng.standard_normal((32,))
    d = da.from_array(x, chunks=8)
    p, l, u = da.linalg.lu(d)
    y = da.linalg.solve_triangular(l, (p.T @ da.from_array(b, chunks=32)).rechunk(32), lower=True)
    sol = da.linalg.solve_triangular(u, y, lower=False)
    np.testing.assert_allclose(np.asarray(sol.compute()), np.linalg.solve(x, b), atol=1e-8)


def test_blocked_lu_on_mesh(rng):
    import jax
    from jax.sharding import Mesh

    from dask_array_tpu.parallel import use_mesh

    devs = np.asarray(jax.devices("cpu")[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("x", "y"))
    x = rng.standard_normal((64, 64))
    d = da.from_array(x, chunks=16)
    p, l, u = da.linalg.lu(d)
    with use_mesh(mesh):
        _assert_lu(p, l, u, x)


# -- 2-D-chunked QR -----------------------------------------------------------


def _assert_qr(q, r, x, atol=1e-8):
    q, r = np.asarray(q.compute()), np.asarray(r.compute())
    m, n = x.shape
    assert q.shape == (m, n)
    assert r.shape == (n, n)
    np.testing.assert_allclose(q @ r, x, atol=atol)
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=atol)
    np.testing.assert_allclose(np.tril(r, -1), 0, atol=atol)


def test_blocked_qr_square_grid(rng):
    x = rng.standard_normal((64, 64))
    d = da.from_array(x, chunks=16)
    q, r = da.linalg.qr(d)
    from dask_array_tpu.ops.linalg_decomp import BlockedQR

    assert isinstance(q.expr, BlockedQR)
    assert q.chunks == ((16,) * 4, (16,) * 4)
    _assert_qr(q, r, x)


def test_blocked_qr_tall_2d_grid(rng):
    x = rng.standard_normal((96, 32))
    d = da.from_array(x, chunks=(24, 16))
    q, r = da.linalg.qr(d)
    _assert_qr(q, r, x)


def test_blocked_qr_uneven_panels(rng):
    x = rng.standard_normal((60, 45))
    d = da.from_array(x, chunks=((30, 30), (20, 20, 5)))
    q, r = da.linalg.qr(d)
    _assert_qr(q, r, x)


def test_qr_short_fat_2d_raises(rng):
    d = da.from_array(rng.standard_normal((8, 32)), chunks=(4, 8))
    with pytest.raises(NotImplementedError, match="SHORT-FAT"):
        da.linalg.qr(d)


def test_blocked_qr_on_mesh_no_full_gather(rng):
    """The HLO of a blocked QR on a row-sharded mesh must not all-gather
    the FULL matrix (panels yes, matrix no)."""
    import jax
    from jax.sharding import Mesh

    from dask_array_tpu._diagnostics import compiled_hlo
    from dask_array_tpu.parallel import use_mesh

    devs = np.asarray(jax.devices("cpu")[:8])
    mesh = Mesh(devs, ("r",))
    x = rng.standard_normal((256, 64))
    d = da.from_array(x, chunks=(32, 16))
    q, r = da.linalg.qr(d)
    with use_mesh(mesh):
        _assert_qr(q, r, x)
        hlo = compiled_hlo(q)
    # no all-gather of the full 256x64 input: only n x b panel-sized
    # intermediates may be gathered
    for line in hlo.splitlines():
        if "all-gather" in line and "f64[256," in line.replace(" ", ""):
            raise AssertionError(f"full-matrix all-gather in blocked QR: {line}")


# -- blocked triangular solve / solve -----------------------------------------


def test_blocked_tri_solve_lower(rng):
    from dask_array_tpu.ops.linalg_decomp import BlockedTriSolve

    L = np.tril(rng.standard_normal((32, 32))) + 8 * np.eye(32)
    b = rng.standard_normal((32, 6))
    dl = da.from_array(L, chunks=8)
    db = da.from_array(b, chunks=(8, 3))
    out = da.linalg.solve_triangular(dl, db, lower=True)
    assert isinstance(out.expr, BlockedTriSolve)  # blocked path engaged
    import scipy.linalg as sl

    np.testing.assert_allclose(np.asarray(out.compute()), sl.solve_triangular(L, b, lower=True), atol=1e-8)


def test_blocked_tri_solve_upper_vector(rng):
    U = np.triu(rng.standard_normal((24, 24))) + 6 * np.eye(24)
    b = rng.standard_normal((24,))
    out = da.linalg.solve_triangular(
        da.from_array(U, chunks=6), da.from_array(b, chunks=6), lower=False
    )
    import scipy.linalg as sl

    np.testing.assert_allclose(np.asarray(out.compute()), sl.solve_triangular(U, b, lower=False), atol=1e-8)


def test_blocked_tri_solve_trans(rng):
    L = np.tril(rng.standard_normal((16, 16))) + 5 * np.eye(16)
    b = rng.standard_normal((16,))
    out = da.linalg.solve_triangular(
        da.from_array(L, chunks=4), da.from_array(b, chunks=4), lower=True, trans=1
    )
    import scipy.linalg as sl

    np.testing.assert_allclose(np.asarray(out.compute()), sl.solve_triangular(L, b, lower=True, trans=1), atol=1e-8)


def test_blocked_solve_matches_numpy(rng):
    x = rng.standard_normal((40, 40)) + 10 * np.eye(40)
    b = rng.standard_normal((40, 3))
    d = da.from_array(x, chunks=10)
    out = da.linalg.solve(d, da.from_array(b, chunks=(10, 3)))
    np.testing.assert_allclose(np.asarray(out.compute()), np.linalg.solve(x, b), atol=1e-7)


def test_blocked_solve_vector_rhs(rng):
    x = rng.standard_normal((24, 24)) + 8 * np.eye(24)
    b = rng.standard_normal((24,))
    out = da.linalg.solve(da.from_array(x, chunks=6), da.from_array(b, chunks=6))
    np.testing.assert_allclose(np.asarray(out.compute()), np.linalg.solve(x, b), atol=1e-7)


def test_blocked_solve_on_mesh(rng):
    import jax
    from jax.sharding import Mesh

    from dask_array_tpu.parallel import use_mesh

    devs = np.asarray(jax.devices("cpu")[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("x", "y"))
    x = rng.standard_normal((32, 32)) + 9 * np.eye(32)
    b = rng.standard_normal((32, 4))
    out = da.linalg.solve(da.from_array(x, chunks=8), da.from_array(b, chunks=(8, 2)))
    with use_mesh(mesh):
        np.testing.assert_allclose(np.asarray(out.compute()), np.linalg.solve(x, b), atol=1e-7)


def test_solve_pos_definite_path(rng):
    a = rng.standard_normal((12, 12))
    spd = a @ a.T + 12 * np.eye(12)
    b = rng.standard_normal((12,))
    out = da.linalg.solve(da.from_array(spd, chunks=12), da.from_array(b, chunks=12), assume_a="pos")
    np.testing.assert_allclose(np.asarray(out.compute()), np.linalg.solve(spd, b), atol=1e-8)


@pytest.mark.parametrize("iterator,n_iter", [("power", 0), ("power", 2), ("QR", 1), ("QR", 2)])
def test_svd_compressed_iterators(rng, iterator, n_iter):
    # low-rank matrix: compressed SVD recovers the spectrum
    u0 = np.linalg.qr(rng.standard_normal((120, 5)))[0]
    v0 = np.linalg.qr(rng.standard_normal((80, 5)))[0]
    s0 = np.array([20.0, 10.0, 5.0, 2.0, 1.0])
    x = (u0 * s0) @ v0.T
    d = da.from_array(x, chunks=(30, 40))
    u, s, vh = da.linalg.svd_compressed(
        d, k=5, iterator=iterator, n_power_iter=n_iter, seed=0
    )
    sv = np.asarray(s.compute())
    np.testing.assert_allclose(sv, s0, rtol=1e-3)
    recon = np.asarray(u.compute()) * sv @ np.asarray(vh.compute())
    np.testing.assert_allclose(recon, x, atol=1e-4)


def test_svd_compressed_bad_iterator(rng):
    d = da.from_array(rng.standard_normal((20, 10)), chunks=5)
    with pytest.raises(ValueError, match="power"):
        da.linalg.svd_compressed(d, k=3, iterator="bogus", n_power_iter=1)


def test_solve_triangular_conjugate_trans(rng):
    # trans='C'/2 must use the CONJUGATE transpose (review finding)
    import scipy.linalg as sl

    L = np.tril(rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8)))
    L = L + 6 * np.eye(8)
    b = rng.standard_normal((8,)) + 1j * rng.standard_normal((8,))
    out = da.linalg.solve_triangular(
        da.from_array(L, chunks=8), da.from_array(b, chunks=8), lower=True, trans="C"
    )
    np.testing.assert_allclose(
        np.asarray(out.compute()), sl.solve_triangular(L, b, lower=True, trans="C"), atol=1e-10
    )


def test_tsqr_householder_uneven_tail_block(rng):
    # review finding: q_inner sliced at fixed n strides misaligned when the
    # tail block has fewer than n rows
    from dask_array_tpu import config

    x = rng.standard_normal((1048, 64))
    d = da.from_array(x, chunks=((512, 512, 24), (64,)))
    with config.set({"tpu.qr-method": "householder"}):
        q, r = da.linalg.tsqr(d)
        qv, rv = np.asarray(q.compute()), np.asarray(r.compute())
    np.testing.assert_allclose(qv @ rv, x, atol=1e-8)
    np.testing.assert_allclose(qv.T @ qv, np.eye(64), atol=1e-8)


def test_qr_mode_not_reduced_raises(rng):
    d = da.from_array(rng.standard_normal((8, 4)), chunks=(4, 4))
    with pytest.raises(NotImplementedError, match="mode"):
        da.linalg.qr(d, mode="complete")


def test_svd_coerce_signs_deterministic(rng):
    # svd_flip: component sums of vh rows are non-negative, stable reruns
    x = rng.standard_normal((64, 8))
    d = da.from_array(x, chunks=(16, 8))
    u1, s1, vh1 = da.linalg.svd(d)
    v = np.asarray(vh1.compute())
    assert (v.sum(axis=1) >= -1e-10).all()
    u2, s2, vh2 = da.linalg.svd(da.from_array(x.copy(), chunks=(16, 8)))
    np.testing.assert_allclose(np.asarray(vh2.compute()), v, atol=1e-9)
    # reconstruction unaffected by the flip
    np.testing.assert_allclose(
        np.asarray(u1.compute()) * np.asarray(s1.compute()) @ v, x, atol=1e-8
    )


def test_svd_compressed_square_comp_level(rng):
    # review finding: comp_level == n hit svd()'s 2-D-chunked guard
    x = rng.standard_normal((512, 64))
    d = da.from_array(x, chunks=(128, 32))  # column chunks of 32
    u, s, vh = da.linalg.svd_compressed(d, k=60, n_oversamples=10, seed=0)
    sv = np.asarray(s.compute())
    ref = np.linalg.svd(x, compute_uv=False)[:60]
    np.testing.assert_allclose(sv, ref, rtol=1e-4)


def test_scan_lu_large_grid(rng):
    # nb > 16 with a uniform grid: the lax.fori_loop panel formulation
    # (O(nb) trace instead of O(nb^3)); same reconstruction contract
    x = rng.standard_normal((100, 100))
    d = da.from_array(x, chunks=5)  # nb = 20
    p, l, u = da.linalg.lu(d)
    from dask_array_tpu.ops.linalg_decomp import BlockedLU

    assert isinstance(p.expr, BlockedLU)  # did NOT fall back in-core
    _assert_lu(p, l, u, x)


def test_scan_lu_very_large_grid(rng):
    x = rng.standard_normal((256, 256))
    p, l, u = da.linalg.lu(da.from_array(x, chunks=4))  # nb = 64
    _assert_lu(p, l, u, x, atol=1e-7)


def test_lu_large_nonuniform_grid_falls_back_incore(rng):
    # nb > 16 and non-uniform: in-core (still correct)
    x = rng.standard_normal((90, 90))
    chunks = (5,) * 4 + (7,) * 10  # 14... make 18 blocks, non-uniform
    chunks = (5,) * 8 + (10,) * 5  # 18 blocks? 40+50=90, 13 blocks
    chunks = (4,) * 5 + (7,) * 10  # 20+70=90, 15 blocks -> unrolled ok
    chunks = (3,) * 10 + (6,) * 10  # 30+60=90, 20 blocks non-uniform
    d = da.from_array(x, chunks=(chunks, chunks))
    p, l, u = da.linalg.lu(d)
    _assert_lu(p, l, u, x)


def test_pivoted_lu_block_matches_contract(rng):
    # da.linalg.lu honours the scipy contract a == p @ l @ u (l unit lower,
    # u upper, p a permutation) for single- and multi-block f64 and complex
    for n, c in ((1, 1), (2, 2), (9, 9), (33, 33), (33, 11)):
        x = rng.standard_normal((n, n))
        p, l, u = (np.asarray(v) for v in da.compute(*da.linalg.lu(da.from_array(x, chunks=c))))
        np.testing.assert_allclose(p @ l @ u, x, atol=1e-11)
        assert np.allclose(np.triu(l, 1), 0) and np.allclose(np.diag(l), 1)
        assert np.allclose(np.tril(u, -1), 0)
        np.testing.assert_allclose(p @ p.T, np.eye(n), atol=1e-13)
    x = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    p, l, u = (np.asarray(v) for v in da.compute(*da.linalg.lu(da.from_array(x, chunks=3))))
    np.testing.assert_allclose(p @ l @ u, x, atol=1e-11)


@pytest.mark.parametrize("together", [True, False])
def test_tsqr_svd_u_and_vh_agree(together):
    # the fused TSQRSVD builds u, s and vh as separate expressions; on this
    # input their Gram eigenvectors came out with different signs, so
    # U S Vh missed A by O(|A|) while U and Vh were each orthonormal
    rng = np.random.default_rng(1)
    for shape in ((32, 32), (16, 32), (32, 32)):
        rng.standard_normal(shape)
    a = rng.standard_normal((256, 8)).astype(np.float32)
    u, s, vh = da.linalg.svd(da.from_array(a, chunks=(64, 8)))
    if together:
        u, s, vh = da.compute(u, s, vh)
    else:
        u, s, vh = u.compute(), s.compute(), vh.compute()
    np.testing.assert_allclose((np.asarray(u) * s) @ vh, a, atol=1e-4)


def test_tsqr_svd_fused_one_program(rng):
    # the fused TSQRSVD expression (tpu.tsqr-svd="fused", the default):
    # u/s/vh are each a single expression node whose build never forms Q
    from dask_array_tpu.ops.linalg_decomp import TSQRSVD

    x = rng.standard_normal((400, 16)).astype(np.float32)
    d = da.from_array(x, chunks=(100, 16))
    u, s, vh = da.linalg.tsqr(d, compute_svd=True)
    assert isinstance(u.expr, TSQRSVD) and u.expr.which == "u"
    assert isinstance(s.expr, TSQRSVD) and s.expr.which == "s"
    assert isinstance(vh.expr, TSQRSVD) and vh.expr.which == "vh"
    uc, sc, vhc = da.compute(u, s, vh)
    sn = np.linalg.svd(x, compute_uv=False)
    np.testing.assert_allclose(sc, sn, atol=1e-4)
    np.testing.assert_allclose((uc * sc) @ vhc, x, atol=1e-3)
    np.testing.assert_allclose(uc.T @ uc, np.eye(16), atol=1e-5)
    np.testing.assert_allclose(vhc @ vhc.T, np.eye(16), atol=1e-5)


def test_tsqr_svd_fused_vs_barrier_same_subspaces(rng):
    x = rng.standard_normal((300, 12)).astype(np.float32)
    uf, sf, vf = da.compute(*da.linalg.svd(da.from_array(x, chunks=(64, 12))))
    with da.config.set({"tpu.tsqr-svd": "barrier"}):
        ub, sb, vb = da.compute(*da.linalg.svd(da.from_array(x.copy(), chunks=(64, 12))))
    np.testing.assert_allclose(sf, sb, atol=1e-4)
    # svd_flip fixes signs on both paths, so vectors match directly
    np.testing.assert_allclose(uf, ub, atol=1e-3)
    np.testing.assert_allclose(vf, vb, atol=1e-3)


def test_tsqr_svd_fused_ill_conditioned(rng):
    # graded singular spectrum over 2 decades — U's orthogonality error
    # grows as eps * cond(R)^2 through the eigh-SVD of R (identically on
    # the fused and barrier paths; measured 7e-5 at cond 1e2, 0.03 at 1e3):
    # the shifted cascade must stay finite and orthogonal in that range
    m, n = 500, 20
    q0 = np.linalg.qr(rng.standard_normal((m, n)))[0]
    sv = np.logspace(0, -2, n)
    x = (q0 * sv) @ np.linalg.qr(rng.standard_normal((n, n)))[0]
    x = x.astype(np.float32)
    u, s, vh = da.linalg.svd(da.from_array(x, chunks=(125, 20)))
    uc, sc, vhc = da.compute(u, s, vh)
    assert np.isfinite(uc).all() and np.isfinite(sc).all()
    np.testing.assert_allclose(
        sc[:8], np.linalg.svd(x, compute_uv=False)[:8], rtol=1e-3
    )
    np.testing.assert_allclose(uc.T @ uc, np.eye(n), atol=5e-4)


def test_tsqr_svd_fused_s_only(rng):
    # computing only the singular values must not require u/vh programs
    x = rng.standard_normal((256, 8)).astype(np.float32)
    _, s, _ = da.linalg.svd(da.from_array(x, chunks=(64, 8)))
    np.testing.assert_allclose(
        s.compute(), np.linalg.svd(x, compute_uv=False), atol=1e-4
    )


def test_tsqr_svd_fused_f64(rng):
    x = rng.standard_normal((300, 10))
    u, s, vh = da.linalg.svd(da.from_array(x, chunks=(75, 10)))
    uc, sc, vhc = da.compute(u, s, vh)
    np.testing.assert_allclose(sc, np.linalg.svd(x, compute_uv=False), atol=1e-9)
    np.testing.assert_allclose((uc * sc) @ vhc, x, atol=1e-8)
