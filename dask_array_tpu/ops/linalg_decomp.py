"""Matrix decompositions: qr/tsqr/sfqr, svd, svd_compressed, lu, cholesky,
solve/solve_triangular/inv/lstsq, norm.

Parity: ``/root/reference/dask_array/linalg/`` (``_qr.py``, ``_svd.py``,
``_lu.py``, ``_cholesky.py``, ``_solve.py``, ``_norm.py``) — fresh
implementation.

XLA-first: the reference decomposes into ~15 bespoke per-block task
expressions because its workers hold one block each.  Here the blocked
*algorithm* (TSQR: per-row-block QR -> QR of stacked R factors -> Q
update) is still used for tall-skinny inputs — it is exactly the right
algorithm when rows are sharded over a mesh (per-shard QR + small
all-gathered inner QR) — but each step is jnp.linalg inside the single
traced program, so XLA schedules the panel work directly.
"""

from __future__ import annotations

import functools

import numpy as np

from dask_array_tpu._executor import BlockView, iter_block_indices
from dask_array_tpu._expr import ArrayExpr


def _jnp():
    import jax.numpy as jnp

    return jnp


def _float_dtype(dt):
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.complexfloating):
        return dt
    if dt == np.float32:
        return dt
    if dt.kind not in "fc":
        from dask_array_tpu._chunks import is_float_dtype

        if is_float_dtype(dt):
            # ml_dtypes floats (bfloat16/float8): factorizations need more
            # precision; f32 is enough and runs at the fast rate
            return np.dtype("f4")
    return np.dtype("f8")


class TSQR(ArrayExpr):
    """Tall-skinny QR (parity: ``tsqr``, ``_qr.py:362``).

    Two methods (config ``tpu.qr-method``):

    * ``cholqr2`` (default): CholeskyQR2 — R from the Cholesky factor of
      the Gram matrix A^T A, Q = A R^-1, repeated once for Householder-level
      orthogonality.  All the FLOPs are matmuls, the Gram matrix
      is a psum over row shards on a mesh (the communication-optimal
      tall-skinny factorization).  Requires
      cond(A)^2 < 1/eps for the first pass (fine for the float32/float64
      tall-skinny regimes this targets).
    * ``householder``: per-row-block jnp.linalg.qr + QR of the stacked R
      factors (the reference's block algorithm, bitwise-stable for
      ill-conditioned inputs).
    """

    _parameters = ("array", "which")  # which: "q" | "r"

    @functools.cached_property
    def chunks(self):
        from dask_array_tpu._chunks import has_unknown_chunks

        m_chunks, n_chunks = self.array.chunks
        n = sum(n_chunks)
        if self.which == "q":
            if has_unknown_chunks((m_chunks,)):
                # unknown row splits: q is one (unknown-height) row block so
                # downstream per-block consumers can slice it (BlockView)
                m_chunks = (float("nan"),)
            return (m_chunks, (n,))
        return ((n,), (n,))

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=_float_dtype(self.array.dtype))

    @staticmethod
    def _cholqr_once(a, dt, shift=16.0):
        """One CholeskyQR pass.  Plain CholeskyQR NaNs whenever cond(A)^2
        exceeds 1/eps (Gram matrix numerically indefinite — exactly the
        svd_compressed compression-panel case); two robustifications:

        * ``shifted`` (default, config ``tpu.qr-gram``): shifted Cholesky
          (Fukaya et al. 2020) — ``chol(G + shift * eps * ||G||_F I)``;
          guaranteed positive-definite, all native-precision matmuls + one
          tiny chol.  The QR3 schedule passes ``shift=(16, 1, 0)``: the
          heavy first shift regularizes arbitrarily ill-conditioned (even
          rank-deficient) panels, and the UNSHIFTED final pass removes the
          shift's orthogonality bias (measured: ortho error 2.4e-7 on a
          cond^2 >> 1/eps_f32 panel, equal to the eigh clamp).
        * ``eigh-clamp``: clamp G's spectrum at ``eps * lambda_max`` via a
          float64 eigendecomposition.  Bitwise-closest to the exact
          factor, but it adds an f64 eigendecomposition to every pass
          where shifted runs matmuls only.
        """
        q, r, _w = TSQR._cholqr_pass(a, dt, shift)
        return q, r

    @staticmethod
    def _cholqr_pass(a, dt, shift=16.0):
        """One CholeskyQR pass, also returning the applied inverse factor
        ``w = R^-1`` (so ``q = a @ w``).  Exposing ``w`` lets the fused
        TSQR-SVD path skip forming the final Q explicitly."""
        import jax.numpy as jnp
        import jax.scipy.linalg as jsl

        from dask_array_tpu import config

        g = jnp.matmul(
            a.conj().T, a,
            precision=config.get("tpu.gram-precision", "highest"),
        )
        g = (g + g.conj().T) / 2
        n = a.shape[1]
        if config.get("tpu.qr-gram", "shifted") == "eigh-clamp":
            gd = g.astype(jnp.float64)
            w, v = jnp.linalg.eigh(gd)
            floor = float(jnp.finfo(dt).eps) * jnp.maximum(w[-1], 1e-300)
            w = jnp.maximum(w, floor)
            gd_psd = (v * w[None, :]) @ v.T
            l = jnp.linalg.cholesky(gd_psd).astype(dt)
        elif shift:
            # ||G||_F >= ||G||_2 bounds the shift from above
            eps = float(jnp.finfo(jnp.real(jnp.zeros((), dt)).dtype).eps)
            normf = jnp.sqrt(jnp.sum(jnp.real(g * jnp.conj(g))))
            s = shift * eps * normf + float(np.finfo(np.float64).tiny)
            l = jnp.linalg.cholesky(g + s * jnp.eye(n, dtype=g.dtype)).astype(dt)
        else:
            l = jnp.linalg.cholesky(g).astype(dt)
        # Q = A R^-1.  A triangular solve against 10^6 RHS columns is a
        # serial substitution; invert the TINY (n x n) factor instead and
        # apply it as one big matmul.  The
        # inv's u*cond(L) rounding is within what the later QR3 passes
        # already clean up (cond(L) is bounded by the pass-1 shift).
        linv = jsl.solve_triangular(l, jnp.eye(n, dtype=l.dtype), lower=True)
        q = jnp.matmul(a, linv.conj().T, precision="highest")
        return q, l.conj().T, linv.conj().T

    def _build(self, ctx):
        import jax.numpy as jnp

        from dask_array_tpu import config

        view = ctx.build(self.array)
        dt = self.dtype
        method = config.get("tpu.qr-method", "cholqr2")

        if method == "householder":
            nb = view.numblocks[0]
            qs, rs = [], []
            for i in range(nb):
                block = view.block((i, 0)).astype(dt)
                q, r = jnp.linalg.qr(block, mode="reduced")
                qs.append(q)
                rs.append(r)
            stacked = jnp.concatenate(rs, axis=0)
            q_inner, r_final = jnp.linalg.qr(stacked, mode="reduced")
            sign = jnp.sign(jnp.diagonal(r_final))
            sign = jnp.where(sign == 0, 1.0, sign).astype(dt)
            r_final = r_final * sign[:, None]
            q_inner = q_inner * sign[None, :]
            if self.which == "r":
                return BlockView(self.chunks, dense=r_final)
            # per-block R factors have min(rows_i, n) rows: slice q_inner at
            # the CUMULATIVE offsets, not a fixed n stride (short tail blocks)
            blocks = {}
            off = 0
            for i in range(nb):
                rows_i = rs[i].shape[0]
                inner = q_inner[off:off + rows_i, :]
                off += rows_i
                blocks[(i, 0)] = qs[i] @ inner
            return BlockView(self.chunks, blocks=blocks)

        # eigenvalue-clamped CholeskyQR3 on the whole tall matrix: the
        # clamp keeps the first pass positive-definite for ill-conditioned
        # panels (cond^2 > 1/eps), the two repeats restore Householder-level
        # orthogonality
        a = view.dense().astype(dt)
        q1, r1 = self._cholqr_once(a, dt, shift=16.0)
        q2, r2 = self._cholqr_once(q1, dt, shift=1.0)
        q, r3 = self._cholqr_once(q2, dt, shift=0.0)
        r = jnp.matmul(
            r3, jnp.matmul(r2, r1, precision="highest"), precision="highest"
        )
        if self.which == "r":
            return BlockView(self.chunks, dense=r)
        return BlockView(self.chunks, dense=q)


class TSQRSVD(ArrayExpr):
    """Fused tall-skinny SVD: one traced program per output.

    The barrier formulation (``tpu.tsqr-svd="barrier"``) splits Q/R, the
    small-R SVD, and the U apply into three programs, forcing the Q panel
    through device memory at every boundary.
    This expression runs the whole pipeline in ONE program and never forms
    Q explicitly: CholeskyQR3 keeps only the per-pass inverse factors, the
    small R factors feed the eigh-SVD, and ``U = Q2 @ (W3 @ Ur)`` is a
    single tall matmul (the three outputs share one program via
    ``da.compute``; XLA CSE collapses the common subtrees).

    Parity: the reference's ``tsqr(compute_svd=True)`` path
    (``/root/reference/dask_array/linalg/_qr.py:362``, SVD branch).
    """

    _parameters = ("array", "which")  # which: "u" | "s" | "vh"

    @functools.cached_property
    def chunks(self):
        from dask_array_tpu._chunks import has_unknown_chunks

        m_chunks, n_chunks = self.array.chunks
        n = sum(n_chunks)
        if self.which == "u":
            if has_unknown_chunks((m_chunks,)):
                m_chunks = (float("nan"),)  # see TSQR.chunks
            return (m_chunks, (n,))
        if self.which == "s":
            return ((n,),)
        return ((n,), (n,))

    @functools.cached_property
    def _meta(self):
        nd = 1 if self.which == "s" else 2
        return np.empty((0,) * nd, dtype=_float_dtype(self.array.dtype))

    def _build(self, ctx):
        import jax.numpy as jnp

        view = ctx.build(self.array)
        dt = self._meta.dtype
        a = view.dense().astype(dt)
        q1, r1, _w1 = TSQR._cholqr_pass(a, dt, shift=16.0)
        q2, r2, _w2 = TSQR._cholqr_pass(q1, dt, shift=1.0)
        # the final Q (q3 = q2 @ w3) is never needed: XLA dead-code
        # eliminates it, U comes from q2 and w3 directly
        _q3, r3, w3 = TSQR._cholqr_pass(q2, dt, shift=0.0)
        r = jnp.matmul(
            r3, jnp.matmul(r2, r1, precision="highest"), precision="highest"
        )
        ur, s, vh = _svd_fn(r, full_matrices=False)
        if self.which == "s":
            return BlockView(self.chunks, dense=s)
        if self.which == "vh":
            return BlockView(self.chunks, dense=vh)
        u = jnp.matmul(
            q2, jnp.matmul(w3, ur, precision="highest"), precision="highest"
        )
        return BlockView(self.chunks, dense=u)


def _svd_fn(a, full_matrices=False):
    """SVD of a small/in-core matrix, method per config ``tpu.svd-method``.

    "eigh" (default): singular triplets from the self-adjoint eigendecomp of
    the Gram matrix.  Squares the condition number (fine downstream of
    CholeskyQR'd inputs); "jacobi" uses jnp.linalg.svd.
    """
    import jax.numpy as jnp

    from dask_array_tpu import config

    if config.get("tpu.svd-method", "eigh") != "eigh":
        return jnp.linalg.svd(a, full_matrices=full_matrices)
    m, n = a.shape
    if m < n:
        u, s, vh = _svd_fn(a.conj().T, full_matrices=full_matrices)
        return vh.conj().T, s, u.conj().T
    g = jnp.matmul(a.conj().T, a, precision="highest")  # Hermitian Gram
    w, v = jnp.linalg.eigh(g)  # ascending eigenvalues
    w = jnp.maximum(w[::-1], 0.0)
    v = v[:, ::-1]
    # an eigenvector is defined up to a unit factor; fix it (largest entry
    # real and positive) so that U and Vh agree when they are traced apart,
    # as TSQRSVD's outputs are
    big = v[jnp.argmax(jnp.abs(v), axis=0), jnp.arange(n)]
    v = v * (jnp.abs(big) / jnp.where(big == 0, 1, big)).conj()[None, :]
    s = jnp.sqrt(w)
    safe = jnp.where(s > 0, s, 1.0)
    u = jnp.matmul(a, v, precision="highest") / safe[None, :]
    return u, s, v.conj().T


class DenseLinalg(ArrayExpr):
    """One whole-matrix linalg op inside the trace (single logical block)."""

    _parameters = ("fn_name", "which", "out_chunks", "_dtype", "kwargs")
    _defaults = {"kwargs": ()}
    # operands[5:]: input exprs

    @property
    def arrays(self):
        return self.operands[5:]

    def _name_prefix(self):
        return self.fn_name.replace(".", "-")

    @property
    def chunks(self):
        return self.out_chunks

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.out_chunks), dtype=self._dtype)

    def _build(self, ctx):
        import jax
        import jax.numpy as jnp
        import jax.scipy.linalg as jsl

        denses = [ctx.build(a).dense() for a in self.arrays]
        if self.fn_name == "svd":
            fn = _svd_fn
        else:
            ns = {"jnp.linalg": jnp.linalg, "jsl": jsl, "jnp": jnp}
            mod_name, fn_name = self.fn_name.rsplit(".", 1) if "." in self.fn_name else ("jnp", self.fn_name)
            fn = getattr(ns[mod_name], fn_name)
        out = fn(*denses, **dict(self.kwargs or ()))
        if self.which is not None:
            out = out[self.which] if isinstance(self.which, int) else getattr(out, self.which)
        if out.dtype != self.dtype:
            out = out.astype(self.dtype)
        return BlockView(self.out_chunks, dense=out)


def _single(expr, fn_name, which, out_shape, dtype, kwargs=(), extra=()):
    from dask_array_tpu._collection import new_collection

    chunks = tuple((int(s),) for s in out_shape)
    return new_collection(
        DenseLinalg(fn_name, which, chunks, np.dtype(dtype), tuple(kwargs), expr, *extra)
    )


class BlockedQR(ArrayExpr):
    """QR of a 2-D-chunked matrix: block CGS2 panels + tall-skinny QR.

    Parity target: the reference's block QR machinery
    (``linalg/_qr.py:38-360``) extended to 2-D-chunked grids (its ``qr``
    raises there).  The algorithm is classical block Gram-Schmidt with
    reorthogonalization (CGS2): for each column panel, project out all
    previous Q panels (two passes — tall matmuls, row-sharded with
    psums on a mesh), then factor the panel with the CholeskyQR cascade.
    No whole-matrix gather: every step is a column-panel matmul.
    """

    _parameters = ("array", "which")  # which: "q" | "r"

    @functools.cached_property
    def chunks(self):
        m_chunks, n_chunks = self.array.chunks
        if self.which == "q":
            return (m_chunks, n_chunks)
        return (n_chunks, n_chunks)

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=_float_dtype(self.array.dtype))

    def _build(self, ctx):
        import jax.numpy as jnp

        view = ctx.build(self.array)
        dt = self.dtype
        a = view.dense().astype(dt)
        n_chunks = self.array.chunks[1]
        col_bounds = np.cumsum([0] + list(n_chunks))
        npanels = len(n_chunks)

        q_panels: list = []
        r_blocks: dict = {}
        for k in range(npanels):
            v = a[:, int(col_bounds[k]):int(col_bounds[k + 1])]
            # CGS2: two projection passes against all previous panels
            for pass_ in range(2):
                for m in range(k):
                    c = jnp.matmul(q_panels[m].T, v, precision="highest")
                    r_blocks[(m, k)] = r_blocks.get((m, k), 0) + c
                    v = v - jnp.matmul(q_panels[m], c, precision="highest")
            qk, r1 = TSQR._cholqr_once(v, dt, shift=16.0)
            qk, r2 = TSQR._cholqr_once(qk, dt, shift=1.0)
            qk, r3 = TSQR._cholqr_once(qk, dt, shift=0.0)
            r_blocks[(k, k)] = jnp.matmul(
                r3, jnp.matmul(r2, r1, precision="highest"), precision="highest"
            )
            q_panels.append(qk)

        if self.which == "q":
            return BlockView(self.chunks, dense=jnp.concatenate(q_panels, axis=1))
        rows = []
        for i in range(npanels):
            row = []
            for j in range(npanels):
                if j < i:
                    row.append(jnp.zeros((n_chunks[i], n_chunks[j]), dtype=dt))
                else:
                    row.append(r_blocks[(i, j)])
            rows.append(jnp.concatenate(row, axis=1))
        return BlockView(self.chunks, dense=jnp.concatenate(rows, axis=0))


def qr(a, mode="reduced"):
    """QR decomposition.

    Tall-skinny inputs use the blocked TSQR path; short-fat use sfqr;
    2-D-chunked grids use the blocked CGS2 panel algorithm (``BlockedQR``).
    """
    from dask_array_tpu._collection import Array, new_collection

    if a.ndim != 2:
        raise ValueError("qr requires a 2-D array")
    if mode != "reduced":
        raise NotImplementedError(
            f"qr mode={mode!r} is not supported (only 'reduced'; parity with "
            "the reference, linalg/_qr.py:560)"
        )
    m_blocks, n_blocks = len(a.chunks[0]), len(a.chunks[1])
    dt = _float_dtype(a.dtype)
    m, n = a.shape
    k = min(m, n)
    if n_blocks == 1 and m_blocks > 1:
        return tsqr(a)
    if m_blocks == 1 and n_blocks > 1:
        return sfqr(a)
    if m_blocks == 1 and n_blocks == 1:
        q = _single(a.expr, "jnp.linalg.qr", 0, (m, k), dt, kwargs=(("mode", "reduced"),))
        r = _single(a.expr, "jnp.linalg.qr", 1, (k, n), dt, kwargs=(("mode", "reduced"),))
        return q, r
    if m < n:
        raise NotImplementedError(
            "qr of a 2-D-chunked SHORT-FAT array is not supported; rechunk "
            "rows to a single block (sfqr)"
        )
    return (
        new_collection(BlockedQR(a.expr, "q")),
        new_collection(BlockedQR(a.expr, "r")),
    )


def tsqr(a, compute_svd=False, _max_vchunk_size=None):
    """Direct tall-skinny QR (parity: ``tsqr``, ``_qr.py:362``)."""
    from dask_array_tpu._collection import new_collection

    if len(a.chunks[1]) != 1:
        raise ValueError(
            "tsqr requires the array to have only one column block "
            f"(got column chunks {a.chunks[1]})"
        )
    from dask_array_tpu import config

    m, n = a.shape
    if not (isinstance(m, float) and np.isnan(m)) and m < n:
        # short input (reference tsqr supports it, `_qr.py:362`): the whole
        # array is at most (n-1, n) — in-core after a row collapse.  The
        # Gram/CholeskyQR path is invalid here (rank-deficient Gram).
        if len(a.chunks[0]) != 1:
            a = a.rechunk({0: -1})
        dt = _float_dtype(a.dtype)
        k = int(m)
        q = _single(a.expr, "jnp.linalg.qr", 0, (m, k), dt, kwargs=(("mode", "reduced"),))
        r = _single(a.expr, "jnp.linalg.qr", 1, (k, n), dt, kwargs=(("mode", "reduced"),))
        if not compute_svd:
            return q, r
        # reference contract: vh is the FULL (n, n) right factor for short
        # inputs (d_vh = max(k, n)); u is (m, k) (full == reduced, m < n)
        kw = (("full_matrices", True),)
        u = _single(a.expr, "svd", 0, (m, k), dt, kwargs=kw)
        s = _single(a.expr, "svd", 1, (k,), dt, kwargs=kw)
        vh = _single(a.expr, "svd", 2, (n, n), dt, kwargs=kw)
        return u, s, vh

    q = new_collection(TSQR(a.expr, "q"))
    r = new_collection(TSQR(a.expr, "r"))
    if not compute_svd:
        return q, r
    if (
        config.get("tpu.tsqr-svd", "fused") == "fused"
        and config.get("tpu.qr-method", "cholqr2") == "cholqr2"
    ):
        # one-program fused pipeline (never forms Q)
        return (
            new_collection(TSQRSVD(a.expr, "u")),
            new_collection(TSQRSVD(a.expr, "s")),
            new_collection(TSQRSVD(a.expr, "vh")),
        )
    # barrier formulation (config ``tpu.tsqr-svd="barrier"``, and the
    # householder qr-method): SVD of the small R behind a program barrier,
    # as its own compiled program
    from dask_array_tpu._materialize import Barrier

    dt = _float_dtype(a.dtype)
    n = a.shape[1]
    r_b = Barrier(r.expr)
    ur = _single(r_b, "svd", 0, (n, n), dt, kwargs=(("full_matrices", False),))
    s = _single(r_b, "svd", 1, (n,), dt, kwargs=(("full_matrices", False),))
    vh = _single(r_b, "svd", 2, (n, n), dt, kwargs=(("full_matrices", False),))
    u = q @ ur
    return u, s, vh


def sfqr(a, name=None):
    """Short-fat QR: factor the leading square block, push through the rest
    (parity: ``sfqr``)."""
    m, n = a.shape
    if len(a.chunks[0]) != 1:
        raise ValueError("sfqr requires a single row block")
    dt = _float_dtype(a.dtype)
    q = _single(a.expr, "jnp.linalg.qr", 0, (m, min(m, n)), dt, kwargs=(("mode", "reduced"),))
    r = _single(a.expr, "jnp.linalg.qr", 1, (min(m, n), n), dt, kwargs=(("mode", "reduced"),))
    return q, r


def svd_flip(u, v, u_based_decision=False):
    """Deterministic singular-vector signs (parity: ``svd_flip``,
    ``/root/reference/dask_array/_utils.py:187``): orient each singular pair
    so the chosen side's component sums are non-negative."""
    if u_based_decision:
        signs_row = u.sum(axis=0, keepdims=True)  # (1, k)
    else:
        signs_row = v.sum(axis=1, keepdims=True).T  # (1, k)
    signs = 2.0 * ((signs_row >= 0).astype(u.dtype) - 0.5)
    return u * signs, v * signs.T


def svd(a, coerce_signs=True, full_matrices=False, compute_uv=True):
    """SVD; tall/short inputs use the TSQR reduction (parity: ``svd``,
    ``/root/reference/dask_array/linalg/_svd.py``: ``compute_uv=False``
    returns only the singular values, ``full_matrices=True`` is rejected
    unless uv is not computed)."""
    if a.ndim != 2:
        raise ValueError(
            f"Array must be 2D for svd, got {a.ndim}D (shape {a.shape})"
        )
    if not compute_uv:
        # full_matrices does not change the singular values
        _, s, _ = svd(a, coerce_signs=False)
        return s
    if full_matrices:
        raise NotImplementedError(
            "full_matrices=True is not supported; use full_matrices=False "
            "(thin SVD) or compute_uv=False"
        )
    m, n = a.shape
    m_blocks, n_blocks = len(a.chunks[0]), len(a.chunks[1])
    dt = _float_dtype(a.dtype)

    def _known(v):
        return not (isinstance(v, float) and np.isnan(v))

    if m_blocks > 1 and n_blocks > 1:
        raise NotImplementedError(
            "svd of an array chunked along both axes is not supported; rechunk "
            "so one axis has a single chunk, or use svd_compressed"
        )
    if m_blocks == 1 and n_blocks == 1:
        k = min(m, n)
        u = _single(a.expr, "svd", 0, (m, k), dt, kwargs=(("full_matrices", False),))
        s = _single(a.expr, "svd", 1, (k,), dt, kwargs=(("full_matrices", False),))
        vh = _single(a.expr, "svd", 2, (k, n), dt, kwargs=(("full_matrices", False),))
    elif m_blocks >= n_blocks:
        # numblocks dispatch (reference `_svd.py:201-222`): row-chunked goes
        # through tsqr even when the SHAPE is short; trim the full factors
        u, s, vh = tsqr(a, compute_svd=True)
        if _known(m) and _known(n) and m < n:
            k = min(m, n)
            u, vh = u[:, :k], vh[:k, :]
    else:
        u_t, s, vh_t = tsqr(a.T, compute_svd=True)
        u, vh = vh_t.T, u_t.T
        if _known(m) and _known(n) and m > n:
            k = min(m, n)
            u, vh = u[:, :k], vh[:k, :]
    if coerce_signs:
        u, vh = svd_flip(u, vh)
    return u, s, vh


def compression_level(n, q, n_oversamples=10, min_subspace_size=20):
    """Compression level for svd_compressed: ``q`` plus oversamples, floored
    at ``min_subspace_size``, capped by the space size (parity:
    ``compression_level``, ``/root/reference/dask_array/linalg/_svd.py:229``)."""
    return min(max(min_subspace_size, q + n_oversamples), n)


def compression_matrix(data, q, iterator="power", n_power_iter=0, n_oversamples=10, seed=None, compute=False):
    """Orthonormal panel spanning the most active subspace (parity:
    ``compression_matrix``, ``_svd.py:254``); returns the (comp, m) matrix
    whose transpose is the sampled range basis."""
    q_mat = _range_panel(data, q, iterator, n_power_iter, n_oversamples, seed)
    return q_mat.T


def _range_panel(a, k, iterator, n_power_iter, n_oversamples, seed):
    """The randomized range finder shared by compression_matrix and
    svd_compressed: sample, (power|QR)-iterate, orthonormalize via TSQR."""
    from dask_array_tpu.ops.random import default_rng

    m, n = a.shape
    comp_level = compression_level(min(m, n), k, n_oversamples=n_oversamples)
    rng = default_rng(seed)
    omega = rng.standard_normal(
        size=(n, comp_level), chunks=(a.chunks[1], -1)
    ).astype(_float_dtype(a.dtype))
    mat_h = a @ omega
    if iterator == "power":
        # plain power iteration, ONE orthonormalization at the end
        # (parity: compression_matrix power branch, _svd.py).  Each step is
        # rescaled by its max-abs — a scalar, so the spanned subspace is
        # untouched — because singular values grow as sigma^(2k+1) and the
        # final CholeskyQR squares them again: without the rescale a float32
        # panel overflows to inf/NaN for even mildly conditioned inputs.
        from dask_array_tpu.ops.reductions import max as _max
        from dask_array_tpu.ops.ufuncs import abs as _abs

        for _ in range(n_power_iter):
            mat_h = a @ (a.T @ mat_h)
            mat_h = mat_h / _max(_abs(mat_h))
        q, _ = tsqr(mat_h)
    elif iterator == "QR":
        # re-orthonormalize via TSQR every half-step (stable for large
        # n_power_iter; parity: compression_matrix QR branch)
        q, _ = tsqr(mat_h)
        for _ in range(n_power_iter):
            q, _ = tsqr(a.T @ q)
            q, _ = tsqr(a @ q)
    else:
        raise ValueError(
            f"Compression matrix iterator must be 'power' or 'QR', got {iterator!r}"
        )
    return q


def svd_compressed(a, k, iterator="power", n_power_iter=0, n_oversamples=10, seed=None, compute=False, coerce_signs=True):
    """Randomized (compressed) SVD (parity: ``svd_compressed``,
    ``_svd.py:329``) — pure composition of matmul/QR collections."""
    q = _range_panel(a, k, iterator, n_power_iter, n_oversamples, seed)
    b = q.T @ a
    comp_level = q.shape[1]
    if comp_level >= b.shape[1]:
        # square-ish compressed panel: the m>=n svd path needs ONE column
        # block (b is comp x n, small either way)
        b = b.rechunk((b.shape[0], b.shape[1]))
    else:
        b = b.rechunk((b.shape[0], b.chunks[1]))
    u_inner, s, vh = svd(b, coerce_signs=False)
    u = q @ u_inner
    u, s, vh = u[:, :k], s[:k], vh[:k, :]
    if coerce_signs:
        u, vh = svd_flip(u, vh)
    return u, s, vh


def cholesky(a, lower=False):
    m, n = a.shape
    if m != n:
        raise ValueError("Dimension mismatch: cholesky requires a square array")
    dt = _float_dtype(a.dtype)
    out = _single(a.expr, "jnp.linalg.cholesky", None, (m, n), dt)
    if lower:
        return out
    from dask_array_tpu.ops.manipulation import transpose
    from dask_array_tpu.ops.ufuncs import conj

    return conj(transpose(out))


class BlockedLU(ArrayExpr):
    """Right-looking block LU with block-local pivoting.

    Parity: the reference's blocked ``lu`` (``linalg/_lu.py:265``) — the
    permutation is block-diagonal (pivoting within each diagonal block, the
    standard blocked relaxation; reconstruction ``P @ L @ U == A`` holds
    exactly).  Per step: factor the diagonal block, retroactively permute
    the L panel row, triangular-solve the row/column panels, then rank-b
    update the trailing submatrix — the update matmuls are independent and
    shard over a mesh (the FLOP bulk), unlike a whole-matrix in-core ``lu``
    which is replicated-and-serial.
    """

    _parameters = ("array", "which")  # which: "p" | "l" | "u"

    @functools.cached_property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=_float_dtype(self.array.dtype))

    def _build(self, ctx):
        import jax.numpy as jnp
        import jax.scipy.linalg as jsl

        view = ctx.build(self.array)
        dt = self.dtype
        nb = view.numblocks[0]
        chunks0 = self.array.chunks[0]
        if nb > _LU_MAX_BLOCKS and len(set(chunks0)) == 1:
            # large uniform grids: O(nb) traced loop instead of O(nb^3)
            return self._build_scan(ctx, view, dt, nb, int(chunks0[0]))
        A = {
            (i, j): view.block((i, j)).astype(dt)
            for i in range(nb)
            for j in range(nb)
        }
        P: dict = {}
        L: dict = {}
        U: dict = {}
        for k in range(nb):
            p_k, l_kk, u_kk = jsl.lu(A[(k, k)])
            P[k] = p_k
            L[(k, k)] = l_kk
            U[(k, k)] = u_kk
            # retroactively permute this block-row's already-computed L panel
            for m in range(k):
                L[(k, m)] = jnp.matmul(p_k.T, L[(k, m)], precision="highest")
            for j in range(k + 1, nb):
                U[(k, j)] = jsl.solve_triangular(
                    l_kk,
                    jnp.matmul(p_k.T, A[(k, j)], precision="highest"),
                    lower=True,
                    unit_diagonal=True,
                )
            for i in range(k + 1, nb):
                # L[i,k] = A[i,k] @ inv(u_kk)  <=>  u_kk^T X^T = A[i,k]^T
                L[(i, k)] = jsl.solve_triangular(
                    u_kk.T, A[(i, k)].T, lower=True
                ).T
            for i in range(k + 1, nb):
                for j in range(k + 1, nb):
                    A[(i, j)] = A[(i, j)] - jnp.matmul(
                        L[(i, k)], U[(k, j)], precision="highest"
                    )

        chunks0 = self.array.chunks[0]
        blocks = {}
        for i in range(nb):
            for j in range(nb):
                if self.which == "p":
                    b = P[i] if i == j else jnp.zeros((chunks0[i], chunks0[j]), dtype=dt)
                elif self.which == "l":
                    if i == j:
                        b = L[(i, j)]
                    elif j < i:
                        b = L[(i, j)]
                    else:
                        b = jnp.zeros((chunks0[i], chunks0[j]), dtype=dt)
                else:
                    if j >= i:
                        b = U[(i, j)]
                    else:
                        b = jnp.zeros((chunks0[i], chunks0[j]), dtype=dt)
                blocks[(i, j)] = b
        return BlockView(self.chunks, blocks=blocks)


    def _build_scan(self, ctx, view, dt, nb, b):
        """Panel LU as a ``lax.fori_loop`` over block columns.

        The unrolled form above traces O(nb^3) matmuls; this form traces ONE
        step and loops it, so compile time is O(1) in the grid.  The price is
        masked full-width panels (fixed shapes for XLA): each step solves and
        updates width-n strips instead of the shrinking trailing submatrix,
        ~3x the exact LU FLOPs — the matmul-friendly trade, and the panel
        matmuls still shard over a mesh.  Same block-diagonal pivoting
        contract as the unrolled form (reference ``linalg/_lu.py:265``).
        """
        import jax
        import jax.numpy as jnp
        import jax.scipy.linalg as jsl

        n = nb * b
        A0 = view.dense().astype(dt)
        P0 = jnp.zeros((nb, b, b), dtype=dt)
        rows = jnp.arange(n)

        def step(k, state):
            A, P = state
            off = k * b
            diag = jax.lax.dynamic_slice(A, (off, off), (b, b))
            p_k, l_kk, u_kk = jsl.lu(diag)

            # row strip: permute whole strip (retro-permutes the finished L
            # panels on the left, preps the U panels on the right), then
            # unit-lower solve; keep the solve only right of the diagonal
            R = jax.lax.dynamic_slice(A, (off, 0), (b, n))
            R = jnp.matmul(p_k.T, R, precision="highest")
            S = jsl.solve_triangular(l_kk, R, lower=True, unit_diagonal=True)
            right = rows[None, :] >= off + b
            row_new = jnp.where(right, S, R)
            A = jax.lax.dynamic_update_slice(A, row_new, (off, 0))

            # column strip: right-solve against u_kk; keep below the diagonal
            C = jax.lax.dynamic_slice(A, (0, off), (n, b))
            T = jsl.solve_triangular(u_kk.T, C.T, lower=True).T
            below = rows[:, None] >= off + b
            col_new = jnp.where(below, T, C)
            A = jax.lax.dynamic_update_slice(A, col_new, (0, off))

            # packed diagonal block: strict-lower holds L, upper holds U
            A = jax.lax.dynamic_update_slice(
                A, jnp.tril(l_kk, -1) + u_kk, (off, off)
            )

            # rank-b trailing update; masks confine it to the trailing block
            Lp = jnp.where(below, T, 0)
            Up = jnp.where(right, S, 0)
            A = A - jnp.matmul(Lp, Up, precision="highest")
            P = P.at[k].set(p_k)
            return A, P

        A, P = jax.lax.fori_loop(0, nb, step, (A0, P0))

        if self.which == "l":
            dense = jnp.tril(A, -1) + jnp.eye(n, dtype=dt)
        elif self.which == "u":
            dense = jnp.triu(A)
        else:
            dense = jnp.zeros((n, n), dtype=dt)
            for i in range(nb):
                dense = jax.lax.dynamic_update_slice(dense, P[i], (i * b, i * b))
        return BlockView(self.chunks, dense=dense)


# block grids past this edge would trace O(nb^3) matmuls if unrolled; uniform
# grids switch to the lax.fori_loop panel formulation (_build_scan), and
# non-uniform ones fall back to the in-core factorization (XLA's blocked LU)
_LU_MAX_BLOCKS = 16


def lu(a):
    """Blocked LU decomposition ``a = p @ l @ u`` of a square chunked array.

    Runs the right-looking blocked algorithm over the chunk grid: in-core
    ``lu`` on the diagonal panel, triangular solves on the row/column
    panels, Schur-complement updates on the trailing blocks — all inside
    one traced XLA program (panels iterate under ``lax.fori_loop`` past 16
    blocks).  Requires a square regular chunk grid.  Reference parity:
    ``linalg/_lu.py:265``.
    """
    m, n = a.shape
    if m != n:
        raise ValueError("lu requires a square array")
    dt = _float_dtype(a.dtype)
    m_chunks, n_chunks = a.chunks
    nb = len(m_chunks)
    def _blocked_ok(chunks_axis):
        # small grids unroll exactly; large ones need the fori_loop panel
        # formulation, which requires a uniform block size
        return len(chunks_axis) <= _LU_MAX_BLOCKS or len(set(chunks_axis)) == 1

    if nb > 1 and m_chunks == n_chunks and _blocked_ok(m_chunks):
        from dask_array_tpu._collection import new_collection

        return (
            new_collection(BlockedLU(a.expr, "p")),
            new_collection(BlockedLU(a.expr, "l")),
            new_collection(BlockedLU(a.expr, "u")),
        )
    if nb > 1 and m_chunks != n_chunks:
        # square blocks required on the diagonal: align to the row grid
        a = a.rechunk((m_chunks, m_chunks))
        if _blocked_ok(m_chunks):
            return lu(a)
    p = _single(a.expr, "jsl.lu", 0, (m, m), dt)
    l = _single(a.expr, "jsl.lu", 1, (m, m), dt)
    u = _single(a.expr, "jsl.lu", 2, (m, m), dt)
    return p, l, u


class BlockedTriSolve(ArrayExpr):
    """Blocked forward/backward substitution: solve ``T x = b`` per block row.

    Parity: the reference's blocked triangular solves inside ``solve``
    (``linalg/_solve.py:125,163``).  Each block-row update is a panel
    matmul (shards over a mesh); only the diagonal-block solves are
    small in-core triangular solves.
    """

    _parameters = ("tmat", "rhs", "lower", "unit_diagonal")

    @functools.cached_property
    def chunks(self):
        return self.rhs.chunks

    @functools.cached_property
    def _meta(self):
        return np.empty(
            (0,) * self.rhs.ndim,
            dtype=_float_dtype(np.promote_types(self.tmat.dtype, self.rhs.dtype)),
        )

    def _build(self, ctx):
        import jax.numpy as jnp
        import jax.scipy.linalg as jsl

        tview = ctx.build(self.tmat)
        bview = ctx.build(self.rhs)
        dt = self.dtype
        nb = tview.numblocks[0]
        vec = self.rhs.ndim == 1
        ncol = 1 if vec else bview.numblocks[1]

        out_blocks = {}
        for k in range(ncol):
            x: dict = {}
            order = range(nb) if self.lower else range(nb - 1, -1, -1)
            for i in order:
                b_i = (bview.block((i,)) if vec else bview.block((i, k))).astype(dt)
                acc = b_i
                js = range(i) if self.lower else range(i + 1, nb)
                for j in js:
                    t_ij = tview.block((i, j)).astype(dt)
                    acc = acc - jnp.matmul(t_ij, x[j], precision="highest")
                t_ii = tview.block((i, i)).astype(dt)
                rhs_i = acc[:, None] if vec else acc
                sol = jsl.solve_triangular(
                    t_ii, rhs_i, lower=self.lower, unit_diagonal=self.unit_diagonal
                )
                x[i] = sol[:, 0] if vec else sol
            for i in range(nb):
                out_blocks[(i,) if vec else (i, k)] = x[i]
        return BlockView(self.chunks, blocks=out_blocks)


def _blocked_tri_applicable(a, b):
    m_chunks, n_chunks = a.chunks
    if m_chunks != n_chunks or len(m_chunks) <= 1 or len(m_chunks) > _LU_MAX_BLOCKS:
        return False
    if b.chunks[0] != m_chunks:
        return False
    return True


def solve(a, b, sym_pos=None, assume_a="gen"):
    from dask_array_tpu._collection import new_collection

    dt = _float_dtype(np.promote_types(a.dtype, b.dtype))
    out_shape = b.shape
    if assume_a == "pos" or sym_pos:
        fn = "jsl.solve"
        kwargs = (("assume_a", "pos"),)
        return _single(a.expr, fn, None, out_shape, dt, kwargs=kwargs, extra=(b.expr,))
    m_chunks = a.chunks[0]
    if (
        a.chunks[0] == a.chunks[1]
        and 1 < len(m_chunks) <= _LU_MAX_BLOCKS
    ):
        # blocked path: P L U x = b  (panel matmuls shard over a mesh)
        p, l, u = lu(a)
        pb = p.T @ b
        pb = pb.rechunk((m_chunks,) + tuple(pb.chunks[1:]))
        y = solve_triangular(l, pb, lower=True, unit_diagonal=True)
        return solve_triangular(u, y, lower=False)
    return _single(a.expr, "jnp.linalg.solve", None, out_shape, dt, extra=(b.expr,))


def solve_triangular(a, b, lower=False, trans=0, unit_diagonal=False):
    """Solve ``a x = b`` for triangular ``a``, block-forward/back substitution.

    ``trans`` in ``(0, 'N') | (1, 'T') | (2, 'C')`` solves with ``a``,
    ``a.T`` or ``a.conj().T``.  Reference parity: ``linalg/_solve.py:125``.
    """
    from dask_array_tpu._collection import new_collection

    dt = _float_dtype(np.promote_types(a.dtype, b.dtype))
    if trans in (1, "T"):
        return solve_triangular(
            a.T, b, lower=not lower, trans=0, unit_diagonal=unit_diagonal
        )
    if trans in (2, "C"):
        from dask_array_tpu.ops.ufuncs import conj

        return solve_triangular(
            conj(a).T, b, lower=not lower, trans=0, unit_diagonal=unit_diagonal
        )
    if _blocked_tri_applicable(a, b):
        return new_collection(
            BlockedTriSolve(a.expr, b.expr, bool(lower), bool(unit_diagonal))
        )
    return _single(
        a.expr,
        "jsl.solve_triangular",
        None,
        b.shape,
        dt,
        kwargs=(("lower", bool(lower)), ("trans", 0), ("unit_diagonal", bool(unit_diagonal))),
        extra=(b.expr,),
    )


def inv(a):
    m, n = a.shape
    if m != n:
        raise ValueError("inv requires a square array")
    return _single(a.expr, "jnp.linalg.inv", None, (m, n), _float_dtype(a.dtype))


def lstsq(a, b):
    m, n = a.shape
    dt = _float_dtype(np.promote_types(a.dtype, b.dtype))
    # residuals and singular values are REAL even for complex systems
    real_dt = np.empty((0,), dtype=dt).real.dtype
    nrhs = b.shape[1] if b.ndim == 2 else None
    x_shape = (n, nrhs) if nrhs else (n,)
    kwargs = (("rcond", None),)
    x = _single(a.expr, "jnp.linalg.lstsq", 0, x_shape, dt, kwargs=kwargs, extra=(b.expr,))
    resid_shape = (nrhs,) if nrhs else (1,)
    residuals = _single(a.expr, "jnp.linalg.lstsq", 1, resid_shape, real_dt, kwargs=kwargs, extra=(b.expr,))
    rank = _single(a.expr, "jnp.linalg.lstsq", 2, (), np.dtype(np.int32), kwargs=kwargs, extra=(b.expr,))
    sv = _single(a.expr, "jnp.linalg.lstsq", 3, (min(m, n),), real_dt, kwargs=kwargs, extra=(b.expr,))
    return x, residuals, rank, sv


def norm(x, ord=None, axis=None, keepdims=False):
    """Matrix/vector norms composed from reductions (parity: ``_norm.py``)."""
    from dask_array_tpu.ops import reductions as red
    from dask_array_tpu.ops.manipulation import expand_dims
    from dask_array_tpu.ops.ufuncs import abs as _abs, sqrt

    if axis is None:
        if ord is None:
            # numpy: default norm of an unaxed array of ANY ndim is the
            # 2-norm of the raveled values
            return sqrt(red.sum(_abs(x) ** 2, keepdims=keepdims))
        axis = tuple(range(x.ndim))
    elif isinstance(axis, (int, np.integer)):
        axis = (int(axis) % x.ndim,)
    else:
        axis = tuple(int(a) % x.ndim for a in axis)

    if len(axis) == 1:
        ax = axis[0]
        if ord is None or ord == 2:
            return sqrt(red.sum(_abs(x) ** 2, axis=ax, keepdims=keepdims))
        if ord == np.inf:
            return red.max(_abs(x), axis=ax, keepdims=keepdims)
        if ord == -np.inf:
            return red.min(_abs(x), axis=ax, keepdims=keepdims)
        if ord == 0:
            return red.sum(x != 0, axis=ax, keepdims=keepdims).astype(_float_dtype(x.dtype))
        if ord == 1:
            return red.sum(_abs(x), axis=ax, keepdims=keepdims)
        return red.sum(_abs(x) ** ord, axis=ax, keepdims=keepdims) ** (1.0 / ord)

    if len(axis) == 2:
        a1, a2 = axis

        def _restore_dims(r):
            if keepdims:
                return expand_dims(r, tuple(sorted(axis)))
            return r

        if ord in (None, "fro", "f"):
            return sqrt(red.sum(_abs(x) ** 2, axis=axis, keepdims=keepdims))
        if ord in ("nuc", 2, -2):
            if x.ndim != 2:
                raise NotImplementedError(
                    f"norm ord={ord!r} of stacked matrices is not supported"
                )
            sx = x
            if len(x.chunks[0]) > 1 and len(x.chunks[1]) > 1:
                sx = x.rechunk((x.shape[0], x.shape[1]))
            _, s_, _ = svd(sx)
            if ord == "nuc":
                r = red.sum(s_)
            elif ord == 2:
                r = red.max(s_)
            else:
                r = red.min(s_)
            return _restore_dims(r)
        # ±1 / ±inf: reduce one axis with sum(|x|), then max/min the other
        if ord in (1, -1, np.inf, -np.inf):
            sum_axis = a1 if ord in (1, -1) else a2
            sums = red.sum(_abs(x), axis=sum_axis, keepdims=True)
            pick = red.max if ord in (1, np.inf) else red.min
            # sums kept its dims, so reducing both original axes is exact
            return pick(sums, axis=(min(a1, a2), max(a1, a2)), keepdims=keepdims)
        raise ValueError(f"Invalid norm order {ord!r} for matrices")
    raise ValueError("Improper number of dimensions to norm.")
