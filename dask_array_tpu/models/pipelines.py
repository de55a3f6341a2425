"""Flagship workload pipelines.

Reusable end-to-end compute pipelines built entirely from the lazy array
API — the workloads behind ``__graft_entry__`` and the bench harnesses
(BASELINE.md configs: slice-pushdown README example, split_every tree
reductions, blocked matmul with rechunk pressure, map_overlap stencil,
tall-skinny QR/SVD).
"""

from __future__ import annotations

import numpy as np


def readme_example(n=1000, chunk=100):
    """(x + x.T)[:chunk, :chunk] on ones — the slice-pushdown showcase."""
    import dask_array_tpu as da

    x = da.ones((n, n), chunks=(chunk, chunk))
    return (x + x.T)[:chunk, :chunk]


def normalize_contract(a, b):
    """Feature-normalize then contract: the flagship forward step."""
    centered = a - a.mean(axis=0)
    scaled = centered / (a.std(axis=0) + 1e-6)
    y = scaled @ b.T
    return (y * y).sum(axis=1)


def reduction_tree(n=10000, chunk=1000, split_every=4):
    """sum/mean/std cascade with explicit split_every (BASELINE config 2)."""
    import dask_array_tpu as da

    x = da.random.default_rng(0).standard_normal((n, n), dtype="float32", chunks=chunk)
    s = x.sum(axis=0, split_every=split_every)
    m = x.mean(axis=1, split_every=split_every)
    sd = x.std(split_every=split_every)
    return s, m, sd


def blocked_matmul(n=8192, chunk=1024, dtype="bfloat16", seed=0):
    """tensordot/matmul with misaligned operand chunks (rechunk pressure)."""
    import jax.numpy as jnp

    import dask_array_tpu as da

    dt = jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    rng = np.random.default_rng(seed)
    a_np = rng.standard_normal((n, n)).astype(dt)
    b_np = rng.standard_normal((n, n)).astype(dt)
    a = da.from_array(a_np, chunks=chunk)
    b = da.from_array(b_np, chunks=chunk // 2)  # misaligned: exercises unify
    return a @ b


def stencil2d(n=4096, chunk=1024, dtype="float32", seed=0, form="slices", persist=False):
    """depth-1 map_overlap Laplace stencil (BASELINE config 4).

    ``form="slices"``: the function takes the 1-cell ghost ring and returns
    the interior from five shifted windows (``trim=False``).
    ``form="roll"``: the function rolls the padded block and map_overlap
    trims the ring.
    """
    import jax.numpy as jnp

    import dask_array_tpu as da

    x = da.random.default_rng(seed).standard_normal((n, n), dtype=dtype, chunks=chunk)
    if persist:
        x = x.persist()

    if form == "roll":
        def laplace(b):
            return (
                jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0)
                + jnp.roll(b, 1, 1) + jnp.roll(b, -1, 1)
                - 4 * b
            )

        return da.map_overlap(laplace, x, depth=1, boundary="reflect", dtype=dtype)

    def laplace(p):
        # p arrives with a 1-cell ghost ring; the interior Laplacian is five
        # shifted windows of p, already the trimmed output shape
        return (
            p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4 * p[1:-1, 1:-1]
        )

    return da.map_overlap(
        laplace, x, depth=1, boundary="reflect", trim=False, dtype=dtype,
        chunks=x.chunks,
    )


def tall_skinny_svd(rows=1_000_000, cols=128, chunk_rows=100_000, dtype="float32", seed=0):
    """TSQR-based SVD of a tall-skinny matrix (BASELINE config 5)."""
    import dask_array_tpu as da

    x = da.random.default_rng(seed).standard_normal(
        (rows, cols), dtype=dtype, chunks=(chunk_rows, cols)
    )
    return da.linalg.svd(x)


def rechunk_relayout(n=8192, chunk=1024, dtype="float32", seed=0, persist=False):
    """Rows->cols block relayout of a transposed array (BASELINE metric 2).

    On one chip this is the memory-bandwidth-bound form of the rechunk
    boundary (one physical transpose: read + write of every byte); on a
    mesh the same expression emits an ``all-to-all``
    (``parallel/collectives.py:mesh_collective_relayout``, proven by
    ``tests/test_rechunk_collective.py``).  Report effective GB/s as
    ``2 * nbytes / t`` against the HBM roofline.
    """
    import dask_array_tpu as da

    x = da.random.default_rng(seed).standard_normal(
        (n, n), dtype=dtype, chunks=(chunk, n)
    )
    if persist:
        # hold the input on-device so steady-state measures ONLY the
        # relayout's read+write passes, not the RNG regeneration
        x = x.persist()
    # transpose makes the relayout physical (a bare rechunk is metadata-only
    # inside one XLA program — itself a design win over task-based rechunk);
    # the freeze keeps the rechunk boundary from being absorbed upstream
    return x.T.freeze_chunks().rechunk((chunk, n))
