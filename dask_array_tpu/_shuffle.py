"""Shuffle: reorder elements along one axis by positional groups.

Each indexer group becomes exactly one output chunk (parity:
``/root/reference/dask_array/_shuffle.py``).  Device execution is a dense
gather (``jnp.take``), which on a mesh lowers to an all-to-all + gather — the SPMD analog of the reference's grouped-task layer.
"""

from __future__ import annotations

import functools

import numpy as np

from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr
from dask_array_tpu._chunks import validate_axis


class Shuffle(ArrayExpr):
    _parameters = ("array", "indexer", "axis")

    _sharding_boundary = True

    @functools.cached_property
    def chunks(self):
        chunks = list(self.array.chunks)
        chunks[self.axis] = tuple(len(g) for g in self.indexer)
        return tuple(chunks)

    @property
    def _meta(self):
        return self.array._meta

    @functools.cached_property
    def _flat_index(self):
        return np.concatenate([np.asarray(g, dtype=np.int64) for g in self.indexer])

    def _rebase(self, child, axis=None):
        """The same reorder applied to a different child (optionally at a
        different axis) — the hook acceptors use to push a reorder
        (Shuffle or Take share this protocol) into their operands."""
        return Shuffle(child, self.indexer, self.axis if axis is None else axis)

    def _simplify_down(self):
        # identity shuffle: groups exactly reproduce the existing chunks in order
        flat = self._flat_index
        n = self.array.shape[self.axis]
        if (
            not (isinstance(n, float) and np.isnan(n))
            and len(flat) == n
            and np.array_equal(flat, np.arange(n))
            and self.chunks == self.array.chunks
        ):
            return self.array
        return None

    def _accept_slice(self, index):
        from dask_array_tpu._slicing import Slice, is_basic_index

        # slices on non-shuffled axes commute with the shuffle
        if not is_basic_index(index):
            return None
        from numbers import Integral

        if any(isinstance(i, Integral) for i in index):
            return None
        if index[self.axis] != slice(None):
            return None
        if all(i == slice(None) for i in index):
            return None
        return Shuffle(Slice(self.array, tuple(index)), self.indexer, self.axis)

    def _build(self, ctx):
        import jax.numpy as jnp

        view = ctx.build(self.array)
        dense = jnp.take(view.dense(), jnp.asarray(self._flat_index), axis=self.axis)
        return BlockView(self.chunks, dense=dense)

    def transfer_bytes(self):
        import math

        nb = self.array.nbytes
        if isinstance(nb, float) and math.isnan(nb):
            return (0, 0)
        out_elems = sum(len(g) for g in self.indexer)
        n = self.array.shape[self.axis]
        moved = int(nb * out_elems / max(1, n))
        return (0, moved)


def shuffle(x, indexer, axis=0, chunks="auto"):
    """Reorder elements of ``x`` along ``axis`` following grouped indices.

    ``indexer`` is a list of lists of int positions; each group lands in a
    single output chunk (groups may be merged toward the average input chunk
    size, within ``array.chunk-size-tolerance``).
    """
    from dask_array_tpu import config
    from dask_array_tpu._collection import Array, new_collection

    expr = x.expr if isinstance(x, Array) else x
    axis = validate_axis(axis, expr.ndim)
    if not isinstance(indexer, (list, tuple)) or not all(
        isinstance(g, (list, tuple, np.ndarray)) for g in indexer
    ):
        raise ValueError("indexer must be a list of lists of ints")
    indexer = [tuple(int(i) for i in g) for g in indexer]
    n = expr.shape[axis]
    for g in indexer:
        for i in g:
            if i < 0 or i >= n:
                raise IndexError(f"indexer position {i} out of bounds for axis of size {n}")

    # merge small neighboring groups toward the mean input chunk size
    tol = config.get("array.chunk-size-tolerance", 1.25)
    mean = np.mean(expr.chunks[axis]) if len(expr.chunks[axis]) else 1
    limit = int(mean * tol)
    merged: list[tuple] = []
    for g in indexer:
        if merged and len(merged[-1]) + len(g) <= limit:
            merged[-1] = merged[-1] + g
        else:
            merged.append(tuple(g))
    return new_collection(Shuffle(expr, tuple(merged), axis))
