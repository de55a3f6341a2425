"""Dtype-reinterpret views (Array.view / chunk.view).

Parity: the ``view`` routine (``/root/reference/dask_array/_chunk.py``
``view``) — on the device a view is a ``lax.bitcast_convert_type`` (no data
movement), with the trailing axis resized when the itemsizes differ.
"""

from __future__ import annotations

import functools

import numpy as np

from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr


class View(ArrayExpr):
    _parameters = ("array", "_dtype", "order")

    @functools.cached_property
    def chunks(self):
        old = self.array.dtype.itemsize
        new = np.dtype(self._dtype).itemsize
        chunks = list(self.array.chunks)
        if old == new:
            return tuple(chunks)
        last = chunks[-1]
        if old > new:
            factor = old // new
            chunks[-1] = tuple(c * factor for c in last)
        else:
            factor = new // old
            if any(c % factor for c in last):
                raise ValueError(
                    "When changing to a larger dtype, every chunk along the "
                    "last axis must be divisible by the itemsize ratio "
                    f"(ratio {factor}, chunks {last})"
                )
            chunks[-1] = tuple(c // factor for c in last)
        return tuple(chunks)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=np.dtype(self._dtype))

    def _build(self, ctx):
        import jax.numpy as jnp
        from jax import lax

        dense = ctx.build(self.array).dense()
        new_dt = np.dtype(self._dtype)
        old_dt = self.array.dtype
        if new_dt == old_dt:
            return BlockView(self.chunks, dense=dense)
        if new_dt.itemsize > old_dt.itemsize:
            # pack: group `factor` trailing elements, bitcast collapses them
            factor = new_dt.itemsize // old_dt.itemsize
            grouped = dense.reshape(dense.shape[:-1] + (-1, factor))
            out = lax.bitcast_convert_type(grouped, new_dt)
        else:
            out = lax.bitcast_convert_type(dense, new_dt)
            # itemsize shrink appends a trailing axis; fold into the last dim
            if out.ndim == dense.ndim + 1:
                out = out.reshape(dense.shape[:-1] + (-1,))
        return BlockView(self.chunks, dense=out)


def view(x, dtype=None, order="C"):
    from dask_array_tpu._collection import Array, new_collection

    if order != "C":
        raise NotImplementedError("view(order='F') is not supported (C layout only)")
    expr = x.expr if isinstance(x, Array) else x
    if dtype is None:
        dtype = expr.dtype
    dtype = np.dtype(dtype)
    if expr.ndim == 0 and dtype.itemsize != expr.dtype.itemsize:
        raise ValueError("cannot change itemsize of a 0-d array view")
    return new_collection(View(expr, dtype, order))
