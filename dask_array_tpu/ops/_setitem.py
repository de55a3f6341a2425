"""__setitem__: out-of-place assignment expressions.

Parity: ``SetItem`` (``/root/reference/dask_array/slicing/_setitem.py``).
``Array.__setitem__`` swaps the collection's expression for this node (the
underlying data is never mutated — functional update, which on the device lowers
to an XLA dynamic-update-slice / scatter that the compiler performs
in-place when the buffer is donated).
"""

from __future__ import annotations

import functools

import numpy as np

from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr
from dask_array_tpu._slicing import normalize_index


class SetItem(ArrayExpr):
    _parameters = ("array", "index", "value")

    @property
    def chunks(self):
        return self.array.chunks

    @property
    def _meta(self):
        return self.array._meta

    @functools.cached_property
    def _bool_mask_pos(self):
        for pos, i in enumerate(self.index):
            dt = getattr(i, "dtype", None)
            if dt is not None and np.dtype(dt) == bool:
                return pos
        return None

    @functools.cached_property
    def _traceable(self):
        # boolean-mask assignment with a data-dependent-length value array
        # cannot be staged (the mask selection count is dynamic)
        pos = self._bool_mask_pos
        if pos is None:
            return True
        val_nd = getattr(self.value, "ndim", 0)
        return val_nd == 0

    def _build(self, ctx):
        import jax.numpy as jnp

        view = ctx.build(self.array)
        dense = view.dense()
        if isinstance(self.value, ArrayExpr):
            val = ctx.build(self.value).dense()
        else:
            val = self.value
        pos = self._bool_mask_pos
        if pos is not None and getattr(val, "ndim", 0) == 0:
            # scalar fill under a boolean mask: a select, traceable
            mask = self.index[pos]
            mask = ctx.build(mask).dense() if isinstance(mask, ArrayExpr) else np.asarray(mask)
            if mask.ndim < dense.ndim:
                shape = mask.shape + (1,) * (dense.ndim - mask.ndim)
                mask = mask.reshape(shape)
            out = jnp.where(mask, jnp.asarray(val, dtype=dense.dtype), dense)
        else:
            idx = tuple(
                (np.asarray(i) if not isinstance(i, ArrayExpr) else ctx.build(i).dense())
                if not isinstance(i, slice)
                else i
                for i in self.index
            )
            out = dense.at[idx].set(val)
        if out.dtype != dense.dtype:
            out = out.astype(dense.dtype)
        return BlockView(self.chunks, dense=out)


def setitem(x, index, value):
    from dask_array_tpu._collection import Array, new_collection

    index = normalize_index(index, x.shape)
    if any(i is None for i in index):
        raise IndexError("newaxis is not allowed in assignment indices")
    if isinstance(value, Array):
        value = value.expr
    elif isinstance(value, (list, tuple)):
        value = np.asarray(value)
    if isinstance(value, np.ndarray) and value.ndim == 0:
        value = value[()]
    # frozen arrays in the index tokenize by content/identity
    index = tuple(np.asarray(i) if isinstance(i, (list, np.ndarray)) else i for i in index)

    # errors raise AT ASSIGNMENT, not at compute (reference:
    # tests/test_slicing.py::test_setitem_errors_raise_at_assignment_time):
    # for a fully basic index over known dims, the selected region's shape
    # is static — validate the value broadcasts into it now
    import math

    region = []
    basic = True
    for i, dim in zip(index, x.shape):
        if isinstance(dim, float) and math.isnan(dim):
            basic = False
            break
        if isinstance(i, slice):
            region.append(len(range(*i.indices(int(dim)))))
        elif isinstance(i, (int, np.integer)):
            continue  # int index drops the axis
        else:
            basic = False  # fancy/bool index: dynamic selection
            break
    vshape = tuple(getattr(value, "shape", ()) or ())
    if basic and vshape and not any(isinstance(s, float) and math.isnan(s) for s in vshape):
        rshape = tuple(region)
        for ax in range(1, len(vshape) + 1):
            v = vshape[-ax]
            r = rshape[-ax] if ax <= len(rshape) else 1
            if v != 1 and (ax > len(rshape) or (v != r)):
                raise ValueError(
                    f"shape mismatch: value array of shape {vshape} could not "
                    f"be broadcast to indexing result of shape {rshape}"
                )
    return new_collection(SetItem(x.expr, index, value))
