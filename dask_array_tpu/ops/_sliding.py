"""Sliding/moving window reductions.

Parity: ``/root/reference/dask_array/reductions/_sliding_window.py``
(``SlidingWindowReduction`` banded plans, ``MovingWindowReduction`` with
bottleneck ``move_*`` semantics incl. ``min_count``) and the
``SlidingWindowView -> Reduction`` fusion (``_overlap.py:457-623``) — fresh
implementation.

XLA-first: the reference decomposes into banded per-block kernels
(suffix-scan + covered totals + prefix-scan).  Here the whole moving
window is ONE ``lax.reduce_window`` — XLA's native windowed
reduction the banded plan emulates — so the fusion rewrite collapses
``reduce(sliding_window_view(x))`` into a single node and no window
dimension is ever materialized.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from dask_array_tpu._chunks import validate_axis
from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr


def _reduce_window(dense, kind, window, axis, padding):
    """One lax.reduce_window along ``axis``."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    nd = dense.ndim
    dims = tuple(window if i == axis else 1 for i in range(nd))
    strides = (1,) * nd
    pads = tuple(padding if i == axis else (0, 0) for i in range(nd))

    if kind == "sum":
        return lax.reduce_window(dense, np.array(0, dense.dtype), lax.add, dims, strides, pads)
    if kind == "prod":
        return lax.reduce_window(dense, np.array(1, dense.dtype), lax.mul, dims, strides, pads)
    if kind == "max":
        init = np.array(-np.inf if jnp.issubdtype(dense.dtype, jnp.floating) else np.iinfo(dense.dtype).min, dense.dtype)
        return lax.reduce_window(dense, init, lax.max, dims, strides, pads)
    if kind == "min":
        init = np.array(np.inf if jnp.issubdtype(dense.dtype, jnp.floating) else np.iinfo(dense.dtype).max, dense.dtype)
        return lax.reduce_window(dense, init, lax.min, dims, strides, pads)
    raise NotImplementedError(kind)


class SlidingWindowReduce(ArrayExpr):
    """reduce(sliding_window_view(x, w, axis), axis=window_dim) fused.

    Output length n-w+1 along ``axis`` ("valid" windows).
    """

    _parameters = ("array", "kind", "window", "axis", "_dtype")

    def _name_prefix(self):
        return f"swr-{self.kind}"

    @functools.cached_property
    def chunks(self):
        out = [list(c) for c in self.array.chunks]
        shrink = self.window - 1
        axis = out[self.axis]
        i = len(axis) - 1
        while shrink > 0 and i >= 0:
            cut = min(shrink, axis[i])
            axis[i] -= cut
            shrink -= cut
            i -= 1
        out[self.axis] = [c for c in axis if c > 0] or [0]
        return tuple(tuple(c) for c in out)

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        if dtype is not None:
            return np.empty((0,) * self.array.ndim, dtype=np.dtype(dtype))
        probe = np.empty((1,) * self.array.ndim, dtype=self.array.dtype)
        np_fn = getattr(np, self.kind)
        out = np_fn(probe, axis=self.axis)
        keep = self.kind in ("max", "min", "nanmax", "nanmin")
        return np.empty((0,) * self.array.ndim, dtype=probe.dtype if keep else out.dtype)

    def _build(self, ctx):
        import jax.numpy as jnp

        dense = ctx.build(self.array).dense()
        w = self.window
        kind = self.kind
        if kind in ("sum", "prod"):
            # accumulate in the OUTPUT dtype (bool counts become ints, and an
            # explicit dtype= accumulates wide, numpy-style)
            x = dense if dense.dtype == self.dtype else dense.astype(self.dtype)
            out = _reduce_window(x, kind, w, self.axis, (0, 0))
        elif kind in ("max", "min"):
            x = dense.astype(np.int32) if dense.dtype == np.bool_ else dense
            out = _reduce_window(x, kind, w, self.axis, (0, 0))
        elif kind == "mean":
            s = _reduce_window(dense.astype(self.dtype), "sum", w, self.axis, (0, 0))
            out = s / w
        elif kind in ("var", "std"):
            # shifted power sums: without the shift, s2/w - mean^2 loses all
            # precision when |mean| >> std (same discipline as ops/reductions
            # var's d = x - s formulation).
            x = dense.astype(self.dtype)
            c = jnp.mean(x)
            d = x - c
            s = _reduce_window(d, "sum", w, self.axis, (0, 0))
            s2 = _reduce_window(d * d, "sum", w, self.axis, (0, 0))
            out = jnp.maximum(s2 / w - (s / w) ** 2, 0)
            if kind == "std":
                out = jnp.sqrt(out)
        elif kind in ("any", "all"):
            x = dense.astype(self.dtype)
            s = _reduce_window(x.astype(np.int32), "sum", w, self.axis, (0, 0))
            out = (s > 0) if kind == "any" else (s == w)
        elif kind in ("nansum", "nanprod", "nanmean"):
            x = dense.astype(self.dtype)
            if jnp.issubdtype(x.dtype, jnp.inexact):
                valid = ~jnp.isnan(x)  # complex: real-or-imag NaN, numpy semantics
                ident = np.array(1 if kind == "nanprod" else 0).astype(x.dtype)
                fill = jnp.where(valid, x, ident)
                out = _reduce_window(fill, "prod" if kind == "nanprod" else "sum", w, self.axis, (0, 0))
                if kind == "nanmean":
                    cnt = _reduce_window(valid.astype(np.int32), "sum", w, self.axis, (0, 0))
                    out = out / jnp.maximum(cnt, 1)
                    out = jnp.where(cnt == 0, jnp.nan, out)
            else:
                # no NaNs representable: the nan-kind degenerates
                out = _reduce_window(x, "prod" if kind == "nanprod" else "sum", w, self.axis, (0, 0))
                if kind == "nanmean":
                    out = out / w
        elif kind in ("nanmin", "nanmax"):
            x = dense
            if jnp.issubdtype(x.dtype, jnp.floating):
                valid = ~jnp.isnan(x)
                ident = np.array(np.inf if kind == "nanmin" else -np.inf, x.dtype)
                fill = jnp.where(valid, x, ident)
                out = _reduce_window(fill, kind[3:], w, self.axis, (0, 0))
                cnt = _reduce_window(valid.astype(np.int32), "sum", w, self.axis, (0, 0))
                out = jnp.where(cnt == 0, jnp.nan, out)
            else:
                out = _reduce_window(x, kind[3:], w, self.axis, (0, 0))
        else:
            raise NotImplementedError(kind)
        if out.dtype != self.dtype:
            out = out.astype(self.dtype)
        return BlockView(self.chunks, dense=out)


# reduction kinds the fusion understands
FUSABLE_WINDOW_REDUCERS = {
    "sum", "prod", "max", "min", "mean", "var", "std", "any", "all",
    "nansum", "nanprod", "nanmin", "nanmax", "nanmean",
}


class MovingWindowReduction(ArrayExpr):
    """bottleneck move_* semantics: trailing windows, NaN below min_count.

    Parity: ``MovingWindowReduction`` (``_sliding_window.py:249``).
    """

    _parameters = ("array", "kind", "window", "min_count", "axis")

    def _name_prefix(self):
        return f"move-{self.kind}"

    @property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        from dask_array_tpu._chunks import is_float_dtype

        dt = self.array.dtype
        if not is_float_dtype(dt):
            dt = np.dtype("f8")
        return np.empty((0,) * self.array.ndim, dtype=dt)

    def _build(self, ctx):
        import jax.numpy as jnp

        dense = ctx.build(self.array).dense().astype(self.dtype)
        w = self.window
        axis = self.axis
        mc = self.min_count if self.min_count is not None else w
        pad = (w - 1, 0)  # trailing windows

        valid = ~jnp.isnan(dense)
        count = _reduce_window(valid.astype(np.dtype("int32")), "sum", w, axis, pad)
        filled0 = jnp.where(valid, dense, 0)

        kind = self.kind
        if kind in ("sum", "mean"):
            s = _reduce_window(filled0, "sum", w, axis, pad)
            out = s if kind == "sum" else s / jnp.maximum(count, 1)
        elif kind in ("max", "min"):
            ident = np.array(-np.inf if kind == "max" else np.inf, dense.dtype)
            fillv = jnp.where(valid, dense, ident)
            out = _reduce_window(fillv, kind, w, axis, pad)
        elif kind in ("var", "std"):
            # shifted power sums (see SlidingWindowReduce): the global
            # nanmean as shift kills the |mean| >> std cancellation; it is
            # NaN only when every element is NaN, and then count < min_count
            # masks the output anyway.
            c = jnp.where(jnp.any(valid), jnp.nanmean(dense), 0.0).astype(dense.dtype)
            d = jnp.where(valid, dense - c, 0)
            s = _reduce_window(d, "sum", w, axis, pad)
            s2 = _reduce_window(d * d, "sum", w, axis, pad)
            n = jnp.maximum(count, 1)
            out = jnp.maximum(s2 / n - (s / n) ** 2, 0)
            if kind == "std":
                out = jnp.sqrt(out)
        else:
            raise NotImplementedError(kind)
        out = jnp.where(count >= mc, out, jnp.nan)
        return BlockView(self.chunks, dense=out)


def _move(a, kind, window, min_count=None, axis=-1):
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._from_array import asarray

    a = asarray(a)
    axis = validate_axis(axis, a.ndim)
    if window < 1:
        raise ValueError("window must be >= 1")
    n = a.shape[axis]
    if not (isinstance(n, float) and math.isnan(n)) and window > n:
        raise ValueError(f"window {window} exceeds axis length {n}")
    return new_collection(
        MovingWindowReduction(a.expr, kind, int(window), int(min_count) if min_count else None, axis)
    )


def move_sum(a, window, min_count=None, axis=-1):
    return _move(a, "sum", window, min_count, axis)


def move_mean(a, window, min_count=None, axis=-1):
    return _move(a, "mean", window, min_count, axis)


def move_max(a, window, min_count=None, axis=-1):
    return _move(a, "max", window, min_count, axis)


def move_min(a, window, min_count=None, axis=-1):
    return _move(a, "min", window, min_count, axis)


def move_var(a, window, min_count=None, axis=-1):
    return _move(a, "var", window, min_count, axis)


def move_std(a, window, min_count=None, axis=-1):
    return _move(a, "std", window, min_count, axis)
