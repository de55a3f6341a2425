"""Reductions: typed dense reductions + the generic tree-reduce framework.

Parity: ``/root/reference/dask_array/reductions/`` (``reduction()``,
``Reduction``/``PartialReduce``, typed subclasses, arg-reductions,
cumulative scans, median/quantile) — fresh implementation.

XLA-first: a *typed* reduction (sum/mean/max/...) lowers to ONE dense XLA
reduce — inside a jitted program XLA already emits the optimal multi-pass
reduction (and, over a sharded axis, a psum tree), so the
reference's ``split_every`` PartialReduce cascade would only hide
information from the compiler.  ``split_every`` is still accepted (tree
shape is an execution detail here).  The generic ``reduction()`` API with
arbitrary user chunk/combine/aggregate functions keeps the explicit
per-block tree (``PartialReduce``), because user functions must see real
blocks.
"""

from __future__ import annotations

import builtins
import functools
import math
from numbers import Integral

import numpy as np

from dask_array_tpu import config
from dask_array_tpu._blockwise import Blockwise, elemwise
from dask_array_tpu._chunks import cached_cumsum, validate_axis
from dask_array_tpu._executor import BlockView, iter_block_indices


from dask_array_tpu._expr import ArrayExpr
from dask_array_tpu._slicing import is_basic_index


def handle_out(out, result):
    """numpy-style ``out=`` (lazy): defer to the collection-layer helper."""
    from dask_array_tpu._collection import handle_out as _handle_out

    return _handle_out(out, result)


def _jnp():
    import jax.numpy as jnp

    return jnp


# ---------------------------------------------------------------------------
# typed dense reductions
# ---------------------------------------------------------------------------

# name -> (jnp function name, numpy function for meta, takes dtype kw)
_DENSE_KERNELS = {
    "sum": ("sum", np.sum, True),
    "prod": ("prod", np.prod, True),
    "min": ("min", np.min, False),
    "max": ("max", np.max, False),
    "any": ("any", np.any, False),
    "all": ("all", np.all, False),
    "mean": ("mean", np.mean, True),
    "nansum": ("nansum", np.nansum, True),
    "nanprod": ("nanprod", np.nanprod, True),
    "nanmin": ("nanmin", np.nanmin, False),
    "nanmax": ("nanmax", np.nanmax, False),
    "nanmean": ("nanmean", np.nanmean, True),
    "median": ("median", np.median, False),
    "nanmedian": ("nanmedian", np.nanmedian, False),
}


class Reduction(ArrayExpr):
    """A typed whole-axis reduction, executed as one dense XLA reduce."""

    _parameters = ("array", "kind", "axes", "keepdims", "_dtype", "split_every", "extra")
    _defaults = {"split_every": None, "extra": ()}

    def _name_prefix(self):
        return self.kind

    @functools.cached_property
    def chunks(self):
        out = []
        for ax, c in enumerate(self.array.chunks):
            if ax in self.axes:
                if self.keepdims:
                    out.append((1,))
            else:
                out.append(c)
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        nd = len(self.chunks)
        if dtype is not None:
            return np.empty((0,) * nd, dtype=np.dtype(dtype))
        _, np_fn, _ = _DENSE_KERNELS[self.kind]
        if self.array.dtype.kind == "O":
            # object-dtype reductions stay object (host lane; numpy cannot
            # know the element type — reference test_object_reduction)
            return np.empty((0,) * nd, dtype=object)
        probe = np.empty((1,) * self.array.ndim, dtype=self.array.dtype)
        with np.errstate(all="ignore"):
            out = np_fn(probe, axis=self.axes, keepdims=self.keepdims)
        return np.empty((0,) * nd, dtype=out.dtype)

    def _build(self, ctx):
        jnp = _jnp()
        jnp_name, np_fn, takes_dtype = _DENSE_KERNELS[self.kind]
        x = ctx.build(self.array).dense()
        from dask_array_tpu._chunks import device_dtype, host_only_dtype
        from dask_array_tpu._executor import _is_host_only

        if _is_host_only(x) or host_only_dtype(self.dtype):
            # host lane: object/str/structured/masked blocks reduce with
            # numpy (np reducers dispatch mask-aware through np.ma —
            # reference parity: per-block numpy kernels on masked sources,
            # /root/reference/dask_array/tests/test_reductions.py:1094)
            kwargs = {"axis": self.axes, "keepdims": self.keepdims}
            if takes_dtype and not host_only_dtype(self.dtype):
                kwargs["dtype"] = self.dtype
            kwargs.update(dict(self.extra or ()))
            from dask_array_tpu._dispatch import is_duck_chunk

            masked = isinstance(x, np.ma.MaskedArray)
            duck = is_duck_chunk(x)
            with np.errstate(all="ignore"):
                dense = np_fn(x if (masked or duck) else np.asarray(x), **kwargs)
            if (masked and isinstance(dense, np.ma.MaskedArray)) or (
                duck and is_duck_chunk(dense)
            ):
                # host lane result keeps its block type (mask / duck wrapper)
                if dense.dtype != self.dtype:
                    dense = dense.astype(self.dtype)
                return BlockView(self.chunks, dense=dense)
            return BlockView(self.chunks, dense=np.asarray(dense, dtype=self.dtype))

        fn = getattr(jnp, jnp_name)
        kwargs = {"axis": self.axes, "keepdims": self.keepdims}
        out_dt = device_dtype(self.dtype)
        if takes_dtype:
            acc_dt = out_dt
            from dask_array_tpu._chunks import is_float_dtype

            if np.dtype(out_dt).itemsize < 4 and is_float_dtype(out_dt):
                # sub-f32 float accumulators STALL once the partial's ulp
                # exceeds the addend (a 64x64 bf16 sum of 256s plateaus at
                # 2^19); accumulate in f32, cast the result — XLA fuses
                # both casts into the reduce, and numpy's own sub-f32
                # accumulation is strictly less accurate, never more
                acc_dt = np.dtype("f4")
            kwargs["dtype"] = acc_dt
        extra = dict(self.extra or ())
        kwargs.update(extra)
        dense = fn(x, **kwargs)
        if dense.dtype != out_dt:
            dense = dense.astype(out_dt)
        return BlockView(self.chunks, dense=dense)

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        from dask_array_tpu._slicing import Slice

        # ints on kept axes become size-1 slices pushed inside, with an
        # outer [0] extraction (parity: _accept_slice_impl, _reduction.py:809)
        inner = []
        outer = []  # index applied AFTER the (pushed) reduction
        out_pos = 0
        any_push = False
        for ax in range(self.array.ndim):
            if ax in self.axes:
                if self.keepdims:
                    ind = index[out_pos]
                    if ind not in (slice(None), slice(0, 1, 1)):
                        return None
                    outer.append(slice(None))
                    out_pos += 1
                inner.append(slice(None))
            else:
                ind = index[out_pos]
                out_pos += 1
                dim = self.array.shape[ax]
                if isinstance(ind, Integral):
                    if not (isinstance(dim, float) and math.isnan(dim)) and dim <= 1:
                        # nothing left to shrink: keep the int outside
                        # (re-pushing would wrap a new layer every pass)
                        inner.append(slice(None))
                        outer.append(int(ind))
                    else:
                        inner.append(slice(int(ind), int(ind) + 1, 1))
                        outer.append(0)
                        any_push = True
                else:
                    from dask_array_tpu._slicing import normalize_slice

                    norm = normalize_slice(ind, dim) if not (isinstance(dim, float) and math.isnan(dim)) else ind
                    inner.append(norm)
                    outer.append(slice(None))
                    if norm != slice(None):
                        any_push = True
        if not any_push:
            return None
        pushed = type(self)(Slice(self.array, tuple(inner)), *self.operands[1:])
        if builtins.any(isinstance(o, Integral) for o in outer):
            return Slice(pushed, tuple(outer))
        return pushed


def _coerce(a):
    """Accept raw numpy/array-likes everywhere reductions do (reference
    reduction_1d_test: ``da.sum(np_array)`` works)."""
    from dask_array_tpu._collection import Array

    if isinstance(a, Array):
        return a
    from dask_array_tpu._expr import ArrayExpr

    if isinstance(a, ArrayExpr):
        return a
    from dask_array_tpu.ops._from_array import asarray

    return asarray(a)


def _reduce(x, kind, axis=None, dtype=None, keepdims=False, split_every=None, extra=()):
    from dask_array_tpu._collection import Array, new_collection

    x = _coerce(x)
    expr = x.expr if isinstance(x, Array) else x
    if axis is None:
        axes = tuple(range(expr.ndim))
    elif isinstance(axis, (tuple, list)):
        axes = tuple(sorted(validate_axis(a, expr.ndim) for a in axis))
    else:
        axes = (validate_axis(axis, expr.ndim),)
    if dtype is not None:
        dtype = np.dtype(dtype)
    if split_every is not None:
        # canonical {axis: n} form so equivalent specs share one name
        # (reference: split_every=4 == {0:2,1:2} on 2 axes, same keys)
        split_every = tuple(sorted(_normalize_split_every(split_every, axes).items()))
    return new_collection(
        Reduction(expr, kind, axes, bool(keepdims), dtype, split_every, extra)
    )


def sum(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "sum", axis, dtype, keepdims, split_every))


def prod(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "prod", axis, dtype, keepdims, split_every))


def numel(x, axis=None, keepdims=False, dtype="f8", **kwargs):
    """Count of elements along ``axis``, shaped like the reduction output
    (reference chunk kernel: ``reductions/_common.py`` numel)."""
    from dask_array_tpu._collection import Array

    if isinstance(x, Array):
        from dask_array_tpu.ops.creation import ones_like

        return sum(ones_like(x, dtype=dtype), axis=axis, keepdims=keepdims)
    return np.sum(np.ones_like(np.asarray(x)), axis=axis, keepdims=keepdims, dtype=np.dtype(dtype))


def nannumel(x, axis=None, keepdims=False, dtype="f8", **kwargs):
    """Count of non-NaN elements along ``axis`` (reference nannumel)."""
    from dask_array_tpu._collection import Array

    if isinstance(x, Array):
        from dask_array_tpu.ops.ufuncs import isnan as da_isnan

        return sum((~da_isnan(x)).astype(dtype), axis=axis, keepdims=keepdims)
    return np.sum(~np.isnan(np.asarray(x)), axis=axis, keepdims=keepdims, dtype=np.dtype(dtype))


def min(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "min", axis, None, keepdims, split_every))


def max(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "max", axis, None, keepdims, split_every))


def any(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "any", axis, None, keepdims, split_every))


def all(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "all", axis, None, keepdims, split_every))


def mean(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "mean", axis, dtype, keepdims, split_every))


def nansum(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nansum", axis, dtype, keepdims, split_every))


def nanprod(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nanprod", axis, dtype, keepdims, split_every))


def nanmin(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nanmin", axis, None, keepdims, split_every))


def nanmax(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nanmax", axis, None, keepdims, split_every))


def nanmean(a, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _reduce(a, "nanmean", axis, dtype, keepdims, split_every))


def median(a, axis=None, keepdims=False, out=None):
    return handle_out(out, _reduce(a, "median", axis, None, keepdims, None))


def nanmedian(a, axis=None, keepdims=False, out=None):
    return handle_out(out, _reduce(a, "nanmedian", axis, None, keepdims, None))


# -- variance family ----------------------------------------------------------


def _var_dtype(a, dtype):
    if dtype is not None:
        return np.dtype(dtype)
    dt = a.dtype
    if np.issubdtype(dt, np.integer) or dt == bool:
        return np.dtype(float)
    return dt


def moment(a, order, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    """Central moment of the given order (power-sums formulation)."""
    if order < 0:
        raise ValueError("Order must be non-negative")
    a = _coerce(a)
    dt = _var_dtype(a, dtype)
    if order == 0:
        from dask_array_tpu.ops.creation import ones

        axes = _axes_of(a, axis)
        if keepdims:
            shape = tuple(1 if i in axes else s for i, s in enumerate(a.shape))
        else:
            shape = tuple(s for i, s in enumerate(a.shape) if i not in axes)
        return ones(shape, dtype=dt)
    n = _count(a, axis, keepdims=True, split_every=split_every)
    mu = sum(a.astype(dt), axis=axis, keepdims=True, split_every=split_every) / n
    centered = (a.astype(dt) - mu) ** order
    m = sum(centered, axis=axis, dtype=dt, keepdims=keepdims, split_every=split_every)
    denom = _count(a, axis, keepdims=keepdims, split_every=split_every) - ddof
    return handle_out(out, m / denom)


def _axes_of(a, axis):
    if axis is None:
        return tuple(range(a.ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(validate_axis(x, a.ndim) for x in axis)
    return (validate_axis(axis, a.ndim),)


def _unmasked_ones_block(b):
    """1 where valid, 0 where masked (host kernel for masked counts)."""
    if isinstance(b, np.ma.MaskedArray):
        return (~np.ma.getmaskarray(b)).astype("f8")
    return np.ones_like(np.asarray(b), dtype="f8") if isinstance(b, np.ndarray) else _jnp().ones_like(b, dtype="f8")


def _has_masked_leaves(expr) -> bool:
    from dask_array_tpu._executor import collect_leaves

    return builtins.any(
        isinstance(b, np.ma.MaskedArray) for _, b in collect_leaves(expr)
    )


def _count(a, axis, keepdims, split_every, dtype="f8"):
    from dask_array_tpu.ops.creation import ones

    if _has_masked_leaves(a.expr):
        # np.ma semantics: masked elements are excluded from the count
        # (the reference gets this from its masked-aware numel dispatch,
        # /root/reference/dask_array/_dispatch.py) — one extra reduction,
        # only on the masked host lane
        valid = elemwise(_unmasked_ones_block, a)
        return sum(valid, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every)

    axes = _axes_of(a, axis)
    sizes = [a.shape[ax] for ax in axes]
    if builtins.all(isinstance(s, (int, np.integer)) for s in sizes):
        # static shape: the count is a compile-time constant — no runtime
        # ones-reduction (it would be one more pass for XLA to schedule)
        n = 1
        for s in sizes:
            n *= int(s)
        return np.dtype(dtype).type(n)
    o = ones(a.shape, dtype=dtype, chunks=a.chunks)
    return sum(o, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every)


def _nancount(a, axis, keepdims, split_every, dtype="f8"):
    import jax.numpy as jnp

    notnan = elemwise(jnp.logical_not, elemwise(jnp.isnan, a))
    return sum(notnan, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every)


def _var_shift(a):
    """A cheap data-derived shift for the one-pass variance formulation.

    The array's first element (one block read after slice pushdown).  Any
    value within the data's range makes the shifted power-sum cancellation
    benign (|E[x-s]| ~ std); the first element also makes var of a constant
    array EXACTLY zero.  Falls back to 0 for empty/unknown-size arrays.
    """
    shape = a.shape
    if builtins.any((not isinstance(s, (int, np.integer))) or s <= 0 for s in shape):
        return None
    return a[(0,) * a.ndim]


def _mask_nan_to(v, c):
    import jax.numpy as jnp

    return jnp.where(jnp.isnan(v), c, v)


def _nan_shift(a):
    """0-d in-range shift robust to NaNs ANYWHERE: ``nan_to_num(nanmean)``.

    ``_var_shift``'s first element may itself be NaN (then a 0 fallback
    reopens the |mean| >> std cancellation), so this pays one extra
    reduction pass for a global nanmean.  nanmean is NaN only when EVERY
    element is — and then the variance is all-NaN regardless of shift.
    It is also the better shift for sliding-view moments: the mean halves
    the worst-case |shift - window| distance on trending data, and being
    NaN-robust it never poisons NaN-free windows.  When ``a`` is a sliding
    window view the nanmean runs over the view's SOURCE — same value
    range, n instead of n*w elements, and still a 0-d operand so the
    elemwise pushdown keeps the window-fusion intact.
    """
    import jax.numpy as jnp

    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._overlap import SlidingWindowView

    expr = a.expr
    if isinstance(expr, SlidingWindowView):
        a = new_collection(expr.array)
    shape = a.shape
    if builtins.any((not isinstance(s, (int, np.integer))) or s <= 0 for s in shape):
        return None
    return elemwise(jnp.nan_to_num, nanmean(a))


def var(a, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    """Variance via ONE-PASS shifted power sums.

    ``var = (Q - |T|^2/n) / (n - ddof)`` with ``d = x - s``, ``T = sum(d)``,
    ``Q = sum(|d|^2)``.  Unlike the two-pass mean-then-centered form
    (the reference's moment_chunk/moment_agg pipeline,
    ``/root/reference/dask_array/reductions/_common.py``), T and Q are
    INDEPENDENT reductions over one fused producer, so XLA multi-output
    fusion reads the input from HBM exactly once.  The shift keeps the cancellation benign.
    """
    import jax.numpy as jnp

    a = _coerce(a)
    dt = _var_dtype(a, dtype)
    cdt = np.dtype(dt)
    complex_data = np.dtype(a.dtype).kind == "c"
    if complex_data and cdt.kind != "c":
        # numpy oddity: an explicit REAL dtype on complex input keeps the
        # DATA complex but accumulates the mean in the real dtype (dropping
        # imag), so m2 = sum|x - real_mean|^2 = Q - real(T)^2/n
        x = a
        rdt = cdt
    else:
        x = a.astype(dt)
        rdt = np.dtype(cdt.char.lower().replace("c", "f")) if cdt.kind == "c" else cdt
    from dask_array_tpu.ops._overlap import SlidingWindowView

    if _has_masked_leaves(a.expr):
        # masked host lane: the [0,...] shift element could itself be
        # masked, poisoning every d = x - s; the unshifted sums are exact
        # over the valid elements (correctness lane, not a perf lane)
        s = None
    elif isinstance(a.expr, SlidingWindowView):
        # sliding moments: the first ELEMENT of the view is a poor shift for
        # trending data (windows far from it lose relative precision); the
        # source nanmean is in-range for every window, costs one extra
        # n-element pass, and stays 0-d so the window fusion holds
        s = _nan_shift(a)
    else:
        s = _var_shift(x)
    if s is not None:
        if complex_data and cdt.kind != "c":
            s = elemwise(jnp.real, s).astype(rdt)
        elif s.dtype != cdt:
            s = s.astype(cdt)
    d = x if s is None else x - s
    n = _count(a, axis, keepdims=keepdims, split_every=split_every, dtype=rdt)
    if complex_data:
        from dask_array_tpu.ops.ufuncs import conj

        sq = (d * conj(d)).real
        if cdt.kind == "c":
            t = sum(d, axis=axis, dtype=dt, keepdims=keepdims, split_every=split_every)
            tsq = (t * conj(t)).real
        else:
            t = sum(elemwise(jnp.real, d), axis=axis, dtype=rdt, keepdims=keepdims, split_every=split_every)
            tsq = t * t
    else:
        t = sum(d, axis=axis, dtype=dt, keepdims=keepdims, split_every=split_every)
        sq = d * d
        tsq = t * t
    q = sum(sq, axis=axis, dtype=rdt, keepdims=keepdims, split_every=split_every)
    # rounding can push m2 epsilon-negative; clamp (maximum propagates NaN)
    m2 = elemwise(jnp.maximum, q - tsq / n, 0)
    res = m2 / (n - ddof)
    # numpy returns the EXPLICITLY requested dtype, even integer (truncating)
    # or complex (imag 0); the internal real accumulator dtype differs then
    if dtype is not None and res.dtype != np.dtype(dtype):
        if np.dtype(dtype).kind in "iu":
            # numpy's integer-dtype moments do exact integer arithmetic; our
            # float value can sit 1 ulp BELOW that integer (XLA rewrites /n
            # as *reciprocal), which truncation would drop a whole unit —
            # round to nearest first
            res = elemwise(_jnp().rint, res)
        res = res.astype(np.dtype(dtype))
    return handle_out(out, res)


def std(a, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    import jax.numpy as jnp

    res = elemwise(jnp.sqrt, var(a, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every))
    if dtype is not None and res.dtype != np.dtype(dtype):
        res = res.astype(np.dtype(dtype))
    return handle_out(out, res)


def nanvar(a, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    """NaN-skipping variance via the same shifted power sums as :func:`var`
    (NaN terms contribute 0 to both sums; counts exclude them).  The shift
    is a global nanmean — one extra pass, see :func:`_nan_shift` — because
    the first element may be NaN."""
    import jax.numpy as jnp

    a = _coerce(a)
    dt = _var_dtype(a, dtype)
    cdt = np.dtype(dt)
    complex_data = np.dtype(a.dtype).kind == "c"
    if complex_data and cdt.kind != "c":
        x = a
        xdt = np.dtype(a.dtype)
        rdt = cdt
    else:
        x = a.astype(dt)
        xdt = cdt
        rdt = np.dtype(cdt.char.lower().replace("c", "f")) if cdt.kind == "c" else cdt
    inexact = xdt.kind in "fc"
    s = _nan_shift(a) if inexact else None
    if s is not None:
        if complex_data and cdt.kind != "c":
            s = elemwise(jnp.real, s).astype(rdt)
        elif s.dtype != xdt:
            s = s.astype(xdt)
    # NaN data terms must not poison the shifted sums: mask each to the
    # shift (contributing exactly 0 to T and Q) before differencing
    if s is not None:
        d = elemwise(_mask_nan_to, x, s) - s
    elif inexact:
        d = elemwise(_mask_nan_to, x, 0)
    else:
        d = x  # integers carry no NaNs
    n = _nancount(a, axis, keepdims=keepdims, split_every=split_every, dtype=rdt)
    if complex_data:
        from dask_array_tpu.ops.ufuncs import conj

        sq = (d * conj(d)).real
        if cdt.kind == "c":
            t = sum(d, axis=axis, dtype=dt, keepdims=keepdims, split_every=split_every)
            tsq = (t * conj(t)).real
        else:
            t = sum(elemwise(jnp.real, d), axis=axis, dtype=rdt, keepdims=keepdims, split_every=split_every)
            tsq = t * t
    else:
        t = sum(d, axis=axis, dtype=dt, keepdims=keepdims, split_every=split_every)
        sq = d * d
        tsq = t * t
    q = sum(sq, axis=axis, dtype=rdt, keepdims=keepdims, split_every=split_every)
    m2 = elemwise(jnp.maximum, q - tsq / n, 0)
    res = m2 / (n - ddof)
    if dtype is not None and res.dtype != np.dtype(dtype):
        if np.dtype(dtype).kind in "iu":
            res = elemwise(jnp.rint, res)  # see var(): 1-ulp-below truncation
        res = res.astype(np.dtype(dtype))
    return handle_out(out, res)


def nanstd(a, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
    import jax.numpy as jnp

    res = elemwise(jnp.sqrt, nanvar(a, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every))
    if dtype is not None and res.dtype != np.dtype(dtype):
        res = res.astype(np.dtype(dtype))
    return handle_out(out, res)


# -- arg reductions --------------------------------------------------------------


class ArgReduction(ArrayExpr):
    _parameters = ("array", "kind", "axis", "keepdims")

    _DENSE = {"argmin": "argmin", "argmax": "argmax", "nanargmin": "nanargmin", "nanargmax": "nanargmax"}

    def _name_prefix(self):
        return self.kind

    @functools.cached_property
    def chunks(self):
        if self.axis is None:
            # numpy keepdims over a full reduction keeps EVERY axis at size 1
            return ((1,),) * self.array.ndim if self.keepdims else ()
        out = []
        for ax, c in enumerate(self.array.chunks):
            if ax == self.axis:
                if self.keepdims:
                    out.append((1,))
            else:
                out.append(c)
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=np.intp)

    def _build(self, ctx):
        from dask_array_tpu._dispatch import is_duck_chunk

        jnp = _jnp()
        x = ctx.build(self.array).dense()
        if isinstance(x, np.ma.MaskedArray) or is_duck_chunk(x):
            # masked/duck host lane: numpy's arg-reductions dispatch
            # mask-aware (masked elements never win) / through NEP-18
            jnp = np
        fn = getattr(jnp, self._DENSE[self.kind])
        if self.axis is None:
            dense = fn(x)
            if self.keepdims:
                dense = dense.reshape((1,) * self.array.ndim)
        else:
            dense = fn(x, axis=self.axis, keepdims=self.keepdims)
        if jnp is np and not is_duck_chunk(dense):
            dense = np.asarray(dense)  # duck results keep their wrapper
        if ctx.mode == "eager":
            # eager values are concrete: raise where numpy raises even for
            # in-graph consumers (the trace lane keeps jax's -1 sentinel —
            # a traced program cannot raise data-dependently; see
            # docs/divergences.md)
            self._host_validate(dense)
        return BlockView(self.chunks, dense=dense.astype(np.intp))

    def _host_validate(self, result):
        # jnp's arg-reductions encode "no valid element" (all-NaN slice /
        # empty axis) as -1, which numpy raises for; re-raise at the host
        # fetch so direct computes match numpy (in-graph consumers keep the
        # sentinel — a traced program cannot raise data-dependently)
        if np.any(np.asarray(result) == -1):
            if self.kind.startswith("nan"):
                raise ValueError(f"All-NaN slice encountered in {self.kind}")
            raise ValueError(f"attempt to get {self.kind} of an empty sequence")


def _argreduce(a, kind, axis=None, keepdims=False, split_every=None, out=None):
    from dask_array_tpu._collection import Array, new_collection

    expr = a.expr if isinstance(a, Array) else a
    if axis is not None:
        if not isinstance(axis, Integral):
            raise TypeError(f"axis must be an integer or None, got {axis!r}")
        axis = validate_axis(axis, expr.ndim)
    return new_collection(ArgReduction(expr, kind, axis, bool(keepdims)))


def argmin(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _argreduce(a, "argmin", axis, keepdims, split_every))


def argmax(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _argreduce(a, "argmax", axis, keepdims, split_every))


def nanargmin(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _argreduce(a, "nanargmin", axis, keepdims, split_every))


def nanargmax(a, axis=None, keepdims=False, split_every=None, out=None):
    return handle_out(out, _argreduce(a, "nanargmax", axis, keepdims, split_every))


class ArgChunk(ArrayExpr):
    """Per-block chunk step of a generic arg-reduction.

    Maps the user chunk function over blocks with each block's global offset
    info so per-block indices become global.  Parity: ``ArgChunk``
    (``/root/reference/dask_array/reductions/_arg_reduction.py:16``).

    The protocol is inherently host-side (structured arrays / dicts carrying
    ``vals``/``arg`` fields), so the whole program runs in eager mode.
    """

    _parameters = ("array", "chunk_func", "axis", "ravel")
    _traceable = False

    def _name_prefix(self):
        return "arg-chunk"

    @functools.cached_property
    def chunks(self):
        return tuple(
            (1,) * len(c) if i in self.axis else c
            for i, c in enumerate(self.array.chunks)
        )

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=np.intp)

    def _build(self, ctx):
        view = ctx.build(self.array)
        x = self.array
        starts = [cached_cumsum(bd, initial_zero=True) for bd in x.chunks]
        blocks = {}
        for idx in iter_block_indices(view.numblocks):
            off = tuple(int(starts[d][i]) for d, i in enumerate(idx))
            if self.ravel:
                offset_info = (off, x.shape)
            else:
                offset_info = off[self.axis[0]]
            b = np.asarray(view.block(idx))  # user funcs build structured arrays
            blocks[tuple(idx)] = self.chunk_func(b, self.axis, offset_info)
        return BlockView(self.chunks, blocks=blocks)


def arg_reduction(x, chunk, combine, agg, axis=None, keepdims=False, split_every=None, out=None):
    """Generic arg-reduction: offset-carrying per-block chunk step + tree.

    Parity: ``arg_reduction`` (``reductions/_arg_reduction.py:89``) — the
    chunk function receives ``(block, axis, offset_info)`` and typically
    returns a structured array with ``vals``/``arg`` fields; combine/agg
    receive the concatenated partials.
    """
    from dask_array_tpu._collection import Array, new_collection

    arr = x if isinstance(x, Array) else new_collection(x)
    if axis is None:
        axis_t = tuple(range(arr.ndim))
        ravel = True
    elif isinstance(axis, Integral):
        axis_t = (validate_axis(axis, arr.ndim),)
        ravel = arr.ndim == 1
    else:
        raise TypeError(f"axis must be either `None` or int, got '{axis}'")

    for ax in axis_t:
        c = arr.chunks[ax]
        if len(c) > 1 and builtins.any(
            isinstance(v, float) and math.isnan(v) for v in c
        ):
            raise ValueError(
                "Arg-reductions do not work with arrays that have "
                "unknown chunksizes.  A possible solution is "
                "x.compute_chunk_sizes()"
            )

    tmp = ArgChunk(arr.expr, chunk, axis_t, ravel)
    expr = _build_tree_reduce_expr(
        tmp, agg, axis_t, bool(keepdims), np.dtype(np.intp), split_every, combine,
        "arg", True,
    )
    return handle_out(out, new_collection(expr))


# -- cumulative -----------------------------------------------------------------


class CumReduction(ArrayExpr):
    """Cumulative scan along one axis (dense: one XLA associative scan).

    The reference implements both a sequential carry chain and a Blelloch
    work-efficient scan over blocks (``_cumulative.py``); inside one XLA
    program ``jnp.cumsum``/``cumprod`` already lower to an optimal parallel
    scan, so ``method`` only survives as an API knob.
    """

    _parameters = ("array", "kind", "axis", "_dtype", "method")
    _defaults = {"method": "sequential"}

    def _name_prefix(self):
        return self.kind

    @property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        if dtype is not None:
            return np.empty((0,) * self.array.ndim, dtype=np.dtype(dtype))
        np_fn = getattr(np, self.kind)
        probe = np.empty((1,) * self.array.ndim, dtype=self.array.dtype)
        out = np_fn(probe, axis=self.axis)
        return np.empty((0,) * self.array.ndim, dtype=out.dtype)

    def _build(self, ctx):
        from dask_array_tpu._dispatch import is_duck_chunk

        jnp = _jnp()
        x = ctx.build(self.array).dense()
        if isinstance(x, np.ma.MaskedArray) or is_duck_chunk(x):
            # masked/duck host lane: np.cum* dispatch to the mask-aware
            # MaskedArray methods (masked terms contribute the identity)
            # / through the duck type's __array_function__
            with np.errstate(all="ignore"):
                dense = getattr(np, self.kind)(x, axis=self.axis, dtype=self.dtype)
            return BlockView(self.chunks, dense=dense)
        fn = getattr(jnp, self.kind)
        dense = fn(x, axis=self.axis, dtype=self.dtype)
        return BlockView(self.chunks, dense=dense)


def _cum(a, kind, axis=None, dtype=None, method="sequential", out=None):
    from dask_array_tpu._collection import Array, new_collection

    expr = a.expr if isinstance(a, Array) else a
    if axis is None:
        if expr.ndim > 1:
            from dask_array_tpu.ops._reshape import ravel

            expr = ravel(new_collection(expr)).expr
        axis = 0
    axis = validate_axis(axis, expr.ndim)
    if dtype is not None:
        dtype = np.dtype(dtype)
    return new_collection(CumReduction(expr, kind, axis, dtype, method))


def cumsum(a, axis=None, dtype=None, method="sequential", out=None):
    return handle_out(out, _cum(a, "cumsum", axis, dtype, method))


def cumprod(a, axis=None, dtype=None, method="sequential", out=None):
    return handle_out(out, _cum(a, "cumprod", axis, dtype, method))


def nancumsum(a, axis=None, dtype=None, method="sequential", out=None):
    return handle_out(out, _cum(a, "nancumsum", axis, dtype, method))


def nancumprod(a, axis=None, dtype=None, method="sequential", out=None):
    return handle_out(out, _cum(a, "nancumprod", axis, dtype, method))


def cumreduction(func, binop, ident, x, axis=None, dtype=None, out=None, method="sequential", preop=None):
    """Generic cumulative reduction over blocks.

    ``method="sequential"`` uses a carry chain over blocks (carry = the last
    hyperplane of the previous scanned block); ``method="blelloch"`` uses the
    work-efficient two-phase plan — per-block totals via ``preop``, a scan of
    the totals with ``binop``, then a combine into each block's local scan.
    Parity: ``cumreduction`` (``reductions/_cumulative.py:597``) and
    ``CumReductionBlelloch`` (``:267``).
    """
    import jax.numpy as jnp

    name = getattr(func, "__name__", "")
    if func in (np.cumsum, jnp.cumsum) or name == "cumsum":
        return cumsum(x, axis=axis, dtype=dtype, method=method, out=out)
    if func in (np.cumprod, jnp.cumprod) or name == "cumprod":
        return cumprod(x, axis=axis, dtype=dtype, method=method, out=out)
    if method == "blelloch":
        if preop is None:
            raise TypeError(
                'cumreduction with "blelloch" method requires `preop=` argument'
            )
    elif method != "sequential":
        raise ValueError(
            'Invalid method for cumreduction. Expected "sequential" or '
            f'"blelloch". Got: {method!r}'
        )
    if axis is None:
        x = x.ravel() if x.ndim != 1 else x
        axis = 0
    axis = validate_axis(axis, x.ndim)
    from dask_array_tpu._collection import new_collection

    return handle_out(out, new_collection(
        _GenericCumLowered(
            x.expr, func, binop, ident, axis, np.dtype(dtype) if dtype else None,
            method, preop,
        )
    ))


class _GenericCumLowered(ArrayExpr):
    _parameters = ("array", "func", "binop", "ident", "axis", "_dtype", "method", "preop")
    _defaults = {"method": "sequential", "preop": None}

    @property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        if dtype is not None:
            return np.empty((0,) * self.array.ndim, dtype=dtype)
        probe = np.empty((1,) * self.array.ndim, dtype=self.array.dtype)
        out = self.func(probe, axis=self.axis)
        return np.empty((0,) * self.array.ndim, dtype=out.dtype)

    def _scan_one(self, b):
        scanned = self.func(b, axis=self.axis)
        if self.dtype is not None and scanned.dtype != self.dtype:
            scanned = scanned.astype(self.dtype)
        return scanned

    def _build(self, ctx):
        view = ctx.build(self.array)
        axis = self.axis
        blocks = {}
        nb = view.numblocks
        if self.method == "blelloch":
            # phase 1: per-block totals; phase 2: inclusive prefix of totals
            # feeds each block's combine (the up/down sweep is XLA's problem
            # once traced — semantically this IS the Blelloch plan)
            prefix = {}
            for idx in iter_block_indices(nb):
                b = view.block(idx)
                key_prev = idx[:axis] + (idx[axis] - 1,) + idx[axis + 1 :]
                if idx[axis] > 0:
                    t_prev = self.preop(view.block(key_prev), axis=axis, keepdims=True)
                    p = t_prev if idx[axis] == 1 else self.binop(prefix[key_prev], t_prev)
                    prefix[tuple(idx)] = p
                    blocks[tuple(idx)] = self.binop(p, self._scan_one(b))
                else:
                    blocks[tuple(idx)] = self._scan_one(b)
            return BlockView(self.chunks, blocks=blocks)
        carry = {}
        for idx in iter_block_indices(nb):
            b = view.block(idx)
            scanned = self._scan_one(b)
            key_prev = idx[:axis] + (idx[axis] - 1,) + idx[axis + 1:]
            if idx[axis] > 0:
                c = carry[key_prev]
                scanned = self.binop(c, scanned)
            # carry: last slice along axis
            last = [slice(None)] * len(nb)
            last[axis] = slice(-1, None)
            carry[idx] = scanned[tuple(last)]
            blocks[idx] = scanned
        return BlockView(self.chunks, blocks=blocks)


# -- quantiles --------------------------------------------------------------------


class Quantile(ArrayExpr):
    _parameters = ("array", "q", "axis", "method", "kind", "keepdims")

    def _name_prefix(self):
        return self.kind

    @functools.cached_property
    def _q_arr(self):
        return np.atleast_1d(np.asarray(self.q, dtype="f8"))

    @functools.cached_property
    def _scalar_q(self):
        return np.ndim(self.q) == 0

    @functools.cached_property
    def _reduced_axes(self):
        if self.axis is None:
            return tuple(range(self.array.ndim))
        if isinstance(self.axis, tuple):
            return self.axis
        return (self.axis,)

    @functools.cached_property
    def chunks(self):
        red = set(self._reduced_axes)
        base = []
        for ax, c in enumerate(self.array.chunks):
            if ax in red:
                if self.keepdims:
                    base.append((1,))
                continue
            base.append(c)
        lead = () if self._scalar_q else ((len(self._q_arr),),)
        return lead + tuple(base)

    # methods whose result is a single order statistic: numpy preserves the
    # input dtype for these (quantile([ints], method='lower') is an int)
    _DISCRETE_METHODS = frozenset(
        {"lower", "higher", "nearest", "inverted_cdf", "closest_observation"}
    )
    # Hyndman & Fan continuous families: virtual index
    # n*q + (alpha + q*(1 - alpha - beta)) - 1 (numpy _compute_virtual_index)
    _HF_ALPHA_BETA = {
        "interpolated_inverted_cdf": (0.0, 1.0),
        "hazen": (0.5, 0.5),
        "weibull": (0.0, 0.0),
        "median_unbiased": (1 / 3.0, 1 / 3.0),
        "normal_unbiased": (3 / 8.0, 3 / 8.0),
    }

    @functools.cached_property
    def _meta(self):
        if self.method in self._DISCRETE_METHODS:
            dt = self.array.dtype
        else:
            dt = np.promote_types(self.array.dtype, np.float64) if np.issubdtype(self.array.dtype, np.integer) else self.array.dtype
            if self.array.dtype == bool:
                dt = np.dtype("f8")
        return np.empty((0,) * len(self.chunks), dtype=dt)

    def _build(self, ctx):
        jnp = _jnp()
        x = ctx.build(self.array).dense()
        q = jnp.asarray(self.q)
        if self.method in ("linear", "lower", "higher", "midpoint") and not (
            np.dtype(self.dtype).kind in "iub"
        ):
            fn = jnp.nanquantile if self.kind.startswith("nan") else jnp.quantile
            dense = fn(x, q, axis=self.axis, method=self.method, keepdims=self.keepdims)
        else:
            dense = self._hf(jnp, x, q)
        return BlockView(self.chunks, dense=dense.astype(self.dtype))

    @staticmethod
    def _host_tables(method, qi, ns):
        """(lo, hi, gamma) per candidate count in ``ns``, computed with HOST
        numpy float arithmetic (numpy's exact table,
        ``numpy/lib/_function_base_impl.py _QuantileMethods``).

        Indexes must be derived off-device: numpy's tie rules compare
        ``n*q`` floats for exact equality, and XLA's excess-precision FP
        contraction (mul+sub fused to one FMA rounding) flips those
        comparisons for values like ``5*0.3``.  ``q`` is a static operand
        and ``n`` a bounded integer, so every possible (lo, hi, gamma) is
        precomputable; the traced program just gathers by the per-slice
        count.  ``gamma < 0`` encodes "no interpolation" (discrete take)."""
        ns = np.asarray(ns, dtype="f8")
        with np.errstate(all="ignore"):
            if method == "nearest":
                idx = np.around(qi * (ns - 1))
                lo = hi = idx
                gamma = np.full(ns.shape, -1.0)
            elif method == "lower":
                lo = hi = np.floor(qi * (ns - 1))
                gamma = np.full(ns.shape, -1.0)
            elif method == "higher":
                lo = hi = np.ceil(qi * (ns - 1))
                gamma = np.full(ns.shape, -1.0)
            elif method in ("inverted_cdf", "closest_observation"):
                # numpy _discret_interpolation_to_boundaries: take `next`
                # (floor+1) unless the method's gamma condition selects `prev`
                vi = ns * qi - 1 - (0.5 if method == "closest_observation" else 0.0)
                prev = np.floor(vi)
                frac = vi - prev
                if method == "inverted_cdf":
                    cond = frac == 0
                else:  # nearest-even order statistic at exact midpoints
                    cond = (frac == 0) & (prev % 2 == 1)
                lo = hi = np.where(cond, prev, prev + 1)
                gamma = np.full(ns.shape, -1.0)
            else:
                if method in ("linear", "midpoint"):
                    vi = qi * (ns - 1)
                elif method == "averaged_inverted_cdf":
                    vi = ns * qi - 1
                else:
                    alpha, beta = Quantile._HF_ALPHA_BETA[method]
                    vi = ns * qi + (alpha + qi * (1 - alpha - beta)) - 1
                prev = np.floor(vi)
                frac = vi - prev
                if method == "midpoint":
                    gamma = np.where(frac == 0, 0.0, 0.5)
                elif method == "averaged_inverted_cdf":
                    gamma = np.where(frac == 0, 0.5, 1.0)
                else:
                    gamma = frac
                lo, hi = prev, prev + 1
        n_minus_1 = np.maximum(ns - 1, 0)
        lo = np.clip(lo, 0, n_minus_1).astype("i4")
        hi = np.clip(hi, 0, n_minus_1).astype("i4")
        # all-NaN slice (n == 0): land on the last physical element (a NaN)
        empty = ns == 0
        if empty.any():
            lo = np.where(empty, -1, lo).astype("i4")
            hi = np.where(empty, -1, hi).astype("i4")
        return lo, hi, gamma.astype("f8")

    def _hf(self, jnp, x, q):
        """Hand-rolled Hyndman & Fan quantile methods — jax's builtin
        supports only linear/lower/higher/midpoint/nearest, and its 'nearest'
        resolves ties differently from numpy's half-to-even.  Multiple
        reduced axes flatten into one work axis (numpy semantics)."""
        red = self._reduced_axes
        nd = x.ndim
        if len(red) == nd:
            x2 = x.reshape(-1)
            axis = 0
        elif len(red) == 1:
            x2 = x
            axis = red[0]
        else:
            x2 = jnp.moveaxis(x, red, tuple(range(nd - len(red), nd)))
            x2 = x2.reshape(x2.shape[: nd - len(red)] + (-1,))
            axis = x2.ndim - 1
        xs = jnp.sort(x2, axis=axis)  # nans sort last
        N = x2.shape[axis]
        has_nan = None
        n = None  # traced per-slice count (nan kind only)
        if self.kind.startswith("nan") and jnp.issubdtype(x2.dtype, jnp.floating):
            n = jnp.sum(~jnp.isnan(x2), axis=axis, keepdims=True)
        elif jnp.issubdtype(x2.dtype, jnp.floating):
            # numpy's non-nan quantile propagates NaN (NaNs sort last and
            # would otherwise be indexed past); match it.
            has_nan = jnp.any(jnp.isnan(x2), axis=axis, keepdims=True)
        ns = np.arange(N + 1) if n is not None else np.array([N])
        qv = np.atleast_1d(np.asarray(self.q, dtype="f8"))
        work_shape = list(xs.shape)
        work_shape[axis] = 1
        out = []
        for i in range(qv.shape[0]):
            lo_t, hi_t, g_t = self._host_tables(self.method, float(qv[i]), ns)
            if n is None:
                lo = jnp.broadcast_to(jnp.asarray(lo_t[0]), tuple(work_shape))
                hi = jnp.broadcast_to(jnp.asarray(hi_t[0]), tuple(work_shape))
                gamma = float(g_t[0])
            else:
                lo = jnp.take(jnp.asarray(lo_t), n)
                hi = jnp.take(jnp.asarray(hi_t), n)
                gamma = jnp.take(jnp.asarray(g_t), n)
            a = jnp.take_along_axis(xs, lo, axis=axis)
            if isinstance(gamma, float) and gamma < 0:
                taken = a  # discrete method: single order statistic
            else:
                b = jnp.take_along_axis(xs, hi, axis=axis)
                g = jnp.broadcast_to(jnp.asarray(gamma), a.shape)
                g = jnp.where(g < 0, 0.0, g)  # per-slice discrete rows
                # numpy _lerp: switch formulation at t=0.5 for precision
                taken = jnp.where(g >= 0.5, b - (b - a) * (1 - g), a + (b - a) * g)
            if has_nan is not None:
                taken = jnp.where(has_nan, jnp.nan, taken)
            taken = jnp.squeeze(taken, axis=axis)
            if self.keepdims:
                taken = jnp.expand_dims(taken, red)
            out.append(taken)
        dense = out[0] if self._scalar_q else jnp.stack(out, axis=0)
        return dense


def _quantile_args(expr, axis, method, kwargs):
    """Shared quantile argument normalization (reference
    ``reductions/_common.py:977``: tuple axes supported, ``interpolation``
    rename warns, ``weights`` declined)."""
    if kwargs.pop("interpolation", None) is not None:
        import warnings

        warnings.warn(
            "The `interpolation` argument to quantile was renamed to `method`.",
            FutureWarning,
            stacklevel=3,
        )
    if kwargs.pop("weights", None) is not None:
        raise NotImplementedError("weighted quantiles are not supported")
    if axis is not None:
        if isinstance(axis, (tuple, list)):
            axis = tuple(sorted(validate_axis(ax, expr.ndim) for ax in axis))
            if len(set(axis)) != len(axis):
                raise ValueError("duplicate axis")
            if len(axis) == 1:
                axis = axis[0]
        else:
            axis = validate_axis(axis, expr.ndim)
    return axis


def quantile(a, q, axis=None, method="linear", keepdims=False, **kwargs):
    from dask_array_tpu._collection import Array, new_collection

    expr = a.expr if isinstance(a, Array) else a
    axis = _quantile_args(expr, axis, method, kwargs)
    return new_collection(Quantile(expr, q if np.ndim(q) == 0 else tuple(np.asarray(q).tolist()), axis, method, "quantile", bool(keepdims)))


def nanquantile(a, q, axis=None, method="linear", keepdims=False, **kwargs):
    from dask_array_tpu._collection import Array, new_collection

    expr = a.expr if isinstance(a, Array) else a
    axis = _quantile_args(expr, axis, method, kwargs)
    return new_collection(Quantile(expr, q if np.ndim(q) == 0 else tuple(np.asarray(q).tolist()), axis, method, "nanquantile", bool(keepdims)))


class ApproxPercentile(ArrayExpr):
    """Merge-based approximate percentile of a 1-D chunked array.

    The reference's scalable path
    (``reductions/_percentile.py:70-149`` merge_percentiles /
    ``:52-67`` tdigest): per-chunk percentiles at an endpoint-padded q
    grid, weighted by chunk lengths, merged by sorted cumulative-count
    interpolation.  XLA-first: chunk lengths are STATIC, so the whole
    merge (sort + cumsum + interp over ``nblocks * (len(q)+2)`` values)
    traces into the one XLA program — no host-side combine step.
    """

    _parameters = ("array", "q", "method")

    def _name_prefix(self):
        return "approx-percentile"

    @functools.cached_property
    def _q_arr(self):
        return np.asarray(self.q, dtype="f8")

    @functools.cached_property
    def chunks(self):
        return ((len(self._q_arr),),)

    @functools.cached_property
    def _meta(self):
        dt = self.array.dtype
        if np.issubdtype(dt, np.integer) or dt == bool:
            dt = np.dtype("f8")
        return np.empty((0,), dtype=dt)

    def _build(self, ctx):
        jnp = _jnp()
        view = ctx.build(self.array)
        q = self._q_arr
        calc_q = np.pad(q, 1, mode="constant")
        calc_q[-1] = 100.0
        method = self.method
        from dask_array_tpu._chunks import is_float_dtype

        if not (
            np.issubdtype(self.array.dtype, np.number)
            or is_float_dtype(self.array.dtype)
        ):
            method = "nearest"
        vals_parts, count_parts = [], []
        total_n = 0
        for bi, n in enumerate(self.array.chunks[0]):
            if n == 0:
                continue
            block = view.block((bi,))
            v = jnp.percentile(
                jnp.asarray(block).astype(self.dtype), jnp.asarray(calc_q), method=method
            )
            # weight of each grid point: the q-mass it newly covers, scaled
            # by this chunk's length (merge_percentiles' count model)
            c = np.empty(len(calc_q))
            c[0] = calc_q[0]
            c[1:] = np.diff(calc_q)
            c *= n
            vals_parts.append(v)
            count_parts.append(c)
            total_n += n
        if not vals_parts:
            raise ValueError("No non-trivial arrays found")
        combined_vals = jnp.concatenate(vals_parts)
        combined_counts = jnp.asarray(np.concatenate(count_parts))
        order = jnp.argsort(combined_vals)
        combined_vals = combined_vals[order]
        combined_counts = combined_counts[order]
        combined_q = jnp.cumsum(combined_counts)
        desired_q = jnp.asarray(q) * total_n
        if method == "linear":
            rv = jnp.interp(desired_q, combined_q, combined_vals)
        else:
            left = jnp.searchsorted(combined_q, desired_q, side="left")
            right = jnp.searchsorted(combined_q, desired_q, side="right") - 1
            left = jnp.minimum(left, len(calc_q) * len(vals_parts) - 1)
            lower = jnp.minimum(left, right)
            upper = jnp.maximum(left, right)
            if method == "lower":
                rv = combined_vals[lower]
            elif method == "higher":
                rv = combined_vals[upper]
            elif method == "midpoint":
                rv = 0.5 * (combined_vals[lower] + combined_vals[upper])
            elif method == "nearest":
                lres = jnp.abs(combined_q[lower] - desired_q)
                ures = jnp.abs(combined_q[upper] - desired_q)
                rv = jnp.where(lres > ures, combined_vals[upper], combined_vals[lower])
            else:
                raise ValueError(
                    "interpolation method can only be 'linear', 'lower', "
                    "'higher', 'midpoint', or 'nearest'"
                )
        return BlockView(self.chunks, dense=rv.astype(self.dtype))


def percentile(a, q, method="linear", internal_method=None, **kwargs):
    """Percentiles of a 1-D array (dask signature: result is 1-D, len(q)).

    Parity: ``reductions/_percentile.py:151`` — ``interpolation=`` is the
    deprecated alias of ``method=``.  ``internal_method``:

    * ``None``/``"default"``: EXACT dense percentiles (the
      one-program computation supersedes the approximation for most
      sizes).
    * ``"dask"`` / ``"tdigest"``: the reference's scalable approximate
      merge (per-chunk percentiles, weighted merge) — one pass per chunk,
      never materializing the concatenated array.  ``tdigest`` maps to
      the same mergeable-summary computation (the crick dependency is not
      used).
    """
    import warnings

    from dask_array_tpu._collection import Array, new_collection

    if "interpolation" in kwargs:
        warnings.warn(
            "The `interpolation=` argument to percentile was renamed to `method=`",
            FutureWarning,
        )
        method = kwargs.pop("interpolation")
    if method in ("default", "dask", "tdigest"):
        warnings.warn(
            "The `method=` argument was renamed to `internal_method=`",
            FutureWarning,
        )
        internal_method, method = method, "linear"
    if a.ndim == 0:
        raise NotImplementedError("support for arrays of ndim 0 is not implemented.")
    if a.ndim > 1:
        # N-D percentile is numpy-style quantile of q/100 (reference
        # `_percentile.py:248-251`)
        q01 = np.true_divide(q, a.dtype.type(100) if a.dtype.kind == "f" else 100)
        return quantile(a, q01, method=method, **kwargs)
    if internal_method in ("dask", "tdigest"):
        expr = a.expr if isinstance(a, Array) else a
        q_t = tuple(np.atleast_1d(np.asarray(q, dtype="f8")).tolist())
        return new_collection(ApproxPercentile(expr, q_t, method))
    q01 = np.true_divide(q, 100)
    out = quantile(a, tuple(np.atleast_1d(q01).tolist()), axis=0, method=method)
    return out


def nanpercentile(a, q, method="linear", **kwargs):
    """NaN-skipping percentile, any ndim (reference ``_percentile.py:256``:
    ``nanquantile(a, q/100, **kwargs)``)."""
    import warnings

    if "interpolation" in kwargs:
        warnings.warn(
            "The `interpolation=` argument to nanpercentile was renamed to `method=`",
            FutureWarning,
        )
        method = kwargs.pop("interpolation")
    q01 = np.true_divide(q, a.dtype.type(100) if a.dtype.kind == "f" else 100)
    if a.ndim == 1 and "axis" not in kwargs:
        kwargs["axis"] = 0
    return nanquantile(a, q01, method=method, **kwargs)


# -- generic reduction framework ------------------------------------------------------


def _is_jax_value(x):
    return hasattr(x, "aval") or (type(x).__module__ or "").startswith("jax")


def _concat_parts(parts, axis):
    if builtins.any(_is_jax_value(p) for p in parts):
        return _jnp().concatenate(parts, axis=axis)
    return np.concatenate(parts, axis=axis)


def _concatenate2(arrays, axes=None):
    """Concatenate a nested list of arrays along multiple axes.

    The outer list level concatenates along ``axes[0]``, the next level along
    ``axes[1]``, and so on.  Dicts of arrays concatenate field-wise; numpy
    structured arrays concatenate on the host.  Parity: ``_concatenate2``
    (``/root/reference/dask_array/_core_utils.py:191``).
    """
    if axes is None:
        axes = []
    if not isinstance(arrays, (list, tuple)):
        return arrays
    if len(axes) > 1:
        arrays = [_concatenate2(a, axes=axes[1:]) for a in arrays]
    parts = list(arrays)
    if len(parts) == 1:
        return parts[0]
    if not axes:
        return parts[0]
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat_parts([p[k] for p in parts], axes[0]) for k in first}
    return _concat_parts(parts, axes[0])


def _concat_then(fn, axes_sorted, window):
    """``concatenate=True`` adapter: flatten the lol window, then reduce."""
    return fn(_concatenate2(window, axes=list(axes_sorted)))


def _to_host(b):
    """Eager-mode block coercion so numpy-written user kernels always work."""
    if isinstance(b, dict):
        return {k: _to_host(v) for k, v in b.items()}
    if _is_jax_value(b):
        return np.asarray(b)
    return b


class ChunkReduce(ArrayExpr):
    """Per-block chunk phase of the generic reduction (keepdims=True).

    Each block maps to ``func(block[, weights_block], axis=axes,
    keepdims=True)``; outputs may be arrays, dicts of arrays, or structured
    arrays — they flow through the tree as opaque block payloads.
    """

    _parameters = ("array", "func", "axes", "output_size", "_dtype", "weights")
    _defaults = {"weights": None}

    def _name_prefix(self):
        fn = self.func
        base = getattr(fn, "func", fn)
        return f"{getattr(base, '__name__', 'reduce')}-chunk"

    @functools.cached_property
    def chunks(self):
        return tuple(
            (self.output_size,) * len(c) if ax in self.axes else c
            for ax, c in enumerate(self.array.chunks)
        )

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        dt = np.dtype(dtype) if dtype is not None else self.array.dtype
        return np.empty((0,) * len(self.chunks), dtype=dt)

    def _build(self, ctx):
        view = ctx.build(self.array)
        wview = ctx.build(self.weights) if self.weights is not None else None
        eager = ctx.mode == "eager"
        blocks = {}
        for idx in iter_block_indices(view.numblocks):
            b = view.block(idx)
            if eager:
                b = _to_host(b)
            if wview is not None:
                w = wview.block(idx)
                if eager:
                    w = _to_host(w)
                res = self.func(b, w, axis=self.axes, keepdims=True)
            else:
                res = self.func(b, axis=self.axes, keepdims=True)
            blocks[tuple(idx)] = res
        return BlockView(self.chunks, blocks=blocks)


class PartialReduce(ArrayExpr):
    """One tree step: reduce windows of ``split_every`` blocks per axis.

    ``func`` receives the window as nested lists over the reduced axes (the
    reference's lol structure); with ``concatenate=True`` the ``_concat_then``
    wrapper flattens it first.  Parity: ``PartialReduce``
    (``reductions/_reduction.py:900``).
    """

    _parameters = ("array", "func", "split_every", "keepdims", "_dtype", "output_size", "name_")
    _defaults = {"output_size": 1, "name_": None}

    def _name_prefix(self):
        return self.operand("name_") or "partial-reduce"

    @functools.cached_property
    def _split_dict(self):
        return dict(self.split_every)

    @functools.cached_property
    def chunks(self):
        se = self._split_dict
        out = []
        for ax, c in enumerate(self.array.chunks):
            if ax in se:
                n_groups = builtins.max(1, -(-len(c) // se[ax]))
                if self.keepdims:
                    out.append((self.output_size,) * n_groups)
            else:
                out.append(c)
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        dt = np.dtype(dtype) if dtype is not None else self.array.dtype
        return np.empty((0,) * len(self.chunks), dtype=dt)

    def _build(self, ctx):
        view = ctx.build(self.array)
        se = self._split_dict
        nb_in = view.numblocks
        ndim = len(nb_in)
        eager = ctx.mode == "eager"
        groups = {}
        for ax, n in enumerate(nb_in):
            if ax in se:
                step = builtins.max(1, se[ax])
                groups[ax] = [range(lo, builtins.min(lo + step, n)) for lo in range(0, n, step)]
        out_nb = tuple(
            len(groups[ax]) if ax in se else nb_in[ax] for ax in range(ndim)
        )
        blocks = {}
        for out_full in iter_block_indices(out_nb):
            def rec(ax, prefix):
                if ax == ndim:
                    b = view.block(prefix)
                    return _to_host(b) if eager else b
                if ax in se:
                    return [rec(ax + 1, prefix + (i,)) for i in groups[ax][out_full[ax]]]
                return rec(ax + 1, prefix + (out_full[ax],))

            window = rec(0, ())
            res = self.func(window)
            if self.keepdims:
                out_key = tuple(out_full)
            else:
                out_key = tuple(out_full[ax] for ax in range(ndim) if ax not in se)
            blocks[out_key] = res
        return BlockView(self.chunks, blocks=blocks)


def _normalize_split_every(split_every, axes):
    """Canonical ``{axis: n}`` form (parity: ``_reduction.py:715``)."""
    split_every = split_every or config.get("split_every", None) or 16
    if isinstance(split_every, dict):
        # clamp to >= 2: a fan-in of 1 would never reduce (and the final
        # step's 1-block groups would collide on one output key)
        return {k: builtins.max(2, int(split_every.get(k, 2))) for k in axes}
    if isinstance(split_every, Integral):
        n = builtins.max(int(split_every ** (1 / (len(axes) or 1))), 2)
        return dict.fromkeys(axes, n)
    raise ValueError("split_every must be a int or a dict")


def _build_tree_reduce_expr(
    expr, aggregate, axes, keepdims, dtype, split_every, combine, name,
    concatenate, output_size=1,
):
    """Tree cascade of PartialReduce steps (parity: ``_reduction.py:751``)."""
    se = _normalize_split_every(split_every, axes)
    depth = 1
    for ax, n in enumerate(expr.numblocks):
        if ax in se and se[ax] != 1 and n > 1:
            depth = builtins.max(depth, int(math.ceil(math.log(n, se[ax]))))

    func = functools.partial(combine or aggregate, axis=axes, keepdims=True)
    if concatenate:
        func = functools.partial(_concat_then, func, tuple(sorted(axes)))
    se_t = tuple(sorted(se.items()))
    for _ in range(depth - 1):
        expr = PartialReduce(expr, func, se_t, True, dtype, 1)

    agg = functools.partial(aggregate, axis=axes, keepdims=keepdims)
    if concatenate:
        agg = functools.partial(_concat_then, agg, tuple(sorted(axes)))
    # the final step sees <= split_every blocks per reduced axis: one group
    return PartialReduce(expr, agg, se_t, bool(keepdims), dtype, output_size, name)


def _accepts_named_kw(fn, kw):
    import inspect

    base = fn.func if isinstance(fn, functools.partial) else fn
    try:
        params = inspect.signature(base).parameters
    except (TypeError, ValueError):
        return False
    p = params.get(kw)
    return p is not None and p.kind is not inspect.Parameter.VAR_KEYWORD


def reduction(
    x,
    chunk,
    aggregate,
    axis=None,
    keepdims=False,
    dtype=None,
    split_every=None,
    combine=None,
    name=None,
    out=None,
    concatenate=True,
    output_size=1,
    meta=None,
    weights=None,
):
    """Generic tree reduction with user chunk/combine/aggregate kernels.

    Parity: ``reduction()`` (``/root/reference/dask_array/reductions/
    _reduction.py:259``).  The chunk function runs per block
    (``keepdims=True``); combine reduces ``split_every``-sized windows of
    partials; aggregate finishes.  With ``concatenate=True`` (default) the
    window is concatenated into one array first; with ``concatenate=False``
    the functions receive the nested list of raw partials (the dict-protocol
    form used by e.g. the reference's ``mean_chunk``/``mean_combine``).
    ``weights`` are broadcast to ``x`` and passed per-block as the chunk
    function's second argument.
    """
    from dask_array_tpu._collection import Array, new_collection

    arr = x if isinstance(x, Array) else new_collection(x)
    axes = _axes_of(arr, axis)
    if dtype is None:
        raise ValueError("Must specify dtype")
    dtype = np.dtype(dtype)

    chunk_func = chunk
    if _accepts_named_kw(chunk_func, "dtype"):
        chunk_func = functools.partial(chunk_func, dtype=dtype)
    aggregate_func = aggregate
    if _accepts_named_kw(aggregate_func, "dtype"):
        aggregate_func = functools.partial(aggregate_func, dtype=dtype)
    combine_func = combine
    if combine_func is not None and _accepts_named_kw(combine_func, "dtype"):
        combine_func = functools.partial(combine_func, dtype=dtype)

    weights_expr = None
    if weights is not None:
        from dask_array_tpu.ops._from_array import asanyarray
        from dask_array_tpu.ops.manipulation import broadcast_to

        wgt = asanyarray(weights)
        try:
            wgt = broadcast_to(wgt, arr.shape)
        except ValueError:
            raise ValueError(
                f"Weights with shape {wgt.shape} are not broadcastable "
                f"to x with shape {arr.shape}"
            )
        wgt = wgt.rechunk(arr.chunks)
        weights_expr = wgt.expr

    expr = ChunkReduce(arr.expr, chunk_func, axes, int(output_size), dtype, weights_expr)
    expr = _build_tree_reduce_expr(
        expr, aggregate_func, axes, bool(keepdims), dtype, split_every,
        combine_func, name, concatenate, int(output_size),
    )
    return handle_out(out, new_collection(expr))


def _tree_reduce(x, aggregate, axis, keepdims, dtype, split_every=None, combine=None, name=None, concatenate=True, reduced_meta=None):
    """Tree-reduce pre-chunked partials (parity: ``_reduction.py:729``)."""
    from dask_array_tpu._collection import Array, new_collection

    arr = x if isinstance(x, Array) else new_collection(x)
    axes = _axes_of(arr, axis)
    expr = _build_tree_reduce_expr(
        arr.expr, aggregate, axes, bool(keepdims),
        np.dtype(dtype) if dtype is not None else None,
        split_every, combine, name, concatenate,
    )
    return new_collection(expr)


def trace(a, offset=0, axis1=0, axis2=1, dtype=None):
    from dask_array_tpu.ops.routines import diagonal

    return diagonal(a, offset=offset, axis1=axis1, axis2=axis2).sum(axis=-1, dtype=dtype)
