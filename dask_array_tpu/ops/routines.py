"""General numpy-style routines.

Parity: ``/root/reference/dask_array/routines/`` — fresh implementation.
Most routines compose from elemwise/blockwise/reduction/slicing
expressions; data-dependent-shape routines (nonzero, unique, ...) are
untraceable nodes computed eagerly with unknown (nan) chunks, matching the
reference's contract.
"""

from __future__ import annotations

import functools
import math
from numbers import Integral, Number

import numpy as np

from dask_array_tpu._blockwise import elemwise
from dask_array_tpu._chunks import cached_cumsum, validate_axis
from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr


def _jnp():
    import jax.numpy as jnp

    return jnp


def _asarray(x):
    from dask_array_tpu.ops._from_array import asarray

    return asarray(x)


# ---------------------------------------------------------------------------
# elementwise-composed routines
# ---------------------------------------------------------------------------


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    if x is None or y is None:
        raise ValueError("either both or neither of x and y should be given")
    from dask_array_tpu._collection import Array

    shapes = [np.shape(condition), np.shape(x), np.shape(y)]
    if (
        not isinstance(condition, Array)
        and np.ndim(condition) == 0
        and not any(s != s for sh in shapes for s in sh)  # no nan dims
    ):
        # scalar truth: no elementwise select — return the chosen branch
        # directly (reference test_where_bool_optimization: `w1 is d`),
        # applying numpy's broadcast/promotion rules only when needed
        chosen = x if condition else y
        out_dtype = np.result_type(
            getattr(x, "dtype", x), getattr(y, "dtype", y)
        )
        shape = np.broadcast_shapes(*shapes)
        c = _asarray(chosen)
        if c.dtype != out_dtype:
            c = c.astype(out_dtype)
        if c.shape != shape:
            from dask_array_tpu.ops.manipulation import broadcast_to

            c = broadcast_to(c, shape)
        return c
    jnp = _jnp()
    return elemwise(jnp.where, condition, x, y)


def round(a, decimals=0):
    jnp = _jnp()
    return elemwise(jnp.round, a, decimals=decimals)


around = round


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    jnp = _jnp()
    return elemwise(jnp.isclose, a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan).all()


def iscomplexobj(x):
    return np.issubdtype(getattr(x, "dtype", np.asarray(x).dtype), np.complexfloating)


def isnull(values):
    """Element-wise NaN/NaT test (pandas semantics: null == NaN or NaT).

    Non-float dtypes return all-False.  Reference parity:
    ``routines/_misc.py isnull``.
    """
    jnp = _jnp()
    v = _asarray(values)
    if np.issubdtype(v.dtype, np.floating) or np.issubdtype(v.dtype, np.complexfloating):
        return elemwise(jnp.isnan, v)
    from dask_array_tpu.ops.creation import zeros

    return zeros(v.shape, dtype=bool, chunks=v.chunks)


def notnull(values):
    """Element-wise inverse of :func:`isnull`."""
    jnp = _jnp()
    return ~isnull(values)


def result_type(*arrays_and_dtypes):
    return np.result_type(*[
        a.dtype if isinstance(getattr(a, "dtype", None), np.dtype) else a
        for a in arrays_and_dtypes
    ])


def ndim(a):
    if hasattr(a, "ndim"):
        return a.ndim
    return np.asarray(a).ndim


def shape(a):
    if hasattr(a, "shape"):
        return a.shape
    return np.asarray(a).shape


def count_nonzero(a, axis=None):
    a = _asarray(a)
    # astype(bool) (not `!= 0`) so str/object host-lane arrays follow
    # numpy's truthiness (reference test_count_nonzero_str/_obj)
    return a.astype(bool).sum(axis=axis, dtype=np.intp)


def ptp(a, axis=None):
    a = _asarray(a)
    return a.max(axis=axis) - a.min(axis=axis)


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _asarray(a)
    if weights is None:
        avg = a.mean(axis=axis, keepdims=keepdims)
        from dask_array_tpu.ops.reductions import _count

        scl = _count(a, axis, keepdims=keepdims, split_every=None, dtype=avg.dtype)
    else:
        w = _asarray(weights)
        if w.shape != a.shape:
            # numpy's validation contract (np.average raises these verbatim)
            if axis is None:
                raise TypeError(
                    "Axis must be specified when shapes of a and weights differ."
                )
            if w.ndim != 1:
                raise TypeError(
                    "1D weights expected when shapes of a and weights differ."
                )
            ax = validate_axis(axis, a.ndim)
            if w.shape[0] != a.shape[ax]:
                raise ValueError(
                    "Length of weights not compatible with specified axis."
                )
        if w.ndim != a.ndim and axis is not None and w.ndim == 1:
            ax = validate_axis(axis, a.ndim)
            shape_w = [1] * a.ndim
            shape_w[ax] = w.shape[0]
            w = w.reshape(tuple(shape_w))
        scl = w.sum(axis=axis, keepdims=keepdims)
        avg = (a * w).sum(axis=axis, keepdims=keepdims) / scl
    if returned:
        from dask_array_tpu.ops.manipulation import broadcast_to

        if scl.shape != avg.shape:
            scl = broadcast_to(scl, avg.shape)
        return avg, scl
    return avg


def cov(m, y=None, rowvar=1, bias=0, ddof=None, fweights=None, aweights=None, *, dtype=None):
    """Weighted covariance (numpy semantics incl. fweights/aweights).

    Parity: reference ``routines/_statistics.py`` ``cov`` (frequency and
    reliability weights follow ``np.cov``'s normalization rules; ``dtype``
    sets the accumulation/result dtype as in numpy).
    """
    if ddof is not None and ddof != int(ddof):
        raise ValueError("ddof must be integer")
    m = _asarray(m)
    if dtype is not None:
        m = m.astype(np.dtype(dtype))
        if y is not None:
            y = _asarray(y).astype(np.dtype(dtype))
    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    X = m if m.ndim == 2 else m.reshape((1, -1))
    if not rowvar and X.shape[0] != 1:
        X = X.T
    if y is not None:
        y = _asarray(y)
        Y = y if y.ndim == 2 else y.reshape((1, -1))
        if not rowvar and Y.shape[0] != 1:
            Y = Y.T
        from dask_array_tpu.ops.stacking import concatenate

        X = concatenate([X, Y], axis=0)
    N = X.shape[1]
    if ddof is None:
        ddof = 1 if bias == 0 else 0

    w = None
    if fweights is not None:
        fweights = _asarray(fweights)
        if fweights.ndim > 1:
            raise RuntimeError("cannot handle multidimensional fweights")
        if fweights.shape[0] != N:
            raise RuntimeError("incompatible numbers of samples and fweights")
        if not np.issubdtype(fweights.dtype, np.integer):
            raise TypeError("fweights must be integer")
        w = fweights
    if aweights is not None:
        aweights = _asarray(aweights)
        if aweights.ndim > 1:
            raise RuntimeError("cannot handle multidimensional aweights")
        if aweights.shape[0] != N:
            raise RuntimeError("incompatible numbers of samples and aweights")
        w = aweights if w is None else w * aweights

    from dask_array_tpu.ops.linalg import dot
    from dask_array_tpu.ops.ufuncs import conj

    if w is None:
        fact = N - ddof
        mean_ = X.mean(axis=1, keepdims=True)
        Xc = X - mean_
        return dot(Xc, conj(Xc).T) / fact

    w = w.astype("float64")
    v1 = w.sum()
    # np.cov's normalization: v1 for ddof=0; v1-ddof for fweights-only;
    # v1 - ddof*sum(w*a)/v1 when reliability weights are present
    if ddof == 0:
        fact = v1
    elif aweights is None:
        fact = v1 - ddof
    else:
        fact = v1 - ddof * (w * aweights).sum() / v1
    mean_ = ((X * w).sum(axis=1, keepdims=True)) / v1
    Xc = X - mean_
    return dot(Xc * w, conj(Xc).T) / fact


def corrcoef(x, y=None, rowvar=1):
    from dask_array_tpu.ops.ufuncs import sqrt

    c = cov(x, y, rowvar)
    if c.ndim == 0:
        return c / c
    d = diagonal(c)
    denom = sqrt(d[:, None] * d[None, :])
    return c / denom


# ---------------------------------------------------------------------------
# differences / gradients
# ---------------------------------------------------------------------------


def diff(a, n=1, axis=-1, prepend=None, append_=None, append=None):
    a = _asarray(a)
    if append is None:
        append = append_
    n = int(n)
    if n < 0:
        raise ValueError(f"order must be non-negative but got {n}")
    if n == 0:
        # numpy returns the input untouched at order 0 — prepend/append are
        # NOT applied (np.diff early-returns before concatenating).
        return a
    axis = validate_axis(axis, a.ndim)
    parts = []
    if prepend is not None:
        parts.append(_asarray(prepend))
    parts.append(a)
    if append is not None:
        parts.append(_asarray(append))
    if len(parts) > 1:
        from dask_array_tpu.ops.manipulation import broadcast_to
        from dask_array_tpu.ops.stacking import concatenate

        def fit(p):
            if p.ndim == a.ndim:
                return p
            # scalars / lower-rank values broadcast like numpy's diff
            target = tuple(1 if i == axis else s for i, s in enumerate(a.shape))
            if p.ndim == 0:
                return broadcast_to(p, target)
            return broadcast_to(p.reshape((1,) * (a.ndim - p.ndim) + p.shape), target)

        parts = [fit(p) for p in parts]
        a = concatenate(parts, axis=axis)
    for _ in range(int(n)):
        hi = tuple(slice(1, None) if i == axis else slice(None) for i in range(a.ndim))
        lo = tuple(slice(None, -1) if i == axis else slice(None) for i in range(a.ndim))
        a = a[hi] - a[lo]
    return a


def ediff1d(ary, to_end=None, to_begin=None):
    ary = _asarray(ary).ravel()
    out = diff(ary)
    parts = []
    if to_begin is not None:
        parts.append(_asarray(to_begin).ravel())
    parts.append(out)
    if to_end is not None:
        parts.append(_asarray(to_end).ravel())
    if len(parts) > 1:
        from dask_array_tpu.ops.stacking import concatenate

        return concatenate(parts)
    return out


def gradient(f, *varargs, axis=None, edge_order=1):
    f = _asarray(f)
    if axis is None:
        axes = tuple(range(f.ndim))
    elif isinstance(axis, Integral):
        axes = (validate_axis(axis, f.ndim),)
    else:
        axes = tuple(validate_axis(ax, f.ndim) for ax in axis)
    if varargs and len(varargs) not in (1, len(axes)):
        raise TypeError("invalid number of arguments")
    if edge_order not in (1, 2):
        raise ValueError("'edge_order' greater than 2 not supported")
    for ax in axes:
        if f.shape[ax] < edge_order + 1:
            raise ValueError(
                "Shape of array too small to calculate a numerical gradient, "
                "at least (edge_order + 1) elements are required."
            )
    spacings = list(varargs) if varargs else [1.0] * len(axes)
    if len(spacings) == 1 and len(axes) > 1:
        spacings = spacings * len(axes)

    results = []
    for ax, h in zip(axes, spacings):
        results.append(_gradient_axis(f, ax, h, edge_order))
    if len(results) == 1:
        return results[0]
    return results


class _GradientAxis(ArrayExpr):
    _parameters = ("array", "axis", "spacing", "edge_order")

    @property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        probe = np.gradient(np.ones((2,) * self.array.ndim, dtype=self.array.dtype), axis=self.axis)
        return np.empty((0,) * self.array.ndim, dtype=probe.dtype)

    def _build(self, ctx):
        jnp = _jnp()
        dense = ctx.build(self.array).dense()
        sp = self.spacing
        if isinstance(sp, np.ndarray):
            sp = jnp.asarray(sp)
        out = jnp.gradient(dense, sp, axis=self.axis)
        # jnp.gradient has no edge_order parameter (first-order boundaries
        # only); numpy's default-invisible difference shows up at
        # edge_order=2, where the boundary points use one-sided 3-point
        # stencils (non-uniform coefficients when the spacing is an array).
        n = dense.shape[self.axis]
        if self.edge_order == 2 and n >= 3:
            f = jnp.moveaxis(dense, self.axis, 0)
            g = jnp.moveaxis(out, self.axis, 0)
            if jnp.ndim(sp) == 0:
                h = sp
                first = (-3.0 * f[0] + 4.0 * f[1] - f[2]) / (2.0 * h)
                last = (3.0 * f[-1] - 4.0 * f[-2] + f[-3]) / (2.0 * h)
            else:
                x = sp
                d1, d2 = x[1] - x[0], x[2] - x[1]
                first = (
                    -(2.0 * d1 + d2) / (d1 * (d1 + d2)) * f[0]
                    + (d1 + d2) / (d1 * d2) * f[1]
                    - d1 / (d2 * (d1 + d2)) * f[2]
                )
                d1, d2 = x[-2] - x[-3], x[-1] - x[-2]
                last = (
                    d2 / (d1 * (d1 + d2)) * f[-3]
                    - (d2 + d1) / (d1 * d2) * f[-2]
                    + (2.0 * d2 + d1) / (d2 * (d1 + d2)) * f[-1]
                )
            g = g.at[0].set(first).at[-1].set(last)
            out = jnp.moveaxis(g, 0, self.axis)
        return BlockView(self.chunks, dense=out)


def _gradient_axis(f, ax, h, edge_order):
    from dask_array_tpu._collection import new_collection

    if hasattr(h, "ndim") and getattr(h, "ndim", 0) > 0:
        h = np.asarray(h)
    return new_collection(_GradientAxis(f.expr, ax, h, edge_order))


# ---------------------------------------------------------------------------
# data-dependent-shape routines (eager, nan chunks)
# ---------------------------------------------------------------------------


class _EagerUnary(ArrayExpr):
    """Base: run a jnp function eagerly; output size is data-dependent."""

    _parameters = ("array", "kind", "params")
    _defaults = {"params": ()}

    _traceable = False

    @functools.cached_property
    def chunks(self):
        return ((float("nan"),),) * 1 if self._out_ndim == 1 else tuple(
            ((float("nan"),),) * self._out_ndim
        )

    _out_ndim = 1

    @property
    def _meta(self):
        return np.empty((0,), dtype=self._out_dtype)

    _out_dtype = np.intp

    def _build(self, ctx):
        raise NotImplementedError


class NonzeroAxis(ArrayExpr):
    _parameters = ("array", "axis_out")

    _traceable = False

    @property
    def chunks(self):
        return ((float("nan"),),)

    @property
    def _meta(self):
        return np.empty((0,), dtype=np.intp)

    def _build(self, ctx):
        jnp = _jnp()
        dense = ctx.build(self.array).dense()
        if isinstance(dense, np.ndarray) and dense.dtype.kind not in "biufc":
            # str/object/structured host lane: numpy truthiness
            out = jnp.asarray(np.nonzero(dense)[self.axis_out])
        else:
            out = jnp.nonzero(dense)[self.axis_out]
        return BlockView(self.chunks, dense=out.astype(np.intp))


def nonzero(a):
    from dask_array_tpu._collection import new_collection

    a = _asarray(a)
    return tuple(new_collection(NonzeroAxis(a.expr, i)) for i in range(a.ndim))


def flatnonzero(a):
    a = _asarray(a)
    return nonzero(a.ravel())[0]


def argwhere(a):
    from dask_array_tpu.ops.stacking import stack

    a = _asarray(a)
    nz = nonzero(a)
    if not nz:
        from dask_array_tpu.ops._from_array import from_array

        return from_array(np.empty((0, 0), dtype=np.intp))
    return stack(nz, axis=1, allow_unknown_chunksizes=True)


class Unique(ArrayExpr):
    _parameters = ("array", "which")  # which: values|indices|inverse|counts

    _traceable = False

    @property
    def chunks(self):
        if self.which == "inverse":
            # the inverse has one entry per input element: size is KNOWN
            # whenever the input's is (reference asserts (x.size,) shape)
            size = self.array.size
            if not (isinstance(size, float) and np.isnan(size)):
                return ((int(size),),)
        return ((float("nan"),),)

    @functools.cached_property
    def _meta(self):
        if self.which == "values":
            return np.empty((0,), dtype=self.array.dtype)
        return np.empty((0,), dtype=np.intp)

    def _build(self, ctx):
        jnp = _jnp()
        dense = ctx.build(self.array).dense().ravel()
        vals, idx, inv, counts = jnp.unique(
            dense, return_index=True, return_inverse=True, return_counts=True
        )
        out = {"values": vals, "indices": idx, "inverse": inv, "counts": counts}[self.which]
        if self.which != "values":
            out = out.astype(np.intp)
        return BlockView(self.chunks, dense=out)


def unique(ar, return_index=False, return_inverse=False, return_counts=False):
    from dask_array_tpu._collection import new_collection

    ar = _asarray(ar)
    out = [new_collection(Unique(ar.expr, "values"))]
    if return_index:
        out.append(new_collection(Unique(ar.expr, "indices")))
    if return_inverse:
        out.append(new_collection(Unique(ar.expr, "inverse")))
    if return_counts:
        out.append(new_collection(Unique(ar.expr, "counts")))
    if len(out) == 1:
        return out[0]
    return tuple(out)


def union1d(ar1, ar2):
    from dask_array_tpu.ops.stacking import concatenate

    return unique(concatenate([_asarray(ar1).ravel(), _asarray(ar2).ravel()], axis=0))


class Bincount(ArrayExpr):
    """numpy semantics: output length is max(x.max()+1, minlength) — data-
    dependent, so the node is eager with unknown chunks (values above
    minlength are COUNTED, never silently dropped)."""

    _parameters = ("array", "weights", "minlength")

    _traceable = False

    @functools.cached_property
    def chunks(self):
        return ((float("nan"),),)

    @functools.cached_property
    def _meta(self):
        dt = np.intp if self.weights is None else np.promote_types(
            self.weights.dtype, np.float64
        )
        return np.empty((0,), dtype=dt)

    def _build(self, ctx):
        jnp = _jnp()
        dense = ctx.build(self.array).dense()
        w = ctx.build(self.weights).dense() if isinstance(self.weights, ArrayExpr) else None
        # eager: dense is concrete, so numpy's grow-to-max semantics apply
        length = int(max(int(dense.max()) + 1 if dense.size else 0, self.minlength or 0))

        # jnp.bincount's scatter-add beats the compare-accumulate scan here
        # (kernels/histogram.py)
        out = jnp.bincount(dense, weights=w, length=length)
        if out.dtype != self.dtype:
            out = out.astype(self.dtype)
        return BlockView(self.chunks, dense=out)


def bincount(x, weights=None, minlength=0, split_every=None):
    from dask_array_tpu._collection import Array, new_collection

    x = _asarray(x)
    if x.ndim != 1:
        raise ValueError("Input array must be one dimensional")
    if not np.issubdtype(x.dtype, np.integer):
        raise TypeError("Input array must be an integer array")
    w = weights.expr if isinstance(weights, Array) else (
        _asarray(weights).expr if weights is not None else None
    )
    return new_collection(Bincount(x.expr, w, int(minlength) if minlength else None))


def digitize(a, bins, right=False):
    jnp = _jnp()
    bins = np.asarray(bins)
    out = elemwise(lambda x: jnp.digitize(x, jnp.asarray(bins), right=right), _asarray(a))
    return out.astype(np.intp)


class Searchsorted(ArrayExpr):
    _parameters = ("array", "values", "side", "sorter")

    @property
    def chunks(self):
        return self.values.chunks

    @property
    def _meta(self):
        return np.empty((0,) * self.values.ndim, dtype=np.intp)

    def _build(self, ctx):
        jnp = _jnp()
        a = ctx.build(self.array).dense()
        v = ctx.build(self.values).dense()
        if isinstance(self.sorter, ArrayExpr):
            # numpy semantics: sorter permutes `a` into sorted order
            a = jnp.take(a, ctx.build(self.sorter).dense())
        out = jnp.searchsorted(a, v, side=self.side)
        return BlockView(self.chunks, dense=out.astype(np.intp))


def searchsorted(a, v, side="left", sorter=None):
    from dask_array_tpu._collection import new_collection

    a, v = _asarray(a), _asarray(v)
    if a.ndim != 1:
        raise ValueError("a must be 1-dimensional")
    sorter_expr = _asarray(sorter).expr if sorter is not None else None
    return new_collection(Searchsorted(a.expr, v.expr, side, sorter_expr))


def isin(element, test_elements, assume_unique=False, invert=False):
    jnp = _jnp()
    element = _asarray(element)
    test = np.asarray(test_elements) if not hasattr(test_elements, "expr") else None
    if test is not None:
        return elemwise(
            lambda x: jnp.isin(x, jnp.asarray(test), assume_unique=assume_unique, invert=invert),
            element,
        )
    from dask_array_tpu._collection import new_collection

    return new_collection(_IsinLazy(element.expr, test_elements.expr, bool(invert)))


class _IsinLazy(ArrayExpr):
    _parameters = ("array", "test", "invert")

    @property
    def chunks(self):
        return self.array.chunks

    @property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=bool)

    def _build(self, ctx):
        jnp = _jnp()
        a = ctx.build(self.array).dense()
        t = ctx.build(self.test).dense()
        return BlockView(self.chunks, dense=jnp.isin(a, t, invert=self.invert))


# ---------------------------------------------------------------------------
# selection / conditioning
# ---------------------------------------------------------------------------


def select(condlist, choicelist, default=0):
    jnp = _jnp()
    if len(condlist) != len(choicelist):
        raise ValueError("list of cases must be same length as list of conditions")
    if len(condlist) == 0:
        raise ValueError("select with an empty condition list is not possible")
    args = list(condlist) + list(choicelist)
    n = len(condlist)

    def _select(*arrays, **kw):
        conds = arrays[:n]
        choices = arrays[n:]
        return jnp.select(list(conds), list(choices), default=default)

    return elemwise(_select, *args)


def piecewise(x, condlist, funclist, *args, **kw):
    x = _asarray(x)
    from dask_array_tpu.ops._map_blocks import map_blocks

    def _piecewise(block, *cond_blocks):
        jnp = _jnp()
        n = len(cond_blocks)
        fl = list(funclist)
        y = jnp.zeros_like(block)
        if len(fl) == n + 1:
            y = y + fl[-1](block, *args, **kw) if callable(fl[-1]) else y + fl[-1]
            fl = fl[:-1]
        for cond, fn in zip(cond_blocks, fl):
            val = fn(block, *args, **kw) if callable(fn) else fn
            y = jnp.where(cond, val, y)
        return y

    conds = [c if hasattr(c, "expr") else _asarray(c) for c in condlist]
    return map_blocks(_piecewise, x, *conds, dtype=x.dtype)


def choose(a, choices):
    jnp = _jnp()
    args = [a] + list(choices)
    n = len(choices)

    def _choose(idx, *cs):
        return jnp.choose(idx, list(cs), mode="clip")

    return elemwise(_choose, *args)


def compress(condition, a, axis=None):
    a = _asarray(a)
    condition = np.asarray(condition)
    if condition.ndim != 1:
        raise ValueError("condition must be one dimensional")
    if axis is None:
        a = a.ravel()
        axis = 0
    axis = validate_axis(axis, a.ndim)
    if len(condition) > a.shape[axis]:
        raise IndexError("condition is longer than the input size")
    from dask_array_tpu.ops._fancy_indexing import take

    return take(a, np.nonzero(condition)[0], axis=axis)


def extract(condition, arr):
    condition = _asarray(condition)
    arr = _asarray(arr)
    return arr.ravel()[condition.ravel()]


# ---------------------------------------------------------------------------
# triangles / diagonals
# ---------------------------------------------------------------------------


def tril(m, k=0):
    jnp = _jnp()
    return elemwise(lambda x: jnp.tril(x, k=k), _asarray(m))


def triu(m, k=0):
    jnp = _jnp()
    return elemwise(lambda x: jnp.triu(x, k=k), _asarray(m))


def tril_indices(n, k=0, m=None, chunks="auto"):
    from dask_array_tpu.ops._from_array import from_array

    rows, cols = np.tril_indices(n, k=k, m=m)
    return from_array(rows, chunks=chunks), from_array(cols, chunks=chunks)


def tril_indices_from(arr, k=0):
    if arr.ndim != 2:
        raise ValueError("input array must be 2-d")
    return tril_indices(arr.shape[0], k=k, m=arr.shape[1])


def triu_indices(n, k=0, m=None, chunks="auto"):
    from dask_array_tpu.ops._from_array import from_array

    rows, cols = np.triu_indices(n, k=k, m=m)
    return from_array(rows, chunks=chunks), from_array(cols, chunks=chunks)


def triu_indices_from(arr, k=0):
    if arr.ndim != 2:
        raise ValueError("input array must be 2-d")
    return triu_indices(arr.shape[0], k=k, m=arr.shape[1])


class Diagonal(ArrayExpr):
    _parameters = ("array", "offset", "axis1", "axis2")

    @functools.cached_property
    def chunks(self):
        arr = self.array
        a1, a2 = self.axis1, self.axis2
        n1, n2 = arr.shape[a1], arr.shape[a2]
        k = self.offset
        length = max(0, min(n1 + min(0, k), n2 - max(0, k)))
        # diagonal chunk boundaries: union of row/col boundaries projected
        b1 = set(cached_cumsum(arr.chunks[a1], initial_zero=True))
        b2 = {b - k for b in cached_cumsum(arr.chunks[a2], initial_zero=True)}
        start = max(0, -k)
        cuts = sorted(
            {min(max(b - start, 0), length) for b in (b1 | b2)}
        )
        out = tuple(b - a for a, b in zip(cuts[:-1], cuts[1:]) if b > a) or (0,)
        other = tuple(
            c for ax, c in enumerate(arr.chunks) if ax not in (a1, a2)
        )
        return other + (out,)

    @property
    def _meta(self):
        return np.empty((0,) * (self.array.ndim - 1), dtype=self.array.dtype)

    def _build(self, ctx):
        jnp = _jnp()
        dense = ctx.build(self.array).dense()
        out = jnp.diagonal(dense, offset=self.offset, axis1=self.axis1, axis2=self.axis2)
        return BlockView(self.chunks, dense=out)


def diagonal(a, offset=0, axis1=0, axis2=1):
    from dask_array_tpu._collection import new_collection

    a = _asarray(a)
    if a.ndim < 2:
        raise ValueError("diag requires an array of at least two dimensions")
    axis1 = validate_axis(axis1, a.ndim)
    axis2 = validate_axis(axis2, a.ndim)
    if axis1 == axis2:
        raise ValueError("axis1 and axis2 cannot be the same")
    return new_collection(Diagonal(a.expr, int(offset), axis1, axis2))


# ---------------------------------------------------------------------------
# coarsen
# ---------------------------------------------------------------------------


def aligned_coarsen_chunks(chunks, multiple):
    """Rechunk targets aligned to a coarsening factor.

    Contract (reference ``routines/_coarsen.py:22`` properties): element
    count conserved; chunks already divisible by ``multiple`` are untouched;
    at most one chunk is added; at most one chunk is left indivisible and it
    is the last.
    """
    floors = [(c // multiple) * multiple for c in chunks]
    excess = sum(c - f for c, f in zip(chunks, floors))
    # hand whole multiples of the excess to the smallest chunks that lost
    # something (never to already-aligned chunks, which stay verbatim)
    donees = sorted(
        (i for i, (c, f) in enumerate(zip(chunks, floors)) if f != c),
        key=lambda i: floors[i],
    )
    units, remainder = divmod(excess, multiple)
    for k in range(units):
        floors[donees[k]] += multiple
    if remainder:
        floors.append(remainder)
    return tuple(f for f in floors if f > 0)


class Coarsen(ArrayExpr):
    _parameters = ("array", "reduction_name", "axes", "trim_excess", "kwargs")
    _defaults = {"kwargs": ()}

    @functools.cached_property
    def chunks(self):
        axes = dict(self.axes)
        out = []
        for ax, c in enumerate(self.array.chunks):
            f = axes.get(ax, 1)
            if f == 1:
                out.append(tuple(c))
            else:
                if self.trim_excess:
                    out.append(tuple(x // f for x in c if x // f) or (0,))
                else:
                    out.append(tuple(x // f for x in c))
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        np_fn = getattr(np, self.reduction_name)
        probe = np_fn(np.ones((1, 1), dtype=self.array.dtype), axis=0)
        return np.empty((0,) * self.array.ndim, dtype=probe.dtype)

    def _build(self, ctx):
        jnp = _jnp()
        dense = ctx.build(self.array).dense()
        axes = dict(self.axes)
        fn = getattr(jnp, self.reduction_name)
        shape = dense.shape
        if self.trim_excess:
            trims = tuple(
                slice(0, (shape[ax] // axes.get(ax, 1)) * axes.get(ax, 1))
                for ax in range(len(shape))
            )
            dense = dense[trims]
            shape = dense.shape
        new_shape = []
        red_axes = []
        for ax, s in enumerate(shape):
            f = axes.get(ax, 1)
            new_shape.extend([s // f, f])
            red_axes.append(2 * ax + 1)
        out = fn(dense.reshape(tuple(new_shape)), axis=tuple(red_axes), **dict(self.kwargs or ()))
        if out.dtype != self.dtype:
            out = out.astype(self.dtype)
        return BlockView(self.chunks, dense=out)


def coarsen(reduction, x, axes, trim_excess=False, **kwargs):
    """Downsample ``x`` by applying ``reduction`` over non-overlapping windows.

    ``axes`` maps axis -> window size (e.g. ``{0: 2, 1: 4}``).  With
    ``trim_excess`` the trailing remainder is dropped instead of raising.
    Reference parity: ``routines/_coarsen.py``; the reduction runs inside
    one fused XLA program via a reshape-reduce formulation.
    """
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu._rechunk import Rechunk

    x = _asarray(x)
    name = getattr(reduction, "__name__", None)
    jnp = _jnp()
    if name is None or not hasattr(jnp, name):
        raise NotImplementedError(f"coarsen reduction {reduction!r} has no jnp equivalent")
    axes = {validate_axis(k, x.ndim): int(v) for k, v in axes.items()}
    for ax, f in axes.items():
        if not trim_excess and x.shape[ax] % f != 0:
            raise ValueError(f"Coarsening factor {f} does not divide axis {ax} of size {x.shape[ax]}")
    expr = x.expr
    # align chunk boundaries to the coarsening factors
    target = tuple(
        aligned_coarsen_chunks(expr.chunks[ax], axes[ax]) if ax in axes and axes[ax] > 1 else expr.chunks[ax]
        for ax in range(x.ndim)
    )
    if target != expr.chunks:
        expr = Rechunk(expr, target)
    return new_collection(
        Coarsen(expr, name, tuple(sorted(axes.items())), bool(trim_excess), tuple(sorted(kwargs.items())))
    )


# ---------------------------------------------------------------------------
# apply along/over axes
# ---------------------------------------------------------------------------


def apply_along_axis(func1d, axis, arr, *args, dtype=None, shape=None, **kwargs):
    from dask_array_tpu._collection import new_collection

    arr = _asarray(arr)
    axis = validate_axis(axis, arr.ndim)
    if shape is None or dtype is None:
        probe = np.ones(max(1, arr.shape[axis]), dtype=arr.dtype)
        test = np.asarray(func1d(probe, *args, **kwargs))
        if shape is None:
            shape = test.shape
        if dtype is None:
            dtype = test.dtype
    return new_collection(
        _ApplyAlongAxis(arr.expr, func1d, axis, tuple(shape), np.dtype(dtype), args, tuple(sorted(kwargs.items())))
    )


class _ApplyAlongAxis(ArrayExpr):
    _parameters = ("array", "func", "axis", "out_shape", "_dtype", "args", "kwargs")

    @functools.cached_property
    def chunks(self):
        pre = tuple(self.array.chunks[ax] for ax in range(self.axis))
        post = tuple(self.array.chunks[ax] for ax in range(self.axis + 1, self.array.ndim))
        mid = tuple((s,) for s in self.out_shape)
        return pre + mid + post

    @property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=self._dtype)

    def _build(self, ctx):
        import jax

        dense = ctx.build(self.array).dense()
        fn = self.func
        args = self.args
        kw = dict(self.kwargs or ())

        def f1d(v):
            return fn(v, *args, **kw)

        # vmap over all other axes
        moved = jax.numpy.moveaxis(dense, self.axis, -1)
        lead_shape = moved.shape[:-1]
        flat = moved.reshape((-1, moved.shape[-1]))
        try:
            out = jax.vmap(f1d)(flat)
        except Exception:
            out = jax.numpy.stack([f1d(flat[i]) for i in range(flat.shape[0])])
        out = out.reshape(lead_shape + self.out_shape)
        # move lead axes back around the inserted out axes
        nd_out = len(lead_shape) + len(self.out_shape)
        perm = (
            list(range(self.axis))
            + list(range(len(lead_shape), nd_out))
            + list(range(self.axis, len(lead_shape)))
        )
        out = jax.numpy.transpose(out, perm)
        if out.dtype != self._dtype:
            out = out.astype(self._dtype)
        return BlockView(self.chunks, dense=out)


def apply_over_axes(func, a, axes):
    a = _asarray(a)
    if isinstance(axes, Integral):
        axes = (axes,)
    out = a
    for ax in axes:
        ax = validate_axis(ax, a.ndim)
        res = func(out, ax)
        if res.ndim == out.ndim:
            out = res
        elif res.ndim == out.ndim - 1:
            from dask_array_tpu.ops.manipulation import expand_dims

            out = expand_dims(res, ax)
        else:
            raise ValueError("function is not returning an array of the correct shape")
    return out


# ---------------------------------------------------------------------------
# index math
# ---------------------------------------------------------------------------


def _is_lazy_collection(x):
    from dask_array_tpu._collection import Array

    return isinstance(x, Array) or hasattr(x, "__dask_graph__")


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    """Reference parity (routines/_indexing.py:38): coords stack along a new
    leading axis; per-block kernel drops it.  mode='raise' must raise on
    out-of-bounds at compute time, so that path runs eagerly on host."""
    from dask_array_tpu._collection import new_collection

    if np.isscalar(dims):
        dims = (dims,)
    if _is_lazy_collection(dims) or any(_is_lazy_collection(d) for d in dims):
        raise NotImplementedError(
            f"Dask types are not supported in the `dims` argument: {dims!r}"
        )
    dims = tuple(int(d) for d in dims)

    if hasattr(multi_index, "ndim") and multi_index.ndim > 0:
        index_stack = _asarray(multi_index)
    else:
        from dask_array_tpu.ops.stacking import stack

        coords = [_asarray(m) for m in multi_index]
        if any(
            isinstance(c, float) and np.isnan(c)
            for m in coords
            for c in np.asarray(m.shape).ravel().tolist()
        ):
            raise ValueError(
                "ravel_multi_index requires known chunk sizes to broadcast "
                "the coordinate arrays; call compute_chunk_sizes() first"
            )
        arrs = broadcast_arrays(*coords)
        index_stack = stack(arrs)
    lead = index_stack.shape[0]
    if not (isinstance(lead, float) and np.isnan(lead)) and int(lead) != len(dims):
        raise ValueError(
            f"parameter multi_index must be a sequence of length {len(dims)}"
        )
    if not np.issubdtype(index_stack.dtype, np.signedinteger):
        raise TypeError("only int indices permitted")
    if len(index_stack.chunks[0]) != 1:
        # the kernel reads every coordinate of one point together
        index_stack = index_stack.rechunk({0: -1})

    if mode == "raise":
        return new_collection(
            _RavelMultiRaise(dims, order, index_stack.expr)
        )

    from dask_array_tpu.ops._map_blocks import map_blocks

    return map_blocks(
        functools.partial(_ravel_multi_block, dims=dims, mode=mode, order=order),
        index_stack,
        dtype=np.intp,
        chunks=index_stack.chunks[1:],
        drop_axis=0,
    )


def _ravel_multi_block(block, dims=None, mode="wrap", order="C"):
    jnp = _jnp()
    if isinstance(block, np.ndarray):
        return np.ravel_multi_index(tuple(block), dims, mode=mode, order=order)
    out = jnp.ravel_multi_index(tuple(block), dims, mode=mode, order=order)
    return out.astype(np.intp)


class _RavelMultiRaise(ArrayExpr):
    """mode='raise' path: numpy's bounds check must fire at compute time,
    which a trace cannot do — evaluates eagerly on host."""

    _parameters = ("dims", "order", "stacked")  # stacked: (n_dims, ...) coords

    _traceable = False

    @functools.cached_property
    def chunks(self):
        return tuple(self.stacked.chunks[1:])

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=np.intp)

    def _build(self, ctx):
        import jax.numpy as jnp

        val = np.asarray(ctx.build(self.stacked).dense())
        out = np.ravel_multi_index(tuple(val), self.dims, order=self.order)
        return BlockView(self.chunks, dense=jnp.asarray(np.asarray(out, dtype=np.intp)))


def unravel_index(indices, shape, order="C"):
    jnp = _jnp()
    indices = _asarray(indices)
    size = indices.size
    size_known = not (isinstance(size, float) and np.isnan(size))
    if not shape or (size_known and int(size) == 0):
        # reference parity (routines/_indexing.py:31): empty shape or no
        # indices -> one empty 1-D coordinate array per dimension
        from dask_array_tpu.ops.creation import empty

        return tuple(empty((0,), dtype=np.intp, chunks=1) for _ in shape)
    out = []
    for i in range(len(shape)):
        out.append(
            elemwise(
                functools.partial(_unravel_one, shape=tuple(shape), order=order, i=i),
                indices,
            ).astype(np.intp)
        )
    return tuple(out)


def _unravel_one(x, shape=None, order="C", i=0):
    jnp = _jnp()
    if order == "F":
        # jnp.unravel_index is C-order only; F-order = C-order on the
        # reversed shape, coordinates read back in reverse
        coords = jnp.unravel_index(x, shape[::-1])
        return coords[len(shape) - 1 - i]
    return jnp.unravel_index(x, shape)[i]


# ---------------------------------------------------------------------------
# broadcast / unify helpers
# ---------------------------------------------------------------------------


def broadcast_arrays(*args, subok=False):
    from dask_array_tpu.ops.manipulation import broadcast_to

    arrays = [_asarray(a) for a in args]
    shape = np.broadcast_shapes(*[a.shape for a in arrays])
    return [broadcast_to(a, shape) for a in arrays]


def unify_chunks(*args, **kwargs):
    """da.unify_chunks(a, 'ij', b, 'jk') -> (chunkss dict, [arrays rechunked])."""
    from dask_array_tpu._chunks import common_blockdim

    if not args:
        return {}, []
    arrays = list(args[::2])
    inds = [tuple(i) for i in args[1::2]]
    label_chunks: dict = {}
    for a, ind in zip(arrays, inds):
        for pos, lbl in enumerate(ind):
            c = a.chunks[pos]
            prev = label_chunks.get(lbl)
            if prev is None:
                label_chunks[lbl] = c
            elif prev != c:
                label_chunks[lbl] = common_blockdim([prev, c])
    out = []
    for a, ind in zip(arrays, inds):
        want = tuple(label_chunks[lbl] for lbl in ind)
        out.append(a.rechunk(want) if want != a.chunks else a)
    return label_chunks, out


# ---------------------------------------------------------------------------
# topk
# ---------------------------------------------------------------------------


class TopK(ArrayExpr):
    _parameters = ("array", "k", "axis", "kind")  # kind: values|indices

    @functools.cached_property
    def chunks(self):
        chunks = list(self.array.chunks)
        chunks[self.axis] = (abs(self.k),)
        return tuple(chunks)

    @functools.cached_property
    def _meta(self):
        dt = self.array.dtype if self.kind == "values" else np.intp
        return np.empty((0,) * self.array.ndim, dtype=dt)

    def _build(self, ctx):
        import jax
        import jax.numpy as jnp

        dense = ctx.build(self.array).dense()
        k = self.k
        moved = jnp.moveaxis(dense, self.axis, -1)
        if k >= 0:
            vals, idxs = jax.lax.top_k(moved, k)  # k largest, descending
        else:
            vals, idxs = jax.lax.top_k(-moved, -k)  # k smallest, ascending
            vals = -vals
        out = vals if self.kind == "values" else idxs.astype(np.intp)
        out = jnp.moveaxis(out, -1, self.axis)
        return BlockView(self.chunks, dense=out)


def topk(a, k, axis=-1, split_every=None):
    """The ``k`` largest (``k<0``: smallest) elements along ``axis``, sorted.

    Block-wise tournament selection: each block contributes its own top-k
    and the partials merge in a tree (reference ``routines/_topk.py``),
    so the full axis is never gathered.  ``split_every`` bounds the fan-in.
    """
    from dask_array_tpu._collection import new_collection

    a = _asarray(a)
    axis = validate_axis(axis, a.ndim)
    return new_collection(TopK(a.expr, int(k), axis, "values"))


def argtopk(a, k, axis=-1, split_every=None):
    """Indices of the ``k`` largest (``k<0``: smallest) elements along ``axis``.

    Lazy analog of ``np.argsort``-then-slice, computed block-wise with a
    tournament merge so only ``k`` candidates per block travel (reference
    ``routines/_topk.py``).  ``split_every`` bounds the merge fan-in.
    """
    from dask_array_tpu._collection import new_collection

    a = _asarray(a)
    axis = validate_axis(axis, a.ndim)
    return new_collection(TopK(a.expr, int(k), axis, "indices"))


# ---------------------------------------------------------------------------
# insert / delete / append
# ---------------------------------------------------------------------------


def insert(arr, obj, values, axis=None):
    """numpy-parity insert (reference routines/_insert_delete.py:64; numpy's
    size-1 branch inserts the whole ``values`` block at that position)."""
    from dask_array_tpu.ops.manipulation import broadcast_to, moveaxis
    from dask_array_tpu.ops.stacking import concatenate

    arr = _asarray(arr)
    if axis is None:
        arr = arr.ravel()
        axis = 0
    axis = validate_axis(axis, arr.ndim)
    n = arr.shape[axis]
    if isinstance(obj, slice):
        obj = np.arange(*obj.indices(n))
    obj_arr = np.asarray(obj)
    scalar_obj = obj_arr.ndim == 0
    obj_arr = np.atleast_1d(obj_arr)
    if obj_arr.size and (obj_arr.min() < -n or obj_arr.max() > n):
        bad = obj_arr[(obj_arr < -n) | (obj_arr > n)][0]
        raise IndexError(
            f"index {int(bad)} is out of bounds for axis {axis} with size {n}"
        )
    obj_arr = np.where(obj_arr < 0, obj_arr + n, obj_arr).astype(np.intp)
    values = _asarray(values)

    def _axis_slice(lo, hi):
        return tuple(
            slice(lo, hi) if i == axis else slice(None) for i in range(arr.ndim)
        )

    if obj_arr.size == 1:
        # numpy: pad values to arr.ndim (leading 1s); a SCALAR obj moves
        # values' first axis to the insert axis; the whole block goes in
        if values.ndim < arr.ndim:
            values = values.reshape((1,) * (arr.ndim - values.ndim) + values.shape)
        if scalar_obj and arr.ndim > 1:
            values = moveaxis(values, 0, axis)
        # numpy assigns into the slot (broadcasting off-axis dims)
        numnew = values.shape[axis]
        slot = tuple(numnew if i == axis else s for i, s in enumerate(arr.shape))
        if values.shape != slot:
            values = broadcast_to(values, slot)
        pos = int(obj_arr[0])
        parts = []
        if pos > 0:
            parts.append(arr[_axis_slice(0, pos)])
        parts.append(values)
        if pos < n:
            parts.append(arr[_axis_slice(pos, None)])
        return concatenate(parts, axis=axis)

    # multi-index branch: values broadcast to one slot per index, assigned
    # in obj order at stable-sorted positions (numpy's mergesort interleave)
    shape_v = tuple(len(obj_arr) if i == axis else s for i, s in enumerate(arr.shape))
    if values.ndim < arr.ndim:
        if values.ndim == 0:
            values = broadcast_to(values, shape_v)
        else:
            values = broadcast_to(
                values.reshape((1,) * (arr.ndim - values.ndim) + values.shape),
                shape_v,
            )
    elif values.shape != shape_v:
        values = broadcast_to(values, shape_v)
    order = np.argsort(obj_arr, kind="stable")
    parts = []
    pos = 0
    for rank, ins_at in enumerate(np.sort(obj_arr)):
        ins_at = int(ins_at)
        if ins_at > pos:
            parts.append(arr[_axis_slice(pos, ins_at)])
        src = int(order[rank])
        parts.append(values[_axis_slice(src, src + 1)])
        pos = ins_at
    if pos < n:
        parts.append(arr[_axis_slice(pos, None)])
    return concatenate(parts, axis=axis)


def delete(arr, obj, axis=None):
    from dask_array_tpu.ops.stacking import concatenate

    arr = _asarray(arr)
    if axis is None:
        arr = arr.ravel()
        axis = 0
    axis = validate_axis(axis, arr.ndim)
    n = arr.shape[axis]
    if isinstance(obj, slice):
        keep = np.ones(n, dtype=bool)
        keep[obj] = False
    else:
        obj = np.atleast_1d(np.asarray(obj))
        obj = np.where(obj < 0, obj + n, obj)
        keep = np.ones(n, dtype=bool)
        keep[obj.astype(np.intp)] = False
    from dask_array_tpu.ops._fancy_indexing import take

    return take(arr, np.nonzero(keep)[0], axis=axis)


def append(arr, values, axis=None):
    from dask_array_tpu.ops.stacking import concatenate

    arr = _asarray(arr)
    values = _asarray(values)
    if axis is None:
        return concatenate([arr.ravel(), values.ravel()], axis=0)
    return concatenate([arr, values], axis=validate_axis(axis, arr.ndim))
