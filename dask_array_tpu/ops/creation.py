"""Array creation: constant sources, ranges, identity/diagonal matrices.

Parity: ``/root/reference/dask_array/creation/`` (``BroadcastTrick``
constant leaves with slice/rechunk/shuffle absorption, ``Arange``,
``Linspace``, ``Eye``...) — fresh implementation.

XLA-first: constant leaves trace to a scalar broadcast (free in XLA — no
blocks are ever materialized until a consumer needs them); ranges trace to
``jnp.arange``-style iotas which XLA generates on-device, so creation never
touches the host.
"""

from __future__ import annotations

import functools
import math
from numbers import Integral, Number

import numpy as np

from dask_array_tpu._chunks import normalize_chunks
from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr
from dask_array_tpu._slicing import sliced_blockdim


class BroadcastTrick(ArrayExpr):
    """A constant-fill leaf: absorbs slices/rechunks/shuffles outright.

    Parity: ``BroadcastTrick`` in
    ``/root/reference/dask_array/creation/_ones_zeros.py:17-125``.
    """

    _parameters = ("chunks_", "_dtype", "fill_value", "name_")
    _defaults = {"fill_value": None, "name_": None}

    _fusable_leaf = True

    def _collection_name(self):
        return self.operand("name_") or self._name

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self._dtype)

    def _fill(self):
        return self.fill_value

    def _build(self, ctx):
        import jax.numpy as jnp

        fill = self._fill()
        shape = self.shape
        from dask_array_tpu._chunks import host_only_dtype

        if host_only_dtype(self._dtype):
            # host-only dtype (str/object/structured): numpy constants
            dense = (
                np.zeros(shape, dtype=self._dtype)
                if fill is None
                else np.full(shape, fill, dtype=self._dtype)
            )
        elif fill is None:  # "empty": contents unspecified; zeros here
            dense = jnp.zeros(shape, dtype=self._dtype)
        else:
            dense = jnp.full(shape, fill, dtype=self._dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_slice(self, index):
        new_chunks = []
        for ax, ind in enumerate(index):
            if isinstance(ind, Integral):
                continue
            if ind == slice(None):
                new_chunks.append(self.chunks_[ax])
            else:
                nc, _ = sliced_blockdim(self.chunks_[ax], ind)
                new_chunks.append(nc)
        return type(self)(tuple(new_chunks), self._dtype, self.fill_value)

    def _accept_rechunk(self, target_chunks):
        return type(self)(tuple(target_chunks), self._dtype, self.fill_value)

    def _accept_shuffle(self, shuffle_expr):
        # a reorder of a constant array is the same constant array with
        # the reorder's output grouping (serves Shuffle AND Take parents)
        chunks = list(self.chunks_)
        chunks[shuffle_expr.axis] = shuffle_expr.chunks[shuffle_expr.axis]
        return type(self)(tuple(chunks), self._dtype, self.fill_value)


class Ones(BroadcastTrick):
    _defaults = {**BroadcastTrick._defaults, "fill_value": 1}


class Zeros(BroadcastTrick):
    _defaults = {**BroadcastTrick._defaults, "fill_value": 0}


class Empty(BroadcastTrick):
    _defaults = {**BroadcastTrick._defaults, "fill_value": None}


class Full(BroadcastTrick):
    pass


def _wrap_shape(shape):
    if isinstance(shape, Integral):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _make(cls, shape, dtype, chunks, fill_value=None, meta=None, name=None):
    from dask_array_tpu._collection import new_collection

    shape = _wrap_shape(shape)
    dtype = np.dtype(dtype if dtype is not None else float)
    chunks = normalize_chunks(chunks, shape, dtype=dtype)
    if cls is Full:
        if fill_value is None:
            raise TypeError("full() requires a fill_value")
        if dtype is None:
            dtype = np.asarray(fill_value).dtype
        return new_collection(Full(chunks, dtype, fill_value, name))
    return new_collection(cls(chunks, dtype, name_=name))


def ones(shape, dtype=float, chunks="auto", name=None, meta=None):
    return _make(Ones, shape, dtype, chunks, name=name)


def zeros(shape, dtype=float, chunks="auto", name=None, meta=None):
    return _make(Zeros, shape, dtype, chunks, name=name)


def empty(shape, dtype=float, chunks="auto", name=None, meta=None):
    return _make(Empty, shape, dtype, chunks, name=name)


def full(shape, fill_value, dtype=None, chunks="auto", name=None, meta=None):
    if dtype is None:
        dtype = np.asarray(fill_value).dtype
    return _make(Full, shape, dtype, chunks, fill_value=fill_value, name=name)


def _like(maker, a, dtype=None, chunks=None, shape=None, **kw):
    import math

    from dask_array_tpu._collection import Array

    same_shape = shape is None
    if shape is None:
        shape = a.shape
    elif isinstance(shape, Integral):
        shape = (int(shape),)
    if dtype is None:
        dtype = a.dtype

    def _eq_dim(s, t):
        both_nan = (
            isinstance(s, float) and math.isnan(s) and isinstance(t, float) and math.isnan(t)
        )
        return both_nan or s == t

    same_shape = same_shape or (
        len(tuple(shape)) == len(a.shape)
        and all(_eq_dim(s, t) for s, t in zip(shape, a.shape))
    )
    if (
        isinstance(a, Array)
        and chunks is None
        and same_shape
        and any(isinstance(s, float) and math.isnan(s) for s in a.shape)
    ):
        # unknown (nan) chunks: build per-block on the source so the grid
        # carries over (reference: tests/test_creation.py::test_nan_zeros_ones_like)
        fill = kw.get("fill_value")
        if fill is None:
            fill = 1 if maker is ones else 0
        dt = np.dtype(dtype)

        def _block_fill(b):
            import jax.numpy as jnp

            return jnp.full(b.shape, fill, dtype=dt)

        return a.map_blocks(_block_fill, dtype=dt)

    if chunks is None:
        chunks = a.chunks if isinstance(a, Array) and shape == a.shape else "auto"
    return maker(shape, dtype=dtype, chunks=chunks, **kw)


def _check_like_order(order):
    # device arrays are C-layout; 'F' would silently lie about strides
    if order not in (None, "C", "K", "A"):
        raise NotImplementedError(f"order={order!r} is not supported (C layout only)")


def ones_like(a, dtype=None, order="C", chunks=None, name=None, shape=None):
    _check_like_order(order)
    return _like(ones, a, dtype, chunks, shape, name=name)


def zeros_like(a, dtype=None, order="C", chunks=None, name=None, shape=None):
    _check_like_order(order)
    return _like(zeros, a, dtype, chunks, shape, name=name)


def empty_like(a, dtype=None, order="C", chunks=None, name=None, shape=None):
    _check_like_order(order)
    return _like(empty, a, dtype, chunks, shape, name=name)


def full_like(a, fill_value, dtype=None, order="C", chunks=None, name=None, shape=None):
    _check_like_order(order)
    if dtype is None and hasattr(a, "dtype"):
        dtype = a.dtype
    return _like(full, a, dtype, chunks, shape, fill_value=fill_value, name=name)


# ---------------------------------------------------------------------------
# ranges
# ---------------------------------------------------------------------------


class Arange(ArrayExpr):
    """Lazy arange; generated on-device as an iota (parity:
    ``/root/reference/dask_array/creation/_arange.py``)."""

    _parameters = ("start", "stop", "step", "chunks_", "_dtype")

    _fusable_leaf = True

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,), dtype=self._dtype)

    def _build(self, ctx):
        import jax.numpy as jnp

        n = self.shape[0]
        idx = jnp.arange(n)
        dense = (self.start + idx * self.step).astype(self._dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_slice(self, index):
        (ind,) = index
        if isinstance(ind, Integral):
            return None  # 0-d result; leave to generic slicing
        n = self.shape[0]
        start, stop, step = ind.indices(n)
        new_start = self.start + start * self.step
        new_step = self.step * step
        count = max(0, -(-(stop - start) // step)) if step > 0 else max(0, -(-(start - stop) // -step))
        nc, _ = sliced_blockdim(self.chunks_[0], ind)
        return Arange(new_start, new_start + count * new_step, new_step, (nc,), self._dtype)

    def _accept_rechunk(self, target_chunks):
        return Arange(self.start, self.stop, self.step, tuple(target_chunks), self._dtype)

    def _accept_shuffle(self, shuffle_expr):
        # A reorder (Take/Shuffle) of an arithmetic progression is computed
        # directly from the host index array — the source iota never
        # materializes (an eager-lane take on a huge arange must not build
        # the full range; the trace lane relies on XLA folding iota+gather,
        # which also stops paying once the gather is a leaf).
        return _affine_reorder(shuffle_expr, self.start, self.step, self.shape[0], self._dtype)


def arange(start=0, stop=None, step=1, *, chunks="auto", like=None, dtype=None):
    from dask_array_tpu._collection import new_collection

    if stop is None:
        start, stop = 0, start
    num = int(max(0, math.ceil((stop - start) / step)))
    if dtype is None:
        # EMPTY probe: numpy's arange dtype depends only on the argument
        # TYPES, and a real (0, stop, step) probe can be astronomically long
        # (arange(0, 1e-6, 1e-9) must not materialize 1e9 host elements)
        dtype = np.arange(type(start)(0), type(stop)(0), type(step)(1)).dtype
    dtype = np.dtype(dtype)
    if dtype.kind in "iu" and not (
        float(start).is_integer() and float(step).is_integer()
    ):
        # numpy casts start/step to the requested INT dtype first (the
        # length still comes from the float arguments): arange(3.3, -9.1,
        # -0.25, dtype='i8') is fifty 3s (step truncates to 0)
        start, step = int(start), int(step)
        stop = start + num * step
    chunks = normalize_chunks(chunks, (num,), dtype=dtype)
    return new_collection(Arange(start, stop, step, chunks, dtype))


def _affine_reorder(shuffle_expr, start, step, n, dtype):
    """Serve a Take/Shuffle parent over an affine progression leaf by
    computing ``start + idx*step`` host-side (output-sized, same cost as
    shipping the index array the gather would need anyway)."""
    from dask_array_tpu.ops._from_array import FromArray

    idx = getattr(shuffle_expr, "_flat_index", None)
    if idx is None:
        idx = np.asarray(shuffle_expr.indices, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        return None  # out-of-range semantics stay with the real gather
    vals = np.ascontiguousarray((start + idx * step).astype(dtype))
    return FromArray(vals, (tuple(shuffle_expr.chunks[shuffle_expr.axis]),))


class Linspace(ArrayExpr):
    _parameters = ("start", "stop", "num", "endpoint", "chunks_", "_dtype")

    _fusable_leaf = True

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,), dtype=self._dtype)

    @property
    def _step(self):
        div = (self.num - 1) if self.endpoint else self.num
        return (self.stop - self.start) / max(1, div)

    def _build(self, ctx):
        import jax.numpy as jnp

        idx = jnp.arange(self.num)
        dense = (self.start + idx * self._step).astype(self._dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_rechunk(self, target_chunks):
        return Linspace(self.start, self.stop, self.num, self.endpoint, tuple(target_chunks), self._dtype)

    def _accept_slice(self, index):
        """A sliced linspace is an arithmetic progression: fold to Arange
        with the composed start/step (identical build formula start+idx*step,
        so values match exactly; parity: reference
        ``test_linspace_slice_pushdown``).  Length comes from the sliced
        chunk grid, never re-derived from the float stop."""
        (ind,) = index
        if isinstance(ind, Integral):
            return None
        n = self.num
        start, stop, step = ind.indices(n)
        st = self._step
        new_start = self.start + start * st
        new_step = st * step
        count = max(0, -(-(stop - start) // step)) if step > 0 else max(0, -(-(start - stop) // -step))
        nc, _ = sliced_blockdim(self.chunks_[0], ind)
        return Arange(new_start, new_start + count * new_step, new_step, (tuple(nc),), self._dtype)

    def _accept_shuffle(self, shuffle_expr):
        # same build formula as _build (start + idx*step), so values match
        return _affine_reorder(shuffle_expr, self.start, self._step, self.num, self._dtype)


def linspace(start, stop, num=50, endpoint=True, retstep=False, chunks="auto", dtype=None):
    from dask_array_tpu._collection import new_collection

    num = int(num)
    if dtype is None:
        dtype = np.linspace(0, 1, 1).dtype
    dtype = np.dtype(dtype)
    chunks = normalize_chunks(chunks, (num,), dtype=dtype)
    expr = Linspace(float(start), float(stop), num, bool(endpoint), chunks, dtype)
    from dask_array_tpu._collection import new_collection as _nc

    arr = _nc(expr)
    if retstep:
        return arr, expr._step
    return arr


class Eye(ArrayExpr):
    _parameters = ("N", "M", "k", "chunks_", "_dtype")

    _fusable_leaf = True

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=self._dtype)

    def _build(self, ctx):
        import jax.numpy as jnp

        dense = jnp.eye(self.N, self.M, k=self.k, dtype=self._dtype)
        return BlockView(self.chunks_, dense=dense)

    def _accept_rechunk(self, target_chunks):
        return Eye(self.N, self.M, self.k, tuple(target_chunks), self._dtype)


def eye(N, chunks="auto", M=None, k=0, dtype=float):
    from dask_array_tpu._collection import new_collection

    if M is None:
        M = N
    dtype = np.dtype(dtype)
    ch = normalize_chunks(chunks, (int(N), int(M)), dtype=dtype)
    return new_collection(Eye(int(N), int(M), int(k), ch, dtype))


# ---------------------------------------------------------------------------
# diag / diagonal / tri / pad / tile / repeat / meshgrid / indices / fromfunction
# ---------------------------------------------------------------------------


class Diag1D(ArrayExpr):
    """diag(v) for 1-d v: the k-offset diagonal matrix."""

    _parameters = ("array", "k")

    @functools.cached_property
    def chunks(self):
        n = self.array.shape[0] + abs(self.k)
        c = self.array.chunks[0]
        if self.k == 0:
            return (c, c)
        return ((n,), (n,))

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=self.array.dtype)

    def _build(self, ctx):
        import jax.numpy as jnp

        v = ctx.build(self.array).dense()
        return BlockView(self.chunks, dense=jnp.diag(v, k=self.k))


def diag(v, k=0):
    from dask_array_tpu._collection import Array, new_collection
    from dask_array_tpu.ops._from_array import asarray

    v = asarray(v)
    if v.ndim == 1:
        return new_collection(Diag1D(v.expr, int(k)))
    if v.ndim == 2:
        from dask_array_tpu.ops.routines import diagonal as _diagonal

        return _diagonal(v, offset=k)
    raise ValueError("Array must be 1d or 2d only")


def diagonal(a, offset=0, axis1=0, axis2=1):
    from dask_array_tpu.ops.routines import diagonal as _diagonal

    return _diagonal(a, offset=offset, axis1=axis1, axis2=axis2)


class Tri(ArrayExpr):
    _parameters = ("N", "M", "k", "chunks_", "_dtype")

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0, 0), dtype=self._dtype)

    def _build(self, ctx):
        import jax.numpy as jnp

        dense = jnp.tri(self.N, self.M, self.k, dtype=self._dtype)
        return BlockView(self.chunks_, dense=dense)


def tri(N, M=None, k=0, dtype=float, chunks="auto", *, like=None):
    from dask_array_tpu._collection import new_collection

    if M is None:
        M = N
    dtype = np.dtype(dtype)
    ch = normalize_chunks(chunks, (int(N), int(M)), dtype=dtype)
    return new_collection(Tri(int(N), int(M), int(k), ch, dtype))


class Pad(ArrayExpr):
    _parameters = ("array", "pad_width", "mode", "kwargs")
    _defaults = {"kwargs": ()}

    @functools.cached_property
    def chunks(self):
        # pad bands follow the adjacent edge chunk's size instead of gluing
        # into one band chunk (parity: reference test_pad_constant_chunksizes
        # — padding must not degrade the axis chunk profile)
        def band(width, edge, lo_side):
            if edge <= 0:
                return [width]
            k, rem = divmod(width, edge)
            pieces = [edge] * k
            if rem:
                pieces = [rem] + pieces if lo_side else pieces + [rem]
            return pieces

        out = []
        for ax, c in enumerate(self.array.chunks):
            lo, hi = self.pad_width[ax]
            axis = list(c)
            if lo:
                axis = band(lo, c[0] if c else 0, True) + axis
            if hi:
                axis = axis + band(hi, c[-1] if c else 0, False)
            out.append(tuple(axis) or (0,))
        return tuple(out)

    @property
    def _meta(self):
        return self.array._meta

    @property
    def _traceable(self):
        # a callable pad mode is arbitrary host code: run eagerly
        return not callable(self.mode)

    def _build(self, ctx):
        import jax.numpy as jnp

        dense = ctx.build(self.array).dense()
        kw = dict(self.kwargs or ())
        logical = np.dtype(self.dtype)
        from dask_array_tpu._chunks import host_only_dtype

        if callable(self.mode) or host_only_dtype(logical):
            # function modes are arbitrary host code; host-only dtypes
            # (str/object/structured) pad on the host lane
            out_np = np.pad(np.asarray(dense), self.pad_width, self.mode, **kw)
            if host_only_dtype(logical):
                return BlockView(self.chunks, dense=out_np)
            out = jnp.asarray(out_np)
        else:
            if logical.kind in "Mm" and "constant_values" in kw:
                # datetime shim: blocks are int64 ticks — convert the pad
                # value(s) through the logical unit to ticks
                def ticks(v):
                    if isinstance(v, (tuple, list)):
                        return type(v)(ticks(x) for x in v)
                    return int(np.asarray(v).astype(logical).view("i8"))

                kw["constant_values"] = ticks(kw["constant_values"])
            out = jnp.pad(dense, self.pad_width, mode=self.mode, **kw)
        from dask_array_tpu._chunks import device_dtype

        if out.dtype != device_dtype(self.dtype):
            out = out.astype(device_dtype(self.dtype))
        return BlockView(self.chunks, dense=out)


def pad(array, pad_width, mode="constant", **kwargs):
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._from_array import asarray

    array = asarray(array)
    # normalize pad_width to ((lo, hi), ...) per axis
    pw = np.asarray(pad_width)
    if pw.ndim == 0:
        norm = tuple((int(pw), int(pw)) for _ in range(array.ndim))
    elif pw.ndim == 1 and pw.shape == (2,):
        norm = tuple((int(pw[0]), int(pw[1])) for _ in range(array.ndim))
    elif pw.ndim == 1:
        norm = tuple((int(x), int(x)) for x in pw)
    else:
        norm = tuple((int(lo), int(hi)) for lo, hi in pw)
    if len(norm) != array.ndim:
        raise ValueError("pad_width does not match array ndim")
    if all(lo == 0 and hi == 0 for lo, hi in norm):
        # 0-width pad is the identity — return the INPUT collection
        # (reference test_pad_0_width: ``da_r is da_a``)
        return array
    kw = tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v) for k, v in kwargs.items()
    ))
    return new_collection(Pad(array.expr, norm, mode, kw))


def tile(A, reps):
    from dask_array_tpu.ops._from_array import asarray
    from dask_array_tpu.ops.stacking import concatenate

    A = asarray(A)
    if isinstance(reps, Integral):
        reps = (reps,)
    reps = tuple(int(r) for r in reps)
    if any(r < 0 for r in reps):
        raise ValueError("negative dimensions are not allowed")
    # prepend length-1 axes
    while A.ndim < len(reps):
        from dask_array_tpu.ops.manipulation import expand_dims

        A = expand_dims(A, 0)
    reps = (1,) * (A.ndim - len(reps)) + reps
    out = A
    for ax, r in enumerate(reps):
        if r == 1:
            continue
        if r == 0:
            out = out[tuple(slice(0, 0) if i == ax else slice(None) for i in range(out.ndim))]
            continue
        out = concatenate([out] * r, axis=ax)
    return out


class Repeat(ArrayExpr):
    _parameters = ("array", "repeats", "axis")

    @functools.cached_property
    def chunks(self):
        out = list(self.array.chunks)
        out[self.axis] = tuple(c * self.repeats for c in out[self.axis])
        return tuple(out)

    @property
    def _meta(self):
        return self.array._meta

    def _build(self, ctx):
        import jax.numpy as jnp

        dense = ctx.build(self.array).dense()
        return BlockView(self.chunks, dense=jnp.repeat(dense, self.repeats, axis=self.axis))


def repeat(a, repeats, axis=None):
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._from_array import asarray
    from dask_array_tpu._chunks import validate_axis

    a = asarray(a)
    if axis is None:
        a = a.ravel() if a.ndim != 1 else a
        axis = 0
    axis = validate_axis(axis, a.ndim)
    if not isinstance(repeats, Integral):
        from dask_array_tpu.ops._fancy_indexing import take

        rep = np.asarray(repeats)
        idx = np.repeat(np.arange(a.shape[axis]), rep)
        return take(a, idx, axis=axis)
    return new_collection(Repeat(a.expr, int(repeats), axis))


def meshgrid(*xi, sparse=False, indexing="xy", **kwargs):
    from dask_array_tpu.ops._from_array import asarray
    from dask_array_tpu.ops.manipulation import broadcast_to

    xi = [asarray(x) for x in xi]
    if indexing not in ("ij", "xy"):
        raise ValueError("indexing must be 'ij' or 'xy'")
    ndim = len(xi)
    order = list(range(ndim))
    if indexing == "xy" and ndim > 1:
        order[0], order[1] = order[1], order[0]
    shapes = [xi[i].shape[0] if xi[i].ndim else 1 for i in range(ndim)]
    full_shape = tuple(shapes[order[d]] for d in range(ndim))
    out = []
    for i, x in enumerate(xi):
        pos = order.index(i)
        shape_i = tuple(x.shape[0] if d == pos else 1 for d in range(ndim))
        xr = x.reshape(shape_i)
        if sparse:
            out.append(xr)
        else:
            out.append(broadcast_to(xr, full_shape))
    return out


def indices(dimensions, dtype=int, chunks="auto"):
    from dask_array_tpu.ops.manipulation import broadcast_to
    from dask_array_tpu.ops.stacking import stack

    dimensions = tuple(int(d) for d in dimensions)
    grids = []
    for i, d in enumerate(dimensions):
        if isinstance(chunks, str):
            axis_chunks = chunks
        elif isinstance(chunks, (tuple, list)) and len(chunks) == len(dimensions):
            axis_chunks = chunks[i]  # per-axis spec: this axis's entry
        else:
            axis_chunks = chunks
        r = arange(d, dtype=dtype, chunks=axis_chunks)
        shape_i = tuple(d if j == i else 1 for j in range(len(dimensions)))
        grids.append(broadcast_to(r.reshape(shape_i), dimensions))
    if not grids:
        from dask_array_tpu.ops._from_array import from_array

        return from_array(np.empty((0,), dtype=dtype))
    return stack(grids, axis=0)


def fromfunction(func, shape=None, chunks="auto", dtype=float, **kwargs):
    idx = indices(shape, dtype=dtype, chunks=chunks)
    from dask_array_tpu._blockwise import elemwise

    parts = [idx[i] for i in range(len(shape))]
    return elemwise(lambda *ix: func(*ix, **kwargs), *parts)
