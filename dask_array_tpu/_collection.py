"""The user-facing ``Array`` collection.

Parity: ``Array`` in ``/root/reference/dask_array/_collection.py`` (fresh
implementation): a thin immutable wrapper around one ``ArrayExpr`` with
numpy-style operators/methods, NEP-13/18 interop, and compute/persist.

Name stability contract (reference ``RootAlias`` machinery,
``_expr.py:1061``): ``Array.name`` is the *raw* expression's name and never
changes under optimization; ``persist()`` pins its result leaf to the same
name, so downstream identity (caching, keying) survives optimization.
"""

from __future__ import annotations

import functools
from numbers import Integral, Number

import numpy as np

from dask_array_tpu._expr import ArrayExpr
from dask_array_tpu._chunks import has_unknown_chunks


def new_collection(expr: ArrayExpr) -> "Array":
    """Wrap an expression as a user-facing :class:`Array` (cycle-free
    constructor; reference ``_new_collection.py:6``)."""
    return Array(expr)


def handle_out(out, result: "Array") -> "Array":
    """numpy-style ``out=`` for lazy results (reference ``handle_out``,
    ``_collection.py``): ``out`` must be an ``Array``; its expression is
    replaced in place with the (dtype-cast) result's."""
    if isinstance(out, tuple):
        if len(out) == 1:
            out = out[0]
        elif len(out) > 1:
            raise NotImplementedError("The out parameter is not fully supported")
        else:
            out = None
    if out is None:
        return result
    if not isinstance(out, Array):
        raise NotImplementedError(
            f"The out parameter is not fully supported. Received type "
            f"{type(out).__name__}, expected dask Array"
        )
    if out.shape != result.shape:
        raise ValueError(
            "Mismatched shapes between result and out parameter. "
            f"out={out.shape}, result={result.shape}"
        )
    if out.dtype != result.dtype:
        result = result.astype(out.dtype)
    out._replace_expr(result.expr)
    return out


class Persisted(ArrayExpr):
    """A computed on-device buffer pinned to the original collection name."""

    _parameters = ("buffer", "chunks_", "pinned_name", "dtype_")
    _defaults = {"dtype_": None}

    _fusable_leaf = True

    @property
    def _name(self):  # type: ignore[override]
        return self.pinned_name

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        # dtype_ carries the logical dtype when it differs from the device
        # buffer's (datetime shim: M8/m8 buffers live on device as int64)
        dt = np.dtype(self.dtype_) if self.dtype_ is not None else np.dtype(self.buffer.dtype)
        return np.empty((0,) * len(self.chunks_), dtype=dt)

    def _leaf_buffers(self):
        yield (f"persist-{self.pinned_name}", self.buffer)

    def _structural_operands(self):
        from dask_array_tpu._chunks import dtype_key

        return [("buf", dtype_key(self.buffer.dtype), dtype_key(self._meta.dtype)), self.chunks_]

    def _build(self, ctx):
        from dask_array_tpu._executor import BlockView

        return BlockView(self.chunks_, dense=ctx.leaf(f"persist-{self.pinned_name}"))


class Array:
    __slots__ = ("_expr", "__weakref__")

    def __init__(self, expr: ArrayExpr):
        if not isinstance(expr, ArrayExpr):
            raise TypeError(f"Array() takes an ArrayExpr, got {type(expr)}")
        object.__setattr__(self, "_expr", expr)

    def __reduce__(self):
        return (Array, (self._expr,))

    # -- expression / metadata ------------------------------------------------

    @property
    def expr(self) -> ArrayExpr:
        return self._expr

    def _replace_expr(self, expr: ArrayExpr):
        object.__setattr__(self, "_expr", expr)

    @property
    def name(self) -> str:
        return self._expr._collection_name()

    @property
    def _meta(self):
        return self._expr._meta

    @property
    def dtype(self):
        return self._expr.dtype

    @property
    def shape(self):
        return self._expr.shape

    @property
    def chunks(self):
        return self._expr.chunks

    @property
    def chunksize(self):
        return self._expr.chunksize

    @property
    def ndim(self):
        return self._expr.ndim

    @property
    def size(self):
        return self._expr.size

    @property
    def nbytes(self):
        return self._expr.nbytes

    @property
    def itemsize(self):
        return self.dtype.itemsize

    @property
    def numblocks(self):
        return self._expr.numblocks

    @property
    def npartitions(self):
        return self._expr.npartitions

    @property
    def blocks(self):
        from dask_array_tpu.ops._blocks import BlockAccessor

        return BlockAccessor(self)

    @property
    def vindex(self):
        from dask_array_tpu.ops._fancy_indexing import VIndexAccessor

        return VIndexAccessor(self)

    @property
    def T(self):
        from dask_array_tpu.ops.manipulation import transpose

        return transpose(self)

    @property
    def real(self):
        from dask_array_tpu.ops.ufuncs import real

        return real(self)

    @property
    def imag(self):
        from dask_array_tpu.ops.ufuncs import imag

        return imag(self)

    def __len__(self):
        s = self.shape
        if not s:
            raise TypeError("len() of unsized object")
        if isinstance(s[0], float) and np.isnan(s[0]):
            raise ValueError(
                "Cannot call len() on array with unknown chunk sizes; call compute_chunk_sizes() first"
            )
        return int(s[0])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an array with more than one element is ambiguous.")
        return bool(self.compute())

    def __int__(self):
        return int(self.compute())

    def __float__(self):
        return float(self.compute())

    def __complex__(self):
        return complex(self.compute())

    def __index__(self):
        return int(self.compute())

    def __repr__(self):
        return (
            f"dask_array_tpu.Array<{self.name[:20]}..., shape={self.shape}, "
            f"dtype={self.dtype}, chunksize={self.chunksize}, chunks={len(self.chunks)}d>"
        )

    def pprint(self):
        self._expr.pprint()

    # -- compute / persist ------------------------------------------------------

    def optimize(self, fuse: bool = True) -> "Array":
        from dask_array_tpu._materialize import optimize_expr

        return new_collection(optimize_expr(self._expr, fuse=fuse))

    def simplify(self) -> "Array":
        """Rewrite-only optimization (no lowering/fusion); parity:
        reference ``Array.simplify`` (``_collection.py:327``)."""
        return new_collection(self._expr.simplify())

    @property
    def partitions(self):
        """Slice by partitions; alias of ``.blocks`` (parity:
        ``_collection.py:475``)."""
        return self.blocks

    @property
    def A(self):
        # np.matrix-era compatibility shim (parity: ``_collection.py:960``)
        return self

    def transfer_bytes(self):
        """Estimated (min, max) inter-device bytes moved by the ROOT node's
        incoming edges (parity: ``_collection.py:494``); sum over the
        optimized tree for a whole-computation estimate."""
        return self._expr.transfer_bytes()

    def to_svg(self, size=500):
        """SVG image of the chunk grid (parity: ``_collection.py:1199``)."""
        from dask_array_tpu._svg import array_svg

        return array_svg(self.chunks)

    def to_backend(self, backend=None, **kwargs):
        """Move to a named array backend.  This framework has ONE device
        backend (jax), so the default/'jax' names return self;
        anything else is unknown (parity: ``_collection.py:1182`` — the
        reference moves numpy<->cupy here)."""
        if backend in (None, "jax", "dask_array_tpu"):
            return self
        raise ValueError(f"unknown array backend {backend!r}")

    def to_tiledb(self, uri, *args, **kwargs):
        from dask_array_tpu.io._tiledb import to_tiledb

        return to_tiledb(self, uri, *args, **kwargs)

    def to_dask_dataframe(self, columns=None, index=None, meta=None):
        # requires the dask.dataframe library, not installable in this image
        raise ImportError(
            "to_dask_dataframe requires dask[dataframe], which is not "
            "available; compute() to numpy and build the frame from that"
        )

    @property
    def dask(self):
        """Lazy block mapping {(name, i, j, ...): lazy block Array}.

        The reference's ``.dask`` exports the task graph
        (``_collection.py:184``); this runtime has no task layer, so the
        interop export is one LAZY sub-Array per block — the inverse of
        ``io.from_blocks``.  Nothing computes until a block is computed.
        """
        from dask_array_tpu._executor import iter_block_indices

        name = self._expr._name
        return {
            (name, *idx): self.blocks[idx]
            for idx in iter_block_indices(self.numblocks)
        }

    def compute(self, **kwargs):
        from dask_array_tpu._materialize import compute_to_numpy

        out = compute_to_numpy(self._expr)
        if out.ndim == 0:
            return out[()]
        return out

    def compute_device(self):
        """Compute and keep the result on-device (a dense jax.Array)."""
        from dask_array_tpu._materialize import compute_expr

        return compute_expr(self._expr)

    def persist(self, **kwargs) -> "Array":
        from dask_array_tpu._materialize import compute_expr

        buf = compute_expr(self._expr)
        if has_unknown_chunks(self.chunks):
            # real shapes are now known: adopt one chunk per formerly-unknown axis
            chunks = tuple(
                c if not any(np.isnan(x) for x in c) else (s,)
                for c, s in zip(self.chunks, buf.shape)
            )
        else:
            chunks = self.chunks
        dt = self.dtype
        logical = dt if np.dtype(getattr(buf, "dtype", dt)) != np.dtype(dt) else None
        return new_collection(Persisted(buf, chunks, self.name, logical))

    def visualize(self, *args, **kwargs):
        from dask_array_tpu._diagnostics import expr_table

        return expr_table(self)

    def explain(self, **kwargs):
        from dask_array_tpu._diagnostics import explain

        return explain(self, **kwargs)

    def _repr_html_(self):
        from dask_array_tpu._svg import repr_html

        return repr_html(self)

    def __array__(self, dtype=None, copy=None):
        out = self.compute()
        out = np.asarray(out)
        if dtype is not None and out.dtype != dtype:
            out = out.astype(dtype)
        return out

    # -- numpy protocol interop ---------------------------------------------------

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        from dask_array_tpu.ops.ufuncs import wrap_numpy_ufunc

        if method == "reduce":
            from dask_array_tpu.ops import reductions as _red

            mapping = {
                "add": _red.sum,
                "multiply": _red.prod,
                "maximum": _red.max,
                "minimum": _red.min,
                "logical_or": _red.any,
                "logical_and": _red.all,
            }
            fn = mapping.get(getattr(ufunc, "__name__", None))
            if fn is None or len(inputs) != 1:
                return NotImplemented
            if kwargs.get("out") is not None:
                # numpy's reduce contract WRITES out; we can't honor that
                # lazily — decline so numpy raises instead of silently
                # leaving the buffer unwritten
                return NotImplemented
            kwargs.pop("out", None)
            kwargs.setdefault("axis", 0)  # numpy's ufunc.reduce default
            return fn(inputs[0], **kwargs)
        if method == "outer":
            # reference: __array_ufunc__ routes outer to the wrapped
            # ufunc's .outer (_collection.py:1728)
            from dask_array_tpu.ops import ufuncs as _uf

            da_ufunc = getattr(_uf, getattr(ufunc, "__name__", ""), None)
            if da_ufunc is None or not hasattr(da_ufunc, "outer"):
                return NotImplemented
            return da_ufunc.outer(*inputs, **kwargs)
        if method != "__call__":
            return NotImplemented
        out = kwargs.pop("out", None)
        if out is not None:
            if isinstance(out, tuple):
                if len(out) != 1:
                    return NotImplemented
                out = out[0]
            kwargs["out"] = out
        f = wrap_numpy_ufunc(ufunc)
        if f is None:
            return NotImplemented
        return f(*inputs, **kwargs)

    def __array_function__(self, func, types, args, kwargs):
        from dask_array_tpu._dispatch import lookup_array_function

        impl = lookup_array_function(func)
        if impl is None:
            return NotImplemented
        return impl(*args, **kwargs)

    # -- indexing ---------------------------------------------------------------

    def __getitem__(self, index):
        from dask_array_tpu.ops._getitem import getitem_router

        return getitem_router(self, index)

    def __setitem__(self, index, value):
        from dask_array_tpu.ops._setitem import setitem

        result = setitem(self, index, value)
        self._replace_expr(result.expr)

    # -- operators ---------------------------------------------------------------

    def _binop(self, op, other, reflexive=False):
        from dask_array_tpu._blockwise import elemwise

        if isinstance(other, (list, tuple, np.ndarray)):
            from dask_array_tpu.ops._from_array import asarray

            other = asarray(other)
        elif not isinstance(other, (Array, Number, np.generic)) and not hasattr(other, "dtype"):
            return NotImplemented
        if reflexive:
            return elemwise(op, other, self)
        return elemwise(op, self, other)

    # arithmetic
    def __add__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.add, other)

    def __radd__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.add, other, reflexive=True)

    def __sub__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.subtract, other)

    def __rsub__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.subtract, other, reflexive=True)

    def __mul__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.multiply, other)

    def __rmul__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.multiply, other, reflexive=True)

    def __truediv__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.true_divide, other)

    def __rtruediv__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.true_divide, other, reflexive=True)

    def __floordiv__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.floor_divide, other)

    def __rfloordiv__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.floor_divide, other, reflexive=True)

    def __mod__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.mod, other)

    def __rmod__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.mod, other, reflexive=True)

    def __divmod__(self, other):
        return (self // other, self % other)

    def __rdivmod__(self, other):
        return (self.__rfloordiv__(other), self.__rmod__(other))

    def __pow__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.power, other)

    def __rpow__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.power, other, reflexive=True)

    def __matmul__(self, other):
        from dask_array_tpu.ops.linalg import matmul

        return matmul(self, other)

    def __rmatmul__(self, other):
        from dask_array_tpu.ops.linalg import matmul

        return matmul(other, self)

    # comparisons
    def __lt__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.less, other)

    def __le__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.less_equal, other)

    def __gt__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.greater, other)

    def __ge__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.greater_equal, other)

    def __eq__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.equal, other)

    def __ne__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.not_equal, other)

    def __hash__(self):
        return hash(self.name)

    # bitwise
    def __and__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.bitwise_and, other)

    def __rand__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.bitwise_and, other, reflexive=True)

    def __or__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.bitwise_or, other)

    def __ror__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.bitwise_or, other, reflexive=True)

    def __xor__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.bitwise_xor, other)

    def __rxor__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.bitwise_xor, other, reflexive=True)

    def __lshift__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.left_shift, other)

    def __rlshift__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.left_shift, other, reflexive=True)

    def __rshift__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.right_shift, other)

    def __rrshift__(self, other):
        import jax.numpy as jnp

        return self._binop(jnp.right_shift, other, reflexive=True)

    # unary
    def __neg__(self):
        import jax.numpy as jnp

        from dask_array_tpu._blockwise import elemwise

        return elemwise(jnp.negative, self)

    def __pos__(self):
        return self

    def __abs__(self):
        import jax.numpy as jnp

        from dask_array_tpu._blockwise import elemwise

        return elemwise(jnp.abs, self)

    def __invert__(self):
        import jax.numpy as jnp

        from dask_array_tpu._blockwise import elemwise

        return elemwise(jnp.invert, self)

    # -- methods (delegate to op modules) -------------------------------------------

    def astype(self, dtype, **kwargs):
        from dask_array_tpu.ops._casting import astype_expr

        return new_collection(astype_expr(self._expr, dtype))

    def rechunk(self, chunks="auto", threshold=None, block_size_limit=None, balance=False, method=None):
        from dask_array_tpu._rechunk import rechunk

        return rechunk(self, chunks, threshold=threshold, block_size_limit=block_size_limit, balance=balance, method=method)

    def transpose(self, *axes):
        from dask_array_tpu.ops.manipulation import transpose

        if not axes:
            axes = None
        elif len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = axes[0]
        return transpose(self, axes)

    def reshape(self, *shape, merge_chunks=True, limit=None, order="C"):
        from dask_array_tpu.ops._reshape import reshape

        if order not in (None, "C"):
            # device arrays are C-layout (parity: the reference accepts only
            # the C keyword too, test_reshape_accepts_c_order_keyword)
            raise NotImplementedError(f"reshape(order={order!r}) is not supported")
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = shape[0]
        return reshape(self, shape, merge_chunks=merge_chunks, limit=limit)

    def ravel(self):
        from dask_array_tpu.ops._reshape import ravel

        return ravel(self)

    def flatten(self):
        return self.ravel()

    def squeeze(self, axis=None):
        from dask_array_tpu.ops.manipulation import squeeze

        return squeeze(self, axis)

    def swapaxes(self, axis1, axis2):
        from dask_array_tpu.ops.manipulation import swapaxes

        return swapaxes(self, axis1, axis2)

    def repeat(self, repeats, axis=None):
        from dask_array_tpu.ops.creation import repeat

        return repeat(self, repeats, axis=axis)

    def round(self, decimals=0):
        from dask_array_tpu.ops.routines import round as _round

        return _round(self, decimals)

    def clip(self, min=None, max=None):
        from dask_array_tpu.ops.ufuncs import clip

        return clip(self, min, max)

    def conj(self):
        from dask_array_tpu.ops.ufuncs import conj

        return conj(self)

    def dot(self, other):
        from dask_array_tpu.ops.linalg import dot

        return dot(self, other)

    def choose(self, choices):
        from dask_array_tpu.ops.routines import choose

        return choose(self, choices)

    def copy(self):
        return new_collection(self._expr)

    def to_delayed(self, optimize_graph=True):
        """An object-array of per-block Delayed handles."""
        import itertools

        from dask_array_tpu.io._from_map import Delayed

        out = np.empty(self.numblocks, dtype=object)
        for idx in itertools.product(*(range(n) for n in self.numblocks)):
            block = self.blocks[idx]
            out[idx] = Delayed(block.compute)
        return out

    def item(self):
        return self.compute().item()

    def tolist(self):
        return np.asarray(self.compute()).tolist()

    def view(self, dtype=None, order="C"):
        from dask_array_tpu.ops._view import view

        return view(self, dtype, order)

    def nonzero(self):
        from dask_array_tpu.ops.routines import nonzero

        return nonzero(self)

    def store(self, targets, **kwargs):
        from dask_array_tpu.io._store import store

        return store(self, targets, **kwargs)

    def to_zarr(self, *args, **kwargs):
        from dask_array_tpu.io._zarr import to_zarr

        return to_zarr(self, *args, **kwargs)

    def to_hdf5(self, filename, datapath, **kwargs):
        from dask_array_tpu.io._store import to_hdf5

        return to_hdf5(filename, datapath, self, **kwargs)

    def map_blocks(self, func, *args, **kwargs):
        from dask_array_tpu.ops._map_blocks import map_blocks

        return map_blocks(func, self, *args, **kwargs)

    def map_overlap(self, func, depth, boundary=None, trim=True, **kwargs):
        from dask_array_tpu.ops._overlap import map_overlap

        return map_overlap(func, self, depth=depth, boundary=boundary, trim=trim, **kwargs)

    def freeze_chunks(self):
        """Pin the current chunking as load-bearing: the optimizer may
        rewrite the subtree, but this collection's layout survives."""
        from dask_array_tpu.ops._map_blocks import ChunksFreeze, freeze

        if type(self._expr) is ChunksFreeze:
            return self
        return new_collection(freeze(self._expr))

    def compute_chunk_sizes(self):
        """Compute unknown (nan) chunk sizes (materializes the array).

        Preserves the block GRID: each formerly-unknown chunk adopts the
        concrete size of its computed block (parity: reference
        ``_collection.py:415``), rather than collapsing the axis to one
        chunk.
        """
        if not has_unknown_chunks(self.chunks):
            return self
        from dask_array_tpu._executor import execute
        from dask_array_tpu._materialize import optimize_expr
        from dask_array_tpu.io._from_map import from_blocks

        view = execute(optimize_expr(self._expr), want_view=True)
        if view._blocks is None:
            # the root assembled densely; the per-block structure is gone —
            # the array IS one piece now, so one chunk per axis is exact
            dense = view.dense()
            from dask_array_tpu.ops._from_array import from_array

            return from_array(dense, chunks=dense.shape)
        blocks = view.blocks_dict()
        nb = view.numblocks
        chunks = tuple(
            tuple(
                int(blocks[tuple(i if d == ax else 0 for d in range(len(nb)))].shape[ax])
                for i in range(nb[ax])
            )
            for ax in range(len(nb))
        )
        return from_blocks(blocks, chunks, dtype=self.dtype)

    def shuffle(self, indexer, axis=0, chunks="auto"):
        from dask_array_tpu._shuffle import shuffle

        return shuffle(self, indexer, axis=axis, chunks=chunks)

    def topk(self, k, axis=-1, split_every=None):
        from dask_array_tpu.ops.routines import topk

        return topk(self, k, axis=axis, split_every=split_every)

    def argtopk(self, k, axis=-1, split_every=None):
        from dask_array_tpu.ops.routines import argtopk

        return argtopk(self, k, axis=axis, split_every=split_every)

    def trace(self, offset=0, axis1=0, axis2=1, dtype=None):
        from dask_array_tpu.ops.reductions import trace

        return trace(self, offset=offset, axis1=axis1, axis2=axis2, dtype=dtype)

    # -- reductions -------------------------------------------------------------------

    def sum(self, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import sum as _sum

        return _sum(self, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every, out=out)

    def prod(self, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import prod as _prod

        return _prod(self, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every, out=out)

    def mean(self, axis=None, dtype=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import mean as _mean

        return _mean(self, axis=axis, dtype=dtype, keepdims=keepdims, split_every=split_every, out=out)

    def std(self, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import std as _std

        return _std(self, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every, out=out)

    def var(self, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import var as _var

        return _var(self, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every, out=out)

    def min(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import min as _min

        return _min(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def max(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import max as _max

        return _max(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def any(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import any as _any

        return _any(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def all(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import all as _all

        return _all(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def argmin(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import argmin as _argmin

        return _argmin(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def argmax(self, axis=None, keepdims=False, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import argmax as _argmax

        return _argmax(self, axis=axis, keepdims=keepdims, split_every=split_every, out=out)

    def cumsum(self, axis=None, dtype=None, method="sequential", out=None):
        from dask_array_tpu.ops.reductions import cumsum as _cumsum

        return _cumsum(self, axis=axis, dtype=dtype, method=method, out=out)

    def cumprod(self, axis=None, dtype=None, method="sequential", out=None):
        from dask_array_tpu.ops.reductions import cumprod as _cumprod

        return _cumprod(self, axis=axis, dtype=dtype, method=method, out=out)

    def moment(self, order, axis=None, dtype=None, keepdims=False, ddof=0, split_every=None, out=None):
        from dask_array_tpu.ops.reductions import moment as _moment

        return _moment(self, order, axis=axis, dtype=dtype, keepdims=keepdims, ddof=ddof, split_every=split_every, out=out)
