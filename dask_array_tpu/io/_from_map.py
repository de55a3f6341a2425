"""from_map / from_delayed / from_blocks: build arrays from block-producing
host functions.

Parity: ``FromMap``/``from_delayed`` (``/root/reference/dask_array/io/
_from_map.py``, ``_from_delayed.py``) and the external-graph interop role of
``FromGraph`` (``_from_graph.py``) — fresh implementation.

Device note: the block-producing functions are *host* code (file readers,
loaders).  They run once at compute time on the host; each produced block is
bound as a jit argument, so the device program stays pure and the compiled
executable is reused across computes.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np

from dask_array_tpu._chunks import normalize_chunks
from dask_array_tpu._executor import BlockView, iter_block_indices
from dask_array_tpu._expr import ArrayExpr


class FromMap(ArrayExpr):
    """One host function call per block."""

    _parameters = ("func", "args_per_block", "chunks_", "_dtype", "kwargs", "name_", "opaque_")
    _defaults = {"kwargs": (), "name_": None, "opaque_": False}

    def _collection_name(self):
        return self.operand("name_") or self._name

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self._dtype)

    @functools.cached_property
    def _block_order(self):
        return list(iter_block_indices(tuple(len(c) for c in self.chunks_)))

    def _leaf_key(self, i):
        return f"frommap-{self._name}-{i}"

    def _leaf_buffers(self):
        kwargs = dict(self.kwargs or ())
        for i, args in enumerate(self.args_per_block):
            yield (self._leaf_key(i), _LazyBlock(self.func, args, kwargs))

    def _build(self, ctx):
        import jax.numpy as jnp

        blocks = {}
        resolved = [list(c) for c in self.chunks_]
        for i, idx in enumerate(self._block_order):
            val = ctx.leaf(self._leaf_key(i))
            if self.operand("opaque_"):
                # opaque payload blocks (store(load_stored=False): each block
                # IS the write target object) — no shape contract to enforce
                blocks[tuple(idx)] = val
                continue
            want = tuple(self.chunks_[ax][j] for ax, j in enumerate(idx))
            if any(w != w for w in want):  # nan dims: the declared shape is
                # unknown (from_delayed(shape=(nan,))) — adopt the produced
                # block's shape; the eager lane re-derives real chunks
                if len(val.shape) != len(want):
                    raise ValueError(
                        f"from_map block {tuple(idx)} has ndim {len(val.shape)}, "
                        f"expected {len(want)}"
                    )
                for ax, j in enumerate(idx):
                    size = int(val.shape[ax])
                    prev = resolved[ax][j]
                    if prev == prev and prev != size and not (
                        isinstance(prev, float)
                    ):
                        raise ValueError(
                            f"from_map block {tuple(idx)} axis {ax} has size "
                            f"{size}, inconsistent with {prev} from a sibling"
                        )
                    resolved[ax][j] = size
                blocks[tuple(idx)] = val
                continue
            if tuple(val.shape) != want:
                # unit-axis folds (expand_dims into the loader grid)
                # legitimately re-RANK blocks; anything that would reorder
                # elements (same size, permuted dims) is a user error the
                # reference also rejects (its test_from_map.py
                # rejects_reordering_shape_mismatch)
                if tuple(d for d in val.shape if d != 1) != tuple(
                    d for d in want if d != 1
                ):
                    raise ValueError(
                        f"from_map block {tuple(idx)} has shape {tuple(val.shape)}, "
                        f"incompatible with the declared chunk shape: expected {want}"
                    )
                val = jnp.reshape(val, want) if not isinstance(val, np.ndarray) else val.reshape(want)
            blocks[tuple(idx)] = val
        chunks = tuple(tuple(c) for c in resolved)
        return BlockView(chunks, blocks=blocks)

    def _structural_operands(self):
        # func/args only determine host-produced contents; the program shape
        # is fixed by the chunk grid + dtype
        from dask_array_tpu._chunks import dtype_key

        return [("frommap", dtype_key(self._dtype)), self.chunks_]

    def _accept_slice(self, index):
        """Cull untouched blocks (the IO payoff of slice pushdown: only the
        blocks a slice touches are host-loaded; parity with the reference's
        ``FromArray._accept_slice``, ``io/_from_array.py:446``)."""
        from dask_array_tpu._chunks import cached_cumsum
        from dask_array_tpu._slicing import Slice, is_basic_index, normalize_slice

        if not is_basic_index(index):
            return None
        keep_ranges = []
        residual = []
        outer = []
        any_cull = False
        for ax, ind in enumerate(index):
            c = self.chunks_[ax]
            dim = sum(c)
            if isinstance(ind, Integral):
                ind = slice(int(ind), int(ind) + 1, 1)
                outer.append(0)
            else:
                outer.append(slice(None))
            sl = normalize_slice(ind, dim)
            start, stop, step = sl.indices(dim)
            if step != 1 or stop <= start:
                return None  # strided/empty: keep the slice above
            bounds = cached_cumsum(c, initial_zero=True)
            b0 = int(np.searchsorted(bounds, start, side="right")) - 1
            b1 = int(np.searchsorted(bounds, stop, side="left"))
            keep_ranges.append(range(b0, b1))
            if b0 > 0 or b1 < len(c):
                any_cull = True
            off = int(bounds[b0])
            residual.append(slice(start - off, stop - off, 1))
        if not any_cull:
            return None
        new_chunks = tuple(
            tuple(self.chunks_[ax][i] for i in r) for ax, r in enumerate(keep_ranges)
        )
        grid = tuple(len(c) for c in self.chunks_)
        kept_args = []
        for flat, idx in enumerate(iter_block_indices(grid)):
            if all(idx[ax] in keep_ranges[ax] for ax in range(len(grid))):
                kept_args.append(self.args_per_block[flat])
        culled = FromMap(
            self.func, tuple(kept_args), new_chunks, self._dtype, self.kwargs,
            None, self.operand("opaque_"),
        )
        out = culled
        if any(
            r != slice(0, sum(c), 1) for r, c in zip(residual, new_chunks)
        ):
            out = Slice(out, tuple(residual))
        if any(isinstance(o, Integral) for o in outer):
            out = Slice(out, tuple(outer))
        return out


def fm_pinned(fm):
    """True when a FromMap leaf must not be rewritten/merged: a user-supplied
    name pins its identity (reference: named from_delayed stays as built)
    and opaque payload blocks have no reshape/merge semantics."""
    return fm.operand("name_") is not None or bool(fm.operand("opaque_"))


class _LazyBlock:
    """Host buffer produced on demand (when the executor binds leaves)."""

    __slots__ = ("func", "args", "kwargs", "_value")

    def __init__(self, func, args, kwargs):
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self._value = None

    def materialize(self):
        if self._value is None:
            out = self.func(
                *[_resolve_delayed(a) for a in self.args],
                **{k: _resolve_delayed(v) for k, v in self.kwargs.items()},
            )
            self._value = np.asarray(out)
        return self._value


def _resolve_delayed(v):
    """Recursively compute nested ``Delayed`` arguments (the reference
    consumes multi-task dask.delayed bodies; ours resolves sub-calls at
    host-materialization time)."""
    if isinstance(v, Delayed):
        return v.compute()
    if isinstance(v, tuple):
        return tuple(_resolve_delayed(x) for x in v)
    if isinstance(v, list):
        return [_resolve_delayed(x) for x in v]
    return v


def from_map(func, *iterables, chunks=None, shape=None, args=None, dtype=None, meta=None, name=None, _opaque=False, **kwargs):
    """Create an Array from a function applied to each element of iterables.

    Each call produces one block (blocks stack along axis 0 unless
    ``chunks``+``shape`` describe a full grid).
    """
    from dask_array_tpu._collection import new_collection

    if (
        len(iterables) == 1
        and isinstance(iterables[0], np.ndarray)
        and iterables[0].dtype == object
    ):
        # reference form: a single object ndarray whose SHAPE is the block
        # grid (values[idx] is block idx's argument) — N-D native, 0-d ok
        # (/root/reference/dask_array/tests/test_from_map.py:130-180)
        values = iterables[0]
        if chunks is None:
            raise ValueError(
                "from_map with an object values grid requires chunks="
            )
        if shape is not None:
            chunks = normalize_chunks(chunks, shape, dtype=dtype)
        chunks = tuple(tuple(int(x) for x in c) for c in chunks)
        grid = tuple(len(c) for c in chunks)
        if values.shape != grid:
            raise ValueError(
                f"from_map values grid {values.shape} does not match the "
                f"block grid {grid} implied by chunks"
            )
        call_args = tuple(
            (v,) + tuple(args or ()) for v in values.ravel(order="C")
        )
        if dtype is None:
            dtype = np.asarray(func(*call_args[0], **kwargs)).dtype
        return new_collection(
            FromMap(
                func, call_args, chunks, np.dtype(dtype),
                tuple(sorted(kwargs.items())), name, _opaque,
            )
        )

    iterables = [list(it) for it in iterables]
    if not iterables:
        raise ValueError("from_map requires at least one iterable")
    n = len(iterables[0])
    if not all(len(it) == n for it in iterables):
        raise ValueError("All iterables must have the same length")
    call_args = [tuple(it[i] for it in iterables) + tuple(args or ()) for i in range(n)]

    if dtype is None or chunks is None:
        probe = np.asarray(func(*call_args[0], **kwargs))
        if dtype is None:
            dtype = probe.dtype
        if chunks is None:
            # blocks concatenate along axis 0 (shape, if given, must agree)
            bshape = probe.shape
            chunks = ((bshape[0],) * n,) + tuple((s,) for s in bshape[1:])
            if shape is not None and tuple(shape) != tuple(
                sum(c) for c in chunks
            ):
                raise ValueError(
                    f"from_map: shape={shape} does not match the {n} stacked "
                    f"probe blocks of shape {bshape}; pass chunks= explicitly"
                )
    dtype = np.dtype(dtype)
    if shape is not None:
        chunks = normalize_chunks(chunks, shape, dtype=dtype)
    else:
        # chunks without shape must already be explicit tuples-of-tuples
        if not all(isinstance(c, (tuple, list)) for c in chunks):
            raise ValueError(
                "from_map: chunks given without shape= must be explicit "
                "per-axis tuples, e.g. chunks=((4, 4), (6,))"
            )
        chunks = tuple(tuple(int(x) for x in c) for c in chunks)
    nblocks = int(np.prod([len(c) for c in chunks]))
    if nblocks != n:
        raise ValueError(
            f"from_map got {n} calls but the chunk grid has {nblocks} blocks"
        )
    return new_collection(
        FromMap(func, tuple(call_args), tuple(chunks), dtype, tuple(sorted(kwargs.items())), name, _opaque)
    )


class Delayed:
    """A tiny delayed-call handle (the reference consumes dask.delayed)."""

    __slots__ = ("func", "args", "kwargs", "_key")

    def __init__(self, func, args=(), kwargs=None, key=None):
        self.func = func
        self.args = args
        self.kwargs = kwargs or {}
        self._key = key

    def compute(self):
        return self.func(
            *[_resolve_delayed(a) for a in self.args],
            **{k: _resolve_delayed(v) for k, v in self.kwargs.items()},
        )


def delayed(func, *args, **kwargs):
    if args or kwargs:
        return Delayed(func, args, kwargs)

    def wrap(*a, **kw):
        return Delayed(func, a, kw)

    return wrap


def from_delayed(value, shape, dtype=None, meta=None, name=None):
    """Create an Array (single block) from a delayed/callable value."""
    if isinstance(value, Delayed):
        fn, args, kw = value.func, value.args, value.kwargs
    elif callable(value):
        fn, args, kw = value, (), {}
    else:
        raise TypeError("from_delayed expects a Delayed or a callable")
    if dtype is None:
        raise ValueError("from_delayed requires an explicit dtype")
    from dask_array_tpu._collection import new_collection

    chunks = tuple((s,) for s in shape)
    return new_collection(
        FromMap(fn, (tuple(args),), chunks, np.dtype(dtype), tuple(sorted(kw.items())), name)
    )


def from_blocks(blocks: dict, chunks, dtype=None, name=None):
    """External-graph interop: wrap precomputed blocks {idx: array-like}.

    The analog of the reference's ``from_graph`` (``io/_from_graph.py``) for
    a scheduler-less runtime: the caller supplies every block directly.
    """
    from dask_array_tpu._collection import new_collection

    first = next(iter(blocks.values()))
    if dtype is None:
        dtype = np.asarray(first).dtype
    chunks = tuple(tuple(c) for c in chunks)
    order = list(iter_block_indices(tuple(len(c) for c in chunks)))
    missing = [idx for idx in order if tuple(idx) not in blocks]
    if missing:
        raise ValueError(f"from_blocks: missing blocks {missing[:4]}...")
    args = tuple((tuple(idx),) for idx in order)
    getter = _BlockGetter({tuple(k): v for k, v in blocks.items()})
    return new_collection(FromMap(getter, args, chunks, np.dtype(dtype), ()))


class _BlockGetter:
    def __init__(self, blocks):
        self.blocks = blocks

    def __call__(self, idx):
        return self.blocks[idx]
