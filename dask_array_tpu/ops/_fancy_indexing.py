"""Fancy indexing: integer-array take, boolean masks, vindex.

Parity: ``/root/reference/dask_array/slicing/`` (``_basic.py`` int-array
routing, ``_bool_index.py``, ``_vindex.py``) — fresh implementation.

Device notes: integer-array take is a dense gather (XLA ``gather`` HLO);
boolean masking produces data-dependent shapes, so those nodes are marked
untraceable and the executor computes them eagerly (the reference's
"nan chunks" contract: metadata stays unknown until compute_chunk_sizes).
"""

from __future__ import annotations

import functools
import math
from numbers import Integral

import numpy as np

from dask_array_tpu._chunks import validate_axis
from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr
from dask_array_tpu._slicing import Slice, is_basic_index


class Take(ArrayExpr):
    """Integer-array indexing along one axis (dense gather)."""

    _parameters = ("array", "indices", "axis", "out_chunks_axis")

    @functools.cached_property
    def chunks(self):
        chunks = list(self.array.chunks)
        chunks[self.axis] = self.out_chunks_axis
        return tuple(chunks)

    @property
    def _meta(self):
        return self.array._meta

    def _rebase(self, child, axis=None):
        """Same reorder on a different child (the Shuffle/Take pushdown
        protocol — see Shuffle._rebase)."""
        return Take(
            child,
            self.indices,
            self.axis if axis is None else axis,
            self.out_chunks_axis,
        )

    def _simplify_down(self):
        n = self.array.shape[self.axis]
        idx = np.asarray(self.indices)
        # identity take (same order) disappears; if only the chunk grid
        # differs it degrades to a relayout (reference
        # test_take_sorted_indexer aliases every block — a Rechunk is this
        # framework's alias-or-collective equivalent, never a gather)
        if (
            isinstance(n, (int, np.integer))
            and len(idx) == n
            and np.array_equal(idx, np.arange(n))
        ):
            if self.chunks == self.array.chunks:
                return self.array
            from dask_array_tpu._rechunk import Rechunk

            return Rechunk(self.array, self.chunks)
        # take-of-take on one axis composes: x[i1][i2] == x[i1[i2]]
        if type(self.array) is Take and self.array.axis == self.axis:
            inner = self.array
            composed = np.ascontiguousarray(np.asarray(inner.indices)[idx])
            return Take(inner.array, composed, self.axis, self.out_chunks_axis)
        # span culling: when the indices only touch a sub-range of blocks,
        # slice the source to the block-aligned window first so slice
        # pushdown culls the untouched leaf blocks (the eager lane and leaf
        # transfer both stop paying for blocks the gather never reads)
        src_axis_chunks = self.array.chunks[self.axis]
        if (
            isinstance(n, (int, np.integer))
            and idx.size
            and len(src_axis_chunks) > 1
            and not any(isinstance(c, float) and math.isnan(c) for c in src_axis_chunks)
            and idx.min() >= 0
            and idx.max() < n
        ):
            bounds = np.cumsum((0,) + tuple(src_axis_chunks))
            lo_b = int(np.searchsorted(bounds, idx.min(), side="right") - 1)
            hi_b = int(np.searchsorted(bounds, idx.max(), side="right"))
            if hi_b - lo_b < len(src_axis_chunks):
                lo, hi = int(bounds[lo_b]), int(bounds[hi_b])
                index = tuple(
                    slice(lo, hi) if ax == self.axis else slice(None)
                    for ax in range(self.array.ndim)
                )
                return Take(
                    Slice(self.array, index),
                    np.ascontiguousarray(idx - lo),
                    self.axis,
                    self.out_chunks_axis,
                )
        return None

    def _accept_slice(self, index):
        """Slices on NON-taken axes commute below the take (mirror of
        Shuffle._accept_slice)."""
        from numbers import Integral

        from dask_array_tpu._slicing import Slice, is_basic_index

        if not is_basic_index(index):
            return None
        if any(isinstance(i, Integral) or i is None for i in index):
            return None
        if index[self.axis] != slice(None):
            return None
        if all(i == slice(None) for i in index):
            return None
        return Take(Slice(self.array, tuple(index)), self.indices, self.axis, self.out_chunks_axis)

    def _build(self, ctx):
        import jax.numpy as jnp

        view = ctx.build(self.array)
        src = view.dense()
        if isinstance(src, np.ma.MaskedArray):
            # masked host lane: numpy's take preserves the mask
            out = src.take(np.asarray(self.indices, dtype=np.int64), axis=self.axis)
            return BlockView(self.chunks, dense=out)
        from dask_array_tpu._dispatch import is_duck_chunk

        if is_duck_chunk(src):
            # duck host lane: np.take dispatches NEP-18
            out = np.take(src, np.asarray(self.indices, dtype=np.int64), axis=self.axis)
            return BlockView(self.chunks, dense=out)
        idx = jnp.asarray(np.asarray(self.indices, dtype=np.int64))
        dense = jnp.take(src, idx, axis=self.axis)
        return BlockView(self.chunks, dense=dense)

    def transfer_bytes(self):
        nb = self.array.nbytes
        if isinstance(nb, float) and math.isnan(nb):
            return (0, 0)
        n = self.array.shape[self.axis]
        taken = len(self.indices)
        return (0, int(nb * taken / max(1, n)))


def take(a, indices, axis=0):
    from dask_array_tpu._collection import Array, new_collection
    from dask_array_tpu.ops._from_array import asarray

    a = asarray(a)
    axis = validate_axis(axis, a.ndim)
    if isinstance(indices, Array):
        return _take_lazy(a, indices, axis)
    indices = np.asarray(indices)
    if indices.dtype == bool:
        return fancy_getitem(a, tuple(indices if ax == axis else slice(None) for ax in range(a.ndim)))
    if indices.ndim != 1:
        flat = take(a, indices.ravel(), axis=axis)
        from dask_array_tpu.ops._reshape import reshape

        new_shape = a.shape[:axis] + indices.shape + a.shape[axis + 1:]
        return reshape(flat, new_shape)
    if indices.size == 0:
        # numpy accepts an empty list as a valid empty integer index even
        # though np.asarray([]) is float64 (reference tests/test_slicing.py
        # empty-selection cases)
        indices = indices.astype(np.int64)
    if indices.dtype.kind not in "iub":
        raise IndexError(
            f"only integers, slices, ellipsis, newaxis and integer or "
            f"boolean arrays are valid indices (got dtype {indices.dtype})"
        )
    n = a.shape[axis]
    if isinstance(n, float) and np.isnan(n):
        if len(a.chunks[axis]) == 1:
            # a SINGLE block of unknown size needs no split points: defer the
            # take to per-block execution, where the concrete block supports
            # negative indices and numpy's own bounds errors (reference
            # test_unknown_chunks_length_one)
            idx_arr = np.asarray(indices, dtype=np.int64)
            out_chunks = tuple(
                (len(idx_arr),) if ax == axis else c for ax, c in enumerate(a.chunks)
            )

            def _take_block(b, idx_arr=idx_arr, axis=axis):
                return np.asarray(b).take(idx_arr, axis=axis)

            return a.map_blocks(_take_block, chunks=out_chunks, dtype=a.dtype)
        raise ValueError(
            "Cannot take along an axis with unknown chunk sizes; call "
            "compute_chunk_sizes() first"
        )
    idx = indices.astype(np.int64)
    if n == n:  # not nan
        neg = idx < 0
        if neg.any():
            idx = np.where(neg, idx + n, idx)
        if ((idx < 0) | (idx >= n)).any():
            bad = indices[(idx < 0) | (idx >= n)][0]
            raise IndexError(f"index {bad} is out of bounds for axis {axis} with size {n}")
    # chunk the output axis like the input's typical chunk
    mean = int(np.mean(a.chunks[axis])) if len(a.chunks[axis]) else 1
    mean = max(1, mean)
    ngroups = max(1, -(-len(idx) // mean))
    sizes = [len(g) for g in np.array_split(idx, ngroups)]
    out_axis = tuple(s for s in sizes if s) or (0,)
    # the indices stay an ndarray operand: a Python tuple of 50M boxed ints
    # would cost GBs and re-hash on every simplify pass (tokenize content-
    # hashes small arrays and identity-tokens big ones)
    return new_collection(Take(a.expr, np.ascontiguousarray(idx), axis, out_axis))


def _take_lazy(a, indices, axis):
    """Take with a lazy integer Array of indices (any ndim, known chunks).

    Parity: int-dask-array slicing (``slicing/_basic.py:75,125``) — index
    SHAPES are metadata, so the gather stays lazy/traceable.  ndim>1 lazy
    indices route through ravel + reshape, like the eager path.
    """
    from dask_array_tpu._collection import new_collection

    if indices.ndim != 1:
        from dask_array_tpu._chunks import has_unknown_chunks
        from dask_array_tpu.ops._reshape import reshape

        if has_unknown_chunks(indices.chunks):
            raise ValueError(
                "Slicing with a >1-D lazy index array of unknown chunks is "
                "not supported; call compute_chunk_sizes() on the index first"
            )
        flat = _take_lazy(a, indices.ravel(), axis)
        new_shape = a.shape[:axis] + indices.shape + a.shape[axis + 1:]
        return reshape(flat, new_shape)
    return new_collection(TakeLazy(a.expr, indices.expr, axis))


class TakeLazy(ArrayExpr):
    _parameters = ("array", "indices", "axis")

    @functools.cached_property
    def chunks(self):
        chunks = list(self.array.chunks)
        chunks[self.axis] = self.indices.chunks[0]
        return tuple(chunks)

    @property
    def _meta(self):
        return self.array._meta

    def _host_index_values(self):
        """Concrete index values if they exist WITHOUT computation (a host
        leaf, possibly astype-wrapped); None for data-dependent indices.

        Only VALUE-PRESERVING casts are unwrapped: a general Elemwise
        (``i - 10``, ``abs(i)``) changes the values, so bounds-checking the
        raw leaf would raise (or miss) IndexError for the wrong numbers."""
        from dask_array_tpu.ops._casting import _astype
        from dask_array_tpu.ops._from_array import FromArray

        node = self.indices
        while True:
            if isinstance(node, FromArray) and isinstance(node.source, np.ndarray):
                return node.source
            if type(node).__name__ == "FusedBlockwise":
                node = node.root  # display wrapper; inner nodes re-checked
                continue
            if type(node).__name__ != "Elemwise" or getattr(node, "func", None) is not _astype:
                return None
            deps = node.dependencies()
            if len(deps) != 1:
                return None
            node = deps[0]

    def _build(self, ctx):
        import jax.numpy as jnp

        view = ctx.build(self.array)
        idx = ctx.build(self.indices).dense()
        dim = self.array.shape[self.axis]
        if not (isinstance(dim, float) and math.isnan(dim)):
            host_idx = self._host_index_values()
            if host_idx is not None and host_idx.size and (
                (host_idx.astype("i8") < -dim) | (host_idx.astype("i8") >= dim)
            ).any():
                # indices known before tracing: surface numpy's bounds error
                # (reference test_index_with_int_dask_array_indexerror);
                # data-DEPENDENT indices cannot raise inside a traced
                # program — those gathers CLIP (documented divergence)
                h = host_idx.astype("i8").ravel()
                bad = h[(h < -dim) | (h >= dim)][0]
                raise IndexError(
                    f"index {int(bad)} is out of bounds for axis {self.axis} with size {dim}"
                )
            if ctx.mode == "eager" and host_idx is None and getattr(idx, "size", 0):
                # eager values are concrete: data-DEPENDENT indices get
                # numpy's bounds error too (the trace lane clips — a traced
                # program cannot raise data-dependently; docs/divergences.md)
                h = np.asarray(idx).astype("i8").ravel()
                oob = h[(h < -dim) | (h >= dim)]
                if oob.size:
                    raise IndexError(
                        f"index {int(oob[0])} is out of bounds for axis "
                        f"{self.axis} with size {dim}"
                    )
            idx = jnp.where(idx < 0, idx + dim, idx)  # numpy wrap semantics
        dense = jnp.take(view.dense(), idx, axis=self.axis, mode="clip")
        return BlockView(self.chunks, dense=dense)


class BooleanIndex(ArrayExpr):
    """x[mask]: data-dependent output size -> unknown (nan) chunks, eager.

    Grid-preserving: ONE nan-sized output block per input block, so
    ``compute_chunk_sizes`` can recover a real multi-block grid afterwards.
    For ``axis=None`` the array/mask are pre-raveled 1-D at construction
    (global C order).  Parity: ``BooleanIndexFlattened``
    (``slicing/_bool_index.py:118``).
    """

    _parameters = ("array", "mask", "axis")  # axis None => 1-D x, 1-D mask

    _traceable = False

    @functools.cached_property
    def chunks(self):
        if self.axis is None:
            n = 1
            for c in self.array.chunks:
                n *= len(c)
            return ((float("nan"),) * n,)
        chunks = list(self.array.chunks)
        chunks[self.axis] = (float("nan"),) * len(chunks[self.axis])
        return tuple(chunks)

    @property
    def _meta(self):
        nd = 1 if self.axis is None else self.array.ndim
        return np.empty((0,) * nd, dtype=self.array.dtype)

    def _mask_block(self, ctx, mview, chunks, idx):
        import jax.numpy as jnp

        from dask_array_tpu._executor import block_slices

        if mview is not None:
            return mview.block(idx)
        host = np.asarray(self.mask)
        return jnp.asarray(host[block_slices(chunks, idx)])

    def _build(self, ctx):
        import jax.numpy as jnp

        from dask_array_tpu._executor import iter_block_indices

        view = ctx.build(self.array)
        mview = ctx.build(self.mask) if isinstance(self.mask, ArrayExpr) else None
        blocks = {}
        if self.axis is None:
            for j, idx in enumerate(iter_block_indices(view.numblocks)):
                mb = self._mask_block(ctx, mview, self.array.chunks, idx)
                blocks[(j,)] = view.block(idx)[mb]
            return BlockView(self.chunks, blocks=blocks)
        axis_chunks = (self.array.chunks[self.axis],)
        for idx in iter_block_indices(view.numblocks):
            mb = self._mask_block(ctx, mview, axis_chunks, (idx[self.axis],))
            blocks[tuple(idx)] = jnp.compress(mb, view.block(idx), axis=self.axis)
        return BlockView(self.chunks, blocks=blocks)


class VIndex(ArrayExpr):
    """Pointwise (coordinate) indexing: one XLA gather.

    Parity: ``vindex`` (``slicing/_vindex.py:31,143``), including LAZY
    (dask) index arrays — index SHAPES are metadata, so the gather traces
    into the compiled program without materializing the indices at graph
    build.  ``pattern`` marks, per input axis, either a slice or the slot
    number of an index operand (``operands[3 + slot]``); index operands are
    expressions (eager numpy indices are lifted via ``from_array``).
    Broadcast dims always LEAD in the output (the vindex contract).
    """

    _parameters = ("array", "pattern", "bshape")
    # operands[3:] = index expressions, one per non-slice pattern slot

    def _name_prefix(self):
        return "vindex"

    @property
    def _index_exprs(self):
        return self.operands[3:]

    @functools.cached_property
    def chunks(self):
        lead = tuple((s,) for s in self.bshape)
        rest = tuple(
            self.array.chunks[ax]
            for ax, p in enumerate(self.pattern)
            if isinstance(p, slice)
        )
        return lead + rest

    @property
    def _meta(self):
        return np.empty((0,) * len(self.chunks), dtype=self.array.dtype)

    def _build(self, ctx):
        import jax.numpy as jnp

        dense = ctx.build(self.array).dense()
        arr_axes = [ax for ax, p in enumerate(self.pattern) if not isinstance(p, slice)]
        slice_axes = [ax for ax, p in enumerate(self.pattern) if isinstance(p, slice)]
        # move indexed axes to the FRONT: adjacent index arrays put the
        # broadcast dims first, honoring the vindex contract regardless of
        # where the arrays sat in the original pattern
        dense = jnp.transpose(dense, arr_axes + slice_axes)
        idxs = []
        for ax in arr_axes:
            slot = self.pattern[ax]
            arr = ctx.build(self._index_exprs[slot]).dense()
            dim = self.array.shape[ax]
            if not (isinstance(dim, float) and math.isnan(dim)):
                arr = jnp.where(arr < 0, arr + dim, arr)
            idxs.append(arr)
        out = dense[tuple(idxs)]
        return BlockView(self.chunks, dense=out)

    def transfer_bytes(self):
        nb = self.array.nbytes
        if isinstance(nb, float) and math.isnan(nb):
            return (0, 0)
        return (0, int(nb))


class VIndexAccessor:
    def __init__(self, array):
        self._array = array

    def __getitem__(self, index):
        from dask_array_tpu._collection import Array, new_collection
        from dask_array_tpu.ops._from_array import from_array

        if not isinstance(index, tuple):
            index = (index,)
        x = self._array
        if len(index) > x.ndim:
            raise IndexError(
                f"too many indices for vindex: array is {x.ndim}-dimensional, "
                f"but {len(index)} were indexed"
            )
        if len(index) < x.ndim:
            index = index + (slice(None),) * (x.ndim - len(index))
        pattern = []
        index_exprs = []
        shapes = []
        for i, dim in zip(index, x.shape):
            if isinstance(i, slice):
                if i != slice(None):
                    raise NotImplementedError(
                        "vindex only supports full slices alongside index arrays"
                    )
                pattern.append(i)
                continue
            if isinstance(i, Array):
                if np.dtype(i.dtype) == bool:
                    raise NotImplementedError(
                        "vindex with lazy BOOLEAN arrays is not supported; "
                        "materialize the mask or use x[mask]"
                    )
                expr = i.expr  # negatives normalized lazily in _build
            else:
                arr = np.asarray(i)
                if arr.dtype == bool:
                    arr = np.nonzero(arr)[0]
                arr = np.where(arr < 0, arr + dim, arr)
                if ((arr < 0) | (arr >= dim)).any():
                    raise IndexError("vindex index out of bounds")
                expr = from_array(arr, chunks=arr.shape or -1).expr
            pattern.append(len(index_exprs))
            index_exprs.append(expr)
            shapes.append(expr.shape)
        if not index_exprs:
            return new_collection(x.expr)
        bshape = tuple(int(s) for s in np.broadcast_shapes(*shapes))
        return new_collection(
            VIndex(x.expr, tuple(pattern), bshape, *index_exprs)
        )


def _multi_fancy(x, index):
    """``x[idx...]`` with MULTIPLE advanced indices, numpy semantics.

    numpy's advanced-indexing rules (which the reference declines — its
    ``slicing/_basic.py`` routing suggests ``.vindex``): every non-slice
    entry (arrays AND integer scalars) broadcasts together; the broadcast
    dims land in place when the advanced entries are consecutive, else
    first.  Realized as basic pre-slicing + one ``vindex`` gather + a
    moveaxis for the placement rule.
    """
    from dask_array_tpu._collection import Array

    adv_pos = [k for k, j in enumerate(index) if not isinstance(j, slice)]

    # pre-apply the basic slices (they act on distinct axes, so the advanced
    # index values still address the original coordinates of their own axes)
    basic = tuple(j if isinstance(j, slice) else slice(None) for j in index)
    y = x if all(j == slice(None) for j in basic) else x[basic]

    vargs = []
    for k, j in enumerate(index):
        if isinstance(j, slice):
            vargs.append(slice(None))
        elif isinstance(j, Integral):
            vargs.append(np.asarray(j))  # 0-d advanced index (broadcasts)
        elif isinstance(j, Array):
            if np.dtype(j.dtype) == bool:
                raise NotImplementedError(
                    "lazy boolean arrays among multiple advanced indices are "
                    "not supported; materialize the mask first"
                )
            vargs.append(j)
        else:
            arr = np.asarray(j)
            if arr.dtype == bool:
                # a boolean among multiple advanced indices acts as nonzero()
                if arr.ndim != 1:
                    raise IndexError(
                        "multi-dimensional boolean index among multiple "
                        "advanced indices is not supported"
                    )
                if arr.shape[0] != x.shape[k]:
                    raise IndexError(
                        f"boolean index length {arr.shape[0]} does not match "
                        f"axis {k} size {x.shape[k]}"
                    )
                arr = np.nonzero(arr)[0]
            vargs.append(arr)

    v = y.vindex[tuple(vargs)]

    # placement: consecutive advanced entries put the broadcast dims IN
    # PLACE (after the slice axes that precede them); separated ones lead
    n_slices = sum(1 for j in index if isinstance(j, slice))
    n_b = v.ndim - n_slices
    consecutive = adv_pos == list(range(adv_pos[0], adv_pos[-1] + 1))
    if consecutive and n_b:
        lead_slices = sum(1 for j in index[: adv_pos[0]] if isinstance(j, slice))
        if lead_slices:
            from dask_array_tpu.ops.manipulation import moveaxis

            v = moveaxis(
                v,
                tuple(range(n_b)),
                tuple(range(lead_slices, lead_slices + n_b)),
            )
    return v


def fancy_getitem(x, index):
    """Route a normalized index containing arrays/lists to the right expr."""
    from dask_array_tpu._collection import Array, new_collection

    index = tuple(index)

    # full-ndim boolean mask
    for pos, i in enumerate(index):
        mask_like = (isinstance(i, (np.ndarray, Array)) and getattr(i, "dtype", None) is not None and np.dtype(i.dtype) == bool)
        if mask_like and getattr(i, "ndim", 1) == x.ndim and all(j == slice(None) for k, j in enumerate(index) if k != pos):
            def _known_mismatch(a, b):
                nan = lambda v: isinstance(v, float) and math.isnan(v)
                return not nan(a) and not nan(b) and a != b

            if len(i.shape) != len(x.shape) or any(
                _known_mismatch(a, b) for a, b in zip(i.shape, x.shape)
            ):
                raise IndexError(
                    f"boolean index shape {tuple(i.shape)} did not match "
                    f"indexed array shape {tuple(x.shape)}"
                )
            # ravel both sides first (global C order, like the reference's
            # x.ravel() path) so per-block extraction preserves element order
            from dask_array_tpu.ops._reshape import ravel

            xr = ravel(x) if x.ndim > 1 else x
            if isinstance(i, Array):
                mr = ravel(i) if i.ndim > 1 else i
                m = mr.rechunk(xr.chunks).expr
            else:
                m = np.ascontiguousarray(i).ravel()
            return new_collection(BooleanIndex(xr.expr, m, None))

    fancy_pos = [
        pos
        for pos, i in enumerate(index)
        if not (isinstance(i, slice) or isinstance(i, Integral))
    ]
    if len(fancy_pos) > 1:
        # numpy semantics via vindex (the reference raises here,
        # slicing/_basic.py routing — this is a capability extension)
        return _multi_fancy(x, index)
    if not fancy_pos:  # pragma: no cover - routed to basic indexing upstream
        raise NotImplementedError("fancy_getitem without index arrays")
    (pos,) = fancy_pos
    i = index[pos]
    rest = [j for k, j in enumerate(index) if k != pos]

    if isinstance(i, Array):
        if np.dtype(i.dtype) == bool:
            aligned = i.rechunk((x.chunks[pos],))
            out = new_collection(BooleanIndex(x.expr, aligned.expr, pos))
        else:
            out = _take_lazy(x, i, pos)
    else:
        arr = np.asarray(i)
        if arr.dtype == bool:
            if arr.ndim != 1:
                raise IndexError("boolean index did not match indexed array")
            if arr.shape[0] != x.shape[pos]:
                raise IndexError(
                    f"boolean index length {arr.shape[0]} does not match axis {pos} size {x.shape[pos]}"
                )
            out = take(x, np.nonzero(arr)[0], axis=pos)
        else:
            out = take(x, arr, axis=pos)

    # apply the remaining basic index around the fancy axis
    if all(isinstance(j, slice) and j == slice(None) for j in rest):
        return out
    full = list(index)
    full[pos] = slice(None)
    return new_collection(Slice(out.expr, tuple(full)))
