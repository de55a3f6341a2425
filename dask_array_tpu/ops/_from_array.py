"""FromArray: wrap a concrete (host or device) array as a leaf expression.

Parity: ``FromArray`` in ``/root/reference/dask_array/io/_from_array.py``
(including its deferred ``_region`` slicing so pushed-down slices shrink
what is actually read) — fresh implementation.

XLA-first: the leaf's buffer is bound as a *jit argument*, so the same
compiled executable is reused across calls, the host->device transfer moves
only the pushed-down region, and on a mesh the buffer is device_put with a
chunk-aligned NamedSharding before the call.
"""

from __future__ import annotations

import functools
from builtins import all as builtins_all
from builtins import any as builtins_any
from builtins import sum as builtins_sum
from numbers import Integral

import numpy as np

from dask_array_tpu._chunks import normalize_chunks
from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr
from dask_array_tpu._slicing import normalize_index, is_basic_index, sliced_blockdim, fuse_slice


def _storage_granule(src):
    """Per-axis storage read-granule of ``src``: its ``.shards`` (the larger
    IO unit) or ``.chunks``, or None for in-memory/device arrays.

    xarray-style lazy-indexing adapters wrap a chunked store without
    re-exposing its grid; the store is reachable through the adapter chain
    (``.array`` / ``._array``), so walk it — bounded, since real adapter
    stacks are a handful deep.  Missing this meant a sub-native rechunk
    fused below the storage grid and amplified reads (parity: reference
    ``io/_from_array.py:26`` and its lazy-wrapper regression test).
    """
    for _ in range(16):
        if isinstance(src, np.ndarray) or hasattr(src, "devices"):
            return None
        granule = getattr(src, "shards", None) or getattr(src, "chunks", None)
        if granule is not None:
            return granule
        nxt = getattr(src, "array", None)
        if nxt is None:
            nxt = getattr(src, "_array", None)
        if nxt is None or nxt is src:
            return None
        src = nxt
    return None


class FromArray(ArrayExpr):
    _parameters = ("source", "chunks_", "region", "name_")
    _defaults = {"region": None, "name_": None}

    _fusable_leaf = True

    def _collection_name(self):
        return self.operand("name_") or self._name

    @property
    def _traceable(self):
        # masked and registered duck sources have no device representation
        # (tracing would drop the mask / the duck type): host lane
        from dask_array_tpu._dispatch import is_duck_chunk

        return not (
            isinstance(self.source, np.ma.MaskedArray)
            or is_duck_chunk(self.source)
        )

    @property
    def chunks(self):
        return self.chunks_

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * len(self.chunks_), dtype=self.source.dtype)

    @functools.cached_property
    def _leaf_key(self):
        return f"leaf-{self._name}"

    def _leaf_buffers(self):
        src = self.source
        if self.region is not None:
            src = src[tuple(self.region)]
        yield (self._leaf_key, src)

    def _structural_operands(self):
        # the bound buffer's spec, not its contents: same-shaped datasets
        # share one compiled executable
        from dask_array_tpu._chunks import dtype_key

        return [("buf", dtype_key(self.source.dtype)), self.chunks_]

    def _build(self, ctx):
        import jax.numpy as jnp

        val = ctx.leaf(self._leaf_key)
        if not hasattr(val, "dtype"):
            val = jnp.asarray(val)
        return BlockView(self.chunks_, dense=val)

    def _accept_slice(self, index):
        if not is_basic_index(index):
            return None
        if self.region is not None:
            base_shape = self.source.shape
            fused = fuse_slice(tuple(self.region), tuple(index), base_shape)
            if fused is None:
                return None
            region = fused
        else:
            region = tuple(index)
        new_chunks = []
        ax = 0
        for ind in index:
            if isinstance(ind, Integral):
                ax += 1
                continue
            if ind == slice(None):
                new_chunks.append(self.chunks_[ax])
            else:
                nc, _ = sliced_blockdim(self.chunks_[ax], ind)
                new_chunks.append(nc)
            ax += 1
        return FromArray(self.source, tuple(new_chunks), region)

    @functools.cached_property
    def _storage_chunks(self):
        """Per-axis storage granule size for chunked stores (zarr/h5py
        style sources exposing ``.chunks`` — or ``.shards``, the larger
        IO unit, when present).  None for in-memory arrays, where slicing
        is free.  Parity: the reference's storage-chunk discipline
        (``tests/test_rechunk_pushdown.py:196-461``)."""
        granule = _storage_granule(self.source)
        if granule is None:
            return None
        try:
            granule = tuple(int(c) for c in granule)
        except (TypeError, ValueError):
            return None
        if len(granule) != len(self.chunks_) or builtins_any(g <= 0 for g in granule):
            return None
        return granule

    def _accept_rechunk(self, target_chunks):
        storage = self._storage_chunks
        if storage is None:
            return FromArray(self.source, tuple(target_chunks), self.region)
        # chunked store: absorb only grids whose boundaries land on
        # storage-granule boundaries (each granule read exactly once);
        # finer axes read at the granule grid with the fine rechunk left
        # outside (the reference's refine-to-storage-chunks behavior)
        from dask_array_tpu._rechunk import Rechunk

        starts = tuple(
            (r.start or 0) if isinstance(r, slice) else 0
            for r in (self.region or (slice(None),) * len(storage))
        )
        leaf_chunks = []
        residual = False
        for ax, want in enumerate(target_chunks):
            s = storage[ax]
            off = starts[ax]
            bounds = np.cumsum((0,) + tuple(want))
            if builtins_all((off + int(b)) % s == 0 or b == bounds[-1] for b in bounds):
                leaf_chunks.append(tuple(want))
                continue
            # read at granule granularity on this axis
            total = int(bounds[-1])
            first = min(total, s - (off % s) if off % s else s)
            grid = [first]
            while builtins_sum(grid) < total:
                grid.append(min(s, total - builtins_sum(grid)))
            leaf_chunks.append(tuple(grid))
            residual = residual or tuple(grid) != tuple(want)
        leaf = (
            self
            if tuple(leaf_chunks) == self.chunks_
            else FromArray(self.source, tuple(leaf_chunks), self.region)
        )
        if not residual:
            return leaf
        if leaf is self:
            return None  # already reading at granule grid; Rechunk stays
        return Rechunk(leaf, tuple(target_chunks))


def from_array(x, chunks="auto", name=None, lock=False, asarray=None, fancy=True, meta=None, inline_array=False):
    """Create a lazy Array from an in-memory array-like."""
    from dask_array_tpu._collection import Array, new_collection

    if isinstance(x, Array):
        raise ValueError("Array is already a lazy dask_array_tpu.Array")
    # np.ma.MaskedArray sources are accepted and live on the HOST lane
    # (passthrough ops only — _executor.check_masked_ops guards the rest);
    # reference parity: tests/test_collection.py:1322
    if isinstance(x, (list, tuple, int, float, complex, bool)) or np.isscalar(x):
        x = np.asarray(x)
    if not hasattr(x, "shape") or not hasattr(x, "dtype"):
        x = np.asarray(x)
    # chunked stores (zarr/h5py style): default the grid to the storage
    # granules so reads align with them (the reference's from_array
    # previous_chunks behavior)
    prev = None
    granule = _storage_granule(x)
    if granule is not None:
        try:
            prev = tuple((int(c),) for c in granule)
        except (TypeError, ValueError):
            prev = None
        if prev is not None and len(prev) != len(x.shape):
            prev = None
    chunks = normalize_chunks(chunks, x.shape, dtype=x.dtype, previous_chunks=prev)
    return new_collection(FromArray(x, chunks, None, name))


def asarray(a, chunks=None, *, allow_unknown_chunksizes=False, dtype=None, order=None, like=None, **kwargs):
    from dask_array_tpu._collection import Array

    if isinstance(a, Array):
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a
    if hasattr(a, "to_dask_array"):
        return a.to_dask_array()
    if isinstance(a, (list, tuple)) and any(isinstance(e, Array) for e in a):
        from dask_array_tpu.ops.stacking import stack

        return stack(a)
    a = np.asarray(a, dtype=dtype, order=order)
    return from_array(a, chunks=chunks if chunks is not None else "auto")


def asanyarray(a, dtype=None, order=None, *, like=None, inline_array=False):
    return asarray(a, dtype=dtype, order=order)


def array(x, dtype=None, ndmin=None, *, like=None):
    out = asarray(x, dtype=dtype)
    if ndmin is not None:
        while out.ndim < ndmin:
            out = out[None]
    return out
