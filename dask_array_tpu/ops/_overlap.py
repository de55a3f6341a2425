"""Overlap / map_overlap: ghost-cell (halo) machinery for stencils.

Parity: ``/root/reference/dask_array/_overlap.py`` (``OverlapInternal``,
boundary modes periodic/reflect/nearest/constant/none, ``map_overlap``
pipeline, ``sliding_window_view``, ``push``) — fresh implementation.

XLA-first: a block-with-halo is a *slice of the boundary-extended dense
array*, so inside one chip the "halo exchange" is free (XLA fuses the
overlapping reads), and over a mesh the sharding propagation turns the
out-of-shard reads into exactly the neighbor ppermute/collective-permute
the reference's task-based halo exchange emulates.
"""

from __future__ import annotations

import functools
from numbers import Integral, Number

import numpy as np

from dask_array_tpu._chunks import cached_cumsum, validate_axis
from dask_array_tpu._executor import BlockView, iter_block_indices
from dask_array_tpu._expr import ArrayExpr


def _jnp():
    import jax.numpy as jnp

    return jnp


def coerce_depth(ndim, depth):
    """depth -> {axis: (lo, hi)}"""
    if isinstance(depth, Integral):
        depth = (int(depth),) * ndim
    if isinstance(depth, (list, tuple)):
        depth = dict(enumerate(depth))
    out = {}
    for ax in range(ndim):
        d = depth.get(ax, 0)
        if isinstance(d, Integral):
            out[ax] = (int(d), int(d))
        else:
            out[ax] = (int(d[0]), int(d[1]))
    return out


def coerce_boundary(ndim, boundary):
    """boundary -> {axis: mode} with mode in {'reflect','periodic','nearest',
    'none'} or a constant fill value."""
    if boundary is None:
        boundary = "none"
    if not isinstance(boundary, dict):
        if isinstance(boundary, (list, tuple)):
            boundary = dict(enumerate(boundary))
        else:
            boundary = {ax: boundary for ax in range(ndim)}
    return {ax: boundary.get(ax, "none") for ax in range(ndim)}


# dask's "reflect" includes the edge element (x[depth-1::-1] — reference
# ``_overlap.py:733``), which is numpy's "symmetric", NOT numpy's "reflect"
_PAD_MODE = {"reflect": "symmetric", "periodic": "wrap", "nearest": "edge"}


class Overlap(ArrayExpr):
    """Each block grows by its halo (ghost cells from neighbors/boundary).

    ``margin`` (per-axis ``(mlo, mhi)``) marks extra source rows at the
    array's ends that serve as HALO ONLY — they belong to no block's body
    and suppress boundary handling at their edge.  A block-aligned slice
    of an overlap pipeline pushes down by converting the cut's neighbor
    rows into margins (the slice-through-overlap rewrite; reference
    optimizer family ``tests/test_slice_through_overlap.py``).
    ``body_chunks`` then carries the body grid, since the sliced child's
    own chunk layout no longer encodes it.
    """

    _parameters = ("array", "depth", "boundary", "margin", "body_chunks")
    _defaults = {"margin": None, "body_chunks": None}

    @functools.cached_property
    def _depth_map(self):
        return {ax: d for ax, d in enumerate(self.depth)}

    @functools.cached_property
    def _boundary_map(self):
        return {ax: b for ax, b in enumerate(self.boundary)}

    @functools.cached_property
    def _margins(self):
        m = self.operand("margin")
        if m is None:
            return tuple((0, 0) for _ in self.depth)
        return tuple(tuple(x) for x in m)

    @functools.cached_property
    def _body_grid(self):
        b = self.operand("body_chunks")
        if b is None:
            return self.array.chunks
        return tuple(tuple(x) for x in b)

    @functools.cached_property
    def chunks(self):
        out = []
        for ax, c in enumerate(self._body_grid):
            lo, hi = self.depth[ax]
            bd = self.boundary[ax]
            mlo, mhi = self._margins[ax]
            axis = []
            n = len(c)
            for i, size in enumerate(c):
                add_lo = lo if (i > 0 or bd != "none" or mlo) else 0
                add_hi = hi if (i < n - 1 or bd != "none" or mhi) else 0
                axis.append(size + add_lo + add_hi)
            out.append(tuple(axis))
        return tuple(out)

    @property
    def _meta(self):
        return self.array._meta

    def transfer_bytes(self):
        """Halo bytes moved between blocks (parity: `_overlap.py:92`)."""
        itemsize = self.dtype.itemsize
        total = 0
        grid = self._body_grid
        for ax, c in enumerate(grid):
            lo, hi = self.depth[ax]
            mlo, mhi = self._margins[ax]
            other = 1
            for ax2, c2 in enumerate(grid):
                if ax2 != ax:
                    other *= sum(c2)
            cuts = max(0, len(c) - 1) + bool(mlo) + bool(mhi)
            total += (lo + hi) * cuts * other * itemsize
        return (total, total)

    def _build(self, ctx):
        jnp = _jnp()
        view = ctx.build(self.array)
        dense = view.dense()

        # boundary-extend the dense array per axis (sides with a margin
        # already carry their halo rows in the data: no pad there)
        offsets = []
        for ax in range(dense.ndim):
            lo, hi = self.depth[ax]
            bd = self.boundary[ax]
            mlo, mhi = self._margins[ax]
            plo = lo if (bd != "none" and not mlo) else 0
            phi = hi if (bd != "none" and not mhi) else 0
            if plo == 0 and phi == 0:
                offsets.append(mlo)
                continue
            pw = [(0, 0)] * dense.ndim
            pw[ax] = (plo, phi)
            if bd in _PAD_MODE:
                dense = jnp.pad(dense, pw, mode=_PAD_MODE[bd])
            else:
                dense = jnp.pad(dense, pw, mode="constant", constant_values=bd)
            offsets.append(mlo + plo)

        grid = self._body_grid
        bounds = [cached_cumsum(c, initial_zero=True) for c in grid]
        blocks = {}
        n_ax = [len(c) for c in grid]
        for idx in iter_block_indices(tuple(n_ax)):
            sl = []
            for ax, i in enumerate(idx):
                lo, hi = self.depth[ax]
                bd = self.boundary[ax]
                mlo, mhi = self._margins[ax]
                start = bounds[ax][i] + offsets[ax]
                stop = bounds[ax][i + 1] + offsets[ax]
                take_lo = lo if (i > 0 or bd != "none" or mlo) else 0
                take_hi = hi if (i < n_ax[ax] - 1 or bd != "none" or mhi) else 0
                sl.append(slice(start - take_lo, stop + take_hi))
            blocks[tuple(idx)] = dense[tuple(sl)]
        return BlockView(self.chunks, blocks=blocks)

    def _accept_slice(self, index):
        """Push a basic slice below the halo machinery.

        Non-halo axes commute; a halo axis accepts whole-OUTPUT-block
        slices: the cut's neighbor rows join the pushed slice as margins,
        so panel programs read only their rows + halo (the reference's
        slice-through-overlap family, block-aligned case)."""
        from dask_array_tpu._slicing import Slice, is_basic_index, sliced_blockdim

        if not is_basic_index(index):
            return None
        body = self._body_grid
        out_chunks = self.chunks
        inner, outer, new_margin, new_body = [], [], [], []
        changed = False
        for ax, ind in enumerate(index):
            lo, hi = self.depth[ax]
            bd = self.boundary[ax]
            mlo, mhi = self._margins[ax]
            c = body[ax]
            n = len(c)

            def keep(ind=ind, c=c, mlo=mlo, mhi=mhi):
                # this axis stays outside (applied after the overlap)
                inner.append(slice(None))
                outer.append(ind)
                new_margin.append((mlo, mhi))
                new_body.append(c)

            if ind == slice(None):
                keep()
                continue
            if isinstance(ind, Integral):
                keep()  # rank-changing: keep the int outside
                continue
            if not (lo or hi):
                nc, _ = sliced_blockdim(c, ind)
                inner.append(ind)
                outer.append(slice(None))
                new_margin.append((0, 0))
                new_body.append(tuple(nc))
                changed = True
                continue
            dim = int(sum(out_chunks[ax]))
            start, stop, step = ind.indices(dim)
            if step != 1 or stop <= start:
                keep()
                continue
            ob = np.cumsum((0,) + tuple(int(x) for x in out_chunks[ax]))
            i0 = int(np.searchsorted(ob, start))
            i1 = int(np.searchsorted(ob, stop))
            if ob[i0] != start or ob[i1] != stop or i1 <= i0:
                keep()  # not whole output blocks
                continue
            if i0 == 0 and i1 == n:
                keep(slice(None))
                continue
            if bd == "periodic" and (i0 == 0 or i1 == n):
                # a true-edge panel's wrap halo comes from the OTHER end of
                # the array: a contiguous leaf region cannot supply it
                keep()
                continue
            bb = np.cumsum((0,) + tuple(int(x) for x in c))
            a_in = 0 if i0 == 0 else mlo + int(bb[i0]) - lo
            b_in = (
                mlo + int(bb[n]) + mhi if i1 == n else mlo + int(bb[i1]) + hi
            )
            inner.append(slice(int(a_in), int(b_in), 1))
            outer.append(slice(None))
            new_margin.append((lo if i0 > 0 else mlo, hi if i1 < n else mhi))
            new_body.append(tuple(c[i0:i1]))
            changed = True
        if not changed:
            return None
        pushed = Overlap(
            Slice(self.array, tuple(inner)),
            self.depth,
            self.boundary,
            tuple(new_margin),
            tuple(new_body),
        )
        if all(o == slice(None) for o in outer):
            return pushed
        return Slice(pushed, tuple(outer))


class TrimInternal(ArrayExpr):
    """Shave halos back off every block (parity: ``trim_internal``).

    ``margin`` (per-axis ``(mlo, mhi)``) marks edge blocks that carry
    halos despite being first/last — the trace a block-aligned slice
    leaves when it cuts an overlap pipeline mid-array."""

    _parameters = ("array", "depth", "boundary", "margin")
    _defaults = {"margin": None}

    @functools.cached_property
    def _margins(self):
        m = self.operand("margin")
        if m is None:
            return tuple((0, 0) for _ in self.depth)
        return tuple(tuple(x) for x in m)

    @functools.cached_property
    def chunks(self):
        out = []
        for ax, c in enumerate(self.array.chunks):
            lo, hi = self.depth[ax]
            bd = self.boundary[ax]
            mlo, mhi = self._margins[ax]
            axis = []
            n = len(c)
            for i, size in enumerate(c):
                cut_lo = lo if (i > 0 or bd != "none" or mlo) else 0
                cut_hi = hi if (i < n - 1 or bd != "none" or mhi) else 0
                axis.append(size - cut_lo - cut_hi)
            out.append(tuple(axis))
        return tuple(out)

    @property
    def _meta(self):
        return self.array._meta

    def _build(self, ctx):
        view = ctx.build(self.array)
        blocks = {}
        n_ax = view.numblocks
        for idx in iter_block_indices(n_ax):
            b = view.block(idx)
            sl = []
            for ax, i in enumerate(idx):
                lo, hi = self.depth[ax]
                bd = self.boundary[ax]
                mlo, mhi = self._margins[ax]
                cut_lo = lo if (i > 0 or bd != "none" or mlo) else 0
                cut_hi = hi if (i < n_ax[ax] - 1 or bd != "none" or mhi) else 0
                sl.append(slice(cut_lo, b.shape[ax] - cut_hi))
            blocks[tuple(idx)] = b[tuple(sl)]
        return BlockView(self.chunks, blocks=blocks)

    def _accept_slice(self, index):
        """Non-halo axes commute; a halo axis accepts whole-OUTPUT-block
        slices, converting them to whole overlapped blocks of the child
        with margins marking the halos the new edge blocks carry."""
        from dask_array_tpu._slicing import Slice, is_basic_index

        if not is_basic_index(index):
            return None
        out_chunks = self.chunks
        ov_chunks = self.array.chunks
        inner, outer, new_margin = [], [], []
        changed = False
        for ax, ind in enumerate(index):
            lo, hi = self.depth[ax]
            bd = self.boundary[ax]
            mlo, mhi = self._margins[ax]
            n = len(out_chunks[ax])

            def keep(ind=ind, mlo=mlo, mhi=mhi):
                inner.append(slice(None))
                outer.append(ind)
                new_margin.append((mlo, mhi))

            if ind == slice(None):
                keep()
                continue
            if isinstance(ind, Integral):
                keep()  # rank-changing: keep the int outside
                continue
            if not (lo or hi):
                inner.append(ind)
                outer.append(slice(None))
                new_margin.append((0, 0))
                changed = True
                continue
            dim = int(sum(out_chunks[ax]))
            start, stop, step = ind.indices(dim)
            if step != 1 or stop <= start:
                keep()
                continue
            ob = np.cumsum((0,) + tuple(int(x) for x in out_chunks[ax]))
            i0 = int(np.searchsorted(ob, start))
            i1 = int(np.searchsorted(ob, stop))
            if ob[i0] != start or ob[i1] != stop or i1 <= i0:
                keep()  # not whole output blocks
                continue
            if i0 == 0 and i1 == n:
                keep(slice(None))
                continue
            if bd == "periodic" and (i0 == 0 or i1 == n):
                keep()  # wrap halo needs the array's other end (see Overlap)
                continue
            ovb = np.cumsum((0,) + tuple(int(x) for x in ov_chunks[ax]))
            inner.append(slice(int(ovb[i0]), int(ovb[i1]), 1))
            outer.append(slice(None))
            new_margin.append((lo if i0 > 0 else mlo, hi if i1 < n else mhi))
            changed = True
        if not changed:
            return None
        pushed = TrimInternal(
            Slice(self.array, tuple(inner)),
            self.depth,
            self.boundary,
            tuple(new_margin),
        )
        if all(o == slice(None) for o in outer):
            return pushed
        return Slice(pushed, tuple(outer))


class ShardStencil(ArrayExpr):
    """``map_overlap`` as ONE shard-level stencil with explicit collectives.

    Opt-in via config ``tpu.overlap-method="shard"``.  The per-block halo
    pipeline reads neighbor slices out of the sharded dense array and GSPMD
    inserts a collective-permute per read — correct, but a depth-1 stencil
    over 8 shards compiles to hundreds of small permutes.  This node instead
    ``shard_map``s the dense array once: each shard ring-exchanges exactly
    one lo/hi halo per sharded axis (TWO ppermutes — the minimal
    schedule, SURVEY §2.6 "halo exchange"), realizes the boundary locally on
    the edge shards, applies ``func`` to its whole shard, and trims.

    Contract: ``func`` must be local (output at a point depends only on
    inputs within ``depth``) and size-preserving — the standard
    ``map_overlap`` assumption (reference ``_overlap.py:1041``); block
    boundaries inside a shard are simply never cut, so interior halo work
    disappears entirely.
    """

    _parameters = ("array", "func", "depth", "boundary", "kwargs", "_dtype")

    @functools.cached_property
    def chunks(self):
        return self.array.chunks

    @functools.cached_property
    def _meta(self):
        return np.empty((0,) * self.array.ndim, dtype=self._dtype)

    def transfer_bytes(self):
        itemsize = self.dtype.itemsize
        total = 0
        shape = self.array.shape
        for ax, (lo, hi) in enumerate(self.depth):
            other = 1
            for ax2, s in enumerate(shape):
                if ax2 != ax:
                    other *= s
            total += (lo + hi) * other * itemsize
        return (0, total)

    @staticmethod
    def _edge_fill(shard, ax, width, bd, side):
        """Boundary halo realized from the shard's own edge (global edges)."""
        jnp = _jnp()
        import jax.lax as lax

        size = shard.shape[ax]
        if bd == "reflect":  # dask reflect == numpy symmetric
            if side == "lo":
                return jnp.flip(lax.slice_in_dim(shard, 0, width, axis=ax), axis=ax)
            return jnp.flip(lax.slice_in_dim(shard, size - width, size, axis=ax), axis=ax)
        if bd == "nearest":
            if side == "lo":
                edge = lax.slice_in_dim(shard, 0, 1, axis=ax)
            else:
                edge = lax.slice_in_dim(shard, size - 1, size, axis=ax)
            return jnp.repeat(edge, width, axis=ax)
        # constant fill value (periodic never reaches here: the ring wraps)
        halo_shape = list(shard.shape)
        halo_shape[ax] = width
        return jnp.full(tuple(halo_shape), bd, dtype=shard.dtype)

    def _apply_global(self, dense):
        """Mesh-free form: pad -> func -> trim over the whole array (equal
        to the per-block form under the locality contract)."""
        jnp = _jnp()

        out = dense
        for ax, (lo, hi) in enumerate(self.depth):
            if not (lo or hi):
                continue
            bd = self.boundary[ax]
            pw = [(0, 0)] * out.ndim
            pw[ax] = (lo, hi)
            if bd in _PAD_MODE:
                out = jnp.pad(out, pw, mode=_PAD_MODE[bd])
            else:
                out = jnp.pad(out, pw, mode="constant", constant_values=bd)
        out = self.func(out, **dict(self.kwargs or ()))
        sl = tuple(
            slice(lo, out.shape[ax] - hi) for ax, (lo, hi) in enumerate(self.depth)
        )
        return out[sl].astype(self._dtype)

    def _build(self, ctx):
        import jax
        import jax.lax as lax

        jnp = _jnp()
        view = ctx.build(self.array)
        dense = view.dense()
        mesh = ctx.mesh if ctx.mode == "trace" else None
        if mesh is not None:
            from dask_array_tpu.parallel.layout import plan_layout

            spec = plan_layout(self.array.shape, self.array.chunks, mesh)
            # a sharded halo axis needs shards at least as deep as the halo
            # (a NESTED entry like ("dcn", "x") shards over the group
            # product — multislice meshes ride the same ring schedule,
            # crossing DCN only at the n_slices - 1 slice-boundary pairs)
            for ax, name in enumerate(spec):
                lo, hi = self.depth[ax]
                if name is not None and (lo or hi):
                    n = 1
                    for nm in (name,) if isinstance(name, str) else name:
                        n *= mesh.shape[nm]
                    if self.array.shape[ax] // n < max(lo, hi):
                        spec = None
                        break
        else:
            spec = None
        if spec is None or all(s is None for s in spec):
            return BlockView(self.chunks, dense=self._apply_global(dense))

        from jax.sharding import NamedSharding, PartitionSpec

        from dask_array_tpu.parallel.collectives import _shard_map

        depth = self.depth
        boundary = self.boundary
        func = self.func
        fkw = dict(self.kwargs or ())
        out_dtype = self._dtype

        def body(shard):
            for ax, (lo, hi) in enumerate(depth):
                if not (lo or hi):
                    continue
                bd = boundary[ax]
                name = spec[ax]
                if name is None:
                    # full axis lives on this shard: realize the boundary
                    pw = [(0, 0)] * shard.ndim
                    pw[ax] = (lo, hi)
                    if bd in _PAD_MODE:
                        shard = jnp.pad(shard, pw, mode=_PAD_MODE[bd])
                    else:
                        shard = jnp.pad(shard, pw, mode="constant", constant_values=bd)
                    continue
                names = (name,) if isinstance(name, str) else tuple(name)
                n = 1
                for nm in names:
                    n *= mesh.shape[nm]
                wrap = bd == "periodic"
                size = shard.shape[ax]
                parts = []
                # linearised position over the (possibly nested) group
                idx = lax.axis_index(names[0])
                for nm in names[1:]:
                    idx = idx * mesh.shape[nm] + lax.axis_index(nm)
                if lo:
                    tail = lax.slice_in_dim(shard, size - lo, size, axis=ax)
                    fwd = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
                    from_left = lax.ppermute(tail, names, fwd)
                    if not wrap:
                        fill = self._edge_fill(shard, ax, lo, bd, "lo")
                        from_left = jnp.where(idx == 0, fill, from_left)
                    parts.append(from_left)
                parts.append(shard)
                if hi:
                    head = lax.slice_in_dim(shard, 0, hi, axis=ax)
                    bwd = [(i, (i - 1) % n) for i in range(n) if wrap or i > 0]
                    from_right = lax.ppermute(head, names, bwd)
                    if not wrap:
                        fill = self._edge_fill(shard, ax, hi, bd, "hi")
                        from_right = jnp.where(idx == n - 1, fill, from_right)
                    parts.append(from_right)
                shard = jnp.concatenate(parts, axis=ax) if len(parts) > 1 else parts[0]
            out = func(shard, **fkw)
            sl = tuple(
                slice(lo, out.shape[ax] - hi) for ax, (lo, hi) in enumerate(depth)
            )
            return out[sl].astype(out_dtype)

        pspec = PartitionSpec(*spec)
        fn = _shard_map()(body, mesh=mesh, in_specs=(pspec,), out_specs=pspec)
        dense = jax.lax.with_sharding_constraint(dense, NamedSharding(mesh, pspec))
        return BlockView(self.chunks, dense=fn(dense))


def _shard_stencil_eligible(arrays, depths, bounds, trim, kwargs):
    """Route map_overlap through ShardStencil?  (opt-in method="shard")"""
    if len(arrays) != 1 or not trim:
        return False
    if any(k in kwargs for k in ("chunks", "new_axis", "drop_axis", "meta")):
        return False  # shape-changing funcs keep the per-block pipeline
    d, b = depths[0], bounds[0]
    for ax in range(arrays[0].ndim):
        lo, hi = d[ax]
        if (lo or hi) and b[ax] == "none":
            return False  # 'none' shrinks edge halos: inherently per-block
    return True


def _normalize(x, depth, boundary):
    depth_map = coerce_depth(x.ndim, depth)
    bd_map = coerce_boundary(x.ndim, boundary)
    dep = tuple(depth_map[ax] for ax in range(x.ndim))
    bd = tuple(bd_map[ax] for ax in range(x.ndim))
    return dep, bd


def overlap(x, depth, boundary=None, *, allow_rechunk=True):
    """Add ghost cells to every block."""
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._from_array import asarray

    x = asarray(x)
    dep, bd = _normalize(x, depth, boundary)
    # every chunk must be at least as large as the halo it donates
    for ax, (lo, hi) in enumerate(dep):
        if (lo or hi) and len(x.chunks[ax]) > 1:
            m = min(x.chunks[ax])
            if m < max(lo, hi):
                if not allow_rechunk:
                    raise ValueError(
                        f"overlap depth {max(lo, hi)} exceeds the smallest chunk "
                        f"({m}) along axis {ax}; rechunk first"
                    )
                # merge neighboring chunks until each is >= the halo depth
                target = list(x.chunks)
                merged = []
                acc = 0
                need = max(lo, hi)
                for c in x.chunks[ax]:
                    acc += c
                    if acc >= need:
                        merged.append(acc)
                        acc = 0
                if acc:
                    if merged:
                        merged[-1] += acc
                    else:
                        merged.append(acc)
                target[ax] = tuple(merged)
                x = x.rechunk(tuple(target))
    return new_collection(Overlap(x.expr, dep, bd))


def trim_internal(x, axes, boundary=None):
    """Trim ``axes[ax]`` elements off every internal block boundary of ``x``.

    The inverse of :func:`overlap`: after a ghosted block computation the
    halo rows are cut back so chunks return to their pre-overlap layout.
    Reference parity: ``_overlap.py:643``.
    """
    from dask_array_tpu._collection import new_collection

    dep, bd = _normalize(x, axes, boundary)
    return new_collection(TrimInternal(x.expr, dep, bd))


def trim_overlap(x, depth, boundary=None):
    """Alias of :func:`trim_internal` taking a map_overlap-style ``depth``."""
    return trim_internal(x, depth, boundary=boundary)


def map_overlap(func, *args, depth=None, boundary=None, trim=True, align_arrays=True, allow_rechunk=True, **kwargs):
    """Apply ``func`` to blocks (of one or MORE arrays) with ghost cells.

    Parity: ``map_overlap`` (``_overlap.py:1041-1300``); the pipeline is
    align -> overlap each array -> map_blocks -> trim (``:428-454``).
    ``depth``/``boundary`` may be lists with one entry per array; arrays of
    different ndim block-broadcast (right-aligned), and trimming uses the
    highest-rank array's depth.  Trimming slices relative to each ACTUAL
    output block, so funcs that change block sizes (declared via
    ``chunks=``) trim correctly.
    """
    from dask_array_tpu._collection import Array
    from dask_array_tpu.ops._map_blocks import map_blocks

    if isinstance(func, Array) and args and callable(args[0]):
        # legacy map_overlap(x, func, ...) signature
        func, args = args[0], (func,) + args[1:]
    if not callable(func):
        raise TypeError(
            f"First argument must be callable function, not {type(func).__name__}\n"
            "Usage:   da.map_overlap(function, x)\n"
            "   or:   da.map_overlap(function, x, y, z)"
        )
    if not args or not all(isinstance(a, Array) for a in args):
        raise TypeError(
            "All variadic arguments must be arrays, not "
            f"{[type(a).__name__ for a in args]}\n"
            "Usage:   da.map_overlap(function, x)\n"
            "   or:   da.map_overlap(function, x, y, z)"
        )
    arrays = list(args)

    def coerce(xs, arg, fn):
        if not isinstance(arg, list):
            arg = [arg] * len(xs)
        if len(arg) != len(xs):
            raise ValueError(
                f"got {len(arg)} entries for {len(xs)} array arguments; a "
                "list-form depth/boundary needs one entry per array"
            )
        return [fn(x.ndim, a) for x, a in zip(xs, arg)]

    depths = coerce(arrays, 0 if depth is None else depth, coerce_depth)
    bounds = coerce(arrays, boundary, coerce_boundary)

    if align_arrays and len(arrays) > 1:
        from dask_array_tpu.ops.routines import unify_chunks

        ndim = max(a.ndim for a in arrays)
        uargs = []
        for a in arrays:
            uargs += [a, tuple(range(ndim - a.ndim, ndim))]
        _, arrays = unify_chunks(*uargs)

    # depth 0 everywhere: plain map_blocks (more efficient, parity :1271)
    if all(lo == 0 and hi == 0 for d in depths for (lo, hi) in d.values()):
        return map_blocks(func, *arrays, **kwargs)

    for i, (a, d, b) in enumerate(zip(arrays, depths, bounds)):
        for ax in range(a.ndim):
            lo, hi = d[ax]
            if lo != hi and b[ax] != "none":
                raise NotImplementedError(
                    "Asymmetric overlap is currently only implemented "
                    "for boundary='none', however boundary for dimension "
                    f"{ax} in array argument {i} is {b[ax]}"
                )

    from dask_array_tpu import config

    if config.get("tpu.overlap-method", "auto") == "shard" and _shard_stencil_eligible(
        arrays, depths, bounds, trim, kwargs
    ):
        from dask_array_tpu._collection import new_collection
        from dask_array_tpu._expr import compute_meta

        a = arrays[0]
        dep = tuple(depths[0][ax] for ax in range(a.ndim))
        bd = tuple(bounds[0][ax] for ax in range(a.ndim))
        dtype = kwargs.pop("dtype", None)
        fkw = {k: v for k, v in kwargs.items() if k not in ("name", "token")}
        if dtype is None:
            meta = compute_meta(func, a.ndim, a.expr, **fkw)
            dtype = getattr(meta, "dtype", a.dtype) if meta is not None else a.dtype
        from dask_array_tpu._blockwise import _normalize_kwargs

        return new_collection(
            ShardStencil(a.expr, func, dep, bd, _normalize_kwargs(fkw), np.dtype(dtype))
        )

    overlapped = [
        overlap(a, d, b, allow_rechunk=allow_rechunk)
        for a, d, b in zip(arrays, depths, bounds)
    ]
    mapped = map_blocks(func, *overlapped, **kwargs)
    if trim:
        # trim by the highest-rank array's halo (ties -> first; parity :448)
        i = sorted(enumerate(arrays), key=lambda v: (v[1].ndim, -v[0]))[-1][0]
        return trim_internal(mapped, depths[i], bounds[i])
    return mapped


# ---------------------------------------------------------------------------
# sliding windows
# ---------------------------------------------------------------------------


class SlidingWindowView(ArrayExpr):
    """numpy.lib.stride_tricks.sliding_window_view semantics.

    Window axes are appended as trailing single-chunk dims; the windowed
    source axes lose (window-1) from their final chunk (parity:
    ``SlidingWindowView``, ``_overlap.py:457``).
    """

    _parameters = ("array", "window_shape", "axes")

    @functools.cached_property
    def chunks(self):
        out = [list(c) for c in self.array.chunks]
        for w, ax in zip(self.window_shape, self.axes):
            shrink = w - 1
            axis = out[ax]
            i = len(axis) - 1
            while shrink > 0 and i >= 0:
                cut = min(shrink, axis[i])
                axis[i] -= cut
                shrink -= cut
                i -= 1
            out[ax] = [c for c in axis if c > 0] or [0]
        lead = tuple(tuple(c) for c in out)
        trail = tuple((w,) for w in self.window_shape)
        return lead + trail

    @property
    def _meta(self):
        return np.empty((0,) * (self.array.ndim + len(self.axes)), dtype=self.array.dtype)

    def _simplify_up(self, parent, dependents):
        # fuse reduce(sliding_window_view(x)) over the window dim into one
        # lax.reduce_window (parity: the SlidingWindowView->Reduction fusion,
        # /root/reference/dask_array/_overlap.py:457-623)
        from dask_array_tpu._blockwise import Elemwise
        from dask_array_tpu.ops.reductions import Reduction
        from dask_array_tpu.ops._sliding import (
            FUSABLE_WINDOW_REDUCERS,
            SlidingWindowReduce,
        )

        if (
            type(parent) is Reduction
            and parent.kind in FUSABLE_WINDOW_REDUCERS
            and not (parent.operand("extra") or ())
            and len(self.window_shape) == 1
            and parent.axes == (self.array.ndim,)  # exactly the window dim
            and not (
                self.array.dtype.kind == "c"
                and parent.kind in ("min", "max", "nanmin", "nanmax", "any", "all")
            )
        ):
            deps = dependents.get(self._name, ())
            if any(d._name != parent._name for d in deps):
                return None
            swr = SlidingWindowReduce(
                self.array,
                parent.kind,
                self.window_shape[0],
                self.axes[0],
                parent.dtype,
            )
            if parent.keepdims:
                from dask_array_tpu.ops.manipulation import ExpandDims

                return ExpandDims(swr, (self.array.ndim,))
            return swr
        if type(parent) is Elemwise:
            # elemwise commutes with the window gather, and running it BEFORE
            # windowing is strictly less work (n vs n*w elements); sinking the
            # view also unblocks the Reduction fusion for decomposed moments
            # (var/std/nanvar/nanstd are elemwise chains over the view ending
            # in window-axis sums).  Only scalar (0-d) co-operands are safe:
            # anything with dims would broadcast against the window dim.
            new_args = []
            hit = False
            for a in parent.args:
                if isinstance(a, ArrayExpr):
                    if a._name == self._name:
                        new_args.append(self.array)
                        hit = True
                    elif a.ndim == 0:
                        new_args.append(a)
                    else:
                        return super()._simplify_up(parent, dependents)
                else:
                    if isinstance(a, np.ndarray) and a.ndim > 0:
                        return super()._simplify_up(parent, dependents)
                    new_args.append(a)
            if hit:
                inner = Elemwise(*parent.operands[:2], *new_args)
                return SlidingWindowView(inner, self.window_shape, self.axes)
        return super()._simplify_up(parent, dependents)

    def _accept_slice(self, index):
        """Push basic slicing through the window view.

        Two shapes: an all-int index addresses ONE source element
        (``view[i.., k..] == x[.., i+k, ..]`` — this is what the moment
        shift ``view[(0,)*nd]`` becomes), and lead-axis slicing with the
        window dims untouched maps to a slice of the source extended by
        ``window-1`` on windowed axes.
        """
        import math

        from dask_array_tpu._slicing import Slice, is_basic_index

        if not is_basic_index(index):
            return None
        nd_in = self.array.ndim
        if len(index) != nd_in + len(self.axes):
            return None
        lead, trail = index[:nd_in], index[nd_in:]
        if all(isinstance(i, Integral) for i in index):
            xi = [int(i) for i in lead]
            for j, ax in enumerate(self.axes):
                xi[ax] += int(trail[j])
            return Slice(self.array, tuple(xi))
        if any(t != slice(None) for t in trail):
            return None
        windowed = set(self.axes)
        xi = []
        changed = False
        drop_before = {}
        dropped = 0
        for ax in range(nd_in):
            drop_before[ax] = dropped
            ind = lead[ax]
            if ax in windowed:
                if isinstance(ind, Integral):
                    return None  # window-collapse: only the all-int rule
                w = self.window_shape[self.axes.index(ax)]
                dim = self.array.shape[ax]
                if isinstance(dim, float) and math.isnan(dim):
                    return None
                start, stop, step = ind.indices(int(dim) - w + 1)
                if step != 1 or stop <= start:
                    return None
                xi.append(slice(start, stop - 1 + w, 1))
                if (start, stop) != (0, int(dim) - w + 1):
                    changed = True
            else:
                xi.append(ind)
                if isinstance(ind, Integral):
                    dropped += 1
                    changed = True
                elif ind != slice(None):
                    changed = True
        if not changed:
            return None
        new_axes = tuple(ax - drop_before[ax] for ax in self.axes)
        return SlidingWindowView(Slice(self.array, tuple(xi)), self.window_shape, new_axes)

    def _build(self, ctx):
        jnp = _jnp()
        dense = ctx.build(self.array).dense()
        out = dense
        nd0 = dense.ndim
        for j, (w, ax) in enumerate(zip(self.window_shape, self.axes)):
            n = out.shape[ax]
            starts = jnp.arange(n - w + 1)
            offs = jnp.arange(w)
            idx = starts[:, None] + offs[None, :]  # (n-w+1, w)
            out = jnp.take(out, idx.reshape(-1), axis=ax)
            # axis now has length (n-w+1)*w: split into (n-w+1, w), move w last
            new_shape = out.shape[:ax] + (n - w + 1, w) + out.shape[ax + 1:]
            out = out.reshape(new_shape)
            out = jnp.moveaxis(out, ax + 1, len(new_shape) - 1)
        return BlockView(self.chunks, dense=out)


def sliding_window_view(x, window_shape, axis=None, **kwargs):
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._from_array import asarray

    x = asarray(x)
    if isinstance(window_shape, Integral):
        window_shape = (int(window_shape),)
    window_shape = tuple(int(w) for w in window_shape)
    if axis is None:
        if len(window_shape) != x.ndim:
            raise ValueError("window_shape must match ndim when axis is None")
        axes = tuple(range(x.ndim))
    else:
        if isinstance(axis, Integral):
            axes = (validate_axis(axis, x.ndim),)
        else:
            axes = tuple(validate_axis(a, x.ndim) for a in axis)
    if len(axes) != len(window_shape):
        raise ValueError("window_shape and axis must have the same length")
    for w, ax in zip(window_shape, axes):
        if w > x.shape[ax]:
            raise ValueError("window shape cannot be larger than input array shape")
        if w < 1:
            raise ValueError("`window_shape` must contain positive values")
    return new_collection(SlidingWindowView(x.expr, window_shape, axes))


# ---------------------------------------------------------------------------
# push (forward-fill)
# ---------------------------------------------------------------------------


class Push(ArrayExpr):
    """bottleneck.push semantics: forward-fill NaNs along an axis, at most
    ``n`` positions (None = unlimited).  One XLA associative scan."""

    _parameters = ("array", "n", "axis")

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
        import jax

        jnp = _jnp()
        dense = ctx.build(self.array).dense().astype(self.dtype)
        axis = self.axis
        mc = self.n if self.n is not None else np.iinfo(np.int32).max

        # associative segment summaries: (v = last valid value in segment,
        # g = trailing-invalid count, has = any valid in segment)
        valid = ~jnp.isnan(dense)
        v0 = jnp.where(valid, dense, 0.0)
        g0 = jnp.where(valid, 0, 1).astype(jnp.int32)
        h0 = valid

        def combine(a, b):
            av, ag, ah = a
            bv, bg, bh = b
            v = jnp.where(bh, bv, av)
            g = bg + jnp.where(bh, 0, ag)
            h = ah | bh
            return (v, g, h)

        v, g, h = jax.lax.associative_scan(combine, (v0, g0, h0), axis=axis)
        out = jnp.where(h & (g <= mc), v, jnp.nan)
        return BlockView(self.chunks, dense=out)


def push(array, n=None, axis=-1):
    """Forward-fill NaNs along ``axis`` (bottleneck-style ``push``).

    ``n`` bounds how far a value propagates (default: unlimited).  Runs as
    an associative scan inside the traced program; cross-block carries use
    the same banded plan as the sliding-window reductions.  Reference
    parity: ``_overlap.py:1449``.
    """
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._from_array import asarray

    array = asarray(array)
    axis = validate_axis(axis, array.ndim)
    return new_collection(Push(array.expr, int(n) if n is not None else None, axis))


# slice pushdown for overlap pipelines lives on the classes themselves:
# Overlap._accept_slice / TrimInternal._accept_slice (non-halo axes commute;
# halo axes accept whole-output-block slices via the margin rewrite)
