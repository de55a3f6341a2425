"""Rechunk: change the block layout of an array.

Parity: ``Rechunk``/``plan_rechunk``/``TasksRechunk`` in
``/root/reference/dask_array/_rechunk.py`` — fresh implementation.

XLA-first: a rechunk is a *layout boundary*, not a copy tree.  Inside one
chip the dense traced array simply changes its logical block structure
(free); on a mesh the node carries a sharding constraint so XLA partitions
the program across the boundary with an all-to-all — the SPMD analog of
the reference's multi-stage task planner (its copies-vs-tasks tradeoff
becomes XLA's collective schedule).  The planner-level pushdowns (rechunk
through IO/elemwise/transpose, no-op elision, rechunk∘rechunk collapse)
still happen at expression level where they eliminate work outright.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from dask_array_tpu._chunks import normalize_chunks
from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr


class Rechunk(ArrayExpr):
    _parameters = ("array", "target_chunks")

    _sharding_boundary = True

    @functools.cached_property
    def chunks(self):
        return self.target_chunks

    @property
    def _meta(self):
        return self.array._meta

    def _simplify_down(self):
        if self.target_chunks == self.array.chunks:
            return self.array
        return None

    def _accept_rechunk(self, target_chunks):
        # Rechunk∘Rechunk collapses to one relayout.  This runs through the
        # sharing gate (``_rechunk_pushdown``): a SHARED inner rechunk must
        # stay — collapsing past it would de-share its output and duplicate
        # the upstream read (reference
        # test_rechunk_fusion_not_through_shared_inner_rechunk).
        return Rechunk(self.array, target_chunks)

    @property
    def _lower_cache_key(self):
        # the lower rewrite below depends on whether the child is shared;
        # key the (cross-plan) lower cache on that bit so one plan's
        # decision can never serve the other sharing pattern
        from dask_array_tpu._expr import lowering_shared_names

        if self.array._name in lowering_shared_names():
            return f"{self._name}|shared-child"
        return self._name

    def _lower(self):
        # give the child a chance to absorb the rechunk (IO leaves,
        # creation) — but never a child another parent consumes: absorbing
        # rewrites the child's grid, de-sharing it, and the source would be
        # read once per layout (reference
        # test_rechunk_slice_composition_does_not_push_into_shared_leaf)
        from dask_array_tpu._expr import lowering_shared_names

        if self.array._name in lowering_shared_names():
            return None
        absorbed = self.array._accept_rechunk(self.target_chunks)
        if absorbed is not None:
            return absorbed
        return None

    def _build(self, ctx):
        view = ctx.build(self.array)
        dense = view.dense()
        if ctx.mesh is not None and ctx.mode == "trace":
            from dask_array_tpu.parallel.collectives import mesh_collective_relayout

            out = mesh_collective_relayout(
                dense, self.array.chunks, self.target_chunks, ctx.mesh
            )
            if out is not None:
                # explicit all-to-all schedule drove the relayout; the
                # boundary constraint below is then a no-op re-statement
                return BlockView(self.chunks, dense=out)
        return BlockView(self.chunks, dense=dense)

    def transfer_bytes(self):
        """Between-block movement estimate (for explain / cost decisions).

        min: only misaligned fraction moves; max: full array crosses the
        boundary once (the all-to-all bound).
        """
        nb = self.array.nbytes
        if isinstance(nb, float) and math.isnan(nb):
            return (0, 0)
        moved = _moved_fraction(self.array.chunks, self.target_chunks)
        return (int(round(nb * moved)), int(nb))


def _axis_moved_fraction(src, dst):
    """Fraction of one axis's elements a src->dst relayout moves.

    Min-model (parity: ``moved_fraction``, reference ``_expr.py:675``): each
    destination chunk is assembled where its largest single-source piece
    lives — that piece stays put, the rest travels to join it.  Splits are
    free, merges move everything but the largest run member, jittered
    layouts move only boundary-crossing slivers.
    """
    src = tuple(src)
    dst = tuple(dst)
    total = sum(src)
    if not total or src == dst:
        return 0.0
    if any(isinstance(c, float) and math.isnan(c) for c in src + dst):
        return 0.0
    if sum(dst) != total:
        return 0.0
    if len(src) + len(dst) > 256:
        from dask_array_tpu import native

        out = native.moved_fraction_axis(src, dst)
        if out is not None:
            return out
    moved = 0.0
    i = 0
    src_lo = 0
    dst_lo = 0
    for d in dst:
        dst_hi = dst_lo + d
        best = 0
        while True:
            src_hi = src_lo + src[i]
            overlap = min(src_hi, dst_hi) - max(src_lo, dst_lo)
            if overlap > best:
                best = overlap
            if src_hi <= dst_hi and i + 1 < len(src):
                i += 1
                src_lo = src_hi
            else:
                break
        moved += d - best
        dst_lo = dst_hi
    return moved / total


def _moved_fraction(old, new):
    """Fraction of elements whose block assignment changes.

    An element stays put only if it stays along EVERY axis, so the stay
    fraction is the product of per-axis stay fractions.
    """
    stay = 1.0
    for o, n in zip(old, new):
        stay *= 1.0 - _axis_moved_fraction(o, n)
    return 1.0 - stay


def rechunk(x, chunks="auto", threshold=None, block_size_limit=None, balance=False, method=None):
    """Change the chunking of ``x`` (values unchanged)."""
    from dask_array_tpu._collection import Array, new_collection

    expr = x.expr if isinstance(x, Array) else x
    if isinstance(chunks, dict):
        # axes not named keep their EXISTING chunks; negative keys count
        # from the end (dask semantics; reference test_rechunk_noop_negative_index)
        by_axis = {}
        for k, v in chunks.items():
            ax = k + expr.ndim if k < 0 else k
            if not 0 <= ax < expr.ndim:
                raise ValueError(
                    f"rechunk axis {k} out of range for {expr.ndim}-d array"
                )
            by_axis[ax] = v
        chunks = tuple(by_axis.get(ax, expr.chunks[ax]) for ax in range(expr.ndim))
    if isinstance(chunks, (tuple, list)) and len(chunks) == expr.ndim:
        # None per axis means "keep existing chunks" (dask semantics)
        chunks = tuple(
            expr.chunks[ax] if c is None else c for ax, c in enumerate(chunks)
        )
    norm = normalize_chunks(
        chunks, expr.shape, limit=block_size_limit, dtype=expr.dtype, previous_chunks=expr.chunks
    )
    if balance:
        norm = tuple(_balance_axis(c) for c in norm)
    if norm == expr.chunks:
        return new_collection(expr)
    return new_collection(Rechunk(expr, norm))


def _balance_axis(c):
    """Even out a chunk tuple (same count, sizes differ by <=1)."""
    total = sum(c)
    n = len(c)
    if n == 0 or any(isinstance(x, float) and math.isnan(x) for x in c):
        return tuple(c)
    base = total // n
    rem = total - base * n
    return tuple(base + (1 if i < rem else 0) for i in range(n))


# ---------------------------------------------------------------------------
# chunk-intersection algebra (used by per-block consumers and the C++ planner)
# ---------------------------------------------------------------------------


def old_to_new(old_chunks, new_chunks):
    """For each axis, for each new block: list of (old_block, slice) pieces.

    The fundamental rechunk mapping (parity:
    ``/root/reference/dask_array/_rechunk.py:130``).  Uses the native
    plankit expansion for long axes.
    """
    out = []
    for o, n in zip(old_chunks, new_chunks):
        if len(o) + len(n) > 512:
            from dask_array_tpu import native

            res = native.old_to_new_axis(o, n)
            if res is not None:
                offsets, p_old, p_lo, p_hi = res
                axis = [
                    [
                        (int(p_old[k]), slice(int(p_lo[k]), int(p_hi[k])))
                        for k in range(offsets[j], offsets[j + 1])
                    ]
                    for j in range(len(n))
                ]
                out.append(axis)
                continue
        o_bounds = np.cumsum([0] + list(o))
        axis = []
        pos = 0
        ob = 0
        for size in n:
            lo, hi = pos, pos + size
            pieces = []
            while ob < len(o) and o_bounds[ob + 1] <= lo:
                ob += 1
            b = ob
            while b < len(o) and o_bounds[b] < hi:
                s = max(lo, o_bounds[b]) - o_bounds[b]
                e = min(hi, o_bounds[b + 1]) - o_bounds[b]
                pieces.append((b, slice(int(s), int(e))))
                b += 1
            axis.append(pieces)
            pos = hi
        out.append(axis)
    return out


def intersect_chunks(old_chunks, new_chunks):
    """Iterate, per new block (row-major), the old-block slab decomposition."""
    mapping = old_to_new(old_chunks, new_chunks)
    import itertools

    per_axis = [list(axis) for axis in mapping]
    for combo in itertools.product(*per_axis):
        yield tuple(itertools.product(*combo))


# ---------------------------------------------------------------------------
# multi-stage rechunk planning (parity: plan_rechunk, _rechunk.py:442)
# ---------------------------------------------------------------------------


def _stage_degree(old, new):
    """Max number of old blocks feeding one new block along any axis."""
    deg = 1
    for o, n in zip(old, new):
        if len(o) + len(n) > 256 and not any(
            isinstance(c, float) and math.isnan(c) for c in tuple(o) + tuple(n)
        ):
            from dask_array_tpu import native

            d = native.stage_degree_axis(o, n)
            if d is not None:
                deg = max(deg, d)
                continue
        mapping = old_to_new((o,), (n,))[0]
        deg = max(deg, max((len(pieces) for pieces in mapping), default=1))
    return deg


def plan_rechunk(old_chunks, new_chunks, itemsize=8, threshold=None, block_size_limit=None):
    """Plan intermediate chunk layouts for a rechunk.

    In the traced program this planner does NOT drive execution (GSPMD owns the collective
    schedule for a layout change); it exists for cost reporting (`explain`)
    and for the eager per-block path, where bounding the fan-in degree per
    stage keeps gather widths sane — the copies-vs-tasks tradeoff of the
    reference's planner becomes stages-vs-gather-degree here.

    Returns a list of chunk layouts ending with ``new_chunks``.
    """
    from dask_array_tpu import config

    if threshold is None:
        threshold = config.get("array.rechunk.threshold", 32)
    deg = _stage_degree(old_chunks, new_chunks)
    if deg <= threshold:
        return [new_chunks]
    # stage 1: per axis, the boundary union (refinement) — every old->mid
    # edge is then a pure split (degree 1 per source chunk)
    from dask_array_tpu._chunks import common_blockdim

    mid = tuple(
        common_blockdim([tuple(o), tuple(n)]) if tuple(o) != tuple(n) else tuple(o)
        for o, n in zip(old_chunks, new_chunks)
    )
    if mid == new_chunks:
        return [new_chunks]  # pure split: every gather has width 1
    # stages 2..k: bound the MERGE fan-in (the reference's recursive
    # bounded-degree planner, ``_rechunk.py:395-562``): each stage merges
    # at most ``threshold`` consecutive pieces per target chunk, so no
    # single gather ever exceeds the threshold
    stages = [] if mid == old_chunks else [mid]  # pure merge: skip refine
    cur = mid
    guard = 0
    while cur != new_chunks and guard < 64:
        guard += 1
        nxt_axes = []
        for o_ax, n_ax in zip(cur, new_chunks):
            o_ax, n_ax = tuple(o_ax), tuple(n_ax)
            if o_ax == n_ax:
                nxt_axes.append(o_ax)
                continue
            out = []
            i = 0
            for tgt in n_ax:
                run = []
                s = 0
                while s < tgt and i < len(o_ax):
                    run.append(o_ax[i])
                    s += o_ax[i]
                    i += 1
                if len(run) <= threshold:
                    out.append(tgt)
                else:
                    for g in range(0, len(run), threshold):
                        out.append(sum(run[g : g + threshold]))
            nxt_axes.append(tuple(out))
        nxt = tuple(nxt_axes)
        if nxt == cur:
            break  # cannot make progress (irregular boundary); stop safely
        stages.append(nxt)
        cur = nxt
    if stages[-1] != new_chunks:
        stages.append(new_chunks)
    return stages


def _choose_rechunk_method(old_chunks, new_chunks, threshold=None, mesh=None):
    """tasks vs collective (the reference's tasks-vs-p2p choice,
    ``_rechunk.py:563``).

    On a mesh the decisive question is whether the layout change MOVES a
    mesh axis between array axes — if so, the executor emits an explicit
    ``all_to_all`` schedule (``mesh_collective_relayout``); otherwise the
    relayout is a local reslicing under an unchanged sharding and stays a
    pure constraint.  Off-mesh, high stage degree picks "collective" for
    cost reporting (the all-to-all bound applies in ``transfer_bytes``).
    """
    from dask_array_tpu import config

    method = config.get("array.rechunk.method", "auto")
    if method in ("tasks", "collective", "p2p"):
        return "collective" if method == "p2p" else method
    if mesh is not None:
        from dask_array_tpu.parallel.layout import plan_layout

        shape = tuple(sum(c) for c in old_chunks)
        if not any(isinstance(s, float) and math.isnan(s) for s in shape):
            in_spec = plan_layout(shape, old_chunks, mesh)
            out_spec = plan_layout(shape, new_chunks, mesh)
            for name in mesh.shape:
                a = in_spec.index(name) if name in in_spec else None
                b = out_spec.index(name) if name in out_spec else None
                if a is not None and b is not None and a != b:
                    return "collective"
        return "tasks"
    deg = _stage_degree(old_chunks, new_chunks)
    return "collective" if deg > (threshold or config.get("array.rechunk.threshold", 32)) else "tasks"
