"""Explicit SPMD collectives: shard_map halo exchange, all-to-all reshard,
psum reduction.

The default executor lets GSPMD insert collectives from sharding
constraints.  These explicit implementations exist (a) as the documented
mechanism mapping of SURVEY.md §2.6 (halo -> ppermute, rechunk ->
all_to_all, tree reduce -> psum), (b) for kernels where hand-placed
collectives beat GSPMD's choices (ring schedules), and (c) as the building
blocks for the pallas-level ring collectives in kernels/.
"""

from __future__ import annotations

import functools

import numpy as np


def _shard_map():
    import jax

    # jax>=0.7 exposes shard_map at jax.shard_map; older via jax.experimental
    if hasattr(jax, "shard_map"):
        return jax.shard_map
    from jax.experimental.shard_map import shard_map as sm

    return sm


def halo_exchange(x, mesh, axis_name, axis: int, depth: int, wrap: bool = False):
    """Attach ghost cells from ring neighbors along a sharded axis.

    Each shard receives ``depth`` rows from its left and right neighbors via
    ``lax.ppermute`` (the reference's overlap ghost-cell tasks,
    ``/root/reference/dask_array/_overlap.py:70``, as one neighbor
    exchange).  Edge shards get zero halos unless ``wrap`` (periodic).

    ``axis_name`` may be a TUPLE of mesh axes for an axis sharded over a
    nested group (multi-slice: ``("dcn", "x")``).  The ring runs over the
    linearised group order, so of the ``n-1`` neighbor pairs only the
    ``n_slices - 1`` slice-boundary pairs cross DCN — each carrying one
    depth-row edge, the minimum possible inter-slice halo traffic.

    Returns an array with shard-local shape grown by 2*depth along ``axis``
    (global shape grows by n_shards * 2 * depth — callers trim per shard).
    """
    import jax
    import jax.numpy as jnp
    from jax.lax import ppermute
    from jax.sharding import PartitionSpec as P

    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    n = 1
    for nm in names:
        n *= mesh.shape[nm]
    shard_map = _shard_map()

    spec_in = [None] * x.ndim
    spec_in[axis] = axis_name if isinstance(axis_name, str) else names
    spec = P(*spec_in)

    def body(shard):
        lo_edge = jax.lax.slice_in_dim(shard, 0, depth, axis=axis)
        hi_edge = jax.lax.slice_in_dim(
            shard, shard.shape[axis] - depth, shard.shape[axis], axis=axis
        )
        fwd = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
        bwd = [(i, (i - 1) % n) for i in range(n) if wrap or i > 0]
        from_left = ppermute(hi_edge, names, fwd)   # my left neighbor's tail
        from_right = ppermute(lo_edge, names, bwd)  # my right neighbor's head
        idx = jax.lax.axis_index(names[0])
        for nm in names[1:]:
            idx = idx * mesh.shape[nm] + jax.lax.axis_index(nm)
        if not wrap:
            from_left = jnp.where(idx == 0, jnp.zeros_like(from_left), from_left)
            from_right = jnp.where(idx == n - 1, jnp.zeros_like(from_right), from_right)
        return jnp.concatenate([from_left, shard, from_right], axis=axis)

    fn = shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec)
    return fn(x)


def alltoall_reshard(
    x,
    mesh,
    axis_name: str,
    from_axis: int,
    to_axis: int,
    spec=None,
    spec_in=None,
    spec_out=None,
):
    """Move the sharded dimension from ``from_axis`` to ``to_axis``.

    One ``lax.all_to_all`` — the SPMD form of the reference's
    rechunk task plan for an axis-swap relayout
    (``/root/reference/dask_array/_rechunk.py`` TasksRechunk/P2PRechunk).

    ``spec`` optionally carries the full partition assignment (one mesh-axis
    name or None per array axis) so OTHER mesh axes stay sharded through the
    exchange; only ``axis_name``'s assignment moves.  ``spec_in``/``spec_out``
    override the full in/out assignments explicitly — the relayout scheduler
    uses this for NESTED entries (``("dcn", "x")``), where ``axis_name``
    moves minor-most out of / into an axis other mesh axes keep sharded.
    """
    from jax.lax import all_to_all
    from jax.sharding import PartitionSpec as P

    shard_map = _shard_map()
    if spec_in is None or spec_out is None:
        base = list(spec) if spec is not None else [None] * x.ndim
        spec_in = list(base)
        spec_in[from_axis] = axis_name
        if spec_in[to_axis] == axis_name:
            spec_in[to_axis] = None
        spec_out = list(spec_in)
        spec_out[from_axis] = None
        spec_out[to_axis] = axis_name

    def body(shard):
        return all_to_all(shard, axis_name, split_axis=to_axis, concat_axis=from_axis, tiled=True)

    fn = shard_map(body, mesh=mesh, in_specs=(P(*spec_in),), out_specs=P(*spec_out))
    return fn(x)


def swap_reshard(x, mesh, name_a, name_b, axis_a, axis_b, spec=None):
    """Trade the array axes of two mesh axes without any all-gather.

    The cyclic relayout ``P(a,b) -> P(b,a)`` is the one rechunk shape the
    acyclic staged planner can't order; GSPMD's generic schedule resolves
    it with all-gathers (measured: 3 on a 2x4 mesh).  Two explicit
    schedules avoid that entirely:

    - ``|a| == |b|`` (square): out-shard ``(i, j)`` is exactly in-shard
      ``(j, i)`` — ONE whole-shard ``lax.ppermute`` over the combined
      group, the minimal possible traffic (each device sends its shard
      once).
    - ``|a| != |b|``: three stages through a NESTED sharding of
      ``axis_b`` — (1) ``all_to_all`` moves ``a`` into ``axis_b`` as the
      minor divisor (``P(None, (b, a))``), (2) one whole-shard ppermute
      reorders the nesting to ``P(None, (a, b))``, (3) ``all_to_all``
      pulls ``b`` out to ``axis_a``, leaving ``P(b, a)`` with contiguous
      shards.  Total traffic ~ (1 + (na-1)/na + (nb-1)/nb) shard volumes
      — far below any gather-based plan.

    Reference analog: the rechunk planner's copy-minimising stage choice
    (``/root/reference/dask_array/_rechunk.py:563``).
    Returns None when axis sizes don't divide the nested grid.
    """
    from jax.lax import all_to_all, ppermute
    from jax.sharding import PartitionSpec as P

    n_a = mesh.shape[name_a]
    n_b = mesh.shape[name_b]
    shard_map = _shard_map()
    base = list(spec) if spec is not None else [None] * x.ndim
    spec_in = list(base)
    spec_in[axis_a] = name_a
    spec_in[axis_b] = name_b
    spec_out = list(base)
    spec_out[axis_a] = name_b
    spec_out[axis_b] = name_a

    if n_a == n_b:
        # square: single whole-shard permute; linear index over the
        # combined (name_a, name_b) group is i*n + j in axis-name order
        perm = [(i * n_a + j, j * n_a + i) for i in range(n_a) for j in range(n_a)]

        def body(shard):
            return ppermute(shard, (name_a, name_b), perm)

        fn = shard_map(body, mesh=mesh, in_specs=(P(*spec_in),), out_specs=P(*spec_out))
        return fn(x)

    # non-square: stage through a nested sharding of axis_b
    size_a = x.shape[axis_a]
    size_b = x.shape[axis_b]
    if size_b % (n_a * n_b) != 0 or size_a % n_b != 0 or size_a % n_a != 0:
        return None

    spec_mid1 = list(base)
    spec_mid1[axis_a] = None
    spec_mid1[axis_b] = (name_b, name_a)
    spec_mid2 = list(base)
    spec_mid2[axis_a] = None
    spec_mid2[axis_b] = (name_a, name_b)

    def stage1(shard):
        return all_to_all(shard, name_a, split_axis=axis_b, concat_axis=axis_a, tiled=True)

    # nesting reorder: piece p = j*n_a + i (b-major) must land on the
    # device that owns piece p under a-major nesting, i.e. (p//n_b, p%n_b)
    perm = [
        (i * n_b + j, (j * n_a + i)) for i in range(n_a) for j in range(n_b)
    ]

    def stage2(shard):
        return ppermute(shard, (name_a, name_b), perm)

    def stage3(shard):
        return all_to_all(shard, name_b, split_axis=axis_a, concat_axis=axis_b, tiled=True)

    out = shard_map(stage1, mesh=mesh, in_specs=(P(*spec_in),), out_specs=P(*spec_mid1))(x)
    out = shard_map(stage2, mesh=mesh, in_specs=(P(*spec_mid1),), out_specs=P(*spec_mid2))(out)
    out = shard_map(stage3, mesh=mesh, in_specs=(P(*spec_mid2),), out_specs=P(*spec_out))(out)
    return out


def mesh_collective_relayout(dense, old_chunks, new_chunks, mesh, method=None):
    """Explicit collective schedule for a rechunk layout boundary.

    Compares the mesh layouts of the OLD and NEW chunk grids
    (``plan_layout``); every mesh axis whose array-axis assignment moves is
    resharded with one explicit ``all_to_all`` stage (other mesh axes stay
    sharded through each stage).  Returns the resharded traced value, or
    ``None`` when no axis moves / the method forbids it — the caller then
    falls back to a bare ``with_sharding_constraint`` and GSPMD's schedule.

    This is the executor-wired form of the reference's rechunk planner
    (``/root/reference/dask_array/_rechunk.py:442,563,1326``): its
    copies-vs-tasks choice becomes constraint-vs-explicit-all-to-all, and
    its multi-stage plan becomes one all_to_all per moving mesh axis.
    """
    import math

    from dask_array_tpu import config
    from dask_array_tpu.parallel.layout import plan_layout

    if method is None:
        method = config.get("array.rechunk.method", "auto")
    if method == "tasks":
        return None
    shape = tuple(sum(c) for c in old_chunks)
    if any(isinstance(s, float) and math.isnan(s) for s in shape):
        return None

    def _tup(entry):
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def _entry(t):
        return None if not t else (t[0] if len(t) == 1 else t)

    in_spec = [_tup(e) for e in plan_layout(shape, old_chunks, mesh)]
    out_spec = [_tup(e) for e in plan_layout(shape, new_chunks, mesh)]

    def _axis_of(spec, name):
        for ax, entry in enumerate(spec):
            if name in entry:
                return ax
        return None

    moves = []
    for name in mesh.shape:
        a = _axis_of(in_spec, name)
        b = _axis_of(out_spec, name)
        if a is not None and b is not None and a != b:
            moves.append((name, a, b))
    if not moves:
        if in_spec != out_spec:
            return None  # same-axis nesting reorder: GSPMD's schedule
        return None
    # DCN moves (rare — plan_layout pins DCN axes grid-independently, so a
    # move only happens under a hand-written spec) stage LAST: every
    # exchange completes first, and the slow-fabric transfer runs once on
    # the final layout instead of serialising intermediate stages
    # behind it.
    from dask_array_tpu.parallel.mesh import dcn_axis_names

    dcn = dcn_axis_names(mesh)
    moves.sort(key=lambda mv: mv[0] in dcn)
    # non-moving names must keep their nesting position (we only schedule
    # whole-axis moves); anything else goes to GSPMD
    moving = {mv[0] for mv in moves}
    for ax in range(len(shape)):
        if tuple(n for n in in_spec[ax] if n not in moving) != tuple(
            n for n in out_spec[ax] if n not in moving
        ):
            return None

    # stage the moves so each is a clean tiled all_to_all: the moving mesh
    # axis must be MINOR-MOST at its source (contiguous sub-blocks leave)
    # and land MINOR-MOST on its destination's current occupants (which
    # must already equal the target prefix).  Nested entries arise from
    # DCN-rooted shardings — P(('dcn','x')) — where 'x' relayouts while
    # 'dcn' stays pinned.  Cyclic move sets (mesh-axis swaps) that can't
    # be ordered fall back to swap schedules or the GSPMD constraint.
    def _occ(t):
        n = 1
        for nm in t:
            n *= mesh.shape[nm]
        return n

    local = [s // _occ(e) for s, e in zip(shape, in_spec)]
    cur = [tuple(e) for e in in_spec]
    ordered = []
    pending = list(moves)
    while pending:
        progress = False
        for mv in list(pending):
            name, a, b = mv
            if cur[a] and cur[a][-1] != name:
                continue  # not minor-most yet; a later-nested move first
            target_prefix = out_spec[b][: out_spec[b].index(name)]
            if cur[b] != target_prefix:
                continue  # destination occupied/incomplete; retry later
            n = mesh.shape[name]
            if local[b] % n != 0:
                return None  # unsplittable at this stage
            spec_in_stage = [list(e) for e in cur]
            cur[a] = cur[a][:-1]
            cur[b] = cur[b] + (name,)
            spec_out_stage = [list(e) for e in cur]
            ordered.append(("a2a", name, a, b, spec_in_stage, spec_out_stage))
            local[b] //= n
            local[a] *= n
            pending.remove(mv)
            progress = True
        if progress:
            continue
        # cycle: look for a two-move axis swap — resolvable by
        # swap_reshard (whole-shard ppermute when equal-sized; 3-stage
        # nested all_to_all schedule otherwise).  Longer cycles or
        # indivisible shapes go to GSPMD.
        def _swap_ok(name_a, name_b, axis_a, axis_b):
            na, nb = mesh.shape[name_a], mesh.shape[name_b]
            if na == nb:
                return True
            return (
                shape[axis_b] % (na * nb) == 0
                and shape[axis_a] % na == 0
                and shape[axis_a] % nb == 0
            )

        swap = None
        for m1 in pending:
            for m2 in pending:
                if m1 is m2:
                    continue
                n1, a1, b1 = m1
                n2, a2, b2 = m2
                if a1 != b2 or b1 != a2:
                    continue
                # the flat-entry swap schedules only apply when each axis
                # carries exactly its swapping mesh axis (no nesting)
                if cur[a1] != (n1,) or cur[b1] != (n2,):
                    continue
                if _swap_ok(n1, n2, a1, b1):
                    swap = (n1, n2, a1, b1, m1, m2)
                    break
                if _swap_ok(n2, n1, a2, b2):
                    swap = (n2, n1, a2, b2, m2, m1)
                    break
            if swap:
                break
        if swap is None:
            return None  # irreducible cycle: GSPMD's schedule handles it
        name_a, name_b, a1, b1, m1, m2 = swap
        ordered.append(("swap", name_a, name_b, a1, b1, [_entry(e) for e in cur]))
        cur[a1], cur[b1] = (name_b,), (name_a,)
        pending.remove(m1)
        pending.remove(m2)
    out = dense
    for stage in ordered:
        if stage[0] == "a2a":
            _, name, a, b, s_in, s_out = stage
            out = alltoall_reshard(
                out,
                mesh,
                name,
                from_axis=a,
                to_axis=b,
                spec_in=[_entry(tuple(e)) for e in s_in],
                spec_out=[_entry(tuple(e)) for e in s_out],
            )
        else:
            _, name_a, name_b, a, b, spec = stage
            out = swap_reshard(out, mesh, name_a, name_b, a, b, spec=spec)
            if out is None:  # divisibility declined: GSPMD owns the boundary
                return None
    return out


def psum_reduce(x, mesh, axis_name: str, axis: int):
    """Sum over a sharded axis: local reduce + one psum tree.

    The SPMD form of the reference's ``PartialReduce`` split_every cascade
    (``/root/reference/dask_array/reductions/_reduction.py:900``).
    """
    import jax.numpy as jnp
    from jax.lax import psum
    from jax.sharding import PartitionSpec as P

    shard_map = _shard_map()
    spec_in = [None] * x.ndim
    spec_in[axis] = axis_name
    out_spec = [s for i, s in enumerate(spec_in) if i != axis]

    def body(shard):
        local = jnp.sum(shard, axis=axis)
        return psum(local, axis_name)

    fn = shard_map(body, mesh=mesh, in_specs=(P(*spec_in),), out_specs=P(*out_spec))
    return fn(x)
