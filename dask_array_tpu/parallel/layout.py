"""Chunk-grid -> mesh-sharding layout solver.

The dask "chunks" duality on a mesh (SURVEY.md §7 "chunks-vs-sharding"):
chunks form an arbitrary logical grid; XLA shardings are regular.  This
module maps a chunk grid onto a mesh by assigning mesh axes to the array
axes whose *sizes* divide evenly, preferring the axes with the most blocks
(so each device owns a whole sub-grid of blocks).  Irregular grids fall
back to replication (correct, not scaled) — per-block dispatch handles
them off-mesh.
"""

from __future__ import annotations

import math


def _regular(chunks_axis) -> bool:
    """True if every block along this axis has the same size."""
    if not chunks_axis:
        return False
    first = chunks_axis[0]
    return all(c == first for c in chunks_axis) and not (
        isinstance(first, float) and math.isnan(first)
    )


def plan_layout(shape, chunks, mesh, allow_uneven=False):
    """Choose a PartitionSpec assignment: array axis -> mesh axis (or None).

    Greedy: largest mesh axes get the array axes with the most evenly
    divisible size, one mesh axis per array axis.  With ``allow_uneven``
    (valid for ``with_sharding_constraint`` targets, where GSPMD pads the
    last shard — NOT for ``device_put``), an irregular axis that merely
    FITS the mesh axis (``dim >= msize``) still shards, at a lower score
    than a divisible one — this is the pad-to-regular answer to the
    chunks-vs-sharding duality (SURVEY.md §7): irregular chunk grids
    compute sharded instead of replicated.
    """
    from dask_array_tpu.parallel.mesh import dcn_axis_names

    dcn = dcn_axis_names(mesh)
    assignment: list = [None] * len(shape)
    # DCN axes first, with a STABLE chunk-grid-independent rule (outermost
    # divisible array axis): both sides of any relayout then agree on the
    # DCN assignment, so rechunk boundaries move data over ICI only.  The
    # slow fabric carries the batch-like dimension (the scaling-book
    # data-parallel-over-DCN recipe) and never relayout traffic.
    for name in sorted(dcn, key=lambda n: -mesh.shape[n]):
        msize = mesh.shape[name]
        if msize == 1:
            continue
        for ax, dim in enumerate(shape):
            if assignment[ax] is not None:
                continue
            if isinstance(dim, float) and math.isnan(dim):
                continue
            if dim % msize == 0 or (allow_uneven and dim >= msize):
                assignment[ax] = name
                break
    mesh_axes = sorted(
        ((n, s) for n, s in mesh.shape.items() if n not in dcn),
        key=lambda kv: -kv[1],
    )  # (name, size)
    for name, msize in mesh_axes:
        if msize == 1:
            continue
        best = None
        best_score = 0
        for ax, dim in enumerate(shape):
            occupants = assignment[ax]
            nested = occupants is not None
            if nested:
                # ICI may nest as the MINOR divisor under a DCN-pinned axis
                # (the 8-way batch grid on a (dcn=2, x=4) mesh wants
                # P(('dcn','x'))) — never under another ICI axis, so
                # DCN-free meshes keep the one-mesh-axis-per-array-axis rule
                occ = occupants if isinstance(occupants, tuple) else (occupants,)
                if not all(o in dcn for o in occ):
                    continue
                occ_size = 1
                for o in occ:
                    occ_size *= mesh.shape[o]
            else:
                occ_size = 1
            if isinstance(dim, float) and math.isnan(dim):
                continue
            local = dim // occ_size if dim % occ_size == 0 else dim / occ_size
            if local % msize != 0:
                if not (allow_uneven and not nested and dim >= msize):
                    continue
                score = dim / 8  # shardable via padding, but prefer divisible
            else:
                score = dim
            # prefer sharding axes whose chunk grid also divides evenly
            if chunks is not None and len(chunks) == len(shape):
                nb = len(chunks[ax])
                if _regular(chunks[ax]) and nb % (msize * occ_size) == 0:
                    score *= 4
            if score > best_score:
                best, best_score = ax, score
        if best is not None:
            occupants = assignment[best]
            if occupants is None:
                assignment[best] = name
            elif isinstance(occupants, tuple):
                assignment[best] = occupants + (name,)
            else:
                assignment[best] = (occupants, name)
    return tuple(assignment)


def sharding_for_chunks(shape, chunks, mesh, allow_uneven=False):
    """NamedSharding for an array with this chunk grid on this mesh."""
    if mesh is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec

    spec = plan_layout(shape, chunks, mesh, allow_uneven=allow_uneven)
    return NamedSharding(mesh, PartitionSpec(*spec))


def sharding_for(shape, mesh):
    # device_put target: uneven shardings are NOT allowed here
    return sharding_for_chunks(shape, None, mesh)


def constrain_to_mesh(dense, chunks, mesh):
    """Apply a chunk-aligned sharding constraint to a traced dense value.

    Constraint targets tolerate uneven dims (GSPMD pads), so irregular
    grids still shard here.
    """
    import jax

    sh = sharding_for_chunks(dense.shape, chunks, mesh, allow_uneven=True)
    if sh is None:
        return dense
    try:
        return jax.lax.with_sharding_constraint(dense, sh)
    except Exception:
        return dense
