"""Per-block shard_map execution lane (prototype — VERDICT r3 #5).

The default executor answers the chunks-vs-sharding duality with GSPMD:
dense whole-array ops plus ``with_sharding_constraint``, padding UNEVEN
dims at partition time (which can insert pad/all-gather traffic and
recompute padding work).  This lane makes irregular chunk grids
first-class on the mesh instead: blocks along the chunked axis are padded
to the tallest block, stacked on a leading BLOCK axis, and the block axis
is sharded over every mesh axis.  Inside ``jax.shard_map`` each device
owns whole blocks and runs per-block logic:

  * elemwise trees apply per-block (padding computes garbage that is
    never read back),
  * reductions mask padding to the reduction identity, reduce locally,
    and combine with ONE tiny ``psum``/``pmin``/``pmax`` — the compiled
    HLO contains NO all-gather (``tests/test_shardlane.py`` pins this),
  * cumulative scans run the genuine BLELLOCH two-phase schedule across
    devices: a local scan per device, one tiny all-gather of per-device
    totals, then a local carry apply — the cross-device traffic is
    ``ndev * rest`` elements, not the array
    (reference: ``CumReductionBlelloch``,
    ``/root/reference/dask_array/reductions/_cumulative.py:267``),
  * 2-D matmul/matvec terminals run in one of three forms:
    free (row) axis chunked — the rhs replicates whole and the compiled
    HLO holds NO collective; CONTRACTION axis chunked (the classic
    tensor-parallel split) — both operands restack along the shared
    contraction profile, each device contracts its own blocks, and the
    partials combine with exactly ONE ``psum``; or COLUMN-parallel — a
    single-block lhs against a rhs chunked along its free axis swaps
    operand roles, so the weights shard by columns, the lhs replicates,
    and the HLO again holds no collective (the Megatron column split).
    A rhs chunked along its contraction axis swaps into matmul_k the
    same way.

Engage with config ``tpu.execution-lane = "shard-map"`` (default
``"auto"`` keeps the GSPMD lane).  Scope (a prototype, declines
otherwise): leaves are ``from_array`` host buffers sharing one chunk
grid, chunked along any ONE axis ``d`` (IRREGULAR block heights welcome —
that is the point), combined by elemwise trees, optionally terminated by
one typed reduction (sum/prod/min/max/mean over all axes, over ``d``, or
block-locally over unsharded axes), one cumsum/cumprod (two-phase
Blelloch along ``d``; collective-free block-local scans along unsharded
axes), or one 2-D MATMUL/matvec: rows chunked → rhs replicated whole
(weights-stationary per-device GEMMs, zero collectives); contraction
chunked → both operands restacked along the shared profile, per-device
partial GEMMs, ONE psum (the classic tensor-parallel split).  The rhs's
own declared chunk grid never matters — blocks restack from the dense
host buffer.
"""

from __future__ import annotations

import functools
import math

import numpy as np

#: engagement counter for tests (incremented on every lane execution)
ENGAGED = {"count": 0}

_REDUCE_IDENT = {
    "sum": 0.0,
    "prod": 1.0,
    "min": np.inf,
    "max": -np.inf,
    "mean": 0.0,
    # nan variants combine cross-device with their own masking (padding ->
    # NaN / 0); listed here so the plan gate admits them
    "nansum": 0.0,
    "nanmean": 0.0,
    "nanmin": np.inf,
    "nanmax": -np.inf,
    # truth reductions: padding fills falsy/truthy, combine is pmax/pmin
    "any": False,
    "all": True,
}

#: kinds the lane can execute at all (nanprod joins only block-locally)
_LANE_KINDS = tuple(_REDUCE_IDENT) + ("nanprod",)


def _reduce_ident(kind, dtype):
    """The identity of ``kind`` IN ``dtype`` (padding fill value): ±inf
    maps to the integer extrema for int dtypes, True/False for bool."""
    dtype = np.dtype(dtype)
    if kind in ("sum", "mean"):
        return np.zeros((), dtype)[()]
    if kind == "prod":
        return np.ones((), dtype)[()]
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return info.max if kind == "min" else info.min
    if dtype.kind == "b":
        return kind == "min"
    return np.inf if kind == "min" else -np.inf


def _unwrap(expr):
    while type(expr).__name__ == "FusedBlockwise":
        expr = expr.root
    return expr


def _masked_combine(val, mask, rkind, acc_dtype, red_axes, mesh_axes, count):
    """Mask padding to the identity, reduce locally over ``red_axes``
    (None = all axes), combine across devices with ONE tiny collective.

    nan kinds on float data skip NaNs: nanmean psums a data-dependent
    non-NaN count, and nanmin/nanmax swap NaN locals to the identity with
    an any-real-value vote so an all-NaN+padding device cannot poison the
    pmin/pmax (NaN restored iff NO device held a real value).
    """
    import jax
    import jax.numpy as jnp

    nan_kind = rkind.startswith("nan") and np.dtype(val.dtype).kind in "fc"
    base = rkind[3:] if rkind.startswith("nan") else rkind
    acc_kw = {"dtype": acc_dtype} if acc_dtype.kind in "fc" else {}
    if base in ("any", "all"):
        # padding fills falsy (any) / truthy (all); the tiny bool partials
        # combine with pmax/pmin over an int32 cast
        fill = jnp.asarray(base == "all").astype(val.dtype)
        v = jnp.where(mask, val, fill)
        part = (jnp.any if base == "any" else jnp.all)(v, axis=red_axes)
        comb = jax.lax.pmax if base == "any" else jax.lax.pmin
        return comb(part.astype(jnp.int32), mesh_axes).astype(bool)
    if base in ("sum", "mean"):
        zero = jnp.zeros((), val.dtype)
        if nan_kind:
            real = mask & ~jnp.isnan(val)
            part = jnp.sum(jnp.where(real, val, zero), axis=red_axes, **acc_kw)
        else:
            part = jnp.sum(jnp.where(mask, val, zero), axis=red_axes, **acc_kw)
        tot = jax.lax.psum(part, mesh_axes)
        if rkind == "nanmean" and nan_kind:
            cnt = jax.lax.psum(
                jnp.sum(real, axis=red_axes, dtype=jnp.int32), mesh_axes
            )
            tot = tot / cnt.astype(tot.dtype)
        elif rkind in ("mean", "nanmean"):
            tot = tot / jnp.asarray(count, tot.dtype)
        return tot
    pop = jax.lax.pmin if base == "min" else jax.lax.pmax
    ident = jnp.asarray(_reduce_ident(base, np.dtype(val.dtype)), val.dtype)
    if nan_kind:
        v = jnp.where(mask & ~jnp.isnan(val), val, ident)
        part = (jnp.min if base == "min" else jnp.max)(v, axis=red_axes)
        has = jnp.any(mask & ~jnp.isnan(val), axis=red_axes)
        tot = pop(part, mesh_axes)
        any_has = jax.lax.pmax(has.astype(jnp.int32), mesh_axes)
        return jnp.where(any_has > 0, tot, jnp.asarray(jnp.nan, tot.dtype))
    v = jnp.where(mask, val, ident)
    part = (jnp.min if base == "min" else jnp.max)(v, axis=red_axes)
    return pop(part, mesh_axes)


def _local_reduce(val, rkind, acc_dtype, red_axes, count):
    """Block-local reduce (no padding in scope along ``red_axes``, no
    collective): plain jnp/nan ops with float accumulation dtypes."""
    import jax.numpy as jnp

    op = {"sum": jnp.sum, "mean": jnp.sum, "prod": jnp.prod,
          "min": jnp.min, "max": jnp.max,
          "any": jnp.any, "all": jnp.all,
          "nansum": jnp.nansum, "nanmean": jnp.nanmean,
          "nanprod": jnp.nanprod,
          "nanmin": jnp.nanmin, "nanmax": jnp.nanmax}[rkind]
    kw = {}
    if rkind in ("sum", "mean", "prod", "nansum", "nanmean",
                 "nanprod") and acc_dtype.kind in "fc":
        kw["dtype"] = acc_dtype
    out = op(val, axis=red_axes, **kw)
    if rkind == "mean":
        out = out / jnp.asarray(count, out.dtype)
    return out


def _walk_elem(node, leaves, seen, reds=None, consts=None, scans=None):
    """Walk an elemwise tree down to FromArray leaves; False = decline.

    With ``reds``/``consts`` lists supplied the walk also admits:

    * INNER ``Reduction`` nodes (collected into ``reds``) whose own
      subtree is an elemwise tree over the same leaves — their results
      are replicated inside the shard_map body (one collective each)
      and broadcast back into the outer tree.  This is what makes
      ``x.var()``, ``x.std()`` and ``(x - x.mean()) / x.std()`` ONE
      lane program.  Axis/shape gates run later, once the grid is known.
    * 0-d subtrees of any other kind (collected into ``consts``) —
      evaluated host-side through the regular executor at plan time
      (e.g. the one-pass variance's ``x[0, 0]`` shift element).

    With a ``scans`` list supplied (the r5 multi-terminal widening) the
    walk also admits INNER ``CumReduction`` nodes: a scan preserves
    shape, so its result stays BLOCK-ALIGNED with the stacked leaves and
    feeds the outer tree in place — no broadcast, no extra collective
    beyond the scan's own Blelloch phase.  ``cumsum(x)*2+1``,
    ``(x - cumsum(x)).sum()`` and scan-of-scan pipelines become ONE lane
    program.  Scan subtrees may hold inner reds/consts (evaluated
    first); reduction subtrees stay scan-free, keeping the evaluation
    order acyclic (reds -> scans innermost-first -> outer tree).
    """
    from dask_array_tpu._expr import ArrayExpr
    from dask_array_tpu.ops._from_array import FromArray

    node = _unwrap(node)
    if isinstance(node, FromArray):
        if node._name not in seen:
            seen.add(node._name)
            leaves.append(node)
        return True
    if type(node).__name__ == "Elemwise":
        for a in node.args:
            if isinstance(a, ArrayExpr) and not _walk_elem(
                a, leaves, seen, reds, consts, scans
            ):
                return False
        return True
    if scans is not None:
        from dask_array_tpu.ops.reductions import CumReduction

        if (
            isinstance(node, CumReduction)
            and node.kind in ("cumsum", "cumprod")
            and np.dtype(node.dtype).kind not in "Mm"
        ):
            if node._name in seen:
                return True
            sub_leaves, sub_reds, sub_consts = [], [], []
            sub_seen = set(seen)
            if not _walk_elem(
                node.array, sub_leaves, sub_seen, sub_reds, sub_consts,
                scans,
            ):
                return False
            if reds is None and sub_reds:
                return False  # caller forbids inner reductions
            seen.update(sub_seen)
            leaves.extend(sub_leaves)
            if reds is not None:
                reds.extend(sub_reds)
            consts.extend(sub_consts)
            seen.add(node._name)
            scans.append(node)
            return True
    if reds is not None:
        from dask_array_tpu.ops.reductions import Reduction

        if (
            isinstance(node, Reduction)
            and node.kind in _REDUCE_IDENT
            and node.kind != "prod"
        ):
            # scratch collections: a failed subtree gate must not leave
            # stray leaves behind when the node salvages as a 0-d const
            sub_leaves, sub_consts, sub_seen = [], [], set(seen)
            if _walk_elem(node.array, sub_leaves, sub_seen, None, sub_consts):
                # sub_seen started from seen, so these are all new
                seen.update(sub_seen)
                leaves.extend(sub_leaves)
                consts.extend(sub_consts)
                if node._name not in seen:
                    seen.add(node._name)
                    reds.append(node)
                return True
    if consts is not None and node.shape == ():
        if node._name not in seen:
            seen.add(node._name)
            consts.append(node)
        return True
    return False


def _leaf_grid_ok2(leaves):
    """Shared, known, unmasked leaf grid chunked along exactly TWO axes
    — or ``None``.  Returns ``(grid, (d1, d2))`` with ``d1 < d2``."""
    if not leaves:
        return None
    grid = leaves[0].chunks
    if any(l.chunks != grid for l in leaves):
        return None
    chunked = [ax for ax, c in enumerate(grid) if len(c) != 1]
    if len(chunked) != 2:
        return None
    if any(isinstance(h, float) and math.isnan(h) for c in grid for h in c):
        return None
    if any(sum(grid[ax]) == 0 for ax in chunked):
        return None
    if any(isinstance(l.source, np.ma.MaskedArray) for l in leaves):
        return None
    return grid, tuple(chunked)


def _plan_grid2(kind, terminal, elem_root, leaves, reds=(), consts=(), scans=()):
    """The 2-D-chunk-grid lane: blocks of a two-axis grid flatten
    row-major onto the sharded block axis with a 2-D validity mask.
    Scope: elemwise; reductions over BOTH chunked axes (with or without
    the rest — one collective), over NEITHER (block-local), or
    STRADDLING exactly one chunked axis (grouped one-hot combine + one
    output-sized collective); cumulative scans along unchunked axes
    (block-local) or along a CHUNKED axis (Blelloch two-phase over block
    groups: local scans + one totals all-gather + local carry apply)."""
    ok = _leaf_grid_ok2(leaves)
    if ok is None:
        return None
    grid, dims = ok
    leaf_shape = tuple(int(sum(c)) for c in grid)
    for r in reds:
        # inner reductions must reduce BOTH chunked axes (replicated
        # result) over a leaf-shaped subtree
        if not set(dims) <= set(r.axes) or tuple(r.array.shape) != leaf_shape:
            return None
    for s in scans:
        # inner scans on the 2-D grid: block-local along UNCHUNKED axes
        # (padding is orthogonal, garbage stays padded), or the grouped
        # two-phase Blelloch along a CHUNKED axis (the same schedule the
        # g2_cumulative terminal runs, factored into the body)
        if s.axis is None or tuple(s.array.shape) != leaf_shape:
            return None
    aux = (tuple(reds), tuple(consts), tuple(scans))
    if kind == "elemwise":
        return "g2_elemwise", None, elem_root, leaves, dims, aux
    if kind in ("reduce", "reduce_local"):
        axes = tuple(terminal.axes)
        nd = terminal.array.ndim
        covered = set(dims) <= set(axes)
        disjoint = not (set(dims) & set(axes))
        if disjoint and axes:
            return "g2_reduce_local", terminal, elem_root, leaves, dims, aux
        if covered and (axes == tuple(range(nd)) or set(axes) == set(dims)):
            if terminal.kind not in _REDUCE_IDENT or terminal.kind == "prod":
                return None  # no sign-safe cross-device prod collective
            return "g2_reduce", terminal, elem_root, leaves, dims, aux
        if len(set(dims) & set(axes)) == 1:
            # STRADDLING reduce: exactly one chunked axis folds away while
            # the other survives — devices combine grid-patterned partials
            # by a one-hot grouped reduce + ONE collective of output size
            rk = terminal.kind
            base = rk[3:] if rk.startswith("nan") else rk
            dt = np.dtype(terminal.array.dtype)
            if rk not in _REDUCE_IDENT or base == "prod":
                return None  # no sign-safe cross-device prod collective
            if rk in ("nanmin", "nanmax") and dt.kind in "fc":
                return None  # grouped NaN-restoration vote not built
            if base in ("min", "max") and dt.kind == "c":
                return None  # no jnp extremum compare on complex
            return "g2_reduce_straddle", terminal, elem_root, leaves, dims, aux
        return None
    if kind in ("cumulative", "cumulative_local"):
        if terminal.axis not in dims:
            return "g2_cumulative_local", terminal, elem_root, leaves, dims, aux
        # scan ALONG a chunked axis: the two-phase Blelloch schedule over
        # block groups — local scans, one all-gather of per-block totals,
        # a within-group exclusive combine, local carry apply
        return "g2_cumulative", terminal, elem_root, leaves, dims, aux
    if kind in ("argreduce", "argreduce_local"):
        if terminal.axis is None:
            # full flatten: the 1-D lane's global-index vote with 2-D
            # block origins
            return "g2_argreduce", terminal, elem_root, leaves, dims, aux
        if terminal.axis not in dims:
            # positions along an unchunked axis are block-local truths
            return "g2_argreduce_local", terminal, elem_root, leaves, dims, aux
        # arg-extremum ALONG one chunked axis: grouped global-index vote
        return "g2_argreduce_straddle", terminal, elem_root, leaves, dims, aux
    return None


def _leaf_grid_ok(leaves):
    """Shared, known, single-chunked-axis, unmasked leaf grid — or
    ``None``.  Returns ``(grid, d)`` with ``d`` the one chunked axis
    (0 when every axis is a single block)."""
    if not leaves:
        return None
    grid = leaves[0].chunks
    if any(l.chunks != grid for l in leaves):
        return None  # one shared grid only (prototype)
    chunked = [ax for ax, c in enumerate(grid) if len(c) != 1]
    if len(chunked) > 1:
        return None  # chunked along ONE axis only
    d = chunked[0] if chunked else 0
    if any(isinstance(h, float) and math.isnan(h) for c in grid for h in c):
        return None  # known heights required
    if not grid or not grid[d] or sum(grid[d]) == 0:
        return None  # empty arrays: nothing to shard
    if any(isinstance(l.source, np.ma.MaskedArray) for l in leaves):
        return None  # masked stays on the host lane
    return grid, d


def _plan_matmul(root):
    """Einsum terminal: a 2-D matmul/matvec with one chunked lhs axis.

    Generalized parse: one contraction label shared by both operands (at
    EITHER position of either operand), output = lhs free label then rhs
    free label.  Two lanes by which lhs axis is chunked:

    * **rows** (free axis chunked): the rhs is replicated whole
      (weights-stationary) and each device runs its row blocks' GEMM on
      its own blocks — ZERO collectives in the compiled HLO.
    * **contraction chunked** (``matmul_k`` — the classic tensor-parallel
      pattern): both operands are restacked along the shared contraction
      profile, each device contracts its own blocks, and the partial
      products combine with ONE ``psum`` — the output is replicated.

    Either operand may be an elemwise tree; the rhs's own declared chunk
    grid is irrelevant (blocks are restacked from the dense host buffer).
    """
    labels = root.input_labels
    if len(labels) != 2 or len(root.arrays) != 2:
        return None
    l0, l1 = labels
    out = root.out_labels
    if len(l0) != 2 or len(set(l0)) != 2:
        return None
    common = set(l0) & set(l1)
    if len(common) != 1 or len(set(l1)) != len(l1):
        return None
    c = common.pop()
    lpos = l0.index(c)
    lfree = l0[1 - lpos]
    if len(l1) == 2:  # matrix rhs
        rpos = l1.index(c)
        rfree = l1[1 - rpos]
        if out != lfree + rfree:
            return None
        rhs_vec = False
    elif len(l1) == 1:  # vector rhs
        rpos = 0
        if out != lfree:
            return None
        rhs_vec = True
    else:
        return None
    lhs, rhs = root.arrays
    lhs_leaves, rhs_leaves, consts = [], [], []
    if not _walk_elem(lhs, lhs_leaves, set(), None, consts):
        return None
    if not _walk_elem(rhs, rhs_leaves, set(), None, consts):
        return None
    # the two walks use separate seen sets: dedupe shared 0-d constants
    consts = list({c._name: c for c in consts}.values())
    swapped = False
    if not rhs_vec and lhs_leaves and rhs_leaves:
        rgrid0 = rhs_leaves[0].chunks
        lhs_unchunked = all(
            len(c) == 1 for l in lhs_leaves for c in l.chunks
        )
        rhs_one_chunked = sum(len(c) != 1 for c in rgrid0) == 1 and all(
            l.chunks == rgrid0 for l in rhs_leaves
        )
        if lhs_unchunked and rhs_one_chunked:
            # the CHUNKED operand drives the lane: a single-block lhs
            # against a chunked matrix rhs swaps roles, so the rhs's free
            # axis becomes the COLUMN-parallel split (weights sharded by
            # columns, lhs replicated, zero collectives, output chunked
            # along columns — the classic Megatron column split) and its
            # contraction axis becomes the tensor-parallel matmul_k
            lhs, rhs = rhs, lhs
            lhs_leaves, rhs_leaves = rhs_leaves, lhs_leaves
            lpos, rpos = rpos, lpos
            swapped = True
    ok = _leaf_grid_ok(lhs_leaves)
    if ok is None:
        return None
    d = ok[1]
    if not rhs_leaves:
        return None
    rgrid = rhs_leaves[0].chunks
    if any(l.chunks != rgrid for l in rhs_leaves):
        return None
    if any(isinstance(h, float) and math.isnan(h) for c_ in rgrid for h in c_):
        return None
    if any(isinstance(l.source, np.ma.MaskedArray) for l in rhs_leaves):
        return None
    layout = (lpos, rpos, rhs_vec, swapped)
    if d == 1 - lpos:
        # free axis chunked: rows lane, rhs replicated whole
        kind = "matmul"
    elif d == lpos and len(ok[0][d]) > 1:
        # contraction axis chunked: per-device partial GEMMs + one psum
        kind = "matmul_k"
    else:
        return None
    return kind, root, _unwrap(lhs), lhs_leaves, d, (
        _unwrap(rhs), rhs_leaves, layout, tuple(consts),
    )


def _plan_matmul_post(root):
    """Elemwise tree OVER one matmul (``f(x @ w)`` — the GEMM-then-
    activation pattern): the Einsum plans as usual and the outer tree
    applies per-device to the stacked (rows lane) or replicated
    (matmul_k) GEMM output.  Scope: the outer tree's array operands are
    the ONE Einsum subtree, scalars / 0-d consts, and EXTRA FromArray
    leaves that never touch the chunked output axis (the bias-add
    pattern ``x @ w + b``): those replicate whole into the body —
    matmul_k's output is replicated so any broadcastable leaf binds;
    the rows lane requires the leaf's aligned extent along the chunked
    rows axis to be 1 or absent (anything else would need restacking by
    the OUTPUT grid — declines).  Returns the matmul plan with aux
    extended to ``(..., None, post_elem_root, post_leaves)``."""
    from dask_array_tpu._expr import ArrayExpr
    from dask_array_tpu.ops._from_array import FromArray
    from dask_array_tpu.ops.linalg import Einsum

    mms, consts, pleaves = [], [], []

    def walk(node):
        node = _unwrap(node)
        if isinstance(node, Einsum):
            if all(m._name != node._name for m in mms):
                mms.append(node)
            return True
        if type(node).__name__ == "Elemwise":
            return all(
                walk(a) for a in node.args if isinstance(a, ArrayExpr)
            )
        if node.shape == ():
            consts.append(node)
            return True
        if (
            isinstance(node, FromArray)
            and np.dtype(node.dtype).kind in "fciub"
            and not isinstance(node.source, np.ma.MaskedArray)
            and not any(
                isinstance(h, float) and math.isnan(h)
                for c in node.chunks
                for h in c
            )
        ):
            if all(p._name != node._name for p in pleaves):
                pleaves.append(node)
            return True
        return False

    if not walk(root) or len(mms) != 1:
        return None
    mm = _plan_matmul(mms[0])
    if mm is None:
        return None
    kind, terminal, lhs_root, lhs_leaves, d, aux = mm
    if pleaves:
        out_shape = tuple(int(s) for s in mms[0].shape)
        if kind == "matmul":
            _, _, _, swapped = aux[2]
            if swapped:
                return None  # column-chunked output: restack not built
            for p in pleaves:
                ps = tuple(int(s) for s in p.shape)
                if len(ps) > len(out_shape):
                    return None
                if len(ps) == len(out_shape) and ps and ps[0] != 1:
                    return None  # touches the chunked rows axis
    merged = list({c._name: c for c in list(aux[3]) + consts}.values())
    return kind, terminal, lhs_root, lhs_leaves, d, (
        aux[0], aux[1], aux[2], tuple(merged), None, _unwrap(root),
        tuple(pleaves),
    )


def _plan_stencil(root):
    """Halo stencils (``TrimInternal`` over map_blocks-over-``Overlap``)
    in-lane (r5): blocks stay stacked on the mesh while each block's halo
    rows arrive from its NEIGHBOR blocks — same-device slots by a shifted
    take, device-boundary slots by ONE ppermute of the per-device edge
    bands (plus two static wrap ppermutes for periodic) — then ``func``
    applies per-block and the halos trim away.  GSPMD's lowering of the
    per-block halo pipeline on an irregular grid pads and gathers; the
    reference's analog is the ghost-cell task layer
    (``/root/reference/dask_array/_overlap.py:70``).

    Scope: one array argument (an elemwise tree over one irregular
    1-chunked-axis grid), depth along the chunked axis ``d`` rides the
    ring (depth on unchunked axes is global-boundary padding, handled
    block-locally), boundary per axis in reflect/nearest/periodic/
    constant, symmetric halos, no block_id/block_info injection, no
    margins, ``func`` vmappable over blocks.  ``None`` declines.
    """
    from dask_array_tpu.ops._map_blocks import MapBlocks, MapBlocksInfo
    from dask_array_tpu.ops._overlap import Overlap

    mb = _unwrap(root.array)
    if type(mb) is not MapBlocks or isinstance(mb, MapBlocksInfo):
        return None
    if mb._kwargs_dict.get("__inject_block_id__") or type(mb)._inject_block_id:
        return None
    if mb.new_axes or mb.adjust_chunks:
        return None
    if root.margin is not None:
        return None
    ov_args = mb.array_args
    if len(ov_args) != 1:
        return None
    ov = _unwrap(ov_args[0][0])
    if type(ov) is not Overlap or ov.body_chunks is not None:
        return None
    if tuple(ov.depth) != tuple(root.depth) or tuple(ov.boundary) != tuple(
        root.boundary
    ):
        return None
    depth = tuple(tuple(p) for p in ov.depth)
    boundary = tuple(ov.boundary)
    for (lo, hi), bd in zip(depth, boundary):
        if (lo or hi) and (bd == "none" or lo != hi):
            return None  # 'none' shrinks edge blocks; asymmetric is 'none'-only
        if not (
            bd in ("reflect", "nearest", "periodic", "none")
            or isinstance(bd, (int, float, np.number))
        ):
            return None
    leaves, consts = [], []
    if not _walk_elem(ov.array, leaves, set(), None, consts):
        return None
    ok = _leaf_grid_ok(leaves)
    if ok is None:
        return None
    grid, d = ok
    lo_d, hi_d = depth[d]
    # halos along the chunked axis must fit every donating block
    if (lo_d or hi_d) and min(grid[d]) < max(lo_d, hi_d):
        return None
    return "stencil", root, _unwrap(ov.array), leaves, d, (
        mb, depth, boundary, tuple(consts),
    )


def _plan(root):
    """Validate the subtree and return an execution plan, or None.

    plan = (kind, terminal, elem_root, leaves, d, aux) where kind is
    "elemwise" | "reduce" | "reduce_local" | "cumulative" | "matmul",
    terminal the Reduction/CumReduction/Einsum node (or None), leaves the
    FromArray nodes in deterministic order, d the one chunked (sharded)
    axis, and aux the kind-specific extra ("matmul": the rhs tree + its
    leaves).
    """
    from dask_array_tpu.ops.linalg import Einsum
    from dask_array_tpu.ops.reductions import (
        ArgReduction,
        CumReduction,
        Reduction,
    )

    root = _unwrap(root)
    terminal = None
    kind = "elemwise"
    if isinstance(root, Einsum):
        return _plan_matmul(root)
    if isinstance(root, Reduction):
        if root.keepdims:
            return None
        if root.kind not in _LANE_KINDS:
            return None
        inner = _unwrap(root.array)
        if isinstance(inner, Einsum):
            # reduction OVER the matmul: the GEMM runs per-device and the
            # reduce composes on top (padded rows masked before combining)
            mm = _plan_matmul(inner)
            if mm is None:
                return None
            if mm[0] == "matmul_k":
                if root.kind in ("any", "all"):
                    return None  # truth kinds stay off the GEMM compose
                # the GEMM output is replicated post-psum: ANY lane
                # reduce (nan kinds and prod included) applies locally
                return "matmul_k", inner, mm[2], mm[3], mm[4], mm[5] + (root,)
            if mm[5][2][3]:
                # swapped (column-parallel) rows lane: the sharded output
                # axis is 1 and the compose logic below assumes rows —
                # GSPMD answers the composed form
                return None
            if root.kind not in ("sum", "mean", "prod", "min", "max"):
                return None  # composed GEMM reduces stay plain numeric kinds
            axes = tuple(root.axes)
            nd = root.array.ndim
            if 0 in axes:
                if axes not in (tuple(range(nd)), (0,)):
                    return None
                if root.kind == "prod":
                    return None  # no sign-safe cross-device prod collective
            return "matmul", inner, mm[2], mm[3], mm[4], mm[5] + (root,)
        terminal, kind = root, "reduce"  # split on d below, once known
        elem_root = _unwrap(root.array)
    elif isinstance(root, CumReduction):
        if root.kind not in ("cumsum", "cumprod"):
            return None
        terminal, kind = root, "cumulative"
        elem_root = _unwrap(root.array)
    elif type(root).__name__ == "TrimInternal":
        return _plan_stencil(root)
    elif isinstance(root, ArgReduction):
        # first-occurrence semantics via a global-index vote (nanarg
        # kinds stay out: their all-NaN raise happens at host fetch,
        # which this lane's direct result would bypass); complex dtypes
        # have no jnp extremum compare
        if (
            root.keepdims
            or root.kind not in ("argmin", "argmax")
            or np.dtype(root.array.dtype).kind == "c"
        ):
            return None
        terminal, kind = root, "argreduce"
        elem_root = _unwrap(root.array)
    else:
        elem_root = root

    # walk the tree down to FromArray leaves, collecting INNER reductions
    # (replicated inside the body), INNER scans (block-aligned in place),
    # and 0-d host constants along the way
    leaves, reds, consts, scans = [], [], [], []
    if not _walk_elem(elem_root, leaves, set(), reds, consts, scans):
        if kind == "elemwise":
            # an Einsum inside the tree fails the elemwise walk; the
            # GEMM-then-activation pattern rides the matmul lanes
            return _plan_matmul_post(elem_root)
        return None
    ok = _leaf_grid_ok(leaves)
    if ok is None:
        # a TWO-axis chunk grid rides its own lane (flattened block grid
        # + 2-D validity mask); anything else declines
        return _plan_grid2(
            kind, terminal, elem_root, leaves, reds, consts, scans
        )
    grid, d = ok
    leaf_shape = tuple(int(sum(c)) for c in grid)
    for r in reds:
        # an inner reduction's result must be REPLICATED (the sharded
        # axis reduced away) and its subtree leaf-shaped, so the result
        # broadcasts back into the outer tree with numpy's trailing rules
        if d not in tuple(r.axes) or tuple(r.array.shape) != leaf_shape:
            return None
    for s in scans:
        # an inner scan's subtree must be leaf-shaped so its result stays
        # block-aligned with the stacked leaves (a scan preserves shape);
        # axis=None (flattening) scans leave the lane
        if s.axis is None or tuple(s.array.shape) != leaf_shape:
            return None

    if kind == "reduce":
        axes = tuple(terminal.axes)
        nd = terminal.array.ndim
        if d not in axes and axes:
            # unsharded axes reduce block-locally: no collective, padding
            # drops at unpad (prod is fine — no cross-device combine)
            kind = "reduce_local"
        elif axes in (tuple(range(nd)), (d,)):
            if terminal.kind not in _REDUCE_IDENT:
                return None
        else:
            return None
    elif kind == "cumulative" and terminal.axis != d:
        # an unsharded scan axis never crosses a block boundary: pure
        # block-local work, no collective at all
        kind = "cumulative_local"
    elif kind == "argreduce" and terminal.axis is not None and terminal.axis != d:
        # indices along an unsharded axis are block-local positions
        kind = "argreduce_local"

    return kind, terminal, elem_root, leaves, d, (
        tuple(reds), tuple(consts), tuple(scans),
    )


def _scan_stacked(val, mask, ckind, cdtype, d, hmax, rest, axes, ndev):
    """Two-phase Blelloch scan of stacked blocks ALONG the sharded axis.

    Phase 1: padding masked to the scan identity, local blocks flattened
    into one contiguous scan per device.  Phase 2: ONE tiny all-gather of
    per-device totals, an exclusive combine, a local carry apply.  Shared
    by the terminal ``cumulative`` kind and INNER scans inside elemwise
    trees (the r5 multi-terminal widening) — cross-device traffic is
    ``ndev * rest`` elements either way, never the array.
    """
    import jax
    import jax.numpy as jnp

    ident = 0.0 if ckind == "cumsum" else 1.0
    val = jnp.where(mask, val, jnp.asarray(ident, val.dtype)).astype(
        cdtype if cdtype.kind != "M" else val.dtype
    )
    k_loc = val.shape[0]
    # bring the stacked scan axis next to the block axis so local
    # blocks flatten into one contiguous scan (identity when d==0)
    flat = jnp.moveaxis(val, d + 1, 1).reshape((k_loc * hmax,) + rest)
    scan = jnp.cumsum(flat, axis=0) if ckind == "cumsum" else jnp.cumprod(flat, axis=0)
    total = scan[-1]
    # Blelloch phase 2: ONE tiny all-gather of per-device totals,
    # exclusive-scan them, apply the carry locally
    totals = jax.lax.all_gather(total, axes, tiled=False)
    totals = totals.reshape((ndev,) + rest)
    me = jax.lax.axis_index(axes)
    if ckind == "cumsum":
        carry_all = jnp.cumsum(totals, axis=0) - totals  # exclusive
        scan = scan + carry_all[me]
    else:
        # exclusive cumprod (division would be unsafe with zeros)
        ex = jnp.concatenate(
            [jnp.ones((1,) + rest, totals.dtype),
             jnp.cumprod(totals[:-1], axis=0)], axis=0
        )
        scan = scan * ex[me]
    return jnp.moveaxis(scan.reshape((k_loc, hmax) + rest), 1, d + 1)


def _eval_elem(node, env):
    """Apply the elemwise tree to the per-device stacked blocks."""
    from dask_array_tpu._expr import ArrayExpr

    node = _unwrap(node)
    if node._name in env:
        return env[node._name]
    args = [
        _eval_elem(a, env) if isinstance(a, ArrayExpr) else a
        for a in node.args
    ]
    out = node.func(*args, **node._kwargs_dict)
    env[node._name] = out
    return out


def _const_env(consts):
    """Evaluate 0-d subtrees host-side through the regular executor
    (re-entrant but safe: a 0-d root always declines this lane) and
    return ``{name: jnp scalar}`` to seed evaluation environments."""
    if not consts:
        return {}
    import jax.numpy as jnp

    from dask_array_tpu._collection import new_collection

    return {
        node._name: jnp.asarray(np.asarray(new_collection(node).compute()))
        for node in consts
    }


def _auto_worthwhile(plan):
    """Under ``tpu.execution-lane="auto"`` the lane engages only where it
    beats GSPMD: an IRREGULAR chunked axis (uneven block heights), which
    GSPMD answers with pad-to-regular constraints (inserting pad and
    all-gather traffic the lane avoids).  Regular grids keep the default
    one-XLA-program lane — its layout solver already maps them cleanly."""
    kind, leaves = plan[0], plan[3]
    grid = leaves[0].chunks
    if kind.startswith("g2_"):
        d1, d2 = plan[4]
        return len(set(grid[d1])) > 1 or len(set(grid[d2])) > 1
    return len(set(grid[plan[4]])) > 1


def try_execute_shard(root, mesh, auto=False):
    """Execute ``root`` through the shard_map lane; None = declined.

    ``auto=True`` is the default-lane promotion (VERDICT r4 #3): engage
    without the config override, but only for irregular grids (see
    :func:`_auto_worthwhile`) — the lane is the framework's first-class
    answer to irregularity, not a replacement for GSPMD on regular grids.
    """
    plan = _plan(root)
    if plan is None:
        return None
    if auto and not _auto_worthwhile(plan):
        return None
    if plan[0].startswith("g2_"):
        return _execute_grid2(plan, mesh, np.dtype(_unwrap(root).dtype))
    kind, terminal, elem_root, leaves, d, aux = plan

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = tuple(mesh.axis_names)
    ndev = int(np.prod(list(mesh.shape.values())))
    grid = leaves[0].chunks
    heights = tuple(int(h) for h in grid[d])
    k = len(heights)
    hmax = max(heights) if heights else 1
    kpad = -(-max(k, 1) // ndev) * ndev  # blocks padded to a device multiple
    nd = len(grid)
    # per-block shape: the chunked axis padded to the tallest block
    block_shape = tuple(
        hmax if ax == d else int(sum(c)) for ax, c in enumerate(grid)
    )
    rest = block_shape[:d] + block_shape[d + 1:]

    # stack each leaf's blocks into (kpad, *block_shape) host buffers
    stacked = []
    for leaf in leaves:
        ((key, src),) = list(leaf._leaf_buffers())
        src = np.asarray(src)
        buf = np.zeros((kpad,) + block_shape, dtype=src.dtype)
        pos = 0
        for i, h in enumerate(heights):
            sel = (i,) + (slice(None),) * d + (slice(0, h),)
            srcsel = (slice(None),) * d + (slice(pos, pos + h),)
            buf[sel] = src[srcsel]
            pos += h
        stacked.append(buf)
    sizes = np.zeros((kpad,), dtype=np.int32)
    sizes[:k] = heights

    sh = NamedSharding(mesh, P(axes))
    dev_args = [jax.device_put(b, sh) for b in stacked]
    dev_sizes = jax.device_put(sizes, sh)

    n_true = sum(heights)
    out_dtype = np.dtype(_unwrap(root).dtype)

    if kind in ("matmul", "matmul_k", "stencil"):
        reds, scans, cenv = (), (), _const_env(aux[3])
    else:
        reds, cenv = aux[0], _const_env(aux[1])
        scans = aux[2] if len(aux) > 2 else ()
    # true elements folded per output element of each inner reduction
    rcounts = {
        r._name: math.prod(int(sum(grid[ax])) for ax in r.axes) for r in reds
    }

    def local(fn_args, fn_sizes):
        # padding validity mask: (k_loc, 1..., hmax at stacked axis d, ...1)
        mask = (
            jnp.arange(hmax, dtype=jnp.int32)[None, :]
            < fn_sizes[:, None]
        ).reshape(
            (fn_sizes.shape[0],) + (1,) * d + (hmax,) + (1,) * (nd - d - 1)
        )
        env = dict(cenv)
        for leaf, arr in zip(leaves, fn_args):
            env[leaf._name] = arr
        for r in reds:
            # inner reductions reduce the sharded axis away: their
            # REPLICATED results broadcast back into the outer tree
            # (numpy trailing rules hold — rest axes are never padded)
            sub = _eval_elem(_unwrap(r.array), env)
            rv = _masked_combine(
                sub, mask, r.kind, np.dtype(r.dtype),
                (0,) + tuple(ax + 1 for ax in r.axes), axes,
                rcounts[r._name],
            )
            env[r._name] = rv.reshape(tuple(int(s) for s in r.shape))
        for s in scans:
            # inner scans stay BLOCK-ALIGNED: along the sharded axis they
            # run the two-phase Blelloch schedule, along any other axis
            # they're pure block-local work.  The walk appends post-order
            # (innermost first), so each env entry exists before any
            # outer subtree reads it.
            sub = _eval_elem(_unwrap(s.array), env)
            sdt = np.dtype(s.dtype)
            if s.axis == d:
                sv = _scan_stacked(
                    sub, mask, s.kind, sdt, d, hmax, rest, axes, ndev
                )
            else:
                sv = sub.astype(sdt if sdt.kind != "M" else sub.dtype)
                sv = (
                    jnp.cumsum(sv, axis=s.axis + 1)
                    if s.kind == "cumsum"
                    else jnp.cumprod(sv, axis=s.axis + 1)
                )
            env[s._name] = sv
        val = _eval_elem(elem_root, env)
        return val, mask

    if kind == "stencil":
        # map_overlap in-lane: halo rows from neighbor blocks — shifted
        # takes for same-device slots, ONE ppermute per direction for the
        # device-boundary edge bands (the minimal schedule on the
        # stacked layout), then func per block and trim
        mb, depth, boundary = aux[0], aux[1], aux[2]
        func = mb.operand("func")
        fkw = {
            k_: v_ for k_, v_ in mb._kwargs_dict.items()
            if not k_.startswith("__inject")
        }
        lo_d, hi_d = depth[d]
        bd_d = boundary[d]
        wrap = bd_d == "periodic"
        k_loc = kpad // ndev
        T = lo_d + hmax + hi_d
        mode_map = {"reflect": "symmetric", "nearest": "edge", "periodic": "wrap"}

        def body(fn_sizes, *fn_args):
            env = dict(cenv)
            for leaf, arr in zip(leaves, fn_args):
                env[leaf._name] = arr
            val = _eval_elem(elem_root, env)
            v = jnp.moveaxis(val, d + 1, 1)  # (k_loc, hmax, *trailing)
            trail = (1,) * (v.ndim - 2)
            if lo_d or hi_d:
                me = jax.lax.axis_index(axes)
                gids = me * k_loc + jnp.arange(k_loc, dtype=jnp.int32)
                # per-block VALID tails (last lo_d true rows) and heads;
                # padding rows never donate (indices come from fn_sizes)
                t_idx = jnp.clip(
                    fn_sizes[:, None]
                    - lo_d
                    + jnp.arange(lo_d, dtype=jnp.int32)[None, :],
                    0,
                    hmax - 1,
                )
                tails = jnp.take_along_axis(
                    v, t_idx.reshape((k_loc, lo_d) + trail), axis=1
                )
                heads = v[:, :hi_d]
                fwd = [(i, i + 1) for i in range(ndev - 1)]
                bwd = [(i + 1, i) for i in range(ndev - 1)]
                from_left_dev = jax.lax.ppermute(tails[-1], axes, fwd)
                from_right_dev = jax.lax.ppermute(heads[0], axes, bwd)
                left = jnp.concatenate([from_left_dev[None], tails[:-1]], axis=0)
                right = jnp.concatenate([heads[1:], from_right_dev[None]], axis=0)
                sel_first = (gids == 0).reshape((k_loc,) + (1,) * (v.ndim - 1))
                sel_last = (gids == k - 1).reshape((k_loc,) + (1,) * (v.ndim - 1))
                if wrap:
                    # periodic wrap: block 0's left is block k-1's tail and
                    # vice versa — two static pairs between the devices
                    # holding the global edge blocks
                    dev_last, slot_last = (k - 1) // k_loc, (k - 1) % k_loc
                    wl = jax.lax.ppermute(tails[slot_last], axes, [(dev_last, 0)])
                    wr = jax.lax.ppermute(heads[0], axes, [(0, dev_last)])
                    left = jnp.where(sel_first, wl[None], left)
                    right = jnp.where(sel_last, wr[None], right)
                else:
                    if bd_d == "reflect":
                        lfill = jnp.flip(v[:, :lo_d], axis=1)
                        rfill = jnp.flip(tails, axis=1)
                    elif bd_d == "nearest":
                        lfill = jnp.repeat(v[:, :1], lo_d, axis=1)
                        last_idx = jnp.clip(fn_sizes[:, None] - 1, 0, hmax - 1)
                        rfill = jnp.repeat(
                            jnp.take_along_axis(
                                v, last_idx.reshape((k_loc, 1) + trail), axis=1
                            ),
                            hi_d,
                            axis=1,
                        )
                    else:  # constant fill value
                        lfill = jnp.full(v[:, :lo_d].shape, bd_d, v.dtype)
                        rfill = jnp.full(v[:, :hi_d].shape, bd_d, v.dtype)
                    left = jnp.where(sel_first, lfill, left)
                    right = jnp.where(sel_last, rfill, right)
                # per-block gather [left | valid rows | right] from the
                # concatenated buffer; rows past lo+h+hi are junk the
                # locality contract never reads back into valid outputs
                buf = jnp.concatenate([v, left, right], axis=1)
                t = jnp.arange(T, dtype=jnp.int32)[None, :]
                h = fn_sizes[:, None]
                row = jnp.where(
                    t < lo_d,
                    hmax + t,
                    jnp.where(
                        t < lo_d + h,
                        t - lo_d,
                        hmax + lo_d + jnp.clip(t - lo_d - h, 0, hi_d - 1),
                    ),
                )
                vin = jnp.take_along_axis(
                    buf, row.reshape((k_loc, T) + trail), axis=1
                )
            else:
                vin = v
            vin = jnp.moveaxis(vin, 1, d + 1)
            # depth on unchunked axes is global-boundary padding: the
            # whole axis lives in every block, so it's block-local work
            for ax in range(nd):
                if ax == d:
                    continue
                lo_a, hi_a = depth[ax]
                if not (lo_a or hi_a):
                    continue
                bd_a = boundary[ax]
                w = [(0, 0)] * vin.ndim
                w[ax + 1] = (lo_a, hi_a)
                if bd_a in mode_map:
                    vin = jnp.pad(vin, w, mode=mode_map[bd_a])
                else:
                    vin = jnp.pad(vin, w, constant_values=bd_a)
            out = jax.vmap(lambda b: func(b, **fkw))(vin)
            sl = [slice(None)]
            for ax in range(nd):
                lo_a, hi_a = depth[ax]
                if ax == d:
                    sl.append(slice(lo_d, lo_d + hmax))
                elif lo_a or hi_a:
                    sl.append(slice(lo_a, lo_a + block_shape[ax]))
                else:
                    sl.append(slice(None))
            return out[tuple(sl)]

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),) + (P(axes),) * len(dev_args),
                out_specs=P(axes),
            )
        )
        stacked_out = fn(dev_sizes, *dev_args)
        ENGAGED["count"] += 1
        return _unstack(stacked_out, heights, out_dtype, d)

    if kind in ("matmul", "matmul_k"):
        rhs_root, rhs_leaves, layout = aux[0], aux[1], aux[2]
        post = aux[4] if len(aux) >= 5 else None  # composed terminal Reduction
        # composed POST-ELEMWISE tree over the GEMM output (f(x @ w)):
        # applies per-device on the stacked/replicated result in-body
        post_elem = aux[5] if len(aux) >= 6 else None
        # extra array leaves in the post tree (x @ w + b): replicated
        # whole — the planner guarantees they never touch a chunked axis
        post_leaves = aux[6] if len(aux) >= 7 else ()
        lpos, rpos, rhs_vec, swapped = layout
        kwargs = dict(terminal.kwargs or ())
        from dask_array_tpu import config

        precision = kwargs.get("precision") or config.get(
            "tpu.matmul-precision", "highest"
        )
        lhs_spec = "b" + ("hj" if lpos == 1 else "jh")

    if kind == "matmul":
        # weights-stationary GEMM: rhs (possibly an elemwise tree) is
        # replicated WHOLE (its declared chunk grid is irrelevant); each
        # device contracts its own row blocks locally.  Padding rows
        # multiply to garbage that _unstack drops; the compiled HLO
        # contains NO collective (pinned by tests/test_shardlane.py)
        # where GSPMD's pad-to-regular lowering of the uneven row dim is
        # not collective-free.
        rhs_repl = NamedSharding(mesh, P())
        rhs_args = []
        for leaf in rhs_leaves:
            ((_, src),) = list(leaf._leaf_buffers())
            rhs_args.append(jax.device_put(np.asarray(src), rhs_repl))
        pl_args = []
        for leaf in post_leaves:
            ((_, src),) = list(leaf._leaf_buffers())
            pl_args.append(jax.device_put(np.asarray(src), rhs_repl))
        if rhs_vec:
            spec = f"{lhs_spec},j->bh"
        else:
            # swapped (column-parallel): per-device blocks keep the TRUE
            # output orientation (rows, col-block) so unstacking only
            # concatenates along the column axis
            out_lab = "bkh" if swapped else "bhk"
            spec = f"{lhs_spec},{'jk' if rpos == 0 else 'kj'}->{out_lab}"
        if post is not None:
            p_axes = tuple(post.axes)
            p_nd = post.array.ndim
            p_full = p_axes == tuple(range(p_nd))
            p_sharded = 0 in p_axes
            p_acc = np.dtype(post.dtype)
            ncols = int(post.array.shape[-1]) if not rhs_vec else 1
            p_count = n_true * (ncols if p_full else 1) if p_sharded else ncols

        def body(fn_sizes, *fn_args):
            lhs_args = fn_args[: len(leaves)]
            val, _ = local(lhs_args, fn_sizes)
            renv = dict(cenv)
            for leaf, arr in zip(rhs_leaves, fn_args[len(leaves):]):
                renv[leaf._name] = arr
            rhs = _eval_elem(rhs_root, renv)
            mm = jnp.einsum(spec, val, rhs, precision=precision)
            if post_elem is not None:
                penv = dict(cenv)
                penv[terminal._name] = mm
                for leaf, arr in zip(
                    post_leaves, fn_args[len(leaves) + len(rhs_leaves):]
                ):
                    penv[leaf._name] = arr
                return _eval_elem(post_elem, penv)
            if post is None:
                return mm
            op = {"sum": jnp.sum, "mean": jnp.sum, "prod": jnp.prod,
                  "min": jnp.min, "max": jnp.max}[post.kind]
            kw = {"dtype": p_acc} if (
                post.kind in ("sum", "mean", "prod") and p_acc.kind in "fc"
            ) else {}
            if not p_sharded:
                # unsharded axes only: block-local reduce, rows unpad later
                out = op(mm, axis=tuple(ax + 1 for ax in p_axes), **kw)
                if post.kind == "mean":
                    out = out / jnp.asarray(p_count, out.dtype)
                return out
            # the sharded row axis folds in: mask the padded GEMM rows to
            # the identity, reduce locally, combine with one collective
            # (rows sit at block axis 0 of mm whatever the lhs layout)
            rmask = (
                jnp.arange(hmax, dtype=jnp.int32)[None, :] < fn_sizes[:, None]
            )
            mask2 = rmask.reshape(rmask.shape + (1,) * (mm.ndim - 2))
            ident = jnp.asarray(_reduce_ident(post.kind, mm.dtype), mm.dtype)
            masked = jnp.where(mask2, mm, ident)
            red_axes = None if p_full else (0, 1)
            part = op(masked, axis=red_axes, **kw)
            if post.kind in ("sum", "mean"):
                tot = jax.lax.psum(part, axes)
            elif post.kind == "min":
                tot = jax.lax.pmin(part, axes)
            else:
                tot = jax.lax.pmax(part, axes)
            if post.kind == "mean":
                tot = tot / jnp.asarray(p_count, tot.dtype)
            return tot

        out_sharded = post is None or not p_sharded
        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),)
                + (P(axes),) * len(dev_args)
                + (P(),) * (len(rhs_args) + len(pl_args)),
                out_specs=P(axes) if out_sharded else P(),
            )
        )
        out = fn(dev_sizes, *dev_args, *rhs_args, *pl_args)
        ENGAGED["count"] += 1
        if out_sharded:
            return _unstack(out, heights, out_dtype, 1 if swapped else 0)
        return out.astype(out_dtype) if out.dtype != out_dtype else out

    if kind == "matmul_k":
        # contraction axis chunked — the classic tensor-parallel GEMM:
        # both operands restack along the shared contraction profile
        # (the rhs from its DENSE host buffer, whatever its declared
        # grid), each device contracts its own blocks locally, and
        # the partials combine with exactly ONE psum; the output is
        # replicated.  Padded contraction entries are zeroed on BOTH
        # sides after the elemwise trees run (a tree can turn the zero
        # fill into NaN or non-zero garbage, and NaN*0 = NaN).
        rhs_nd = 1 if rhs_vec else 2
        rblock = [None] * rhs_nd
        ((_, rsrc0),) = list(rhs_leaves[0]._leaf_buffers())
        rshape = np.asarray(rsrc0).shape
        for ax in range(rhs_nd):
            rblock[ax] = hmax if ax == rpos else int(rshape[ax])
        rblock = tuple(rblock)
        rhs_stacked = []
        for leaf in rhs_leaves:
            ((_, src),) = list(leaf._leaf_buffers())
            src = np.asarray(src)
            buf = np.zeros((kpad,) + rblock, dtype=src.dtype)
            pos = 0
            for i, h in enumerate(heights):
                sel = (i,) + (slice(None),) * rpos + (slice(0, h),)
                srcsel = (slice(None),) * rpos + (slice(pos, pos + h),)
                buf[sel] = src[srcsel]
                pos += h
            rhs_stacked.append(buf)
        rhs_args = [jax.device_put(b, sh) for b in rhs_stacked]
        pl_repl = NamedSharding(mesh, P())
        pl_args = []
        for leaf in post_leaves:
            ((_, psrc),) = list(leaf._leaf_buffers())
            pl_args.append(jax.device_put(np.asarray(psrc), pl_repl))
        rhs_spec = "b" + ("j" if rhs_vec else ("jk" if rpos == 0 else "kj"))
        # swapped (rhs-driven contraction split) emits the TRUE output
        # orientation directly — the replicated result needs no transpose
        spec = f"{lhs_spec},{rhs_spec}->" + (
            "h" if rhs_vec else ("kh" if swapped else "hk")
        )

        def body(fn_sizes, *fn_args):
            lhs_args = fn_args[: len(leaves)]
            val, mask = local(lhs_args, fn_sizes)
            renv = dict(cenv)
            for leaf, arr in zip(rhs_leaves, fn_args[len(leaves):]):
                renv[leaf._name] = arr
            rhs = _eval_elem(rhs_root, renv)
            val = jnp.where(mask, val, jnp.zeros((), val.dtype))
            rmask = (
                jnp.arange(hmax, dtype=jnp.int32)[None, :] < fn_sizes[:, None]
            ).reshape(
                (fn_sizes.shape[0],) + (1,) * rpos + (hmax,)
                + (1,) * (rhs_nd - rpos - 1)
            )
            rhs = jnp.where(rmask, rhs, jnp.zeros((), rhs.dtype))
            part = jnp.einsum(spec, val, rhs, precision=precision)
            mm = jax.lax.psum(part, axes)
            if post_elem is not None:
                penv = dict(cenv)
                penv[terminal._name] = mm
                for leaf, arr in zip(
                    post_leaves,
                    fn_args[len(leaves) + len(rhs_leaves):],
                ):
                    penv[leaf._name] = arr
                return _eval_elem(post_elem, penv)
            if post is None:
                return mm
            # mm is the TRUE replicated output: any reduce applies locally
            op = {"sum": jnp.sum, "mean": jnp.mean, "prod": jnp.prod,
                  "min": jnp.min, "max": jnp.max,
                  "nansum": jnp.nansum, "nanmean": jnp.nanmean,
                  "nanprod": jnp.nanprod,
                  "nanmin": jnp.nanmin, "nanmax": jnp.nanmax}[post.kind]
            p_acc = np.dtype(post.dtype)
            kw = {"dtype": p_acc} if (
                post.kind in ("sum", "mean", "prod", "nansum", "nanmean",
                              "nanprod") and p_acc.kind in "fc"
            ) else {}
            return op(mm, axis=tuple(post.axes), **kw)

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),)
                + (P(axes),) * (len(dev_args) + len(rhs_args))
                + (P(),) * len(pl_args),
                out_specs=P(),
            )
        )
        out = fn(dev_sizes, *dev_args, *rhs_args, *pl_args)
        ENGAGED["count"] += 1
        return out.astype(out_dtype) if out.dtype != out_dtype else out

    if kind == "reduce_local":
        rkind = terminal.kind
        acc_dtype = np.dtype(terminal.dtype)
        red_axes = tuple(ax + 1 for ax in terminal.axes)  # +1: stacked hmax dim
        count = math.prod(
            int(sum(grid[ax])) for ax in terminal.axes
        )

        def body(fn_sizes, *fn_args):
            val, _ = local(fn_args, fn_sizes)
            return _local_reduce(val, rkind, acc_dtype, red_axes, count)

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),) + (P(axes),) * len(dev_args),
                out_specs=P(axes),
            )
        )
        stacked_out = fn(dev_sizes, *dev_args)
        ENGAGED["count"] += 1
        # d's position among the surviving (unreduced) axes
        out_d = d - sum(1 for ax in terminal.axes if ax < d)
        return _unstack(stacked_out, heights, out_dtype, out_d)

    if kind == "reduce":
        rkind = terminal.kind
        if rkind == "prod":
            # a cross-device prod all-reduce has no sign-safe collective
            # (psum-of-logs breaks on negatives/zeros); GSPMD lane instead
            return None
        full = len(terminal.axes) == terminal.array.ndim
        acc_dtype = np.dtype(terminal.dtype)
        # count of TRUE elements folded into each output element
        count = n_true * (math.prod(rest) if full else 1)

        def body(fn_sizes, *fn_args):
            val, mask = local(fn_args, fn_sizes)
            # nan kinds on non-float data ARE the plain kinds (numpy: no
            # NaN to skip) — _masked_combine engages nan logic on floats
            red_axes = None if full else (0, d + 1)
            return _masked_combine(val, mask, rkind, acc_dtype, red_axes, axes, count)

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),) + (P(axes),) * len(dev_args),
                out_specs=P(),
            )
        )
        out = fn(dev_sizes, *dev_args)
        ENGAGED["count"] += 1
        return out.astype(out_dtype) if out.dtype != out_dtype else out

    if kind == "cumulative":
        ckind = terminal.kind
        cdtype = np.dtype(terminal.dtype)

        def body(fn_sizes, *fn_args):
            val, mask = local(fn_args, fn_sizes)
            return _scan_stacked(
                val, mask, ckind, cdtype, d, hmax, rest, axes, ndev
            )

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),) + (P(axes),) * len(dev_args),
                out_specs=P(axes),
            )
        )
        stacked_out = fn(dev_sizes, *dev_args)
        ENGAGED["count"] += 1
        return _unstack(stacked_out, heights, out_dtype, d)

    if kind == "cumulative_local":
        # scan axis is unsharded: never crosses a block boundary, so each
        # device scans its own blocks with no collective at all
        ckind = terminal.kind
        scan_ax = terminal.axis + 1
        cdtype = np.dtype(terminal.dtype)

        def body(fn_sizes, *fn_args):
            val, _ = local(fn_args, fn_sizes)
            val = val.astype(cdtype if cdtype.kind != "M" else val.dtype)
            return (
                jnp.cumsum(val, axis=scan_ax)
                if ckind == "cumsum"
                else jnp.cumprod(val, axis=scan_ax)
            )

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),) + (P(axes),) * len(dev_args),
                out_specs=P(axes),
            )
        )
        stacked_out = fn(dev_sizes, *dev_args)
        ENGAGED["count"] += 1
        return _unstack(stacked_out, heights, out_dtype, d)

    if kind == "argreduce_local":
        arg_ax = terminal.axis + 1

        def body(fn_sizes, *fn_args):
            val, _ = local(fn_args, fn_sizes)
            return (
                jnp.argmin if terminal.kind == "argmin" else jnp.argmax
            )(val, axis=arg_ax)

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),) + (P(axes),) * len(dev_args),
                out_specs=P(axes),
            )
        )
        stacked_out = fn(dev_sizes, *dev_args)
        ENGAGED["count"] += 1
        out_d = d - (1 if terminal.axis < d else 0)
        return _unstack(stacked_out, heights, out_dtype, out_d)

    if kind == "argreduce":
        # arg-extremum over the sharded axis (or full flatten): devices
        # vote with the GLOBAL index of their first local extremum —
        # exact numpy first-occurrence semantics without relying on
        # collective NaN propagation (a valid NaN anywhere wins, as in
        # numpy's plain arg-reductions)
        is_min = terminal.kind == "argmin"
        full = terminal.axis is None
        offsets = np.zeros((kpad,), np.int64)
        if k:
            offsets[:k] = np.concatenate([[0], np.cumsum(heights[:-1])])
        dev_offsets = jax.device_put(offsets, sh)
        if full:
            true_shape = tuple(int(sum(c)) for c in grid)
            strides = np.ones(nd, np.int64)
            for i in range(nd - 2, -1, -1):
                strides[i] = strides[i + 1] * true_shape[i + 1]
            n_out = int(np.prod(true_shape))
        else:
            n_out = n_true
        red_axes = None if full else (0, d + 1)

        def body(fn_sizes, fn_offsets, *fn_args):
            val, mask = local(fn_args, fn_sizes)
            fdt = np.dtype(val.dtype)
            if fdt.kind == "b":
                val = val.astype(jnp.int32)
                fdt = np.dtype(np.int32)
            ident = jnp.asarray(
                _reduce_ident("min" if is_min else "max", fdt), val.dtype
            )
            v = jnp.where(mask, val, ident)
            local_ext = (jnp.min if is_min else jnp.max)(v, axis=red_axes)
            glob_ext = (jax.lax.pmin if is_min else jax.lax.pmax)(
                local_ext, axes
            )
            row_idx = fn_offsets[:, None] + jnp.arange(hmax, dtype=jnp.int64)
            row_map = row_idx.reshape(
                (row_idx.shape[0],) + (1,) * d + (hmax,) + (1,) * (nd - d - 1)
            )
            if full:
                idx_map = row_map * int(strides[d])
                for axx in range(nd):
                    if axx == d:
                        continue
                    idx_map = idx_map + (
                        jnp.arange(block_shape[axx], dtype=jnp.int64) * int(strides[axx])
                    ).reshape((1,) + (1,) * axx + (block_shape[axx],) + (1,) * (nd - axx - 1))
            else:
                idx_map = row_map
            geb = glob_ext if full else jnp.expand_dims(glob_ext, (0, d + 1))
            eq = (v == geb) & mask
            if fdt.kind in "fc":
                nan_mask = jnp.isnan(v) & mask
                has_nan = jax.lax.pmax(
                    jnp.any(nan_mask, axis=red_axes).astype(jnp.int32), axes
                )
                hn = has_nan if full else jnp.expand_dims(has_nan, (0, d + 1))
                eq = jnp.where(hn.astype(bool), nan_mask, eq)
            big = jnp.asarray(n_out, jnp.int64)
            cand = jnp.min(jnp.where(eq, idx_map, big), axis=red_axes)
            return jax.lax.pmin(cand, axes)

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes), P(axes)) + (P(axes),) * len(dev_args),
                out_specs=P(),
            )
        )
        out = fn(dev_sizes, dev_offsets, *dev_args)
        ENGAGED["count"] += 1
        return out.astype(out_dtype) if out.dtype != out_dtype else out

    # elemwise terminal: a leaf-shaped root computes stacked and
    # reassembles; a smaller root shape means the tree collapsed to
    # inner-reduction/constant combinations — REPLICATED output (this is
    # how x.var(), x.std() and mean-of-tree pipelines leave the lane)
    leaf_shape = tuple(int(sum(c)) for c in grid)
    replicated = tuple(int(s) for s in elem_root.shape) != leaf_shape

    def body(fn_sizes, *fn_args):
        val, _ = local(fn_args, fn_sizes)
        return val

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axes),) + (P(axes),) * len(dev_args),
            out_specs=P() if replicated else P(axes),
        )
    )
    out = fn(dev_sizes, *dev_args)
    ENGAGED["count"] += 1
    if replicated:
        return out.astype(out_dtype) if out.dtype != out_dtype else out
    return _unstack(out, heights, out_dtype, d)


def _unstack(stacked, heights, out_dtype, axis=0):
    """(k, *block_shape) stacked blocks -> dense, concatenated along
    ``axis`` (each block trimmed to its true height there)."""
    import jax.numpy as jnp

    pre = (slice(None),) * axis
    parts = [stacked[(i,) + pre + (slice(0, h),)] for i, h in enumerate(heights)]
    out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=axis)
    return out.astype(out_dtype) if out.dtype != out_dtype else out


def _execute_grid2(plan, mesh, out_dtype):
    """Execute a 2-D-chunk-grid plan: the k1*k2 block grid flattens
    row-major onto the leading stacked axis (sharded over every mesh
    axis), each block padded to (hmax1, hmax2) along its two chunked
    axes with a 2-D validity mask."""
    kind, terminal, elem_root, leaves, dims, aux = plan

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    d1, d2 = dims
    axes = tuple(mesh.axis_names)
    ndev = int(np.prod(list(mesh.shape.values())))
    grid = leaves[0].chunks
    h1 = tuple(int(h) for h in grid[d1])
    h2 = tuple(int(h) for h in grid[d2])
    k1, k2 = len(h1), len(h2)
    k = k1 * k2
    kpad = -(-k // ndev) * ndev
    hm1, hm2 = max(h1), max(h2)
    nd = len(grid)
    block_shape = tuple(
        hm1 if ax == d1 else hm2 if ax == d2 else int(sum(c))
        for ax, c in enumerate(grid)
    )
    off1 = np.concatenate([[0], np.cumsum(h1)]).astype(int)
    off2 = np.concatenate([[0], np.cumsum(h2)]).astype(int)

    stacked = []
    for leaf in leaves:
        ((_, src),) = list(leaf._leaf_buffers())
        src = np.asarray(src)
        buf = np.zeros((kpad,) + block_shape, dtype=src.dtype)
        for i1 in range(k1):
            for i2 in range(k2):
                sel = [slice(None)] * nd
                sel[d1] = slice(0, h1[i1])
                sel[d2] = slice(0, h2[i2])
                ssel = [slice(None)] * nd
                ssel[d1] = slice(off1[i1], off1[i1 + 1])
                ssel[d2] = slice(off2[i2], off2[i2 + 1])
                buf[(i1 * k2 + i2, *sel)] = src[tuple(ssel)]
        stacked.append(buf)
    s1 = np.zeros((kpad,), np.int32)
    s2 = np.zeros((kpad,), np.int32)
    for i1 in range(k1):
        for i2 in range(k2):
            s1[i1 * k2 + i2] = h1[i1]
            s2[i1 * k2 + i2] = h2[i2]

    sh = NamedSharding(mesh, P(axes))
    dev_args = [jax.device_put(b, sh) for b in stacked]
    dev_s1 = jax.device_put(s1, sh)
    dev_s2 = jax.device_put(s2, sh)

    reds, cenv = aux[0], _const_env(aux[1])
    scans = aux[2] if len(aux) > 2 else ()
    rcounts = {
        r._name: math.prod(int(sum(grid[ax])) for ax in r.axes) for r in reds
    }
    blk_per_dev = kpad // ndev

    def g2_scan(val, mask, ckind, cdtype, ds):
        """Grouped two-phase Blelloch scan along CHUNKED axis ``ds`` —
        shared by the g2_cumulative terminal and inner scans: each block
        scans locally (padding masked to the identity so block totals are
        true totals), ONE all-gather exchanges per-block totals, and each
        block applies the combined totals of its group predecessors as a
        carry.  The group/order masks build in-trace from iota (no
        O(blocks²) jit constant — remote-compile HTTP 413 guard)."""
        ident = 0.0 if ckind == "cumsum" else 1.0
        scan_ax = ds + 1
        scan_is_d2 = ds == d2
        val = jnp.where(mask, val, jnp.asarray(ident, val.dtype)).astype(
            cdtype if cdtype.kind != "M" else val.dtype
        )
        scan = (
            jnp.cumsum(val, axis=scan_ax)
            if ckind == "cumsum"
            else jnp.cumprod(val, axis=scan_ax)
        )
        total = jax.lax.index_in_dim(
            scan, scan.shape[scan_ax] - 1, axis=scan_ax, keepdims=False
        )  # (blk, *trest) — true block totals (padding was identity)
        totals = jax.lax.all_gather(total, axes, tiled=False)
        totals = totals.reshape((kpad,) + total.shape[1:])
        me = jax.lax.axis_index(axes)
        gid = me * blk_per_dev + jnp.arange(blk_per_dev, dtype=jnp.int32)

        def _grp_order(g):
            # group = the block's index along the OTHER chunked axis;
            # order = its position along the scan axis (gid flattens
            # row-major i1*k2+i2)
            if scan_is_d2:
                return g // k2, g % k2
            return g % k2, g // k2

        grp_i, order_i = _grp_order(gid)
        grp_j, order_j = _grp_order(jnp.arange(kpad, dtype=jnp.int32))
        # mine[j, i]: block j's total folds into my block i's carry
        mine = (grp_j[:, None] == grp_i[None, :]) & (
            order_j[:, None] < order_i[None, :]
        )
        mexp = mine.reshape(mine.shape + (1,) * (totals.ndim - 1))
        if ckind == "cumsum":
            carry = jnp.sum(
                jnp.where(mexp, totals[:, None], jnp.zeros((), totals.dtype)),
                axis=0,
            )
        else:
            carry = jnp.prod(
                jnp.where(mexp, totals[:, None], jnp.ones((), totals.dtype)),
                axis=0,
            )
        carry = jnp.expand_dims(carry, scan_ax)
        return scan + carry if ckind == "cumsum" else scan * carry

    def local(fn_args, fs1, fs2):
        m1 = (
            jnp.arange(hm1, dtype=jnp.int32)[None, :] < fs1[:, None]
        ).reshape((fs1.shape[0],) + (1,) * d1 + (hm1,) + (1,) * (nd - d1 - 1))
        m2 = (
            jnp.arange(hm2, dtype=jnp.int32)[None, :] < fs2[:, None]
        ).reshape((fs2.shape[0],) + (1,) * d2 + (hm2,) + (1,) * (nd - d2 - 1))
        mask = m1 & m2
        env = dict(cenv)
        for leaf, arr in zip(leaves, fn_args):
            env[leaf._name] = arr
        for r in reds:
            # inner reductions cover BOTH chunked axes: replicated results
            sub = _eval_elem(_unwrap(r.array), env)
            rv = _masked_combine(
                sub, mask, r.kind, np.dtype(r.dtype),
                (0,) + tuple(ax + 1 for ax in r.axes), axes,
                rcounts[r._name],
            )
            env[r._name] = rv.reshape(tuple(int(s) for s in r.shape))
        for s in scans:
            # post-order: inner entries exist before any outer subtree
            # reads them.  Unchunked axes scan block-locally (padding is
            # orthogonal, garbage stays padded); CHUNKED axes run the
            # grouped Blelloch schedule (padded slots of the scan axis
            # carry the running value — harmless, they trim at unstack
            # and the validity mask excludes them from reductions)
            sub = _eval_elem(_unwrap(s.array), env)
            sdt = np.dtype(s.dtype)
            if s.axis in (d1, d2):
                env[s._name] = g2_scan(sub, mask, s.kind, sdt, s.axis)
                continue
            sv = sub.astype(sdt if sdt.kind != "M" else sub.dtype)
            env[s._name] = (
                jnp.cumsum(sv, axis=s.axis + 1)
                if s.kind == "cumsum"
                else jnp.cumprod(sv, axis=s.axis + 1)
            )
        val = _eval_elem(elem_root, env)
        return val, mask

    def run(body, out_spec):
        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes), P(axes)) + (P(axes),) * len(dev_args),
                out_specs=out_spec,
            )
        )
        out = fn(dev_s1, dev_s2, *dev_args)
        ENGAGED["count"] += 1
        return out

    if kind == "g2_reduce":
        rkind = terminal.kind
        acc_dtype = np.dtype(terminal.dtype)
        full = len(terminal.axes) == terminal.array.ndim
        red_axes = None if full else (0, d1 + 1, d2 + 1)
        rest = math.prod(
            int(sum(c)) for ax, c in enumerate(grid) if ax not in dims
        )
        count = sum(h1) * sum(h2) * (rest if full else 1)

        def body(fs1, fs2, *fn_args):
            val, mask = local(fn_args, fs1, fs2)
            return _masked_combine(
                val, mask, rkind, acc_dtype, red_axes, axes, count
            )

        out = run(body, P())
        return out.astype(out_dtype) if out.dtype != out_dtype else out

    if kind == "g2_reduce_straddle":
        # reduce over exactly ONE chunked axis (plus any unchunked axes):
        # block partials are grouped by their KEPT-axis block index with a
        # one-hot reduce (blocks of other groups contribute the identity),
        # then ONE collective of output size combines across devices.
        # The kept axis stays padded per block and trims at unstack.
        rkind = terminal.kind
        acc_dtype = np.dtype(terminal.dtype)
        axes_r = tuple(terminal.axes)
        dr = d1 if d1 in axes_r else d2  # the reduced-away chunked axis
        dk = d2 if dr == d1 else d1      # the surviving chunked axis
        kk, h_keep = (k1, h1) if dk == d1 else (k2, h2)
        red_axes = tuple(ax + 1 for ax in axes_r)
        count = math.prod(int(sum(grid[ax])) for ax in axes_r)
        nan_kind = rkind.startswith("nan") and np.dtype(
            terminal.array.dtype
        ).kind in "fc"
        base = rkind[3:] if rkind.startswith("nan") else rkind
        blk = kpad // ndev
        # dk's position among the surviving within-block axes
        a_keep = dk - sum(1 for ax in axes_r if ax < dk)

        def body(fs1, fs2, *fn_args):
            val, mask = local(fn_args, fs1, fs2)
            me = jax.lax.axis_index(axes)
            gid = me * blk + jnp.arange(blk, dtype=jnp.int32)
            slot = gid // k2 if dk == d1 else gid % k2
            onehot = slot[:, None] == jnp.arange(kk, dtype=jnp.int32)[None, :]

            def group(part, ident, op):
                oh = onehot.reshape(onehot.shape + (1,) * (part.ndim - 1))
                return op(jnp.where(oh, part[:, None], ident), axis=0)

            if base in ("any", "all"):
                fill = jnp.asarray(base == "all").astype(val.dtype)
                v = jnp.where(mask, val, fill)
                op = jnp.any if base == "any" else jnp.all
                part = op(v, axis=red_axes)
                loc = group(part, base == "all", op)
                comb = jax.lax.pmax if base == "any" else jax.lax.pmin
                return comb(loc.astype(jnp.int32), axes).astype(bool)
            acc_kw = {"dtype": acc_dtype} if (
                base in ("sum", "mean") and acc_dtype.kind in "fc"
            ) else {}
            if base in ("sum", "mean"):
                zero = jnp.zeros((), val.dtype)
                real = mask & ~jnp.isnan(val) if nan_kind else mask
                part = jnp.sum(
                    jnp.where(real, val, zero), axis=red_axes, **acc_kw
                )
                loc = group(part, jnp.zeros((), part.dtype), jnp.sum)
                tot = jax.lax.psum(loc, axes)
                if rkind == "nanmean" and nan_kind:
                    cnt_p = jnp.sum(real, axis=red_axes, dtype=jnp.int32)
                    cnt = jax.lax.psum(group(cnt_p, 0, jnp.sum), axes)
                    tot = tot / cnt.astype(tot.dtype)
                elif base == "mean":
                    tot = tot / jnp.asarray(count, tot.dtype)
                return tot
            ident = jnp.asarray(
                _reduce_ident(base, np.dtype(val.dtype)), val.dtype
            )
            op = jnp.min if base == "min" else jnp.max
            part = op(jnp.where(mask, val, ident), axis=red_axes)
            loc = group(part, ident, op)
            return (jax.lax.pmin if base == "min" else jax.lax.pmax)(loc, axes)

        out = run(body, P())
        return _unstack(out, h_keep, out_dtype, a_keep)

    if kind == "g2_reduce_local":
        rkind = terminal.kind
        acc_dtype = np.dtype(terminal.dtype)
        red_axes = tuple(ax + 1 for ax in terminal.axes)
        count = math.prod(int(sum(grid[ax])) for ax in terminal.axes)

        def body(fs1, fs2, *fn_args):
            val, _ = local(fn_args, fs1, fs2)
            return _local_reduce(val, rkind, acc_dtype, red_axes, count)

        out = run(body, P(axes))
        # the chunked axes' positions among the surviving axes
        a1 = d1 - sum(1 for ax in terminal.axes if ax < d1)
        a2 = d2 - sum(1 for ax in terminal.axes if ax < d2)
        return _unstack2(out, h1, h2, out_dtype, a1, a2)

    if kind == "g2_cumulative":
        # scan along one CHUNKED axis — the grouped Blelloch two-phase
        # schedule (g2_scan).  The cross-device traffic is kpad tiny
        # total-slabs, not the array.
        ckind = terminal.kind
        cdtype = np.dtype(terminal.dtype)
        ds = terminal.axis              # the chunked scan axis

        def body(fs1, fs2, *fn_args):
            val, mask = local(fn_args, fs1, fs2)
            return g2_scan(val, mask, ckind, cdtype, ds)

        out = run(body, P(axes))
        return _unstack2(out, h1, h2, out_dtype, d1, d2)

    if kind == "g2_cumulative_local":
        ckind = terminal.kind
        scan_ax = terminal.axis + 1
        cdtype = np.dtype(terminal.dtype)

        def body(fs1, fs2, *fn_args):
            val, _ = local(fn_args, fs1, fs2)
            val = val.astype(cdtype if cdtype.kind != "M" else val.dtype)
            return (
                jnp.cumsum(val, axis=scan_ax)
                if ckind == "cumsum"
                else jnp.cumprod(val, axis=scan_ax)
            )

        out = run(body, P(axes))
        return _unstack2(out, h1, h2, out_dtype, d1, d2)

    if kind == "g2_argreduce":
        # full-flatten arg-extremum on the 2-D grid: devices vote with the
        # GLOBAL flattened index of their first local extremum (exact numpy
        # first-occurrence semantics; a valid NaN anywhere wins, as in
        # numpy's plain arg-reductions) — one pmin/pmax + one pmin
        is_min = terminal.kind == "argmin"
        true_shape = tuple(int(sum(c)) for c in grid)
        strides = np.ones(nd, np.int64)
        for i in range(nd - 2, -1, -1):
            strides[i] = strides[i + 1] * true_shape[i + 1]
        n_out = int(np.prod(true_shape))
        fo1 = np.zeros((kpad,), np.int64)
        fo2 = np.zeros((kpad,), np.int64)
        for i1 in range(k1):
            for i2 in range(k2):
                fo1[i1 * k2 + i2] = off1[i1]
                fo2[i1 * k2 + i2] = off2[i2]
        dev_o1 = jax.device_put(fo1, sh)
        dev_o2 = jax.device_put(fo2, sh)

        def body(fs1, fs2, fo1_, fo2_, *fn_args):
            val, mask = local(fn_args, fs1, fs2)
            fdt = np.dtype(val.dtype)
            if fdt.kind == "b":
                val = val.astype(jnp.int32)
                fdt = np.dtype(np.int32)
            ident = jnp.asarray(
                _reduce_ident("min" if is_min else "max", fdt), val.dtype
            )
            v = jnp.where(mask, val, ident)
            local_ext = (jnp.min if is_min else jnp.max)(v)
            glob_ext = (jax.lax.pmin if is_min else jax.lax.pmax)(
                local_ext, axes
            )
            r1 = fo1_[:, None] + jnp.arange(hm1, dtype=jnp.int64)
            idx_map = r1.reshape(
                (r1.shape[0],) + (1,) * d1 + (hm1,) + (1,) * (nd - d1 - 1)
            ) * int(strides[d1])
            r2 = fo2_[:, None] + jnp.arange(hm2, dtype=jnp.int64)
            idx_map = idx_map + r2.reshape(
                (r2.shape[0],) + (1,) * d2 + (hm2,) + (1,) * (nd - d2 - 1)
            ) * int(strides[d2])
            for axx in range(nd):
                if axx in (d1, d2):
                    continue
                idx_map = idx_map + (
                    jnp.arange(block_shape[axx], dtype=jnp.int64)
                    * int(strides[axx])
                ).reshape(
                    (1,) + (1,) * axx + (block_shape[axx],)
                    + (1,) * (nd - axx - 1)
                )
            eq = (v == glob_ext) & mask
            if fdt.kind in "fc":
                nan_mask = jnp.isnan(v) & mask
                has_nan = jax.lax.pmax(
                    jnp.any(nan_mask).astype(jnp.int32), axes
                )
                eq = jnp.where(has_nan.astype(bool), nan_mask, eq)
            big = jnp.asarray(n_out, jnp.int64)
            cand = jnp.min(jnp.where(eq, idx_map, big))
            return jax.lax.pmin(cand, axes)

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),) * 4 + (P(axes),) * len(dev_args),
                out_specs=P(),
            )
        )
        out = fn(dev_s1, dev_s2, dev_o1, dev_o2, *dev_args)
        ENGAGED["count"] += 1
        return out.astype(out_dtype) if out.dtype != out_dtype else out

    if kind == "g2_argreduce_straddle":
        # arg-extremum ALONG one chunked axis of the 2-D grid: the
        # grouped composition of g2_reduce_straddle's one-hot combine
        # (blocks grouped by their KEPT-axis slot) and the argreduce
        # global-index vote — per-group extremum (one pmin/pmax), NaN
        # presence per group (one pmax, floats only), then the min GLOBAL
        # index along the reduced axis among group-extremum hits (one
        # pmin).  Exact numpy first-occurrence semantics; a valid NaN
        # anywhere in a slice wins, as in numpy's plain arg-reductions.
        is_min = terminal.kind == "argmin"
        dr = terminal.axis               # the reduced-away chunked axis
        dk = d2 if dr == d1 else d1      # the surviving chunked axis
        kk, h_keep = (k1, h1) if dk == d1 else (k2, h2)
        red_ax = dr + 1
        hm_r = hm1 if dr == d1 else hm2
        n_out = int(sum(grid[dr]))       # index range along dr ("no hit")
        blk = kpad // ndev
        a_keep = dk - (1 if dr < dk else 0)
        fo = np.zeros((kpad,), np.int64)
        for i1 in range(k1):
            for i2 in range(k2):
                fo[i1 * k2 + i2] = off1[i1] if dr == d1 else off2[i2]
        dev_fo = jax.device_put(fo, sh)

        def body(fs1, fs2, fo_, *fn_args):
            val, mask = local(fn_args, fs1, fs2)
            fdt = np.dtype(val.dtype)
            if fdt.kind == "b":
                val = val.astype(jnp.int32)
                fdt = np.dtype(np.int32)
            ident = jnp.asarray(
                _reduce_ident("min" if is_min else "max", fdt), val.dtype
            )
            v = jnp.where(mask, val, ident)
            me = jax.lax.axis_index(axes)
            gid = me * blk + jnp.arange(blk, dtype=jnp.int32)
            slot = gid // k2 if dk == d1 else gid % k2
            onehot = slot[:, None] == jnp.arange(kk, dtype=jnp.int32)[None, :]

            def group(part, gident, op):
                oh = onehot.reshape(onehot.shape + (1,) * (part.ndim - 1))
                return op(jnp.where(oh, part[:, None], gident), axis=0)

            op = jnp.min if is_min else jnp.max
            part = op(v, axis=red_ax)                   # (blk, *survived)
            loc = group(part, ident, op)                # (kk, *survived)
            glob_ext = (jax.lax.pmin if is_min else jax.lax.pmax)(loc, axes)
            # my group's extremum, broadcast back over the reduced axis
            geb = jnp.expand_dims(jnp.take(glob_ext, slot, axis=0), red_ax)
            eq = (v == geb) & mask
            if fdt.kind in "fc":
                nan_mask = jnp.isnan(v) & mask
                nl = group(
                    jnp.any(nan_mask, axis=red_ax), False, jnp.any
                )
                has_nan = jax.lax.pmax(nl.astype(jnp.int32), axes)
                hn = jnp.expand_dims(jnp.take(has_nan, slot, axis=0), red_ax)
                eq = jnp.where(hn.astype(bool), nan_mask, eq)
            big = jnp.asarray(n_out, jnp.int64)
            row = fo_[:, None] + jnp.arange(hm_r, dtype=jnp.int64)
            idx_map = row.reshape(
                (row.shape[0],) + (1,) * dr + (hm_r,) + (1,) * (nd - dr - 1)
            )
            cand = jnp.min(jnp.where(eq, idx_map, big), axis=red_ax)
            return jax.lax.pmin(group(cand, big, jnp.min), axes)

        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=(P(axes),) * 3 + (P(axes),) * len(dev_args),
                out_specs=P(),
            )
        )
        out = fn(dev_s1, dev_s2, dev_fo, *dev_args)
        ENGAGED["count"] += 1
        return _unstack(out, h_keep, out_dtype, a_keep)

    if kind == "g2_argreduce_local":
        # arg-extremum along an UNCHUNKED axis: positions are block-local
        # truths (the reduced axis is whole in every block); the padded
        # rows/cols of the two chunked axes trim away at unstack
        arg_ax = terminal.axis + 1

        def body(fs1, fs2, *fn_args):
            val, _ = local(fn_args, fs1, fs2)
            return (
                jnp.argmin if terminal.kind == "argmin" else jnp.argmax
            )(val, axis=arg_ax)

        out = run(body, P(axes))
        a1 = d1 - (1 if terminal.axis < d1 else 0)
        a2 = d2 - (1 if terminal.axis < d2 else 0)
        return _unstack2(out, h1, h2, out_dtype, a1, a2)

    # g2_elemwise: a sub-leaf-shaped root collapsed to inner-reduction/
    # constant combinations — replicated output
    assert kind == "g2_elemwise", f"unhandled grid2 plan kind: {kind}"
    leaf_shape = tuple(int(sum(c)) for c in grid)
    replicated = tuple(int(s) for s in elem_root.shape) != leaf_shape

    def body(fs1, fs2, *fn_args):
        val, _ = local(fn_args, fs1, fs2)
        return val

    out = run(body, P() if replicated else P(axes))
    if replicated:
        return out.astype(out_dtype) if out.dtype != out_dtype else out
    return _unstack2(out, h1, h2, out_dtype, d1, d2)


def _unstack2(stacked, h1, h2, out_dtype, a1, a2):
    """(k1*k2, *block_shape) stacked blocks -> dense: trim each block to
    its true extents at axes ``a1``/``a2``, concatenate columns then
    rows (row-major flattening order)."""
    import jax.numpy as jnp

    k2 = len(h2)
    rows = []
    for i1, H1 in enumerate(h1):
        parts = []
        for i2, H2 in enumerate(h2):
            sel = [slice(None)] * (stacked.ndim - 1)
            sel[a1] = slice(0, H1)
            sel[a2] = slice(0, H2)
            parts.append(stacked[(i1 * k2 + i2, *sel)])
        rows.append(
            parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=a2)
        )
    out = rows[0] if len(rows) == 1 else jnp.concatenate(rows, axis=a1)
    return out.astype(out_dtype) if out.dtype != out_dtype else out
