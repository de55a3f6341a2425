"""Out-of-core block-streaming execution (the third executor lane).

The trace lane materializes every leaf and the dense root on device, so a
dataset larger than device memory had no execution path.  This lane gives
it one — the XLA-native analog of the reference scheduler's bounded-memory
streaming (per-task expected-nbytes stamps + block-at-a-time execution:
``/root/reference/dask_array/_frisky/collect.py:154-182``,
``crates/dask-array-python/src/common.rs:818``, ``io/_store.py:168``):

* the output (map-stream) or the reduced input (reduce-stream) is cut into
  **panels** along one axis, each a contiguous run of chunk rows;
* the framework's own slice pushdown shrinks each panel program's leaf
  reads to the panel region (``FromArray`` defers the region, so only the
  panel's bytes ever ship host->device — memmaps/chunked stores read only
  the panel from disk);
* panels of equal height share ONE structural key, hence one compiled
  executable (verified before engaging — a per-panel recompile storm
  would be worse than not streaming);
* leaves the pushdown cannot shrink (e.g. the weights of a panel-swept
  matmul) are **pinned device-resident once** instead of re-shipping every
  panel;
* panels execute through a double-buffered pipeline — dispatch runs ahead
  of the blocking device->host fetches — and land in a preallocated host
  result (map-stream) or fold into a small combine accumulator
  (reduce-stream);
* per-panel *expected bytes* (leaf + output nbytes straight from chunk
  metadata — the expected-nbytes accounting) pick the panel height against
  the device-memory budget.

Engagement: ``tpu.out-of-core`` = ``"auto"`` (stream when the program's
estimated device bytes exceed ``tpu.memory-budget``) | ``"force"`` (stream
whenever plannable — tests/benchmarks) | ``"off"``.  The planner declines —
and the normal lanes answer — whenever it cannot PROVE the stream is
bounded and single-compile: irregular heights along the candidate axis,
pushdown that fails to shrink leaf reads, unknown chunks, host-only/masked
data, sub-tree program splits (``Barrier``), or structural keys that differ
across panels.
"""

from __future__ import annotations

import math

import numpy as np

from dask_array_tpu import config
from dask_array_tpu._chunks import parse_bytes

# engagement spy (the shardlane ENGAGED discipline): tests and benches
# assert the lane answered, how many panels it streamed, and how many
# unshrinkable leaves were pinned device-resident
STREAMED = {"count": 0, "panels": 0, "pinned": 0}

# reduce-stream cross-panel combines: every kind here is associative and
# commutative over panel partials (nanmin/nanmax combine with fmin/fmax so
# an all-NaN panel's NaN partial loses to any valid value)
_COMBINE = {
    "sum": np.add,
    "nansum": np.add,
    "prod": np.multiply,
    "nanprod": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
    "nanmin": np.fmin,
    "nanmax": np.fmax,
    "any": np.logical_or,
    "all": np.logical_and,
}


# share of the device's memory limit the out-of-core lane leaves free for
# XLA's temporaries and the panel program's own intermediates
_HEADROOM = 0.25


def _budget() -> int:
    b = config.get("tpu.memory-budget", "auto")
    if b == "auto":
        import jax

        dev = jax.devices()[0]
        if dev.platform == "cpu":
            # host backend: memory is the host's; auto never engages
            return 1 << 62
        stats = dev.memory_stats()
        if not stats or "bytes_limit" not in stats:
            raise RuntimeError(
                f"{dev.device_kind} reports no memory limit; set "
                "tpu.memory-budget to a size"
            )
        return int(stats["bytes_limit"] * (1 - _HEADROOM))
    return int(parse_bytes(b))


def _is_host_leaf(node) -> bool:
    """A FromArray leaf whose buffer lives on the host (streams H2D)."""
    return type(node).__name__ == "FromArray" and not hasattr(
        node.source, "devices"
    )


def _host_leaf_bytes(expr) -> int:
    """Expected host->device bytes of a program: sum of host-leaf nbytes
    (post-pushdown chunk metadata — the expected-nbytes accounting)."""
    total = 0
    for node in expr.walk():
        if not node.dependencies() and _is_host_leaf(node):
            total += int(node.nbytes)
    return total


def _sel(nd, d, start, stop):
    return tuple(
        slice(int(start), int(stop)) if ax == d else slice(None)
        for ax in range(nd)
    )


def _regular_rows(heights):
    """True when all chunk heights along the axis are equal except a
    possibly-smaller tail — the condition for panels of equal element
    height, hence ONE compiled executable."""
    if len(heights) < 2:
        return False
    h = int(heights[0])
    return all(int(x) == h for x in heights[:-1]) and int(heights[-1]) <= h


def _scan(expr):
    """One walk: estimated device bytes of the normal trace lane (host
    leaves + largest materialized node), or None when the program is not
    streamable (unknown chunks, host-only dtypes, masked leaves, Barrier
    program splits)."""
    from dask_array_tpu._chunks import host_only_dtype

    leaf_bytes = 0
    biggest = 0
    for node in expr.walk():
        nb = node.nbytes
        if isinstance(nb, float) and math.isnan(nb):
            return None
        if getattr(node, "_leaf_stop", False):
            return None  # Barrier: subtree computes whole on device
        try:
            if host_only_dtype(node.dtype):
                return None
        except Exception:
            return None
        if not node.dependencies():
            if type(node).__name__ == "FromArray" and isinstance(
                node.source, np.ma.MaskedArray
            ):
                return None
            if _is_host_leaf(node):
                leaf_bytes += int(nb)
        biggest = max(biggest, int(nb))
    return leaf_bytes + biggest


def maybe_stream(expr):
    """Execute ``expr`` out-of-core; None = declined (the normal lanes
    answer).  Returns a HOST numpy array — the result of an out-of-core
    program may itself exceed device memory."""
    mode = config.get("tpu.out-of-core", "auto")
    if mode == "off":
        return None
    if getattr(expr, "ndim", None) is None or not expr.known_chunks:
        return None
    est = _scan(expr)
    if est is None:
        return None
    budget = _budget()
    if mode != "force" and est <= budget:
        return None
    res = _map_stream(expr, budget, mode)
    if res is not None:
        return res
    return _reduce_stream(expr, budget, mode)


# ---------------------------------------------------------------------------
# planning helpers
# ---------------------------------------------------------------------------


def _probe_axis(expr, d, budget, mode, reducer=None):
    """Plan panels along axis ``d``: probe 1- and 2-row panel programs to
    split expected bytes into FIXED (unshrinkable leaves) + PER-ROW, then
    size panels so fixed + rows*(leaf+out per-row) fits the budget.

    Returns (rows_per_panel, heights, fixed_leaf_probe_expr) or None.
    ``reducer`` wraps a sliced input back into the terminal reduction
    (reduce-stream); map-stream slices the root directly.
    """
    from dask_array_tpu._materialize import optimize_expr

    src = expr if reducer is None else expr.array
    heights = src.chunks[d]
    if not _regular_rows(heights):
        return None
    k = len(heights)
    h = int(heights[0])
    nd = src.ndim

    def panel_expr(r0, r1):
        from dask_array_tpu._collection import new_collection

        start, stop = r0 * h, min(r1 * h, int(src.shape[d]))
        sliced = new_collection(src)[_sel(nd, d, start, stop)].expr
        return sliced if reducer is None else reducer(sliced)

    full = _host_leaf_bytes(expr)
    p1 = optimize_expr(panel_expr(0, 1))
    b1 = _host_leaf_bytes(p1)
    if full <= 0 or b1 >= full * 0.9:
        return None  # pushdown did not shrink the reads: unbounded
    if k >= 3:
        b2 = _host_leaf_bytes(optimize_expr(panel_expr(0, 2)))
        per = max(b2 - b1, 1)
        fixed = max(b1 - per, 0)
    else:
        per, fixed = max(b1, 1), 0
    # output bytes per chunk row (map-stream: the panel's slice of the
    # root; reduce-stream: partials are reduced over d, negligible)
    if reducer is None:
        out_per_row = int(expr.nbytes) * h / max(int(expr.shape[d]), 1)
    else:
        out_per_row = 0
    # the pipeline keeps up to depth+1 panels' inputs live on device
    # (dispatched-but-unfinished programs pin their argument buffers); a
    # budget too tight for the configured depth degrades to synchronous
    # streaming (depth 0) before declining
    denom = max(per + out_per_row, 1)
    depth = _depth()
    while True:
        rows = int((budget * 0.8 / (depth + 1) - fixed) // denom)
        if rows >= 1 or depth == 0:
            break
        depth -= 1
    if rows < 1:
        if mode != "force":
            return None  # even one chunk row cannot be bounded
        rows = 1
    if rows >= k:
        if mode != "force":
            return None  # fits in one panel: the normal lane is better
        rows = max(1, (k + 1) // 2)  # force: at least two panels
    return rows, heights, p1, depth


def _pin_resident(expr, probe_opt, budget):
    """Device-pin leaves the pushdown could not shrink, so they ship H2D
    ONCE instead of once per panel (the weights of a panel-swept matmul).
    Returns the (possibly substituted) expr."""
    import jax

    from dask_array_tpu.parallel.mesh import current_mesh

    if current_mesh() is not None:
        return expr  # mesh placement is the layout solver's job
    cap = budget * 0.3
    spent = 0
    mapping = {}
    pinned_srcs = []
    for node in probe_opt.walk():
        if node.dependencies() or not _is_host_leaf(node):
            continue
        src = node.source
        if not isinstance(src, np.ndarray) or isinstance(
            src, np.ma.MaskedArray
        ):
            continue  # memmaps/stores: pinning would read the whole file
        nb = int(node.nbytes)
        if nb < src.nbytes:  # the slice shrank it: it streams
            continue
        if spent + nb > cap:
            continue
        if any(s is src for s in pinned_srcs):
            continue
        spent += nb
        pinned_srcs.append(src)
    if not pinned_srcs:
        return expr
    STREAMED["pinned"] += len(pinned_srcs)
    put = {id(s): jax.device_put(s) for s in pinned_srcs}
    for node in expr.walk():
        if (
            not node.dependencies()
            and type(node).__name__ == "FromArray"
            and id(node.source) in put
        ):
            mapping[node._name] = type(node)(
                put[id(node.source)], *node.operands[1:]
            )
    if not mapping:
        return expr
    return expr._substitute_many(mapping, {})


def _panel_ranges(heights, rows):
    """(start_el, stop_el) element ranges grouping chunk rows into panels."""
    bounds = np.concatenate([[0], np.cumsum([int(x) for x in heights])])
    k = len(heights)
    out = []
    r = 0
    while r < k:
        r2 = min(r + rows, k)
        out.append((int(bounds[r]), int(bounds[r2])))
        r = r2
    return out


def _keys_bounded(exprs):
    """Panels must share compiled executables: at most 3 distinct
    structural keys across ALL panels (boundary-touching first/last panels
    of an overlap program and the shorter tail legitimately differ from
    the interior — a constant, not a per-panel recompile storm)."""
    from dask_array_tpu._executor import structural_key

    keys = set()
    for e in exprs:
        keys.add(structural_key(e))
        if len(keys) > 3:
            return False
    return True


def _depth():
    # 1 = classic double buffering: ship/compute the next panel while
    # fetching the previous one
    return max(int(config.get("tpu.stream-depth", 1)), 0)


# ---------------------------------------------------------------------------
# map-stream: large sliceable output, assembled panel by panel on host
# ---------------------------------------------------------------------------


def _map_stream(expr, budget, mode):
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu._executor import execute
    from dask_array_tpu._materialize import optimize_expr

    nd = expr.ndim
    if nd == 0:
        return None
    chunks = expr.chunks
    for d in sorted(range(nd), key=lambda ax: -len(chunks[ax])):
        plan = _probe_axis(expr, d, budget, mode)
        if plan is None:
            continue
        rows, heights, probe, depth = plan
        pinned = _pin_resident(expr, probe, budget)
        ranges = _panel_ranges(heights, rows)
        coll = new_collection(pinned)
        opts = [
            optimize_expr(coll[_sel(nd, d, a, b)].expr) for a, b in ranges
        ]
        if not _keys_bounded(opts):
            continue  # would recompile per panel: decline this axis

        STREAMED["count"] += 1
        shape = tuple(int(s) for s in expr.shape)
        out = None
        inflight = []

        def land(sel_range, arr):
            nonlocal out
            host = np.asarray(arr)
            if out is None:
                out = np.empty(shape, host.dtype)
            a, b = sel_range
            out[_sel(nd, d, a, b)] = host

        for (a, b), opt in zip(ranges, opts):
            inflight.append(((a, b), execute(opt)))
            STREAMED["panels"] += 1
            if len(inflight) > depth:
                land(*inflight.pop(0))
        for item in inflight:
            land(*item)
        return out
    return None


# ---------------------------------------------------------------------------
# reduce-stream: terminal reduction, panels of the INPUT fold into a small
# combine accumulator
# ---------------------------------------------------------------------------


def _reduce_stream(expr, budget, mode):
    from dask_array_tpu.ops.reductions import Reduction

    if not isinstance(expr, Reduction):
        return None
    kind = expr.kind
    if expr.operand("extra"):
        return None
    mean_kind = kind in ("mean", "nanmean")
    if kind not in _COMBINE and not mean_kind:
        return None
    arr = expr.array
    for d in sorted(expr.axes, key=lambda ax: -len(arr.chunks[ax])):
        res = _reduce_stream_axis(expr, d, budget, mode, mean_kind)
        if res is not None:
            return res
    return None


def _reduce_stream_axis(expr, d, budget, mode, mean_kind):
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu._executor import execute, execute_many
    from dask_array_tpu._materialize import optimize_expr
    from dask_array_tpu.ops.reductions import Reduction

    arr = expr.array
    kind = expr.kind
    axes = tuple(expr.axes)
    keepdims = expr.keepdims
    out_dtype = np.dtype(expr.dtype)

    # the per-panel partial: same reduction kind over the sliced input
    # (for mean kinds, the streamed partial is the matching SUM — the
    # divide by count happens once, after the combine)
    def reducer(panel):
        if mean_kind:
            pkind = "nansum" if kind == "nanmean" else "sum"
            return Reduction(panel, pkind, axes, keepdims, out_dtype, None, ())
        return type(expr)(panel, *expr.operands[1:])

    plan = _probe_axis(expr, d, budget, mode, reducer=reducer)
    if plan is None:
        return None
    rows, heights, _probe, depth = plan
    ranges = _panel_ranges(heights, rows)
    nd = arr.ndim
    acoll = new_collection(arr)

    def panel_exprs(a, b):
        panel = acoll[_sel(nd, d, a, b)]
        roots = [optimize_expr(reducer(panel.expr))]
        if kind == "nanmean":
            # the data-dependent divisor: non-NaN count, streamed in the
            # SAME panel program (one leaf read)
            import dask_array_tpu as da

            cnt = (~da.isnan(panel)).sum(axis=axes, keepdims=keepdims)
            roots.append(optimize_expr(cnt.expr))
        return roots

    opts = [panel_exprs(a, b) for a, b in ranges]
    if not _keys_bounded([o[0] for o in opts]):
        return None

    STREAMED["count"] += 1
    comb = _COMBINE["nansum" if kind == "nanmean" else ("sum" if kind == "mean" else kind)]
    acc = None
    cnt_acc = None
    inflight = []

    def land(vals):
        nonlocal acc, cnt_acc
        part = np.asarray(vals[0])
        acc = part if acc is None else comb(acc, part)
        if len(vals) > 1:
            c = np.asarray(vals[1])
            cnt_acc = c if cnt_acc is None else cnt_acc + c

    for roots in opts:
        if len(roots) == 1:
            inflight.append([execute(roots[0])])
        else:
            inflight.append(execute_many(roots))
        STREAMED["panels"] += 1
        if len(inflight) > depth:
            land(inflight.pop(0))
    for vals in inflight:
        land(vals)

    if kind == "mean":
        count = math.prod(int(arr.shape[ax]) for ax in axes)
        acc = (acc / count).astype(out_dtype, copy=False)
    elif kind == "nanmean":
        with np.errstate(invalid="ignore", divide="ignore"):
            acc = (acc / cnt_acc).astype(out_dtype, copy=False)
    if acc.dtype != out_dtype and out_dtype.kind not in "Mm":
        acc = acc.astype(out_dtype)
    return acc
