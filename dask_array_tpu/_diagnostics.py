"""Optimizer diagnostics: trace_rewrites, explain, chunk_report, expr_table.

Parity: ``/root/reference/dask_array/_diagnostics.py`` — fresh
implementation over the engine's rewrite hook, plus an XLA extra:
``explain`` reports the compiled-program cache state and ``xla_profile``
wraps one compute in the jax profiler.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

import dask_array_tpu._expr as _expr_mod
from dask_array_tpu._expr import ArrayExpr


@dataclass
class RewriteRecord:
    rule: str
    before: str
    after: str
    phase: str
    before_type: str = ""
    after_type: str = ""


class RewriteTrace:
    def __init__(self):
        self.records: list[RewriteRecord] = []

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)

    def counter(self):
        return Counter(r.rule for r in self.records)

    def summary(self) -> str:
        lines = [f"{len(self.records)} rewrites"]
        for rule, n in self.counter().most_common():
            lines.append(f"  {rule}: {n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_rewrites():
    """Record every optimizer rewrite fired inside the block.

    >>> with trace_rewrites() as trace:
    ...     y.optimize()
    >>> print(trace.summary())
    """
    trace = RewriteTrace()
    prev = _expr_mod._trace_hook

    def hook(rule, before, after, phase):
        trace.records.append(
            RewriteRecord(
                rule,
                before._name,
                after._name,
                phase,
                type(before).__name__,
                type(after).__name__,
            )
        )
        if prev is not None:
            prev(rule, before, after, phase)

    _expr_mod._trace_hook = hook
    try:
        yield trace
    finally:
        _expr_mod._trace_hook = prev


def _node_count(expr: ArrayExpr) -> int:
    return sum(1 for _ in expr.walk())


def _transfer_total(expr: ArrayExpr):
    lo = hi = 0
    for node in expr.walk():
        a, b = node.transfer_bytes()
        lo += a
        hi += b
    return lo, hi


def _leaf_read_bytes(expr: ArrayExpr):
    total = 0
    for node in expr.walk():
        if not node.dependencies():
            nb = node.nbytes
            if not (isinstance(nb, float) and np.isnan(nb)):
                total += int(nb)
    return total


def explain(x, fuse: bool = True, file=None):
    """Run simplify / lower / fuse separately, timing and reporting each.

    Parity: ``explain`` (``_diagnostics.py:285``).
    """
    from dask_array_tpu._blockwise import FusedBlockwise, optimize_blockwise_fusion
    from dask_array_tpu._collection import Array

    expr = x.expr if isinstance(x, Array) else x
    report = {}
    out = []

    def emit(line=""):
        out.append(line)

    emit(f"explain: {type(expr).__name__}  shape={expr.shape}  chunks={expr.chunksize}")
    emit(f"  raw: {_node_count(expr)} nodes, leaf reads {_fmt_bytes(_leaf_read_bytes(expr))}")

    with trace_rewrites() as tr_s:
        t0 = time.perf_counter()
        simplified = expr.simplify()
        t_simplify = time.perf_counter() - t0
    emit(
        f"  simplify: {t_simplify * 1e3:.2f} ms, {len(tr_s)} rewrites -> "
        f"{_node_count(simplified)} nodes, leaf reads "
        f"{_fmt_bytes(_leaf_read_bytes(simplified))}"
    )
    for rule, n in tr_s.counter().most_common():
        emit(f"    {rule}: {n}")

    with trace_rewrites() as tr_l:
        t0 = time.perf_counter()
        lowered = simplified.lower_completely()
        t_lower = time.perf_counter() - t0
    emit(
        f"  lower: {t_lower * 1e3:.2f} ms, {len(tr_l)} rewrites -> "
        f"{_node_count(lowered)} nodes"
    )
    for rule, n in tr_l.counter().most_common():
        emit(f"    {rule}: {n}")

    fused = lowered
    if fuse:
        t0 = time.perf_counter()
        fused = optimize_blockwise_fusion(lowered)
        t_fuse = time.perf_counter() - t0
        groups = [n for n in fused.walk() if isinstance(n, FusedBlockwise)]
        emit(
            f"  fuse: {t_fuse * 1e3:.2f} ms, {len(groups)} fused groups "
            f"(sizes {[g.n_fused for g in groups]})"
        )

    lo, hi = _transfer_total(fused)
    emit(f"  est. transfer bytes: min {_fmt_bytes(lo)}, max {_fmt_bytes(hi)}")
    emit(f"  leaf read bytes: {_fmt_bytes(_leaf_read_bytes(fused))}")
    emit(f"  output: shape={fused.shape} dtype={fused.dtype} blocks={fused.npartitions}")

    from dask_array_tpu._executor import _fn_cache

    emit(f"  compiled-program cache: {len(_fn_cache)} entries")

    plan_fp = None
    try:
        from dask_array_tpu import native
        from dask_array_tpu._planrec import plan_fingerprint, plan_records

        rec = plan_records(fused)
        if rec is not None:
            blob, stable = rec
            plan_fp = plan_fingerprint(fused)[0]
            emit(
                f"  plan record: {len(blob)} bytes, fingerprint {plan_fp}"
                f" ({'process-stable' if stable else 'in-process only'},"
                f" {'native' if native.available() else 'python'} encoder)"
            )
    except Exception:
        pass

    text = "\n".join(out)
    print(text, file=file)
    return {
        "simplified": simplified,
        "lowered": lowered,
        "fused": fused,
        "times_ms": {"simplify": t_simplify * 1e3, "lower": t_lower * 1e3},
        "transfer_bytes": (lo, hi),
        "nodes": {
            "raw": _node_count(expr),
            "simplified": _node_count(simplified),
            "lowered": _node_count(lowered),
            "fused": _node_count(fused),
        },
        "read_bytes": {
            "raw": _leaf_read_bytes(expr),
            "simplified": _leaf_read_bytes(simplified),
            "fused": _leaf_read_bytes(fused),
        },
        "rewrites": {"simplify": tr_s.counter(), "lower": tr_l.counter()},
        "plan_fingerprint": plan_fp,
    }


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.1f} PiB"


def chunk_report(*arrays, limit=8, file=None):
    """Summarize chunk-shape health (parity: ``chunk_report``,
    ``_diagnostics.py:43``; ``limit`` caps the per-call report lines)."""
    lines = []
    for a in arrays[: limit if limit else None]:
        chunks = a.chunks
        sizes = []
        import itertools

        for dims in itertools.product(*chunks):
            if any(isinstance(d, float) and np.isnan(d) for d in dims):
                sizes = None
                break
            sizes.append(int(np.prod(dims)) * a.dtype.itemsize)
        name = getattr(a, "name", "?")[:24]
        if sizes is None:
            lines.append(f"{name}: unknown chunk sizes (nan)")
            continue
        lines.append(
            f"{name}: {a.npartitions} blocks, chunk bytes min {_fmt_bytes(min(sizes))} "
            f"/ median {_fmt_bytes(int(np.median(sizes)))} / max {_fmt_bytes(max(sizes))}"
        )
        if max(sizes) > 1 << 30:
            lines.append("  WARNING: chunks exceed 1 GiB; consider rechunking smaller")
        if len(sizes) > 100000:
            lines.append("  WARNING: very large block count; consider rechunking larger")
    text = "\n".join(lines)
    print(text, file=file)
    return text


def expr_table(x, file=None):
    """Tabular view of the (optimized) expression tree."""
    from dask_array_tpu._collection import Array

    expr = x.expr if isinstance(x, Array) else x
    rows = [("node", "shape", "chunksize", "dtype", "blocks", "transfer(max)")]
    for node in expr.walk():
        lo, hi = node.transfer_bytes()
        rows.append(
            (
                type(node).__name__,
                str(node.shape),
                str(node.chunksize),
                str(node.dtype),
                str(node.npartitions),
                _fmt_bytes(hi),
            )
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = [
        "  ".join(cell.ljust(w) for cell, w in zip(row, widths)) for row in rows
    ]
    text = "\n".join(lines)
    print(text, file=file)
    return text


@contextlib.contextmanager
def xla_profile(logdir="/tmp/dask_array_tpu_profile"):
    """Profile the computes inside the block with the jax/XLA profiler."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def tier_report(x, file=None):
    """Classify every node by execution tier (parity: the reference's
    ``_frisky/inventory.py`` tier classifier — binary/native_tuples/adapter/
    fallback becomes trace/eager here, plus whether the native planning
    library is engaged).

    Tiers:
      * ``trace``  — staged into the single jitted XLA program (fast path)
      * ``eager``  — forces concrete evaluation of the whole tree
                     (data-dependent shapes / untraceable host functions)
    """
    from collections import Counter

    from dask_array_tpu import native
    from dask_array_tpu._collection import Array

    expr = x.expr if isinstance(x, Array) else x
    lowered = expr.optimize()
    rows = []
    for node in lowered.walk():
        tier = "trace" if getattr(node, "_traceable", True) else "eager"
        rows.append((type(node).__name__, tier))
    counts = Counter(tier for _, tier in rows)
    lines = [
        f"execution tier report ({len(rows)} nodes): "
        + ", ".join(f"{t}={n}" for t, n in sorted(counts.items()))
    ]
    mode = "eager (whole tree)" if counts.get("eager") else "trace (one jitted XLA program)"
    lines.append(f"  mode: {mode}")
    lines.append(f"  native plankit: {'engaged' if native.available() else 'Python fallback'}")
    for name, tier in rows:
        if tier != "trace":
            lines.append(f"  {name}: {tier}")
    text = "\n".join(lines)
    print(text, file=file)
    return {"counts": dict(counts), "nodes": rows, "native": native.available()}


def plan_table(x, file=None):
    """Decode and display the binary plan record of ``x``'s optimized plan.

    The XLA analog of inspecting the reference's emitted layer records
    (``_frisky/collect.py`` chunk groups + ``tests/test_frisky_protocol.py``
    re-decoder): the node table exactly as the executor's structural cache
    key sees it.  Returns the decoded dict, or None if the plan is not
    expressible in the grammar.
    """
    from dask_array_tpu._collection import Array
    from dask_array_tpu._planrec import decode_plan, plan_records

    expr = x.expr if isinstance(x, Array) else x
    expr = expr.optimize()
    rec = plan_records(expr)
    if rec is None:
        print("plan not expressible in the records grammar", file=file)
        return None
    blob, stable = rec
    decoded = decode_plan(blob)
    lines = [
        f"plan record: {len(decoded['nodes'])} nodes, {len(blob)} bytes, "
        f"grammar v{decoded['version']}"
        f" ({'process-stable' if stable else 'in-process only'})"
    ]
    for i, node in enumerate(decoded["nodes"]):
        nblocks = tuple(len(c) for c in node["chunks"])
        ops = []
        for op in node["ops"]:
            if isinstance(op, tuple) and len(op) == 2 and op[0] == "expr":
                ops.append(f"@{op[1]}")
            elif isinstance(op, tuple) and len(op) == 2 and op[0] == "leaf":
                ops.append(f"leaf#{op[1]}")
            else:
                r = repr(op)
                ops.append(r if len(r) <= 24 else r[:21] + "...")
        lines.append(f"  [{i}] {node['type']} blocks={nblocks} ops=({', '.join(ops)})")
    text = "\n".join(lines)
    print(text, file=file)
    return decoded


def compiled_hlo(x, mesh=None):
    """The optimized HLO text of the ONE compiled XLA program for ``x``.

    The XLA analog of inspecting the reference's emitted task records
    (``bench/diff_layers.py``): what the executor will actually run —
    including the collectives GSPMD/shard_map placed (look for
    ``all-to-all``, ``all-gather``, ``collective-permute``, ``all-reduce``).
    """
    import jax

    from dask_array_tpu._collection import Array
    from dask_array_tpu._executor import (
        _device_put_leaves,
        collect_leaves,
        make_compute_fn,
    )
    from dask_array_tpu._materialize import optimize_expr
    from dask_array_tpu.parallel.mesh import current_mesh

    expr = x.expr if isinstance(x, Array) else x
    lowered = optimize_expr(expr)
    if mesh is None:
        mesh = current_mesh()
    leaf_pairs = collect_leaves(lowered)
    keys = tuple(k for k, _ in leaf_pairs)
    args = _device_put_leaves(leaf_pairs, mesh)
    compute_fn = make_compute_fn(lowered, keys, mesh)
    compiled = jax.jit(compute_fn).lower(*args).compile()
    return compiled.as_text()
