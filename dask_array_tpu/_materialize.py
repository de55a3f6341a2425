"""The optimize -> execute choke point.

Parity: ``/root/reference/dask_array/_materialize.py`` — but where the
reference materializes a task graph, we optimize the expression tree
(simplify -> lower -> fuse) and hand it to the trace-to-XLA executor.
"""

from __future__ import annotations

import functools

import numpy as np

from dask_array_tpu import config
from dask_array_tpu._executor import execute
from dask_array_tpu._expr import ArrayExpr


def optimize_expr(expr: ArrayExpr, fuse: bool = True) -> ArrayExpr:
    """Optimize with a per-expression memo.

    Repeated computes of the SAME collection (steady-state dispatch) skip
    the simplify/lower/fuse walk; the memo lives on the singleton expr (so
    its lifetime tracks the user's collection) and keys on the config
    EPOCH, since policy keys change optimization results.
    """
    opt_flag = config.get("array.optimize-graph", True)
    key = (fuse, bool(opt_flag), config.epoch())
    cached = getattr(expr, "_opt_memo", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    if not opt_flag:
        out = expr.lower_completely()
    else:
        out = expr.optimize(fuse=fuse)
    try:
        expr._opt_memo = (key, out)
    except Exception:
        pass  # exotic expr with __slots__: skip the memo
    return out


def compute_expr(expr: ArrayExpr, optimize: bool = True):
    """Optimize + execute; returns the dense on-device jax.Array — or a
    HOST numpy array when the out-of-core streaming lane answered (its
    result may itself exceed device memory)."""
    from dask_array_tpu._executor import check_masked_ops

    check_masked_ops(expr)  # logical tree: MapBlocks still distinct
    if optimize:
        from dask_array_tpu._streaming import maybe_stream

        streamed = maybe_stream(expr)
        if streamed is not None:
            return streamed
    lowered = optimize_expr(expr) if optimize else expr
    return execute(lowered)


def compute_to_numpy(expr: ArrayExpr):
    out = compute_expr(expr)
    validate = getattr(expr, "_host_validate", None)
    if validate is not None:
        validate(out)
    if isinstance(out, np.ma.MaskedArray):
        return out  # masked host lane: np.asarray would drop the mask
    from dask_array_tpu._dispatch import is_duck_chunk

    if is_duck_chunk(out):
        return out  # duck host lane: compute() returns the registered type
    arr = np.asarray(out)
    dt = expr.dtype
    if getattr(dt, "kind", "") in "Mm" and arr.dtype != dt:
        # datetime shim: device blocks are int64 tick views; restore the
        # logical datetime64/timedelta64 dtype recorded in metadata
        arr = arr.view(dt) if arr.dtype.itemsize == dt.itemsize else arr.astype("i8").view(dt)
    return arr


class Barrier(ArrayExpr):
    """A program split point: the subtree below computes as its OWN jitted
    program and feeds the parent program as a device-buffer leaf.

    Uses: staging very large pipelines past compiler limits, explicit
    memory/compile-time tradeoffs, and debugging.  ``da.barrier(x)``.
    """

    _parameters = ("array",)

    # the subtree below is fully covered by this node's buffer: leaf
    # collection must not descend into it
    _leaf_stop = True

    @property
    def chunks(self):
        return self.array.chunks

    @property
    def _meta(self):
        return self.array._meta

    @functools.cached_property
    def _leaf_key(self):
        return f"barrier-{self._name}"

    def _leaf_buffers(self):
        buf = getattr(self, "_cached_buffer", None)
        if buf is None:
            buf = compute_expr(self.array)
            object.__setattr__(self, "_cached_buffer", buf)
        yield (self._leaf_key, buf)

    def _structural_operands(self):
        from dask_array_tpu._chunks import dtype_key

        return [("buf", dtype_key(self.dtype)), self.chunks]

    def _build(self, ctx):
        from dask_array_tpu._executor import BlockView

        return BlockView(self.chunks, dense=ctx.leaf(self._leaf_key))


def barrier(x):
    """Split the computation here: everything below runs as a separate
    compiled program whose result feeds the rest as a device buffer."""
    from dask_array_tpu._collection import Array, new_collection

    expr = x.expr if isinstance(x, Array) else x
    return new_collection(Barrier(expr))
