"""Trace-to-XLA executor: the XLA-native replacement for task graphs.

Where the reference materializes its lowered expression tree into a dask /
Frisky task graph (``/root/reference/dask_array/_materialize.py``,
``_frisky/collect.py``), this executor *traces* the lowered tree into ONE
jax function over the leaf buffers and jit-compiles it, so that XLA sees the
entire pipeline at once: blockwise chains fuse into single kernels, block
matmuls become large contractions, rechunks become layout changes (and,
on a mesh, collectives inserted by SPMD partitioning).

Every physical expression implements ``_build(ctx) -> BlockView``.  A
``BlockView`` lets a node produce its value in whichever form is natural —
a dict of per-block arrays, or a single dense array — and converts lazily:
dense -> block is slicing (fused by XLA); blocks -> dense is a concatenate.

Execution modes
  * ``trace`` (default): whole tree under ``jax.jit``; requires known chunks.
  * ``eager``: same ``_build`` code, run with concrete arrays (needed for
    unknown/nan chunks, where shapes are data-dependent).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np

from dask_array_tpu import config
from dask_array_tpu._chunks import cached_cumsum, has_unknown_chunks
from dask_array_tpu._expr import ArrayExpr


def _jnp():
    import jax.numpy as jnp

    return jnp


def block_slices(chunks, index):
    """Slices of block ``index`` inside the dense array with these chunks."""
    out = []
    for ax, i in enumerate(index):
        bounds = cached_cumsum(chunks[ax], initial_zero=True)
        out.append(slice(int(bounds[i]), int(bounds[i + 1])))
    return tuple(out)


def iter_block_indices(numblocks):
    return np.ndindex(*numblocks)


class BlockView:
    """Lazy dual representation (blocks dict <-> dense) of one node's value."""

    __slots__ = ("chunks", "_blocks", "_dense")

    def __init__(self, chunks, blocks=None, dense=None):
        assert blocks is not None or dense is not None
        self.chunks = chunks
        self._blocks = blocks
        self._dense = dense

    @property
    def numblocks(self):
        return tuple(len(c) for c in self.chunks)

    def block(self, index):
        if self._blocks is not None:
            return self._blocks[tuple(index)]
        if has_unknown_chunks(self.chunks):
            # an unknown axis with a SINGLE block needs no split point —
            # the whole dense extent is the block (tsqr/svd factors over
            # boolean-masked inputs land here)
            if all(
                len(c) == 1 or not has_unknown_chunks((c,)) for c in self.chunks
            ):
                out = []
                for ax, i in enumerate(index):
                    if has_unknown_chunks((self.chunks[ax],)):
                        out.append(slice(None))
                    else:
                        bounds = cached_cumsum(self.chunks[ax], initial_zero=True)
                        out.append(slice(int(bounds[i]), int(bounds[i + 1])))
                return self._dense[tuple(out)]
            raise ValueError("cannot slice blocks out of an array with unknown chunks")
        return self._dense[block_slices(self.chunks, index)]

    def blocks_dict(self):
        if self._blocks is None:
            self._blocks = {
                tuple(idx): self.block(idx) for idx in iter_block_indices(self.numblocks)
            }
        return self._blocks

    def dense(self):
        if self._dense is None:
            self._dense = _assemble(self._blocks, self.numblocks)
        return self._dense

    @property
    def is_dense(self):
        return self._dense is not None


def _assemble(blocks: dict, numblocks) -> Any:
    """Concatenate a full grid of blocks into one dense array."""
    jnp = _jnp()
    if not numblocks:
        return blocks[()]
    if any(isinstance(b, np.ma.MaskedArray) for b in blocks.values()):
        jnp = np.ma  # masked blocks: np.concatenate would drop the mask
    elif any(_is_host_only(b) for b in blocks.values()):
        jnp = np  # structured blocks concatenate on host

    def rec(axis, prefix):
        if axis == len(numblocks):
            return blocks[prefix]
        parts = [rec(axis + 1, prefix + (i,)) for i in range(numblocks[axis])]
        if len(parts) == 1:
            return parts[0]
        return jnp.concatenate(parts, axis=axis)

    return rec(0, ())


class BuildContext:
    """Carries the memo cache + leaf bindings through one _build traversal."""

    def __init__(self, leaf_values: dict, mode: str = "trace", mesh=None):
        self.cache: dict[str, BlockView] = {}
        self.leaf_values = leaf_values  # key -> (traced or concrete) array
        self.mode = mode
        self.mesh = mesh

    def build(self, expr: ArrayExpr) -> BlockView:
        view = self.cache.get(expr._name)
        if view is None:
            view = expr._build(self)
            assert isinstance(view, BlockView), type(expr).__name__
            view = self._constrain(expr, view)
            self.cache[expr._name] = view
        return view

    def leaf(self, key):
        return self.leaf_values[key]

    def _constrain(self, expr, view: BlockView) -> BlockView:
        """Apply a mesh sharding constraint at layout-relevant nodes."""
        if self.mesh is None or self.mode != "trace":
            return view
        if not getattr(expr, "_sharding_boundary", False):
            return view
        from dask_array_tpu.parallel.layout import constrain_to_mesh

        dense = constrain_to_mesh(view.dense(), view.chunks, self.mesh)
        return BlockView(view.chunks, dense=dense)


# ---------------------------------------------------------------------------
# leaf collection
# ---------------------------------------------------------------------------


def collect_leaves(root: ArrayExpr):
    """(key, host buffer) pairs in STRUCTURAL order (deterministic DFS over
    operand positions).  Two structurally identical trees emit their leaves
    at identical positions, which is what makes the structural compiled-
    function cache sound: the cached closure binds leaves positionally."""
    pairs = []
    seen_nodes = set()
    seen_keys = set()
    stack = [root]
    while stack:
        node = stack.pop()
        if node._name in seen_nodes:
            continue
        seen_nodes.add(node._name)
        for key, buf in node._leaf_buffers():
            if key not in seen_keys:
                seen_keys.add(key)
                pairs.append((key, buf))
        if getattr(node, "_leaf_stop", False):
            # nodes like Barrier fully cover their subtree with one buffer;
            # descending would re-run the isolated subtree's host IO and
            # bind its raw leaves as dead (or worse, donated) jit args
            continue
        # push children reversed so they pop in operand order
        stack.extend(reversed(node.dependencies()))
    return pairs


# ---------------------------------------------------------------------------
# compiled-function cache
# ---------------------------------------------------------------------------

_fn_cache: dict = {}
_FN_CACHE_LIMIT = 512


def structural_key(root: ArrayExpr) -> str:
    """A cache key invariant to leaf buffer CONTENTS (buffers are jit args,
    so two same-shaped datasets share one compiled executable).  Every other
    operand — including scalar literals, which get baked into the trace as
    constants — stays in the key.  Leaf nodes carry their first-visit
    ORDINAL so that sharing patterns (f(A,A,B) vs f(A,B,B)) key differently:
    the cached closure binds leaves positionally.

    Fast path: the native plan-records fingerprint (``_planrec``) — the
    binary plan grammar is injective over the same structure this walk
    hashes, and is process-stable for expressible plans.  Plans the grammar
    declines fall back to the legacy tokenize walk (prefix-disjoint keys,
    so the two schemes can never alias each other).
    """
    from dask_array_tpu.utils._tokenize import tokenize

    cached = getattr(root, "_skey_memo", None)
    if cached is not None:
        return cached

    try:
        from dask_array_tpu._planrec import plan_fingerprint

        pf = plan_fingerprint(root)
    except Exception:
        pf = None
    if pf is not None:
        out = "plan:" + pf[0]
        try:
            root._skey_memo = out
        except Exception:
            pass
        return out

    memo: dict[str, str] = {}
    leaf_ordinal: dict[str, int] = {}

    def rec(node: ArrayExpr) -> str:
        got = memo.get(node._name)
        if got is not None:
            return got
        parts: list = [type(node).__qualname__]
        spec = node._structural_operands() if hasattr(node, "_structural_operands") else None
        if spec is not None:
            ordinal = leaf_ordinal.setdefault(node._name, len(leaf_ordinal))
            parts.append(("leaf", ordinal))
            ops = spec
        else:
            ops = node.operands
        for op in ops:
            if isinstance(op, ArrayExpr):
                parts.append(rec(op))
            else:
                parts.append(op)
        tok = tokenize(*parts)
        memo[node._name] = tok
        return tok

    out = rec(root)
    try:
        root._skey_memo = out
    except Exception:
        pass
    return out


# structural keys whose programs proved untraceable: go straight to eager
_eager_keys: set = set()

# execute_many repeat-call memo: (root ids, mesh, trace cfg) ->
# (roots strong-ref, leaf union, compiled executable)
_em_fastpath: dict = {}

# execute() repeat-call memo: same idea for single-root steady loops
# (serving): skip the traceable walk, leaf collection, and program-key
# construction — only the device_put guard and the compiled call run
_ex_fastpath: dict = {}


def _mesh_key(mesh):
    """Stable mesh identity for cache keys.  ``id(mesh)`` is unsafe: after a
    mesh is garbage-collected a new Mesh can reuse the address and hit an
    executable compiled for a different topology/device order."""
    if mesh is None:
        return None
    return (
        tuple(mesh.axis_names),
        tuple(mesh.devices.shape),
        tuple(d.id for d in mesh.devices.flat),
    )


def make_compute_fn(root: ArrayExpr, keys: tuple, mesh):
    """The traced function computing root's dense value from leaf buffers.

    Shared by the executor and ``diagnostics.compiled_hlo`` so inspected
    HLO matches what actually runs.
    """

    def compute_fn(*leaf_arrays):
        if mesh is not None:
            # leaves whose dims don't divide the mesh arrive replicated
            # (device_put forbids uneven shardings); an uneven CONSTRAINT
            # here scatters them so downstream compute is sharded, not
            # replicated — the pad-to-regular side of the chunks-vs-
            # sharding duality
            from dask_array_tpu.parallel.layout import constrain_to_mesh

            leaf_arrays = tuple(
                constrain_to_mesh(a, None, mesh) if getattr(a, "ndim", 0) else a
                for a in leaf_arrays
            )
        ctx = BuildContext(dict(zip(keys, leaf_arrays)), mode="trace", mesh=mesh)
        return ctx.build(root).dense()

    return compute_fn


def _trace_fn(root: ArrayExpr, keys: tuple, mesh, args):
    """The cached COMPILED executable computing root's dense value.

    AOT-compiled (jit(...).lower(*args).compile()) so the cache holds only
    the executable: the tracing closure — and through it the whole
    expression tree including multi-GB FromArray host buffers — is released
    after compilation instead of being pinned for the cache's lifetime.
    """
    import jax

    donate = config.get("tpu.donate-leaves", False)
    cache_key = _program_key(root, keys, mesh, donate)
    if cache_key in _eager_keys:
        return None, cache_key
    compiled = _fn_cache.get(cache_key)
    if compiled is not None:
        _fn_cache[cache_key] = _fn_cache.pop(cache_key)  # LRU touch
        return compiled, cache_key

    compute_fn = make_compute_fn(root, keys, mesh)

    fn = jax.jit(compute_fn, donate_argnums=tuple(range(len(keys))) if donate else ())
    compiled = fn.lower(*args).compile()
    while len(_fn_cache) >= _FN_CACHE_LIMIT:
        # evict least-recently-used: remote compiles are seconds-to-minutes,
        # so a full wipe would recompile every hot program
        _fn_cache.pop(next(iter(_fn_cache)))
    _fn_cache[cache_key] = compiled
    return compiled, cache_key


# config keys read INSIDE _build/kernels at trace time: their value is baked
# into the compiled program, so it must be part of the executable identity
# (a cached program compiled under qr-gram="eigh-clamp" must not serve a
# session that switched to "shifted")
_TRACE_CONFIG_KEYS = (
    "tpu.matmul-precision",
    "tpu.qr-method",
    "tpu.qr-gram",
    "tpu.gram-precision",
    "tpu.svd-method",
    "tpu.prng-impl",
    "tpu.random-precision",
    "tpu.overlap-method",
)


def _trace_config_key():
    return tuple(config.get(k, None) for k in _TRACE_CONFIG_KEYS)


def _program_key(root, keys, mesh, donate):
    """Executable identity: structure + leaf count + mesh + DONATION (a
    donating executable must never serve a non-donating config, or it
    deletes the caller's buffers) + the trace-affecting config values."""
    return (
        structural_key(root),
        len(keys),
        _mesh_key(mesh),
        bool(donate),
        _trace_config_key(),
    )


def _materialize_buf(b):
    """Host-side IO leaves (from_map) produce their block on first use;
    array-likes (h5py datasets, memmaps, duck arrays) coerce to numpy.

    datetime64/timedelta64 ship as their int64 tick view (jax has no
    datetime dtypes); the logical dtype lives in expression metadata and
    is restored at ``compute_to_numpy`` (the "datetime shim")."""
    from dask_array_tpu._dispatch import is_duck_chunk

    if hasattr(b, "materialize"):
        b = b.materialize()
    if is_duck_chunk(b):
        return b  # registered duck block: np.asarray would drop the type
    if isinstance(b, np.ndarray):
        return b.view("i8") if b.dtype.kind in "Mm" else b
    if hasattr(b, "devices"):
        return b
    if hasattr(b, "__array__") or hasattr(b, "dtype"):
        if not hasattr(b, "__array__") and hasattr(b, "__getitem__") and hasattr(b, "shape"):
            # chunked store (zarr/h5py style, no __array__): bulk-read via
            # slicing — np.asarray would wrap it in a 0-d object array
            b = b[(slice(None),) * len(b.shape)]
        b = np.asarray(b)
        return b.view("i8") if b.dtype.kind in "Mm" else b
    return b


def _is_host_only(arr) -> bool:
    """Structured (record) dtypes and masked arrays have no device
    representation — they stay host numpy and execute through the eager
    lane (the structured/masked host lanes; reference usage:
    ``reductions/_common.py:675-830``, ``_dispatch.py:36,248``)."""
    if isinstance(arr, np.ma.MaskedArray):
        return True
    from dask_array_tpu._dispatch import is_duck_chunk

    if is_duck_chunk(arr):
        return True  # registered duck block: host lane preserves the type
    from dask_array_tpu._chunks import host_only_dtype

    dt = getattr(arr, "dtype", None)
    try:
        return dt is not None and host_only_dtype(dt)
    except TypeError:
        return False


# ops verified MASK-PRESERVING on the host lane: passthroughs (numpy.ma
# handles them), plus compute ops whose kernels dispatch to numpy(.ma)
# counterparts when blocks are masked (``_blockwise.masked_host_kernel``);
# anything else would silently drop the mask through jnp, so it raises
_MASKED_PASSTHROUGH = {
    "FromArray",
    "Slice",
    "Take",
    "Concatenate",
    "ExpandDims",
    "Rechunk",
    "MapBlocks",
    # compute surface (VERDICT r3 #2): jnp kernels swap to their numpy(.ma)
    # counterparts on masked host blocks
    "Elemwise",
    "Blockwise",
    "Transpose",
    "Squeeze",
    "Reduction",
    "CumReduction",
    "ArgReduction",
}


def check_masked_ops(root) -> None:
    """Raise for ops that cannot preserve a mask (jnp would silently drop
    it).  Runs on the LOGICAL tree (before lowering, where MapBlocks is
    still distinct from Elemwise).  Reference parity: masked sources flow
    through numpy block kernels untouched
    (``tests/test_collection.py:1322``); elemwise/blockwise/reductions
    execute with numpy(.ma) kernels on the host lane — the rest of the
    surface raises rather than silently dropping the mask."""
    leaves_masked = any(
        isinstance(b, np.ma.MaskedArray) for _, b in collect_leaves(root)
    )
    if not leaves_masked:
        return
    # only nodes whose OWN subtree carries a masked leaf are gated: an
    # unmasked branch (e.g. ones() mixed into a masked elemwise) computes
    # normally and converts at the consuming kernel
    masked_below: dict[str, bool] = {}

    def rec(node) -> bool:
        got = masked_below.get(node._name)
        if got is not None:
            return got
        masked_below[node._name] = False  # cycle guard (trees only, but safe)
        own = any(
            isinstance(b, np.ma.MaskedArray) for _, b in node._leaf_buffers()
        )
        flag = own or any(rec(d) for d in node.dependencies())
        masked_below[node._name] = flag
        return flag

    for node in root.walk():
        if rec(node) and type(node).__name__ not in _MASKED_PASSTHROUGH:
            raise NotImplementedError(
                f"{type(node).__name__} on a masked array would silently "
                "drop the mask on the device; call x.filled(...) "
                "first (or use map_blocks with numpy.ma kernels)"
            )


def node_traceable(node) -> bool:
    """A node joins the jitted program unless it opts out OR its value has
    no device representation (structured/string/object dtypes)."""
    if not getattr(node, "_traceable", True):
        return False
    from dask_array_tpu._chunks import host_only_dtype

    try:
        return not host_only_dtype(node.dtype)
    except Exception:
        return True


def _device_put_leaves(leaf_pairs, mesh, donate=False):
    import jax

    def guard(b):
        # with donation on, a leaf that is ALREADY a device array would donate
        # the user's own buffer (invalidated after the first call, and a
        # recompute of the same collection would pass the same dead buffer);
        # executor-created copies are the only safe donation targets
        if donate and hasattr(b, "devices"):
            return jax.numpy.copy(b)
        return b

    if mesh is None:
        return [guard(_materialize_buf(b)) for _, b in leaf_pairs]
    from dask_array_tpu.parallel.layout import sharding_for

    out = []
    for key, b in leaf_pairs:
        b = _materialize_buf(b)
        if _is_host_only(b):
            out.append(b)  # no device representation; eager lane consumes it
            continue
        arr = np.asarray(b) if not hasattr(b, "devices") else guard(b)
        sh = sharding_for(getattr(arr, "shape", ()), mesh)
        out.append(jax.device_put(arr, sh) if sh is not None else arr)
    return out


def execute_many(roots, mode: str | None = None):
    """Execute several lowered trees as ONE jitted program (tuple output).

    Shared ancestry builds once (BuildContext memoizes by node name, and
    the singleton registry makes shared subtrees the same node), and every
    leaf ships to the device once — the reference shares work across
    collections through its common task graph
    (``tests/test_collection.py::test_lowering_shares_work_across_collections_with_shared_ancestry``);
    here the sharing is inside one XLA program.
    """
    import jax

    from dask_array_tpu.parallel.mesh import current_mesh

    roots = list(roots)
    if len(roots) == 1:
        return [execute(roots[0])]

    mesh = current_mesh()

    # repeat-call fast path: the same root OBJECTS re-executed (a steady
    # benchmark/serving loop) skip the traceable walk, leaf-union build,
    # and cache-key construction — only the (cheap) device_put guard and
    # the compiled call run per iteration.  Keyed on identity; the memo
    # holds strong refs so ids stay valid.
    fp_key = (
        tuple(map(id, roots)),
        _mesh_key(mesh),
        _trace_config_key(),
        bool(config.get("tpu.donate-leaves", False)),
    )
    hit = _em_fastpath.get(fp_key)
    if hit is not None and mode is None:
        _roots_ref, union, compiled = hit
        args = _device_put_leaves(union, mesh, donate=False)
        return list(compiled(*args))

    traceable = all(
        r.known_chunks and all(node_traceable(n) for n in r.walk()) for r in roots
    )
    if mode is None:
        mode = "trace" if (config.get("tpu.jit", True) and traceable) else "eager"

    # union of leaves, first-visit order; remember each root's positions so
    # sharing patterns key the cache correctly (leaves bind positionally)
    union = []
    pos = {}
    patterns = []
    for r in roots:
        ks = []
        for k, b in collect_leaves(r):
            if k not in pos:
                pos[k] = len(union)
                union.append((k, b))
            ks.append(pos[k])
        patterns.append(tuple(ks))
    keys = tuple(k for k, _ in union)
    donate = config.get("tpu.donate-leaves", False)
    cache_key = (
        "multi",
        tuple(structural_key(r) for r in roots),
        tuple(patterns),
        len(keys),
        _mesh_key(mesh),
        bool(donate),
        _trace_config_key(),
    )

    if mode == "trace" and cache_key in _eager_keys:
        mode = "eager"

    if mode == "trace":
        args = _device_put_leaves(union, mesh, donate=donate)
        try:
            compiled = _fn_cache.get(cache_key)
            if compiled is not None:
                _fn_cache[cache_key] = _fn_cache.pop(cache_key)  # LRU touch
            else:
                def compute_fn(*leaf_arrays):
                    if mesh is not None:
                        from dask_array_tpu.parallel.layout import constrain_to_mesh

                        leaf_arrays = tuple(
                            constrain_to_mesh(a, None, mesh) if getattr(a, "ndim", 0) else a
                            for a in leaf_arrays
                        )
                    ctx = BuildContext(dict(zip(keys, leaf_arrays)), mode="trace", mesh=mesh)
                    return tuple(ctx.build(r).dense() for r in roots)

                fn = jax.jit(
                    compute_fn,
                    donate_argnums=tuple(range(len(keys))) if donate else (),
                )
                compiled = fn.lower(*args).compile()
                while len(_fn_cache) >= _FN_CACHE_LIMIT:
                    _fn_cache.pop(next(iter(_fn_cache)))
                _fn_cache[cache_key] = compiled
            out = list(compiled(*args))
            if not donate and config.get("tpu.jit", True):
                while len(_em_fastpath) >= 32:
                    _em_fastpath.pop(next(iter(_em_fastpath)))
                _em_fastpath[fp_key] = (tuple(roots), union, compiled)
            return out
        except Exception as e:
            if not _is_trace_error(e):
                raise
            if len(_eager_keys) > 4096:
                _eager_keys.clear()
            _eager_keys.add(cache_key)
            import warnings

            warnings.warn(
                f"joint computation is not jax-traceable ({type(e).__name__}); "
                "falling back to eager per-value execution",
                RuntimeWarning,
                stacklevel=2,
            )

    # eager: one shared BuildContext so ancestry still computes once
    import jax.numpy as jnp

    if mesh is not None:
        args = _device_put_leaves(union, mesh)
        vals = dict(zip(keys, args))
    else:
        vals = {}
        for k, b in union:
            b = _materialize_buf(b)
            if _is_host_only(b):
                # structured/masked/duck: stays host (np.asarray on a
                # masked array would drop the mask; on a registered duck
                # block, its type)
                from dask_array_tpu._dispatch import is_duck_chunk

                keep = isinstance(b, np.ndarray) or is_duck_chunk(b)
                vals[k] = b if keep else np.asarray(b)
            elif not hasattr(b, "dtype") or isinstance(b, np.ndarray):
                vals[k] = jnp.asarray(np.asarray(b))
            else:
                vals[k] = b
    ctx = BuildContext(vals, mode="eager", mesh=mesh)
    return [ctx.build(r).dense() for r in roots]


def _is_trace_error(e: Exception) -> bool:
    import jax.errors

    if isinstance(
        e,
        (
            jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError,
            jax.errors.TracerBoolConversionError,
            jax.errors.TracerIntegerConversionError,
            jax.errors.UnexpectedTracerError,
        ),
    ):
        return True
    # numpy raising on a tracer input surfaces as TypeError/ValueError
    # mentioning the tracer
    return "Tracer" in str(e) or "tracer" in str(e)


def execute(root: ArrayExpr, mode: str | None = None, want_view: bool = False):
    """Execute a lowered expression tree; returns a jax.Array (dense).

    With ``want_view=True`` returns the root ``BlockView`` instead — eager
    executions keep their per-block values, which is how
    ``compute_chunk_sizes`` recovers the concrete grid of an unknown-chunk
    array without collapsing it to one block per axis.
    """
    from dask_array_tpu.parallel.mesh import current_mesh

    mesh = current_mesh()

    # repeat-call fast path: the same root OBJECT re-executed (a steady
    # serving loop) skips the traceable walk, leaf collection, and program
    # key build — mirrors _em_fastpath; keyed on identity with a strong
    # root ref so the id stays valid; donation always misses (a donating
    # call consumes its own buffers)
    fp_key = (
        id(root),
        _mesh_key(mesh),
        _trace_config_key(),
    )
    hit = _ex_fastpath.get(fp_key)
    if (
        hit is not None
        and mode is None
        and not config.get("tpu.donate-leaves", False)
        and config.get("tpu.jit", True)
        and config.get("tpu.execution-lane", "auto") in ("auto", "gspmd")
    ):
        leaf_pairs_c, compiled = hit
        args = _device_put_leaves(leaf_pairs_c, mesh, donate=False)
        try:
            result = compiled(*args)
            return BlockView(root.chunks, dense=result) if want_view else result
        except TypeError as te:
            if "compiled with" not in str(te) and "Computation compiled for" not in str(te):
                raise
            # host loaders produced different shapes than the cached
            # program: drop the memo and take the slow path (which retraces
            # and surfaces contract errors as _build's ValueError)
            _ex_fastpath.pop(fp_key, None)

    lane = config.get("tpu.execution-lane", "auto")
    if (
        mesh is not None
        and lane in ("auto", "shard-map")
        and (lane == "shard-map" or (mode is None and config.get("tpu.jit", True)))
    ):
        # per-block shard_map lane: irregular grids are first-class on the
        # mesh — blocks stacked and sharded whole, no pad-to-regular GSPMD
        # constraints (parallel/shardlane.py).  Under "auto" it engages by
        # itself for matching IRREGULAR-grid programs (lane="gspmd" turns
        # it off entirely); "shard-map" forces it wherever the plan
        # matches.  Auto engagement degrades on ANY lane failure — a
        # program that executed before the promotion must keep executing.
        from dask_array_tpu.parallel.shardlane import try_execute_shard

        try:
            res = try_execute_shard(root, mesh, auto=(lane == "auto"))
        except Exception:
            if lane == "shard-map":
                raise
            res = None
        if res is not None:
            return BlockView(root.chunks, dense=res) if want_view else res

    traceable = root.known_chunks and all(node_traceable(node) for node in root.walk())
    if mode is None:
        mode = "trace" if (config.get("tpu.jit", True) and traceable) else "eager"

    leaf_pairs = collect_leaves(root)
    keys = tuple(k for k, _ in leaf_pairs)
    donate = config.get("tpu.donate-leaves", False)

    if mode == "trace" and _program_key(root, keys, mesh, donate) in _eager_keys:
        mode = "eager"  # known-untraceable: skip the wasted device_put pass

    if mode == "trace":
        args = _device_put_leaves(leaf_pairs, mesh, donate=donate)
        try:
            compiled, cache_key = _trace_fn(root, keys, mesh, args)
            if compiled is not None:
                try:
                    result = compiled(*args)
                except TypeError as te:
                    if "compiled with" not in str(te) and "Computation compiled for" not in str(te):
                        raise
                    # structural-cache hit with different LEAF avals (host
                    # loaders produced other shapes than the cached program):
                    # drop the entry and retrace, so shape-contract errors
                    # surface as _build's ValueError, not a jax TypeError
                    _fn_cache.pop(cache_key, None)
                    compiled, cache_key = _trace_fn(root, keys, mesh, args)
                    result = compiled(*args)
                if not donate and config.get("tpu.jit", True) and fp_key not in _ex_fastpath:
                    # entry dies with the root object (weakref finalize), so
                    # a recycled id can never hit a stale entry and the memo
                    # never pins leaf buffers beyond the root's own lifetime
                    import weakref

                    try:
                        weakref.finalize(root, _ex_fastpath.pop, fp_key, None)
                        while len(_ex_fastpath) >= 64:
                            _ex_fastpath.pop(next(iter(_ex_fastpath)))
                        _ex_fastpath[fp_key] = (leaf_pairs, compiled)
                    except TypeError:
                        pass  # non-weakref-able expr: skip the memo
                if want_view:
                    return BlockView(root.chunks, dense=result)
                return result
            # cache_key previously proved untraceable: straight to eager
        except Exception as e:
            # untraceable user code (host numpy functions, data-dependent
            # python control flow) surfaces as jax tracer errors on the
            # FIRST compile of this program; degrade to eager, never fail
            # (the reference's fallback-ladder discipline)
            if not _is_trace_error(e):
                raise
            if len(_eager_keys) > 4096:
                _eager_keys.clear()  # bounded memo; re-proving is cheap
            _eager_keys.add(_program_key(root, keys, mesh, donate))
            import warnings

            warnings.warn(
                f"computation is not jax-traceable ({type(e).__name__}); "
                "falling back to eager per-value execution — wrap host code "
                "in jax ops for the compiled fast path",
                RuntimeWarning,
                stacklevel=2,
            )
    # eager: concrete evaluation (handles unknown chunks / untraceable funcs).
    # Mesh-aware: leaves are device_put with mesh shardings, and per-op
    # dispatch follows input shardings, so even unknown-chunk pipelines
    # compute sharded where their leaves could be sharded.
    import jax.numpy as jnp

    if mesh is not None:
        args = _device_put_leaves(leaf_pairs, mesh)
        vals = dict(zip(keys, args))
    else:
        vals = {}
        for k, b in leaf_pairs:
            b = _materialize_buf(b)
            if _is_host_only(b):
                # structured/masked/duck: stays host (np.asarray on a
                # masked array would drop the mask; on a registered duck
                # block, its type)
                from dask_array_tpu._dispatch import is_duck_chunk

                keep = isinstance(b, np.ndarray) or is_duck_chunk(b)
                vals[k] = b if keep else np.asarray(b)
            elif not hasattr(b, "dtype") or isinstance(b, np.ndarray):
                vals[k] = jnp.asarray(np.asarray(b))
            else:
                vals[k] = b
    ctx = BuildContext(vals, mode="eager", mesh=mesh)
    view = ctx.build(root)
    return view if want_view else view.dense()
