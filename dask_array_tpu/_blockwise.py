"""Blockwise / Elemwise expressions and blockwise fusion.

Parity: the roles of ``Blockwise``/``Elemwise``/``FusedBlockwise`` and
``optimize_blockwise_fusion_array`` in
``/root/reference/dask_array/_blockwise.py`` (fresh implementation).

XLA-first execution: an Elemwise (and any dense-safe Blockwise) builds on
the *dense* traced array — broadcasting, fusion into neighboring matmuls,
and sharding propagation are all delegated to XLA, which does this better
than any hand-rolled per-block task fusion.  General blockwise ops (user
functions, ``map_blocks``) build per block inside the same trace, so the
per-block contract (each call sees exactly one block) is preserved while
XLA still compiles the whole pipeline as one program.
"""

from __future__ import annotations

import functools
import itertools
import math
import numbers
from collections.abc import Iterable

import numpy as np

from dask_array_tpu import config
from dask_array_tpu._chunks import (
    common_blockdim,
    has_unknown_chunks,
    parse_bytes,
    unify_blockdims,
)


def _unify_index_chunks(array_args):
    """Per index label, pick the common chunking across operands under the
    configured unification policy (parity: ``unify_chunks_expr``,
    ``/root/reference/dask_array/_expr.py:723``)."""
    import math

    by_label: dict = {}
    for arr, ind in array_args:
        nb = arr.nbytes
        for pos, label in enumerate(ind):
            c = arr.chunks[pos]
            # broadcast dims (total size 0/1) defer to the real dims
            if len(c) == 1 and sum(c) in (0, 1):
                by_label.setdefault(label, []).append((c, 0.0, True))
            else:
                by_label.setdefault(label, []).append((c, nb, False))
    policy = config.get("array.unify-chunks-policy", "auto")
    limit = parse_bytes(config.get("array.unify-chunks-limit", "512 MiB"))
    out = {}
    for label, cands in by_label.items():
        real = [(c, nb) for c, nb, is_bcast in cands if not is_bcast]
        # numpy broadcasting contract: every non-broadcast operand sharing a
        # label must agree on its total size (unknown/nan sizes are checked
        # at compute time instead)
        totals = {
            int(sum(c)) for c, _ in real if not math.isnan(sum(c))
        }
        if len(totals) > 1:
            raise ValueError(
                "operands could not be broadcast together: axis sizes "
                f"{sorted(totals)} differ along one dimension"
            )
        if not real:
            out[label] = cands[0][0]
            continue
        if len({c for c, _ in real}) == 1:
            out[label] = real[0][0]
            continue
        # bytes per unit length along this axis, for the size-limit check
        lengths = [sum(c) for c, _ in real if not math.isnan(sum(c))]
        sizes = [nb for _, nb in real if not (isinstance(nb, float) and math.isnan(nb))]
        row_bytes = (max(sizes) / max(1, max(lengths))) if (sizes and lengths) else 1.0
        out[label] = unify_blockdims(real, policy=policy, limit_bytes=limit, row_bytes=row_bytes)
    return out
from dask_array_tpu._executor import BlockView, iter_block_indices
from dask_array_tpu._expr import ArrayExpr, compute_meta, meta_from_array
from dask_array_tpu.utils._tokenize import tokenize

_NHEAD = 8  # number of fixed leading operands before the (arg, ind) pairs


def _check_broadcastable(exprs):
    """Raise (numpy-style) if operand shapes cannot broadcast.

    Reads only operand shapes — already computed on the children — so the
    freshly built node's own chunk metadata stays untouched."""
    import math as _math

    shapes = [e.shape for e in exprs if isinstance(e, ArrayExpr)]
    if len(shapes) < 2:
        return
    ndim = max(len(s) for s in shapes)
    for ax in range(1, ndim + 1):
        sizes = set()
        for s in shapes:
            if ax <= len(s):
                d = s[-ax]
                if isinstance(d, float) and _math.isnan(d):
                    continue
                if d != 1:
                    sizes.add(d)
        if len(sizes) > 1:
            raise ValueError(
                "operands could not be broadcast together with shapes "
                + " ".join(str(tuple(s)) for s in shapes)
            )


def _shim_host_operand(a):
    """Convert host datetime64/timedelta64 operands to their int64 tick view
    (datetime shim): jax cannot promote M8/m8 values."""
    if isinstance(a, np.ndarray) and a.dtype.kind in "Mm":
        return a.view("i8")
    if isinstance(a, (np.datetime64, np.timedelta64)):
        return a.view("i8")
    return a


def _contains_masked(args) -> bool:
    for a in args:
        if isinstance(a, np.ma.MaskedArray):
            return True
        if isinstance(a, (list, tuple)) and _contains_masked(a):
            return True
    return False


def _to_host(a):
    """Pull device operands to host numpy for a masked-block call (numpy
    ufunc dispatch on a MaskedArray + jax.Array pair would defer to jax and
    strip the mask)."""
    if isinstance(a, (list, tuple)):
        return type(a)(_to_host(v) for v in a)
    if hasattr(a, "devices"):  # jax.Array
        return np.asarray(a)
    return a


def masked_host_kernel(fn):
    """The numpy(.ma) counterpart of a traced kernel, for masked host blocks.

    jnp kernels silently DROP the mask (tracing coerces np.ma to a plain
    array); numpy ufuncs dispatch through ``MaskedArray.__array_ufunc__``
    and preserve it (including domain masking, e.g. sqrt of negatives), and
    ``np.ma`` holds masked versions of the non-ufunc names (``where``,
    ``concatenate``, ...).  Non-jax callables (operator.*, user map_blocks
    kernels, ``_astype``) pass through untouched — per-block numpy execution
    is the reference's entire masked-array story
    (``/root/reference/dask_array/_dispatch.py:36``).  Returns ``None`` when
    no mask-safe counterpart exists, so callers raise loudly instead of
    miscomputing.
    """
    mod = getattr(fn, "__module__", "") or ""
    if not mod.startswith("jax"):
        return fn
    name = getattr(fn, "__name__", "")
    np_fn = getattr(np, name, None)
    if isinstance(np_fn, np.ufunc):
        return np_fn
    ma_fn = getattr(np.ma, name, None)
    return ma_fn if ma_fn is not None else np_fn


def _contains_duck(args) -> bool:
    from dask_array_tpu._dispatch import is_duck_chunk

    for a in args:
        if is_duck_chunk(a):
            return True
        if isinstance(a, (list, tuple)) and _contains_duck(a):
            return True
    return False


def duck_host_kernel(fn):
    """The numpy-API counterpart of a traced kernel, for duck host blocks.

    jnp kernels coerce operands with ``np.asarray`` (dropping the duck
    type); the numpy function of the same name dispatches through the
    registered type's ``__array_ufunc__``/``__array_function__`` (NEP-13/
    NEP-18) and preserves it.  Kernels without a numpy counterpart keep the
    jnp implementation — correct values, possibly a plain-array block
    (documented divergence; the masked lane raises instead because a
    dropped MASK silently changes VALUES, a dropped wrapper does not)."""
    mod = getattr(fn, "__module__", "") or ""
    if not mod.startswith("jax"):
        return fn
    np_fn = getattr(np, getattr(fn, "__name__", ""), None)
    return np_fn if np_fn is not None else fn


class Blockwise(ArrayExpr):
    """Apply ``func`` block-wise following an index pattern.

    operands = [func, out_ind, token, dtype, adjust_chunks, new_axes,
                concatenate, kwargs, arg0, ind0, arg1, ind1, ...]

    ``out_ind``/``indN`` are tuples of hashable index labels; an index that
    appears in an argument but not in ``out_ind`` is concatenated away
    (``concatenate=True``) before the call, matching dask.array semantics.
    """

    _parameters = (
        "func",
        "out_ind",
        "token",
        "_dtype",
        "adjust_chunks",
        "new_axes",
        "concatenate",
        "kwargs",
    )
    _defaults = {
        "token": None,
        "_dtype": None,
        "adjust_chunks": None,
        "new_axes": None,
        "concatenate": True,
        "kwargs": (),
    }

    # general blockwise must run per block (the func sees exactly one block)
    _dense_safe = False
    _fusable = True

    def _name_prefix(self):
        tok = self.operand("token")
        return tok if tok else type(self).__name__.lower()

    # -- operand views -------------------------------------------------------

    @property
    def arg_pairs(self):
        ops = self.operands[_NHEAD:]
        return [(ops[i], ops[i + 1]) for i in range(0, len(ops), 2)]

    @property
    def array_args(self):
        return [(a, i) for a, i in self.arg_pairs if i is not None and isinstance(a, ArrayExpr)]

    @property
    def _kwargs_dict(self):
        return dict(self.kwargs or ())

    # -- metadata -------------------------------------------------------------

    @functools.cached_property
    def _index_chunks(self):
        """Map index label -> unified chunks along that label (cost-aware)."""
        out = _unify_index_chunks(self.array_args)
        new_axes = dict(self.new_axes or ())
        for label, size in new_axes.items():
            out[label] = size if isinstance(size, tuple) else (size,)
        return out

    @functools.cached_property
    def chunks(self):
        adjust = dict(self.adjust_chunks or ())
        chunks = []
        for label in self.out_ind:
            c = self._index_chunks[label]
            if label in adjust:
                adj = adjust[label]
                if callable(adj):
                    c = tuple(adj(x) for x in c)
                elif isinstance(adj, numbers.Number):
                    c = (int(adj),) * len(c)
                elif isinstance(adj, (tuple, list)):
                    c = tuple(adj)
                else:
                    raise NotImplementedError(f"adjust_chunks values must be callable, int, or tuple, got {adj!r}")
            chunks.append(tuple(c))
        return tuple(chunks)

    @property
    def ndim(self):
        # derivable from the index pattern: metadata access (ndim/dtype)
        # must not force chunk computation (reference
        # tests/test_lazy_metadata.py::test_ndim_does_not_compute_chunks)
        return len(self.out_ind)

    @functools.cached_property
    def _meta(self):
        dtype = self.operand("_dtype")
        if dtype is not None:
            return np.empty((0,) * len(self.out_ind), dtype=np.dtype(dtype))
        args = [a for a, _ in self.arg_pairs]
        meta = compute_meta(self.func, len(self.out_ind), *args, **self._kwargs_dict)
        if meta is None:
            raise ValueError(
                f"could not infer dtype of {self!r}; pass dtype= explicitly"
            )
        return meta

    # -- lowering: operand alignment -------------------------------------------

    def _lower(self):
        from dask_array_tpu._rechunk import Rechunk

        new_ops = list(self.operands[:_NHEAD])
        changed = False
        for arr, ind in self.arg_pairs:
            if ind is not None and isinstance(arr, ArrayExpr):
                want = tuple(
                    self._index_chunks[label]
                    if not (len(arr.chunks[pos]) == 1 and sum(arr.chunks[pos]) in (0, 1))
                    else arr.chunks[pos]
                    for pos, label in enumerate(ind)
                )
                if want != arr.chunks and not has_unknown_chunks(arr.chunks):
                    arr = Rechunk(arr, want)
                    changed = True
            new_ops.extend([arr, ind])
        if changed:
            return type(self)(*new_ops)
        return None

    # -- execution ---------------------------------------------------------------

    # Slice pushdown for generic blockwise (map_blocks-style funcs):
    #   exact  — block-boundary-aligned slices on untransformed labels push
    #            verbatim into the inputs (the block contents the func sees
    #            are unchanged);
    #   coarse — any other unit-step range culls WHOLE blocks: inputs take a
    #            block-aligned cut, a residual slice trims the kept extent
    #            outside.  This is safe even under ``adjust_chunks`` because
    #            block i of the output always comes from block i of each
    #            input along that label.
    # (parity: fine + coarse ``_accept_slice`` at reference
    # ``_blockwise.py:568,684`` and ``test_coarse_slice_through_blockwise``)
    def _accept_slice(self, index):
        from dask_array_tpu._chunks import cached_cumsum
        from dask_array_tpu._slicing import Slice, is_basic_index

        if not is_basic_index(index) or any(isinstance(i, numbers.Integral) for i in index):
            return None
        adjust = dict(self.adjust_chunks or ())
        new_axes = dict(self.new_axes or ())
        exact: dict = {}  # label -> out slice pushed verbatim
        coarse: dict = {}  # label -> (block-aligned input slice, b0, b1)
        residual = [slice(None)] * len(index)
        culled = False
        for pos, ind in enumerate(index):
            if ind == slice(None):
                continue
            if ind.step not in (1, None):
                return None
            label = self.out_ind[pos]
            out_c = self.chunks[pos]
            if any(isinstance(c, float) and math.isnan(c) for c in out_c):
                return None
            bounds = cached_cumsum(out_c, initial_zero=True)
            total = int(bounds[-1])
            start = 0 if ind.start is None else int(ind.start)
            stop = total if ind.stop is None else min(int(ind.stop), total)
            if stop <= start:
                residual[pos] = ind  # empty selection: nothing to cull
                continue
            if label not in adjust and label not in new_axes and start in bounds and stop in bounds:
                exact[label] = ind
                continue
            if label in new_axes:
                residual[pos] = ind  # no input carries this axis
                continue
            b0 = int(np.searchsorted(bounds, start, side="right")) - 1
            b1 = int(np.searchsorted(bounds, stop, side="left"))
            if b0 <= 0 and b1 >= len(out_c):
                residual[pos] = ind  # every block still needed
                continue
            in_c = self._index_chunks[label]
            if any(isinstance(c, float) and math.isnan(c) for c in in_c):
                residual[pos] = ind
                continue
            in_bounds = cached_cumsum(in_c, initial_zero=True)
            coarse[label] = (slice(int(in_bounds[b0]), int(in_bounds[b1]), 1), b0, b1)
            if start == int(bounds[b0]) and stop == int(bounds[b1]):
                residual[pos] = slice(None)
            else:
                residual[pos] = slice(start - int(bounds[b0]), stop - int(bounds[b0]), 1)
            culled = True
        if not exact and not culled:
            return None
        # per-block (tuple) adjust_chunks entries narrow to the kept blocks
        new_adjust = self.operand("adjust_chunks")
        if any(
            label in coarse and isinstance(val, (tuple, list))
            for label, val in adjust.items()
        ):
            new_adjust = tuple(
                (
                    label,
                    tuple(val[coarse[label][1] : coarse[label][2]])
                    if label in coarse and isinstance(val, (tuple, list))
                    else val,
                )
                for label, val in adjust.items()
            )
        new_ops = list(self.operands[:_NHEAD])
        new_ops[4] = new_adjust
        for arr, a_ind in self.arg_pairs:
            if a_ind is not None and isinstance(arr, ArrayExpr):
                sub = []
                for pos, lbl in enumerate(a_ind):
                    # broadcast dims (size 0/1) keep broadcasting after the cut
                    if len(arr.chunks[pos]) == 1 and sum(arr.chunks[pos]) in (0, 1):
                        sub.append(slice(None))
                    elif lbl in exact:
                        sub.append(exact[lbl])
                    elif lbl in coarse:
                        sub.append(coarse[lbl][0])
                    else:
                        sub.append(slice(None))
                if any(s != slice(None) for s in sub):
                    arr = Slice(arr, tuple(sub))
            new_ops.extend([arr, a_ind])
        out = type(self)(*new_ops)
        if any(r != slice(None) for r in residual):
            out = Slice(out, tuple(residual))
        return out

    # reorder (Shuffle/Take) pushdown for GENERIC blockwise (map_blocks):
    # label-mapped, declining when adjust_chunks/new_axes touch the axis
    # (parity: reference test_shuffle_pushes_through_blockwise /
    # test_shuffle_does_not_push_through_blockwise_adjust_chunks)
    def _accept_shuffle(self, shuffle_expr):
        axis = shuffle_expr.axis
        label = self.out_ind[axis]
        adjust = dict(self.adjust_chunks or ())
        new_axes = dict(self.new_axes or ())
        if label in adjust or label in new_axes:
            return None  # per-block sizes transformed on this axis: unsafe
        new_ops = list(self.operands[:_NHEAD])
        changed = False
        for arr, a_ind in self.arg_pairs:
            if a_ind is not None and isinstance(arr, ArrayExpr) and label in a_ind:
                pos = a_ind.index(label)
                if not (len(arr.chunks[pos]) == 1 and sum(arr.chunks[pos]) in (0, 1)):
                    arr = shuffle_expr._rebase(arr, pos)
                    changed = True
            new_ops.extend([arr, a_ind])
        if not changed:
            return None
        return type(self)(*new_ops)

    def _arg_block(self, ctx, arr_view, ind, out_coord, coord_of):
        """Fetch (and contract-concatenate) one argument's block."""
        import jax.numpy as jnp

        nb = arr_view.numblocks
        coords_per_pos = []
        for pos, label in enumerate(ind):
            if label in coord_of:
                c = coord_of[label]
                if nb[pos] == 1:
                    c = 0
                coords_per_pos.append((c,))
            else:
                # contracted index: all blocks along this axis
                coords_per_pos.append(tuple(range(nb[pos])))
        contracted = {pos for pos, label in enumerate(ind) if label not in coord_of}
        if not self.concatenate and contracted:
            # dask semantics (reference blockwise concatenate=False): the
            # function receives nested LISTS of blocks over contracted dims
            # (outermost list = first contracted position), even singletons
            def rec_list(pos, prefix):
                if pos == len(coords_per_pos):
                    return arr_view.block(prefix)
                if pos in contracted:
                    return [rec_list(pos + 1, prefix + (c,)) for c in coords_per_pos[pos]]
                return rec_list(pos + 1, prefix + (coords_per_pos[pos][0],))

            return rec_list(0, ())
        if all(len(c) == 1 for c in coords_per_pos):
            return arr_view.block(tuple(c[0] for c in coords_per_pos))

        # concatenate contracted axes (innermost first)
        def rec(pos, prefix):
            if pos == len(coords_per_pos):
                return arr_view.block(prefix)
            parts = [rec(pos + 1, prefix + (c,)) for c in coords_per_pos[pos]]
            if len(parts) == 1:
                return parts[0]
            if isinstance(parts[0], np.ma.MaskedArray):
                return np.ma.concatenate(parts, axis=pos)
            from dask_array_tpu._dispatch import is_duck_chunk

            if is_duck_chunk(parts[0]):
                # duck host lane: np.concatenate dispatches NEP-18
                return np.concatenate(parts, axis=pos)
            return jnp.concatenate(parts, axis=pos)

        return rec(0, ())

    def _build(self, ctx):
        views = {}
        for arr, ind in self.array_args:
            views[arr._name] = ctx.build(arr)
        kwargs = self._kwargs_dict
        new_axes = dict(self.new_axes or ())
        blocks = {}
        for out_coord in iter_block_indices(self.numblocks):
            coord_of = {
                label: out_coord[i]
                for i, label in enumerate(self.out_ind)
                if label not in new_axes
            }
            args = []
            for arr, ind in self.arg_pairs:
                if ind is None or not isinstance(arr, ArrayExpr):
                    args.append(_shim_host_operand(arr))
                else:
                    args.append(self._arg_block(ctx, views[arr._name], ind, out_coord, coord_of))
            out = self._call(args, kwargs, out_coord)
            if hasattr(out, "dtype") and hasattr(out, "astype"):
                try:
                    want = self.dtype
                except Exception:
                    want = None
                if want is not None and out.dtype != want:
                    from dask_array_tpu._chunks import device_dtype

                    want = device_dtype(want)
                    if out.dtype != want:
                        out = out.astype(want)
            blocks[tuple(out_coord)] = out
        return BlockView(self.chunks, blocks=blocks)

    def _call(self, args, kwargs, out_coord):
        if _contains_masked(args):
            fn = masked_host_kernel(self.func)
            if fn is None:
                raise NotImplementedError(
                    f"{getattr(self.func, '__name__', self.func)!r} has no "
                    "mask-preserving host kernel; call x.filled(...) first"
                )
            with np.errstate(all="ignore"):
                return fn(*_to_host(args), **kwargs)
        if _contains_duck(args):
            # duck host lane: numpy-API kernels dispatch through the
            # registered type's __array_ufunc__/__array_function__ so the
            # block type survives (register_chunk_type)
            fn = duck_host_kernel(self.func)
            with np.errstate(all="ignore"):
                return fn(*_to_host(args), **kwargs)
        return self.func(*args, **kwargs)


class Elemwise(Blockwise):
    """Broadcasting element-wise application (dense fast path).

    Parity: ``Elemwise`` in ``/root/reference/dask_array/_blockwise.py:837``.
    """

    _parameters = ("func", "kwargs")
    _defaults = {"kwargs": ()}
    _dense_safe = True

    # remaining operands (2:) are the raw args (exprs or scalars)

    @property
    def args(self):
        return self.operands[2:]

    # array_args is inherited from Blockwise (it derives from arg_pairs)

    @property
    def arg_pairs(self):
        out_ind = self.out_ind
        res = []
        for a in self.args:
            if isinstance(a, ArrayExpr):
                res.append((a, tuple(out_ind[len(out_ind) - a.ndim:])))
            else:
                res.append((a, None))
        return res

    @functools.cached_property
    def out_ind(self):
        nd = max((a.ndim for a in self.args if isinstance(a, ArrayExpr)), default=0)
        return tuple(range(nd))

    @property
    def out_ndim(self):
        return len(self.out_ind)

    @property
    def adjust_chunks(self):
        return None

    @property
    def new_axes(self):
        return None

    @property
    def concatenate(self):
        return True

    @property
    def token(self):
        return None

    def _name_prefix(self):
        name = getattr(self.func, "__name__", None)
        return name if name else "elemwise"

    def _accept_transpose(self, axes):
        """transpose(elemwise(f, a, b)) == elemwise(f, transpose(a),
        transpose(b)) when no operand broadcasts (reference
        test_transpose_slice_pushdown.py spine: broadcasting declines —
        permuting a broadcast dim changes which axis each operand fills)."""
        from dask_array_tpu.ops.manipulation import make_transpose

        nd = self.out_ndim
        out_shape = self.shape
        new_args = []
        for a in self.args:
            if isinstance(a, ArrayExpr):
                if a.ndim != nd or tuple(a.shape) != tuple(out_shape):
                    return None
                new_args.append(make_transpose(a, axes))
            else:
                new_args.append(a)
        return Elemwise(self.operand("func"), self.operand("kwargs"), *new_args)

    @functools.cached_property
    def _meta(self):
        meta = compute_meta(self.func, self.out_ndim, *self.args, **self._kwargs_dict)
        if meta is None:
            raise ValueError(f"could not infer dtype for {self!r}")
        return meta

    @functools.cached_property
    def _index_chunks(self):
        return _unify_index_chunks(self.array_args)

    def _lower(self):
        from dask_array_tpu._rechunk import Rechunk

        new_args = []
        changed = False
        out_ind = self.out_ind
        for a in self.args:
            if isinstance(a, ArrayExpr) and not has_unknown_chunks(a.chunks):
                ind = tuple(out_ind[len(out_ind) - a.ndim:])
                want = tuple(
                    self._index_chunks[label]
                    if not (len(a.chunks[pos]) == 1 and sum(a.chunks[pos]) in (0, 1))
                    else a.chunks[pos]
                    for pos, label in enumerate(ind)
                )
                if want != a.chunks:
                    a = Rechunk(a, want)
                    changed = True
            new_args.append(a)
        if changed:
            return type(self)(*self.operands[:2], *new_args)
        return None

    def _build(self, ctx):
        # dense path: XLA broadcasts and fuses
        if not has_unknown_chunks(self.chunks):
            args = [
                ctx.build(a).dense() if isinstance(a, ArrayExpr) else _shim_host_operand(a)
                for a in self.args
            ]
            dense = self._call(args, self._kwargs_dict, None)
            # numpy dtype-rule parity: jax may promote differently (e.g.
            # int32+float32); the declared meta dtype wins
            if hasattr(dense, "dtype") and dense.dtype != self.dtype:
                from dask_array_tpu._chunks import device_dtype

                want = device_dtype(self.dtype)
                if dense.dtype != want:
                    dense = dense.astype(want)
            return BlockView(self.chunks, dense=dense)
        return super()._build(ctx)

    # slice pushdown: x[idx] == op(a, b)[idx] == op(a[idx'], b[idx'])
    def _accept_slice(self, index):
        from dask_array_tpu._slicing import Slice, slice_for_ndim

        out_ind = self.out_ind
        out_shape = self.shape
        new_args = []
        for a in self.args:
            if isinstance(a, ArrayExpr):
                sub = slice_for_ndim(index, self.out_ndim, a.ndim, a.shape, out_shape)
                if sub is None:
                    return None
                a = Slice(a, sub) if sub else a
            new_args.append(a)
        return type(self)(*self.operands[:2], *new_args)

    # reorder pushdown: reorder(op(a, b)) == op(reorder(a), reorder(b));
    # serves BOTH Shuffle and Take parents via their shared ._rebase
    # (parity: Elemwise._accept_shuffle, _blockwise.py:1169)
    def _accept_shuffle(self, shuffle_expr):
        axis = shuffle_expr.axis
        out_ind = self.out_ind
        new_args = []
        changed = False
        for a in self.args:
            if isinstance(a, ArrayExpr):
                pos = axis - (len(out_ind) - a.ndim)
                if pos < 0:
                    pass  # broadcast: the axis doesn't exist on this operand
                elif len(a.chunks[pos]) == 1 and sum(a.chunks[pos]) in (0, 1):
                    pass  # size-1 broadcast dim: values repeat either way
                else:
                    a = shuffle_expr._rebase(a, pos)
                    changed = True
            new_args.append(a)
        if not changed:
            # EVERY operand is broadcast along the reordered axis: pushing
            # would erase the reorder's output length (an indexer can grow
            # a size-1 axis); leave it above
            return None
        return type(self)(*self.operands[:2], *new_args)

    # rechunk pushdown: rechunk(op(a, b)) == op(rechunk(a), rechunk(b))
    def _accept_rechunk(self, target_chunks):
        from dask_array_tpu._rechunk import Rechunk

        out_ind = self.out_ind
        new_args = []
        for a in self.args:
            if isinstance(a, ArrayExpr):
                sub = tuple(
                    a.chunks[pos]
                    if len(a.chunks[pos]) == 1 and sum(a.chunks[pos]) in (0, 1)
                    else target_chunks[len(out_ind) - a.ndim + pos]
                    for pos in range(a.ndim)
                )
                if has_unknown_chunks(a.chunks):
                    return None
                if sub != a.chunks:
                    a = Rechunk(a, sub)
            new_args.append(a)
        return type(self)(*self.operands[:2], *new_args)


class FusedBlockwise(ArrayExpr):
    """Display/bookkeeping wrapper around a group of fused blockwise nodes.

    In the reference this emits one fused task per block
    (``_blockwise.py:1574``); here the grouped subtree is already traced into
    one XLA program, so the wrapper only marks the fusion boundary for
    ``explain``/``pprint`` and per-group ``shard_map`` execution.
    """

    _parameters = ("root", "n_fused")
    _defaults = {"n_fused": 1}

    @property
    def _meta(self):
        return self.root._meta

    @property
    def chunks(self):
        return self.root.chunks

    def _pprint_line(self):
        return f"FusedBlockwise[{self.n_fused}]"

    def tree_repr(self, indent=0, seen=None):
        seen = seen if seen is not None else set()
        header = " " * indent + self._pprint_line() + "\n"
        seen.add(self._name)
        out = [header]
        # show the fused subtree indented one extra level, then externals
        out.append(self.root.tree_repr(indent + 2, seen))
        return "".join(out)

    def _build(self, ctx):
        return ctx.build(self.root)


def is_fusable(expr) -> bool:
    return isinstance(expr, Blockwise) and expr._fusable or getattr(expr, "_fusable_leaf", False)


def optimize_blockwise_fusion(root: ArrayExpr) -> ArrayExpr:
    """Wrap maximal fusable blockwise groups in FusedBlockwise markers.

    A group is a connected set of fusable nodes whose interior members have
    no dependents outside the group.  Parity with the grouping pass at
    ``/root/reference/dask_array/_blockwise.py:1405`` (conflict analysis is
    unnecessary here: the executor's BlockView gives every fused node access
    to any input block, so cross-block patterns like ``a + a.T`` are safe).
    """
    from dask_array_tpu._expr import collect_dependents

    dependents = collect_dependents(root)

    # Precompute, once per node, everything fuses_into_parent consults:
    # whether it can absorb children (fusable Blockwise), its arg-name set,
    # and its numblocks.  The naive form rebuilt the parent's arg-name set
    # on EVERY edge probe, which dominated optimizer wall time on wide DAGs
    # (bench/bench_optimize.py wide_tree row).
    nodes = list(root.walk())
    absorbers: dict = {}  # name -> (arg_name_set, numblocks)
    for n in nodes:
        if isinstance(n, Blockwise) and n._fusable:
            absorbers[n._name] = (
                frozenset(a._name for a, _ in n.array_args),
                n.numblocks,
            )

    def fuses_into_parent(node, parent):
        info = absorbers.get(parent._name)
        return (
            info is not None
            and node._name in info[0]
            and node.numblocks == info[1]
        )

    groups = []  # (root_node, member_names)
    for node in nodes:
        if not (isinstance(node, Blockwise) and node._fusable):
            continue
        deps = dependents.get(node._name, ())
        if any(fuses_into_parent(node, p) for p in deps):
            continue  # not a root; belongs to a parent's group
        if any(isinstance(p, FusedBlockwise) for p in deps):
            continue  # already wrapped: optimize() must be idempotent
        # collect members downward
        members = set()
        stack = [node]
        while stack:
            n = stack.pop()
            if n._name in members:
                continue
            members.add(n._name)
            if not isinstance(n, Blockwise):
                continue
            for child, _ in n.array_args:
                if not is_fusable(child):
                    continue
                if not fuses_into_parent(child, n):
                    continue
                # interior nodes must not leak outside the group
                outside = [
                    d for d in dependents.get(child._name, ()) if d._name not in members and d is not n
                ]
                if any(not fuses_into_parent(child, d) for d in outside):
                    continue
                stack.append(child)
        if len(members) >= 1:
            groups.append((node, members))

    if not groups:
        return root
    mapping = {}
    for node, members in groups:
        n_inner = len(members)
        mapping[node._name] = FusedBlockwise(node, n_inner)
    memo: dict = {}
    out = root._substitute_many(mapping, memo)
    return out


# ---------------------------------------------------------------------------
# user-facing constructors
# ---------------------------------------------------------------------------


def _normalize_kwargs(kwargs: dict):
    return tuple(sorted(kwargs.items()))


def elemwise(op, *args, dtype=None, name=None, where=True, out=None, **kwargs):
    """Apply an elementwise function with numpy broadcasting across args."""
    from dask_array_tpu._collection import Array, new_collection

    if out is not None or where is not True:
        return _elemwise_where(op, args, where, out, dtype=dtype, **kwargs)

    def coerce(a):
        if isinstance(a, Array):
            return a.expr
        # n-d array-likes (jax arrays, duck arrays, nested lists) must become
        # leaves: left raw they'd be treated as scalars — out_ind/chunks would
        # ignore their shape and pushdown rewrites would never index them
        if isinstance(a, (list, tuple)) or (
            hasattr(a, "shape") and hasattr(a, "dtype") and getattr(a, "ndim", 0) > 0
        ):
            from dask_array_tpu.ops._from_array import asarray

            return asarray(a).expr
        return a

    exprs = [coerce(a) for a in args]
    expr = Elemwise(op, _normalize_kwargs(kwargs), *exprs)
    # validate broadcastability NOW (numpy raises at call time) — from the
    # operand SHAPES, which are already cached, so the new node's own
    # chunks/meta stay lazy (reference: tests/test_lazy_metadata.py)
    _check_broadcastable(exprs)
    if dtype is not None and np.dtype(dtype) != expr.dtype:
        from dask_array_tpu.ops._casting import astype_expr

        expr = astype_expr(expr, np.dtype(dtype))
    return new_collection(expr)


def _elemwise_where(op, args, where, out, dtype=None, **kwargs):
    import jax.numpy as jnp

    from dask_array_tpu._collection import Array, new_collection

    base = elemwise(op, *args, dtype=dtype, **kwargs)
    if where is True:
        result = base
    else:
        if out is None:
            raise ValueError("where= requires out=")
        result = elemwise(jnp.where, where, base, out)
    if out is not None:
        if not isinstance(out, Array):
            raise NotImplementedError("out= must be a dask_array_tpu Array")
        if np.dtype(result.dtype) != out.dtype:
            result = result.astype(out.dtype)
        out._replace_expr(result.expr)
        return out
    return result


def blockwise(
    func,
    out_ind,
    *args,
    name=None,
    token=None,
    dtype=None,
    adjust_chunks=None,
    new_axes=None,
    align_arrays=True,
    concatenate=None,
    meta=None,
    **kwargs,
):
    """General blockwise operation (dask.array.blockwise-compatible)."""
    from dask_array_tpu._collection import Array, new_collection

    out_ind = tuple(out_ind)
    pairs = []
    it = iter(args)
    for a in it:
        ind = next(it)
        if isinstance(a, Array):
            a = a.expr
        pairs.extend([a, tuple(ind) if ind is not None else None])
    if meta is not None and dtype is None:
        dtype = getattr(meta, "dtype", None)
    adjust = _normalize_kwargs(adjust_chunks) if isinstance(adjust_chunks, dict) else adjust_chunks
    naxes = _normalize_kwargs(new_axes) if isinstance(new_axes, dict) else new_axes
    expr = Blockwise(
        func,
        out_ind,
        token or name,
        np.dtype(dtype) if dtype is not None else None,
        adjust,
        naxes,
        # dask parity: concatenate=None (the default) passes contracted dims
        # as LISTS of blocks; pass True to concatenate them first
        bool(concatenate),
        _normalize_kwargs(kwargs),
        *pairs,
    )
    return new_collection(expr)
