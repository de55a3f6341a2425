"""Chunk-grid algebra: normalization, auto-chunking, unification helpers.

Chunks are a tuple (one entry per axis) of tuples of block sizes, e.g.
``((100, 100), (100, 100))`` for a (200, 200) array in 100x100 blocks.
Unknown block sizes are ``nan`` (produced by e.g. boolean indexing).

Reference parity: the behaviors of ``normalize_chunks``/``auto_chunks``/
``common_blockdim`` in ``/root/reference/dask_array/_core_utils.py:524-931``
(fresh implementation).

On the device the chunk grid is a *logical planning* structure: the executor maps
regular chunk grids onto ``jax.sharding`` partition specs and lets XLA place
blocks; irregular grids fall back to per-block dispatch.
"""

from __future__ import annotations

import functools
import math
import warnings
from numbers import Integral, Number

import numpy as np


class PerformanceWarning(Warning):
    """A warning given when bad chunking may cause poor performance."""


CHUNKS_NONE_ERROR_MESSAGE = """
You must specify a chunks= keyword argument.
This specifies the chunksize of your array blocks.

See the following documentation page for details:
  https://docs.dask.org/en/latest/array-creation.html#chunks
""".lstrip()


def parse_bytes(s) -> int:
    """Parse a byte string ('128 MiB', '1kB', 128) to an int number of bytes."""
    if isinstance(s, (int, float)):
        return int(s)
    s = s.replace(" ", "").lower()
    suffixes = {
        "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40,
        "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12,
        "b": 1,
    }
    for suf in sorted(suffixes, key=len, reverse=True):
        if s.endswith(suf):
            return int(float(s[: -len(suf)]) * suffixes[suf])
    return int(float(s))


def device_dtype(dt):
    """The dtype blocks carry ON DEVICE for a logical numpy dtype.

    jax has no datetime64/timedelta64; those ship as int64 tick views (the
    datetime shim — see _executor._materialize_buf / _materialize.compute_to_numpy).
    """
    dt = np.dtype(dt)
    return np.dtype("i8") if dt.kind in "Mm" else dt


def host_only_dtype(dt) -> bool:
    """True for dtypes with NO device representation (structured records,
    strings, objects, numpy-2 StringDType): their blocks stay host numpy
    and execute through the eager lane.

    ml_dtypes extension scalars (bfloat16, float8_*, int4, ...) report
    numpy kind 'V' exactly like structured dtypes but ARE first-class
    device dtypes — misclassifying them silently demotes every bf16
    computation to per-op eager dispatch (a ~1000x headline regression),
    so they are explicitly carved out here.
    """
    dt = np.dtype(dt)
    if dt.kind not in "VUSOT":
        return False
    return not (
        dt.kind == "V"
        and dt.names is None
        and getattr(dt.type, "__module__", "") == "ml_dtypes"
    )


def dtype_key(dt) -> str:
    """Canonical UNIQUE string for a dtype (token / plan-cache keys).

    ``dt.str`` is NOT unique: 14 ml_dtypes scalars (float8 variants, int4,
    float4/6, ...) all collapse to ``'<V1'``, float8_e5m2 reports a
    non-parseable ``'<f1'``, and none round-trip through ``np.dtype()`` —
    keying programs or tokens on it could alias arrays of DIFFERENT dtypes
    (wrong-dtype cache hits).  Registered ml_dtypes names are unique and
    round-trip; structured dtypes get their full field spec (``.str``
    would collapse equal-itemsize layouts)."""
    dt = np.dtype(dt)
    if dt.names is not None:
        return str(dt)
    s = dt.str
    try:
        if np.dtype(s) == dt:
            return s
    except TypeError:
        pass
    return dt.name


def is_float_dtype(dt) -> bool:
    """``np.issubdtype(dt, np.floating)`` extended to ml_dtypes floats
    (bfloat16, float8_*), which live OUTSIDE numpy's type hierarchy —
    a bare issubdtype check silently routes bf16 down integer/f64
    promotion paths."""
    dt = np.dtype(dt)
    if dt.kind == "f":
        return True
    if dt.kind == "V" and dt.names is None:
        import jax.numpy as jnp

        try:
            return jnp.issubdtype(dt, jnp.floating)
        except Exception:
            return False
    return False


def is_integer(x) -> bool:
    return isinstance(x, Integral) or (isinstance(x, float) and x.is_integer())


def blockdims_from_blockshape(shape, chunkshape):
    """Convert a block shape like (100, 100) into explicit per-axis blockdims."""
    if chunkshape is None:
        raise TypeError("Must supply chunks= keyword argument")
    if shape is None:
        raise TypeError("Must supply shape= keyword argument")
    if np.isnan(sum(shape)) or np.isnan(sum(chunkshape)):
        raise ValueError(f"Array chunk size or shape is unknown. shape: {shape}, chunks: {chunkshape}")
    if not all(map(is_integer, chunkshape)):
        raise ValueError(f"chunks can only contain integers. chunks: {chunkshape}")
    if not all(map(is_integer, shape)):
        raise ValueError(f"shape can only contain integers. shape: {shape}")
    shape = tuple(map(int, shape))
    chunkshape = tuple(map(int, chunkshape))
    return tuple(
        ((bd,) * (d // bd) + ((d % bd,) if d % bd else ()) if d else (0,))
        for d, bd in zip(shape, chunkshape)
    )


def normalize_chunks(chunks, shape=None, limit=None, dtype=None, previous_chunks=None):
    """Normalize a chunks argument to an explicit tuple-of-tuples form.

    Accepts ints, tuples of ints, tuples of tuples of ints, dicts mapping
    axis to chunk size, -1 / None ("one chunk along this axis"), and the
    string "auto" (size blocks toward ``limit`` bytes).
    """
    if dtype and not isinstance(dtype, np.dtype):
        dtype = np.dtype(dtype)
    if chunks is None:
        raise ValueError(CHUNKS_NONE_ERROR_MESSAGE)
    if isinstance(chunks, list):
        chunks = tuple(chunks)
    if isinstance(chunks, (Number, str)):
        chunks = (chunks,) * len(shape)
    if isinstance(chunks, dict):
        chunks = tuple(chunks.get(i, None) for i in range(len(shape)))
    if isinstance(chunks, np.ndarray):
        chunks = chunks.tolist()
    if not chunks and shape and all(s == 0 for s in shape):
        chunks = ((0,),) * len(shape)

    if shape and len(shape) == 1 and len(chunks) > 1 and all(isinstance(c, (Number, str)) for c in chunks):
        if any(isinstance(c, str) for c in chunks):
            raise ValueError(
                f"String values are not supported inside explicit chunk tuples. Got chunks={chunks}"
            )
        chunks = (chunks,)

    if shape and len(chunks) != len(shape):
        raise ValueError(
            "Chunks and shape must be of the same length/dimension. "
            f"Got chunks={chunks}, shape={shape}"
        )
    if -1 in chunks or None in chunks:
        chunks = tuple(s if c in (-1, None) else c for c, s in zip(chunks, shape))

    # byte-size strings ("128 MiB") set the auto limit for their axes
    # (reference `_core_utils.py:850-868`: one consistent value only)
    for c in chunks:
        if isinstance(c, str) and c != "auto":
            chunk_string = c.replace(" ", "")
            if not chunk_string or not chunk_string[-1].isalpha():
                raise ValueError(
                    "String chunk sizes must be 'auto' or byte sizes with a "
                    f"byte unit like 'B', 'MB', or 'MiB'. Got {c!r}"
                )
            parsed = parse_bytes(c)
            if parsed < 0:
                raise ValueError(f"String chunk byte sizes must not be negative. Got {c!r}")
            if limit is None:
                limit = parsed
            elif parsed != limit:
                raise ValueError(
                    f"Only one consistent value of limit or chunk is allowed. Used {parsed} != {limit}"
                )
    chunks = tuple("auto" if isinstance(c, str) and c != "auto" else c for c in chunks)

    # substitute auto-size along "auto" axes
    if any(c == "auto" for c in chunks):
        chunks = auto_chunks(chunks, shape, limit, dtype, previous_chunks)

    if shape is not None:
        chunks = tuple(c if c not in (None, -1) else s for c, s in zip(chunks, shape))

    # expand block shape -> blockdims entry by entry
    out = []
    for i, c in enumerate(chunks):
        if isinstance(c, (tuple, list)):
            for x in c:
                if not (isinstance(x, float) and math.isnan(x)) and int(x) != x:
                    raise ValueError(f"chunks can only contain integers, got {x!r}")
            out.append(tuple(int(x) if not math.isnan(x) else np.nan for x in c))
        elif isinstance(c, Number):
            if shape is None:
                raise ValueError("Must provide shape if chunks are given as block shape ints")
            s = shape[i]
            if isinstance(s, float) and math.isnan(s):
                out.append((np.nan,))
            else:
                if int(c) != c:
                    raise ValueError(f"chunks can only contain integers, got {c!r}")
                c = int(c)
                if c <= 0 and not (c == 0 and s == 0):
                    raise ValueError(f"Chunk sizes must be positive, got {c}")
                # a zero-size dimension is one empty block regardless of c
                out.append(blockdims_from_blockshape((s,), (max(c, 1),))[0])
        else:
            raise ValueError(f"Unrecognized chunk value {c!r}")
    out = tuple(out)

    if shape is not None:
        for i, (c, s) in enumerate(zip(out, shape)):
            csum = sum(c)
            if not (isinstance(s, float) and math.isnan(s)) and not math.isnan(csum) and csum != s:
                raise ValueError(
                    f"Chunks do not add up to shape. Got chunks={out}, shape={shape}"
                )
    return out


def _largest_block_sizes(previous_chunks):
    return tuple(max(c) if c else 0 for c in previous_chunks)


def auto_chunks(chunks, shape, limit, dtype, previous_chunks=None):
    """Resolve "auto" entries in a chunks specification.

    Sizes "auto" axes so that the resulting block byte-size approaches
    ``limit`` (default: config ``array.chunk-size``), respecting the fixed
    (non-auto) axes and preferring multiples of ``previous_chunks`` when
    given (so rechunks stay aligned).
    """
    from dask_array_tpu import config

    if limit is None:
        limit = config.get("array.chunk-size", "128 MiB")
    limit = parse_bytes(limit)
    if dtype is None:
        raise TypeError("dtype must be known for auto-chunking")
    if dtype.hasobject:
        raise NotImplementedError("object dtypes have no fixed itemsize; please provide explicit chunks")
    itemsize = dtype.itemsize

    autos = {i for i, c in enumerate(chunks) if isinstance(c, str) and c == "auto"}
    if not autos:
        return chunks

    fixed_size = 1
    for i, c in enumerate(chunks):
        if i in autos:
            continue
        if isinstance(c, (tuple, list)):
            fixed_size *= max(c) if c else 1
        elif c in (-1, None):
            fixed_size *= shape[i] if shape[i] else 1
        else:
            fixed_size *= c if c else 1

    avail = max(1, limit // (itemsize * max(1, fixed_size)))
    # target edge length per auto axis (even split of the byte budget)
    target = max(1, int(avail ** (1 / len(autos))))

    out = list(chunks)
    for i in sorted(autos):
        s = shape[i]
        if isinstance(s, float) and math.isnan(s):
            raise ValueError(
                "Can not perform automatic rechunking with unknown (nan) chunk sizes."
            )
        if previous_chunks:
            # snap to a multiple/divisor of the previous chunking for alignment
            prev = max(previous_chunks[i]) if previous_chunks[i] else 1
            if prev:
                if target >= prev:
                    size = max(prev, (target // prev) * prev)
                else:
                    # choose a divisor of prev close to target
                    div = max(1, round(prev / max(1, target)))
                    size = max(1, math.ceil(prev / div))
            else:
                size = target
        else:
            size = target
        out[i] = min(size, s) if s else 0
    return tuple(out)


def common_blockdim(blockdims):
    """Find the unified blockdim for one axis across several operands.

    Operands that agree trivially unify; a length-1 (unsplit) axis defers to
    the others; otherwise the result is the refinement: the common partition
    whose boundaries are the union of all operand boundaries.
    """
    if not any(blockdims):
        return ()
    non_trivial = {b for b in blockdims if len(b) > 1}
    if len(non_trivial) == 0:
        return max(blockdims, key=len)
    if len(non_trivial) == 1:
        (res,) = non_trivial
        return res
    if any(math.isnan(sum(b)) for b in non_trivial):
        vals = {tuple(b) for b in non_trivial}
        if len(vals) > 1:
            raise ValueError(
                "Arrays' chunk sizes are unknown and differ; call compute_chunk_sizes() first"
            )
        return vals.pop()
    totals = {sum(b) for b in non_trivial}
    if len(totals) > 1:
        raise ValueError(f"Chunks do not align along axis: lengths {sorted(totals)}")

    # refinement: sweep all boundaries (native pairwise fold for long axes)
    total = totals.pop()
    nt = sorted(non_trivial, key=len)
    if sum(len(b) for b in nt) > 512:
        from dask_array_tpu import native

        acc = tuple(nt[0])
        ok = True
        for b in nt[1:]:
            ref = native.refine_axis(acc, b)
            if ref is None:
                ok = False
                break
            acc = ref
        if ok:
            return acc
    cuts = set()
    for b in non_trivial:
        pos = 0
        for x in b:
            pos += x
            cuts.add(pos)
    cuts.discard(0)
    bounds = sorted(cuts)
    out = []
    prev = 0
    for x in bounds:
        out.append(x - prev)
        prev = x
    assert prev == total
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def _cumsum_cached(seq, initial_zero):
    if any(isinstance(x, float) and math.isnan(x) for x in seq):
        arr = np.cumsum([0] + list(seq)) if initial_zero else np.cumsum(list(seq))
        return tuple(arr.tolist())
    it = np.cumsum([0] + list(seq)) if initial_zero else np.cumsum(list(seq))
    return tuple(int(x) for x in it)


def cached_cumsum(seq, initial_zero=False):
    """Cumulative sum of a chunks tuple (with a leading 0 if requested).

    LRU-cached: per-block loops (block_slices over a 100x100 grid) hit the
    same axis tuples thousands of times per trace.
    """
    return _cumsum_cached(tuple(seq), bool(initial_zero))


def validate_axis(axis, ndim):
    """Normalize (possibly negative / tuple) axis against ndim."""
    if isinstance(axis, (tuple, list)):
        return tuple(validate_axis(ax, ndim) for ax in axis)
    if not isinstance(axis, Integral):
        raise TypeError(f"Axis value must be an integer, got {axis}")
    if axis < -ndim or axis >= ndim:
        raise np.exceptions.AxisError(axis, ndim)
    if axis < 0:
        axis += ndim
    return int(axis)


def has_unknown_chunks(chunks) -> bool:
    return any(
        any(isinstance(c, float) and math.isnan(c) for c in axis) for axis in chunks
    )


def grid_shape(chunks) -> tuple:
    """Number of blocks along each axis."""
    return tuple(len(c) for c in chunks)


def num_blocks(chunks) -> int:
    return int(np.prod([len(c) for c in chunks])) if chunks else 1


def chunks_nbytes(chunks, itemsize) -> float:
    """Total bytes of an array with these chunks (nan if unknown)."""
    total = 1.0
    for axis in chunks:
        total *= sum(axis)
    return total * itemsize


# ---------------------------------------------------------------------------
# cost-aware chunk unification (policy: auto | coarse | refine)
# ---------------------------------------------------------------------------


_MERGE_COST_RATIO = 4  # parity: _expr.py:672 — merge if moved <= ratio * backing


def _boundaries(chunks):
    out = [0]
    for c in chunks:
        out.append(out[-1] + c)
    return out


def _from_boundaries(bounds):
    return tuple(b - a for a, b in zip(bounds[:-1], bounds[1:]))


def unify_blockdims(candidates, policy="auto", limit_bytes=None, row_bytes=1.0):
    """Choose the unified blockdim for one axis across operands, cost-aware.

    ``candidates``: list of (chunks_along_axis, operand_nbytes).
    ``row_bytes``: approximate bytes per unit length along this axis (the
    operand nbytes / axis length), used for the size limit check.

    Parity: ``unify_chunks_expr`` / ``coarse_blockdim`` / ``moved_fraction``
    (``/root/reference/dask_array/_expr.py:586-905``):

    - refine: the common refinement (union of boundaries) — splits only, no
      data moves, but can shatter into many small blocks.
    - coarse: the coarsest common coarsening (intersection of boundaries) —
      fewest blocks, misaligned operands move.
    - auto: coarse unless the bytes that would move exceed
      ``_MERGE_COST_RATIO`` x the bytes already laid out coarsely, or the
      merge would manufacture a chunk above ``limit_bytes`` (then refine,
      with a PerformanceWarning).
    """
    real = [(tuple(c), nb) for c, nb in candidates if len(c) > 1 or (c and c[0] != 0)]
    non_trivial = [(c, nb) for c, nb in real if len(c) > 1]
    if not non_trivial:
        if not real:
            return max((tuple(c) for c, _ in candidates), key=len, default=())
        return real[0][0]
    distinct = {c for c, _ in non_trivial}
    if len(distinct) == 1:
        return next(iter(distinct))
    if any(math.isnan(sum(c)) for c in distinct):
        raise ValueError(
            "Arrays' chunk sizes along an axis are unknown and differ; call "
            "compute_chunk_sizes() first"
        )
    totals = {sum(c) for c in distinct}
    if len(totals) > 1:
        raise ValueError(f"Chunks do not align along axis: lengths {sorted(totals)}")

    bound_sets = {c: set(_boundaries(c)) for c in distinct}
    refined = common_blockdim(list(distinct))

    if policy == "refine":
        return refined

    # coarsest common coarsening: intersection of all boundary sets
    layouts = sorted(distinct, key=len)
    if sum(map(len, layouts)) > 256:
        from dask_array_tpu import native

        coarse = layouts[0]
        for other in layouts[1:]:
            got = native.coarse_axis(coarse, other)
            if got is None:
                coarse = None
                break
            coarse = got
    else:
        coarse = None
    if coarse is None:
        inter = None
        for s in bound_sets.values():
            inter = set(s) if inter is None else (inter & s)
        coarse = _from_boundaries(sorted(inter))

    if limit_bytes is not None and coarse and max(coarse) * row_bytes > limit_bytes:
        warnings.warn(
            "unify-chunks merge would manufacture a chunk above "
            "array.unify-chunks-limit; refining instead",
            PerformanceWarning,
            stacklevel=3,
        )
        return refined

    if policy == "coarse":
        return coarse

    # auto: cost model — operands already in the coarse layout "back" it;
    # everyone else would move
    moved = 0.0
    backing = 0.0
    for c, nb in non_trivial:
        nb = 0.0 if (isinstance(nb, float) and math.isnan(nb)) else float(nb)
        if tuple(c) == coarse:
            backing += nb
        else:
            moved += nb
    if backing > 0 and moved <= _MERGE_COST_RATIO * backing:
        return coarse
    if backing == 0:
        # nobody sits at the coarsest common coarsening: audition every
        # CANDIDATE layout as the target — operands already there back it,
        # everyone else moves.  Qualify when movers <= ratio x backing;
        # among qualifiers prefer the healthiest grid (fewest chunks, then
        # the largest smallest-chunk — this is what heals roll slivers
        # toward the clean source layout).  Parity: the reference's
        # realignment choice (bench_rechunk_insertion.py cases).
        best = None
        best_key = None
        for L in distinct:
            backing_l = 0.0
            movers_l = 0.0
            for c, nb in non_trivial:
                nb = 0.0 if (isinstance(nb, float) and math.isnan(nb)) else float(nb)
                if tuple(c) == tuple(L):
                    backing_l += nb
                else:
                    movers_l += nb
            if backing_l <= 0 or movers_l > _MERGE_COST_RATIO * backing_l:
                continue
            key = (len(L), -min(L))
            if best_key is None or key < best_key:
                best, best_key = L, key
        if best is not None:
            return best
        return refined
    return refined
