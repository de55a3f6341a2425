"""dask_array_tpu: a chunked n-dimensional array framework on JAX/XLA.

NumPy-compatible lazy arrays over a content-addressed expression tree
(``simplify -> lower -> fuse`` with slice/rechunk/shuffle pushdown and
blockwise fusion), executed by tracing the optimized tree into ONE jitted
XLA computation over ``jax.Array``s — sharded on a ``jax.sharding.Mesh``
for multi-device runs (rechunk -> all-to-all, reductions -> psum trees,
halos -> ppermute).

Capability parity target: ``mrocklin/dask-array`` (see SURVEY.md).
"""

from __future__ import annotations

import sys as _sys

# deep expression chains recurse through rewrite passes (~4 frames/node);
# match dask's posture of a raised limit
_sys.setrecursionlimit(max(_sys.getrecursionlimit(), 20000))

# numpy-compatible dtype semantics (f64 default, numpy promotion rules)
import jax as _jax

_jax.config.update("jax_enable_x64", True)

# persistent compile cache: JAX itself reads JAX_COMPILATION_CACHE_DIR; when
# that is unset the cache lives in one fixed, git-ignored directory of the
# checkout, so a later process finds what an earlier one compiled
if not _jax.config.jax_compilation_cache_dir:
    import os as _os

    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(__file__)), ".jax_cache"),
    )

import numpy as _np

from dask_array_tpu import config
from dask_array_tpu._chunks import PerformanceWarning, normalize_chunks
from dask_array_tpu._diagnostics import (
    chunk_report,
    tier_report,
    explain,
    expr_table,
    plan_table,
    trace_rewrites,
    xla_profile,
)
from dask_array_tpu._collection import Array, new_collection
from dask_array_tpu._expr_flow import expr_flow
from dask_array_tpu._materialize import barrier
from dask_array_tpu._blockwise import blockwise, elemwise
from dask_array_tpu._rechunk import rechunk
from dask_array_tpu._shuffle import shuffle
from dask_array_tpu.ops._from_array import array, asanyarray, asarray, from_array
from dask_array_tpu.ops.creation import (
    arange,
    empty,
    empty_like,
    eye,
    full,
    full_like,
    linspace,
    ones,
    ones_like,
    zeros,
    zeros_like,
)
from dask_array_tpu.ops.manipulation import (
    atleast_1d,
    atleast_2d,
    atleast_3d,
    broadcast_to,
    expand_dims,
    flip,
    fliplr,
    flipud,
    moveaxis,
    roll,
    rollaxis,
    rot90,
    squeeze,
    swapaxes,
    transpose,
)
from dask_array_tpu.ops.stacking import block, concatenate, dstack, hstack, stack, vstack
from dask_array_tpu.ops.reductions import (
    _tree_reduce,
    all,
    any,
    argmax,
    argmin,
    cumprod,
    cumreduction,
    cumsum,
    max,
    mean,
    median,
    min,
    moment,
    nanargmax,
    nanargmin,
    nancumprod,
    nancumsum,
    nanmax,
    nanmean,
    nanmedian,
    nanmin,
    nanpercentile,
    nanprod,
    nanquantile,
    nanstd,
    nansum,
    nanvar,
    percentile,
    prod,
    quantile,
    reduction,
    std,
    sum,
    trace,
    var,
    arg_reduction,
)
from dask_array_tpu.ops._map_blocks import map_blocks
from dask_array_tpu import fft, linalg, random
from dask_array_tpu.ops.linalg_decomp import (
    cholesky,
    inv,
    lstsq,
    lu,
    norm,
    qr,
    sfqr,
    solve,
    solve_triangular,
    svd,
    svd_compressed,
    tsqr,
)
from dask_array_tpu.ops.linalg import dot, einsum, matmul, outer, tensordot, vdot
from dask_array_tpu.ops._gufunc import apply_gufunc, as_gufunc, gufunc
from dask_array_tpu.ops._histogram import histogram, histogram2d, histogramdd
from dask_array_tpu.ops._overlap import (
    map_overlap,
    overlap,
    push,
    sliding_window_view,
    trim_internal,
    trim_overlap,
)
from dask_array_tpu.ops._fancy_indexing import take
from dask_array_tpu.ops._reshape import ravel, reshape, reshape_blockwise
from dask_array_tpu.ops.creation import (
    diag,
    diagonal,
    fromfunction,
    indices,
    meshgrid,
    pad,
    repeat,
    tile,
    tri,
)
from dask_array_tpu.ops.routines import (
    aligned_coarsen_chunks,
    allclose,
    append,
    apply_along_axis,
    apply_over_axes,
    argtopk,
    argwhere,
    around,
    average,
    bincount,
    broadcast_arrays,
    choose,
    coarsen,
    compress,
    corrcoef,
    count_nonzero,
    cov,
    delete,
    diff,
    digitize,
    ediff1d,
    extract,
    flatnonzero,
    gradient,
    insert,
    isclose,
    iscomplexobj,
    isin,
    isnull,
    ndim,
    nonzero,
    notnull,
    piecewise,
    ptp,
    ravel_multi_index,
    result_type,
    round,
    searchsorted,
    select,
    shape,
    topk,
    tril,
    tril_indices,
    tril_indices_from,
    triu,
    triu_indices,
    triu_indices_from,
    unify_chunks,
    union1d,
    unique,
    unravel_index,
    where,
)
from dask_array_tpu.ops.ufuncs import *  # noqa: F401,F403
from dask_array_tpu._dispatch import register_chunk_type
from dask_array_tpu import chunk, io
from dask_array_tpu import xarray
from dask_array_tpu.io import (
    from_blocks,
    from_delayed,
    from_map,
    from_npy_stack,
    from_tiledb,
    from_zarr,
    store,
    to_hdf5,
    to_npy_stack,
    to_tiledb,
    to_zarr,
)

# numpy constant / dtype re-exports (parity with the reference namespace)
newaxis = None
nan = _np.nan
inf = _np.inf
e = _np.e
pi = _np.pi
euler_gamma = _np.euler_gamma

bool = _np.bool_
int8 = _np.int8
int16 = _np.int16
int32 = _np.int32
int64 = _np.int64
uint8 = _np.uint8
uint16 = _np.uint16
uint32 = _np.uint32
uint64 = _np.uint64
float32 = _np.float32
float64 = _np.float64
complex64 = _np.complex64
complex128 = _np.complex128

__version__ = "0.3.0"


def compute(*collections, **kwargs):
    """Compute one or more lazy collections (returns a tuple).

    Multiple arrays compute as ONE jitted program: shared ancestry is
    built once and every leaf ships to the device once (the reference
    shares work through its common task graph —
    ``tests/test_collection.py:143``; here the sharing is inside one XLA
    program, ``_executor.execute_many``).
    """
    from dask_array_tpu._executor import execute_many
    from dask_array_tpu._materialize import optimize_expr

    # kwargs (scheduler=, optimize_graph=, ...) are accepted for dask API
    # compat and uniformly ignored by BOTH the single- and multi-array
    # paths — Array.compute has no options.  If Array.compute ever grows
    # one, thread it through execute_many here too.
    arrays = [(i, c) for i, c in enumerate(collections) if isinstance(c, Array)]
    out = list(collections)
    if len(arrays) > 1:
        from dask_array_tpu._executor import check_masked_ops

        for _, c in arrays:
            check_masked_ops(c.expr)
        lowered = [optimize_expr(c.expr) for _, c in arrays]
        denses = execute_many(lowered)
        from dask_array_tpu._dispatch import is_duck_chunk as _is_duck

        for (i, c), dense in zip(arrays, denses):
            if isinstance(dense, _np.ma.MaskedArray) or _is_duck(dense):
                # masked/duck host lane: np.asarray would drop the type
                out[i] = dense
                continue
            arr = _np.asarray(dense)
            dt = c.dtype
            if getattr(dt, "kind", "") in "Mm" and arr.dtype != dt:
                arr = arr.view(dt)
            out[i] = arr[()] if arr.ndim == 0 else arr
    else:
        for i, c in arrays:
            out[i] = c.compute(**kwargs)
    return tuple(out)


def optimize(x, keys=None, **kwargs):
    """Return ``x`` with its expression optimized (simplify -> lower -> fuse).

    Module-level spelling of ``Array.optimize()``; non-Array inputs pass
    through unchanged (dask.optimize API compat).
    """
    if isinstance(x, Array):
        return x.optimize()
    return x


# -- star-import surface -------------------------------------------------------
# `from dask_array_tpu import *` must not bind submodule names (`io` would
# shadow the stdlib module and `xarray` the real package) nor import-time
# helpers like `annotations` (reference guard:
# tests/test_public_namespace.py "star_import_binds_no_submodules").
# Submodules stay reachable as attributes (da.fft, da.linalg, ...).
import types as _types  # noqa: E402

__all__ = sorted(
    _name
    for _name, _value in globals().items()
    if not _name.startswith("_")
    and _name != "annotations"  # the __future__ feature flag is not API
    and not isinstance(_value, _types.ModuleType)
)
del _types


# -- derived docstrings ----------------------------------------------------------
# API-parity functions that shadow a numpy name and carry no docstring of
# their own inherit numpy's documentation (+ a provenance note) — the
# reference's ``derived_from`` pattern, applied once at import.
from dask_array_tpu.utils._derived import derive_docstrings as _derive_docstrings  # noqa: E402

_derive_docstrings(
    globals(),
    __all__,
    [
        ("", _np),
        ("linalg.", _np.linalg),
        ("fft.", _np.fft),
        ("lib.stride_tricks.", _np.lib.stride_tricks),
        ("ma.", _np.ma),
    ],
)
for _mod, _srcs in (
    (linalg, [("linalg.", _np.linalg), ("", _np)]),
    (fft, [("fft.", _np.fft)]),
    (random, [("random.", _np.random)]),
):
    _derive_docstrings(
        {_n: getattr(_mod, _n) for _n in dir(_mod) if not _n.startswith("_")},
        [_n for _n in dir(_mod) if not _n.startswith("_")],
        _srcs,
    )
del _derive_docstrings, _mod, _srcs
