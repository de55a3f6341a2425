"""NEP-18 ``__array_function__`` dispatch: numpy functions -> our lazy ops.

Parity: the role of ``/root/reference/dask_array/_dispatch.py`` (the
reference gets NEP-18 for free via dask collections; here we maintain the
mapping explicitly).
"""

from __future__ import annotations

import numpy as np


def _table():
    import dask_array_tpu as da
    from dask_array_tpu.ops import linalg as _linalg
    from dask_array_tpu.ops import manipulation as _manip
    from dask_array_tpu.ops import reductions as _red
    from dask_array_tpu.ops import routines as _rt
    from dask_array_tpu.ops import stacking as _st
    from dask_array_tpu.ops import _reshape as _rs
    from dask_array_tpu.ops import _fancy_indexing as _fi

    t = {
        np.sum: _red.sum, np.prod: _red.prod, np.mean: _red.mean,
        np.var: _red.var, np.std: _red.std, np.min: _red.min, np.max: _red.max,
        np.any: _red.any, np.all: _red.all, np.argmin: _red.argmin,
        np.argmax: _red.argmax, np.nansum: _red.nansum, np.nanmean: _red.nanmean,
        np.nanmin: _red.nanmin, np.nanmax: _red.nanmax, np.nanstd: _red.nanstd,
        np.nanvar: _red.nanvar, np.nanprod: _red.nanprod,
        np.median: _red.median, np.nanmedian: _red.nanmedian,
        np.cumsum: _red.cumsum, np.cumprod: _red.cumprod,
        np.quantile: _red.quantile, np.nanquantile: _red.nanquantile,
        np.percentile: _red.percentile, np.nanpercentile: _red.nanpercentile,
        np.trace: _red.trace, np.moment if hasattr(np, "moment") else None: _red.moment,
        np.transpose: _manip.transpose, np.swapaxes: _manip.swapaxes,
        np.moveaxis: _manip.moveaxis, np.rollaxis: _manip.rollaxis,
        np.squeeze: _manip.squeeze, np.expand_dims: _manip.expand_dims,
        np.broadcast_to: _manip.broadcast_to, np.flip: _manip.flip,
        np.flipud: _manip.flipud, np.fliplr: _manip.fliplr, np.rot90: _manip.rot90,
        np.roll: _manip.roll, np.atleast_1d: _manip.atleast_1d,
        np.atleast_2d: _manip.atleast_2d, np.atleast_3d: _manip.atleast_3d,
        np.concatenate: _st.concatenate, np.stack: _st.stack,
        np.vstack: _st.vstack, np.hstack: _st.hstack, np.dstack: _st.dstack,
        np.block: _st.block,
        np.reshape: _rs.reshape, np.ravel: _rs.ravel,
        np.dot: _linalg.dot, np.matmul: _linalg.matmul,
        np.tensordot: _linalg.tensordot, np.vdot: _linalg.vdot,
        np.einsum: _linalg.einsum, np.outer: _linalg.outer,
        np.where: _rt.where, np.round: _rt.round, np.around: _rt.around,
        np.isclose: _rt.isclose, np.allclose: _rt.allclose,
        np.count_nonzero: _rt.count_nonzero, np.nonzero: _rt.nonzero,
        np.flatnonzero: _rt.flatnonzero, np.argwhere: _rt.argwhere,
        np.unique: _rt.unique, np.bincount: _rt.bincount,
        np.digitize: _rt.digitize, np.searchsorted: _rt.searchsorted,
        np.isin: _rt.isin, np.union1d: _rt.union1d,
        np.diff: _rt.diff, np.ediff1d: _rt.ediff1d, np.gradient: _rt.gradient,
        np.cov: _rt.cov, np.corrcoef: _rt.corrcoef, np.average: _rt.average,
        np.ptp: _rt.ptp, np.select: _rt.select, np.piecewise: _rt.piecewise,
        np.choose: _rt.choose, np.compress: _rt.compress, np.extract: _rt.extract,
        np.tril: _rt.tril, np.triu: _rt.triu, np.diagonal: _rt.diagonal,
        np.insert: _rt.insert, np.delete: _rt.delete, np.append: _rt.append,
        np.take: _fi.take, np.broadcast_arrays: _rt.broadcast_arrays,
        np.ravel_multi_index: _rt.ravel_multi_index,
        np.unravel_index: _rt.unravel_index,
        np.apply_along_axis: _rt.apply_along_axis,
        np.apply_over_axes: _rt.apply_over_axes,
        np.result_type: _rt.result_type, np.ndim: _rt.ndim, np.shape: _rt.shape,
        np.imag: None, np.real: None,
    }
    from dask_array_tpu.ops import ufuncs as _uf

    t[np.real] = _uf.real
    t[np.imag] = _uf.imag
    t[np.clip] = _uf.clip
    try:
        from dask_array_tpu.ops.creation import diag

        t[np.diag] = diag
    except ImportError:
        pass
    t.pop(None, None)
    return t


_TABLE = None


def lookup_array_function(func):
    global _TABLE
    if _TABLE is None:
        _TABLE = _table()
    return _TABLE.get(func)


# ---------------------------------------------------------------------------
# chunk-type registry (duck arrays usable as blocks)
# ---------------------------------------------------------------------------

_HANDLED_CHUNK_TYPES: list[type] = [np.ndarray, np.ma.MaskedArray]

# registered types that are NOT plain-ndarray flavors: these are the duck
# chunk types that ride the HOST lane (numpy-API kernels dispatch through
# their __array_ufunc__/__array_function__); cached as a tuple because
# is_duck_chunk sits on hot executor paths
_DUCK_TYPES: tuple = ()


def register_chunk_type(type_):
    """Register a duck-array type as a valid block type.

    Parity: ``register_chunk_type`` (``_chunk_types.py:31``).  On the device
    execution path blocks are jax.Arrays; registered duck chunk types ride
    the HOST lane: their blocks are kept as-is (never ``np.asarray``-ed)
    and kernels run through the numpy API, which dispatches through the
    type's ``__array_ufunc__``/``__array_function__`` — the same discipline
    as the masked host lane.  Ops without a numpy counterpart fall back to
    jnp kernels, which compute correct VALUES but may return plain arrays
    (docs/divergences.md).
    """
    global _DUCK_TYPES
    _HANDLED_CHUNK_TYPES.append(type_)
    _DUCK_TYPES = tuple(
        t
        for t in _HANDLED_CHUNK_TYPES
        if isinstance(t, type) and not issubclass(t, np.ndarray)
    )


def is_valid_chunk_type(type_):
    return any(issubclass(type_, t) for t in _HANDLED_CHUNK_TYPES)


def is_valid_array_chunk(array):
    """Is ``array`` of a type dask_array can wrap as a block?

    Parity: ``is_valid_array_chunk`` (``_chunk_types.py:18``)."""
    return array is None or isinstance(array, tuple(_HANDLED_CHUNK_TYPES))


def is_duck_chunk(x) -> bool:
    """Is ``x`` a REGISTERED duck-array block (non-ndarray flavor)?

    Duck blocks execute on the host lane with numpy-API kernels so their
    type survives end-to-end (``register_chunk_type``)."""
    return bool(_DUCK_TYPES) and isinstance(x, _DUCK_TYPES)
