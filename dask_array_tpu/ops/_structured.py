"""Structured (record) dtype support: the host-numpy lane.

JAX/XLA has no structured-dtype representation, so record arrays live as
host numpy end to end: their expressions are untraceable
(``_executor.node_traceable`` routes the program through the eager lane),
leaves skip ``device_put``, and per-block kernels run plain numpy.  Field
access extracts a NUMERIC array, after which downstream ops are ordinary
device-path expressions again.

Parity: the reference inherits structured arrays for free through its
numpy chunk kernels — user-facing surface in
``/root/reference/dask_array/io/_from_array.py`` (from_array of record
arrays) and field access ``x['a']`` through ``Array.__getitem__``; its
arg-reductions use structured payloads internally
(``reductions/_common.py:675-830``), which this framework's generic
``arg_reduction`` already mirrors.
"""

from __future__ import annotations

import functools

import numpy as np

from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr


def _field_dtype(base: np.dtype, names):
    if isinstance(names, str):
        fields = base.fields
        if fields is None or names not in fields:
            raise KeyError(
                f"field {names!r} not found in dtype {base}; available: "
                f"{list(fields) if fields else []}"
            )
        return fields[names][0]
    # multi-field selection: numpy sub-struct view dtype
    return np.empty(0, dtype=base)[list(names)].dtype


class Field(ArrayExpr):
    """``x['a']`` / ``x[['a', 'b']]`` on a structured array (host lane).

    Sub-array fields (``("col1", ("f4", (3, 2)))``) append their inner
    shape as new trailing axes, matching numpy (reference
    ``tests/test_collection.py::test_field_access_with_shape``).
    """

    _parameters = ("array", "names")
    _traceable = False

    @functools.cached_property
    def _field_dt(self):
        return _field_dtype(self.array._meta.dtype, self.names)

    @functools.cached_property
    def chunks(self):
        sub = self._field_dt.shape  # () for plain fields
        return self.array.chunks + tuple((s,) for s in sub)

    @functools.cached_property
    def _meta(self):
        dt = self._field_dt
        return np.empty((0,) * (self.array.ndim + len(dt.shape)), dtype=dt.base)

    def _name_prefix(self):
        return "field"

    def _build(self, ctx):
        view = ctx.build(self.array)
        key = self.names if isinstance(self.names, str) else list(self.names)
        # select on the assembled dense value: np.concatenate would REPACK
        # a multi-field view dtype (offsets lost), so field selection must
        # come last to return exactly what numpy returns
        dense = view.dense()
        if not isinstance(dense, np.ndarray):
            dense = np.asarray(dense)
        return BlockView(self.chunks, dense=dense[key])


def field_access(x, names):
    """Build the Field expression (validates the dtype eagerly)."""
    from dask_array_tpu._collection import new_collection

    expr = x.expr if hasattr(x, "expr") else x
    if np.dtype(expr.dtype).fields is None:
        raise IndexError(
            f"only structured dtypes support field access; got {expr.dtype}"
        )
    if not isinstance(names, str):
        names = tuple(names)
    _field_dtype(np.dtype(expr.dtype), names)  # validate eagerly (KeyError)
    return new_collection(Field(expr, names))
