"""Contractions: einsum / tensordot / dot / matmul / vdot / outer.

Parity: ``/root/reference/dask_array/linalg/_tensordot.py`` and
``_einsum.py`` — fresh implementation.

XLA-first: the reference lowers a contraction to per-block-pair matmul
tasks plus a sum tree (``blockwise(adjust_chunks={k:1}) + .sum()``).  Here
the whole contraction is ONE ``dot_general`` in the traced program: XLA
tiles it onto the matrix units, and when the contracted axis is
sharded over a mesh it inserts the psum over the mesh itself — no rechunk
insertion or partial-sum blocks needed.  Chunk metadata is still computed
dask-style so downstream per-block consumers see the expected grid.
"""

from __future__ import annotations

import functools
import itertools
from numbers import Integral

import numpy as np

from dask_array_tpu import config
from dask_array_tpu._chunks import common_blockdim
from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr

_EINSUM_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def parse_einsum(subscripts: str, ndims: list[int]):
    """Expand '...' and implicit outputs: returns (input_labelss, out_labels)."""
    subscripts = subscripts.replace(" ", "")
    if "->" in subscripts:
        lhs, out = subscripts.split("->")
    else:
        lhs, out = subscripts, None
    inputs = lhs.split(",")
    if len(inputs) != len(ndims):
        raise ValueError(
            f"einsum: {len(inputs)} operand subscripts but {len(ndims)} operands"
        )
    used = set(c for c in subscripts if c.isalpha())
    free = [c for c in _EINSUM_LETTERS if c not in used]
    max_ell = 0
    expanded = []
    for labels, nd in zip(inputs, ndims):
        if "..." in labels:
            explicit = labels.replace("...", "")
            n_ell = nd - len(explicit)
            if n_ell < 0:
                raise ValueError(f"einsum: operand has fewer dims than subscripts {labels!r}")
            max_ell = max(max_ell, n_ell)
        else:
            if len(labels) != nd:
                raise ValueError(
                    f"einsum: subscripts {labels!r} don't match operand ndim {nd}"
                )
    ell_labels = free[:max_ell]
    for labels, nd in zip(inputs, ndims):
        if "..." in labels:
            explicit = labels.replace("...", "")
            n_ell = nd - len(explicit)
            pos = labels.index("...")
            pre = labels[:pos]
            post = labels[pos + 3:]
            mid = "".join(ell_labels[max_ell - n_ell:])
            expanded.append(pre + mid + post)
        else:
            expanded.append(labels)
    if out is None:
        counts = {}
        for labels in expanded:
            for c in labels:
                counts[c] = counts.get(c, 0) + 1
        out_labels = "".join(ell_labels) + "".join(
            sorted(c for c, n in counts.items() if n == 1 and c not in ell_labels)
        )
    else:
        if "..." in out:
            out_labels = out.replace("...", "".join(ell_labels))
        else:
            out_labels = out
    return expanded, out_labels


class Einsum(ArrayExpr):
    """General contraction; dense ``jnp.einsum``."""

    _parameters = ("subscripts", "out_labels", "input_labels", "kwargs")
    _defaults = {"kwargs": ()}

    @property
    def arrays(self):
        return self.operands[4:]

    @functools.cached_property
    def _label_chunks(self):
        out: dict = {}
        for labels, arr in zip(self.input_labels, self.arrays):
            for pos, c in enumerate(labels):
                ch = arr.chunks[pos]
                prev = out.get(c)
                if prev is None:
                    out[c] = ch
                elif prev != ch:
                    if len(ch) == 1 and sum(ch) in (0, 1):
                        continue
                    if len(prev) == 1 and sum(prev) in (0, 1):
                        out[c] = ch
                    else:
                        out[c] = common_blockdim([prev, ch])
        return out

    @functools.cached_property
    def chunks(self):
        return tuple(self._label_chunks[c] for c in self.out_labels)

    @functools.cached_property
    def _meta(self):
        kwargs = dict(self.kwargs or ())
        dtype = kwargs.get("dtype")
        if dtype is None:
            spec = ",".join(self.input_labels) + "->" + self.out_labels
            try:
                metas = [np.ones((1,) * a.ndim, dtype=a.dtype) for a in self.arrays]
                dtype = np.einsum(spec, *metas).dtype
            except TypeError:
                # dtypes numpy.einsum can't handle (bfloat16, ...): jax rules
                import jax

                sds = [jax.ShapeDtypeStruct((1,) * a.ndim, a.dtype) for a in self.arrays]
                import jax.numpy as jnp

                dtype = jax.eval_shape(lambda *xs: jnp.einsum(spec, *xs), *sds).dtype
        return np.empty((0,) * len(self.out_labels), dtype=np.dtype(dtype))

    def _accept_slice(self, index):
        """Slice pushdown through contraction free labels:
        einsum(...)[idx] == einsum(sliced operands) when the sliced output
        labels are plain (non-repeated, non-contracted) free labels."""
        from dask_array_tpu._slicing import Slice, is_basic_index
        from numbers import Integral

        if not is_basic_index(index) or any(isinstance(i, Integral) for i in index):
            return None
        label_slice = {}
        for pos, ind in enumerate(index):
            if ind == slice(None):
                continue
            label = self.out_labels[pos]
            # decline diagonals (label repeated within an operand)
            for labels in self.input_labels:
                if labels.count(label) > 1:
                    return None
            label_slice[label] = ind
        if not label_slice:
            return None
        new_arrays = []
        for labels, arr in zip(self.input_labels, self.arrays):
            sub = tuple(label_slice.get(lbl, slice(None)) for lbl in labels)
            if any(s != slice(None) for s in sub):
                arr = Slice(arr, sub)
            new_arrays.append(arr)
        return Einsum(*self.operands[:4], *new_arrays)

    def _build(self, ctx):
        import jax.numpy as jnp

        denses = [ctx.build(a).dense() for a in self.arrays]
        kwargs = dict(self.kwargs or ())
        kwargs.pop("split_every", None)
        spec = ",".join(self.input_labels) + "->" + self.out_labels
        precision = kwargs.pop("precision", None) or config.get("tpu.matmul-precision", "highest")
        dense = jnp.einsum(spec, *denses, precision=precision, **{k: v for k, v in kwargs.items() if k != "dtype"})
        if dense.dtype != self.dtype:
            dense = dense.astype(self.dtype)
        return BlockView(self.chunks, dense=dense)


def einsum(subscripts, *operands, dtype=None, optimize=False, split_every=None,
           order="K", casting="safe", **kwargs):
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._from_array import asarray

    if order not in ("C", "F", "A", "K"):
        raise ValueError(f"order must be one of 'C', 'F', 'A', or 'K' (got {order!r})")
    if casting not in ("no", "equiv", "safe", "same_kind", "unsafe"):
        raise ValueError(f"casting must be a numpy casting rule (got {casting!r})")
    # `order` is a host-memory-layout request — value-free for device arrays;
    # `casting` gates an explicit dtype= like numpy's einsum does
    arrays = [asarray(op) for op in operands]
    if dtype is not None and casting != "unsafe":
        natural = np.result_type(*[a.dtype for a in arrays])
        if not np.can_cast(natural, np.dtype(dtype), casting=casting):
            raise TypeError(
                f"Cannot cast from {natural} to {np.dtype(dtype)} with casting rule {casting!r}"
            )
    input_labels, out_labels = parse_einsum(subscripts, [a.ndim for a in arrays])
    kw = dict(kwargs)
    if dtype is not None:
        kw["dtype"] = np.dtype(dtype).str
    expr = Einsum(
        subscripts,
        out_labels,
        tuple(input_labels),
        tuple(sorted(kw.items())),
        *[a.expr for a in arrays],
    )
    return new_collection(expr)


def _axes_pair(axes, lhs_ndim, rhs_ndim):
    if isinstance(axes, Integral):
        n = int(axes)
        return tuple(range(lhs_ndim - n, lhs_ndim)), tuple(range(n))
    la, ra = axes
    if isinstance(la, Integral):
        la = (la,)
    if isinstance(ra, Integral):
        ra = (ra,)
    la = tuple(ax % lhs_ndim for ax in la)
    ra = tuple(ax % rhs_ndim for ax in ra)
    if len(la) != len(ra):
        raise ValueError("axes lists must have the same length")
    return la, ra


def tensordot(lhs, rhs, axes=2):
    from dask_array_tpu.ops._from_array import asarray

    lhs, rhs = asarray(lhs), asarray(rhs)
    la, ra = _axes_pair(axes, lhs.ndim, rhs.ndim)
    letters = iter(_EINSUM_LETTERS)
    lhs_labels = [next(letters) for _ in range(lhs.ndim)]
    rhs_labels = [None] * rhs.ndim
    for li, ri in zip(la, ra):
        rhs_labels[ri] = lhs_labels[li]
    for i in range(rhs.ndim):
        if rhs_labels[i] is None:
            rhs_labels[i] = next(letters)
    out = "".join(lhs_labels[i] for i in range(lhs.ndim) if i not in la) + "".join(
        rhs_labels[i] for i in range(rhs.ndim) if i not in ra
    )
    spec = "".join(lhs_labels) + "," + "".join(rhs_labels) + "->" + out
    return einsum(spec, lhs, rhs)


def dot(a, b, out=None):
    from dask_array_tpu.ops._from_array import asarray

    a, b = asarray(a), asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return tensordot(a, b, axes=((a.ndim - 1,), (0,)))
    return tensordot(a, b, axes=((a.ndim - 1,), (b.ndim - 2,)))


def vdot(a, b):
    from dask_array_tpu.ops._from_array import asarray
    from dask_array_tpu.ops.ufuncs import conj

    a, b = asarray(a), asarray(b)
    return dot(conj(a).ravel(), b.ravel())


def outer(a, b):
    from dask_array_tpu.ops._from_array import asarray

    a, b = asarray(a), asarray(b)
    return einsum("i,j->ij", a.ravel(), b.ravel())


def matmul(a, b):
    from dask_array_tpu.ops._from_array import asarray

    a, b = asarray(a), asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        raise ValueError("matmul does not support scalars")
    a_is_vec = a.ndim == 1
    b_is_vec = b.ndim == 1
    if a_is_vec and b_is_vec:
        return einsum("i,i->", a, b)
    if a_is_vec:
        return einsum("i,...ij->...j", a, b)
    if b_is_vec:
        return einsum("...ij,j->...i", a, b)
    return einsum("...ij,...jk->...ik", a, b)
