"""histogram / histogram2d / histogramdd.

Parity: ``/root/reference/dask_array/_histogram.py`` (dask-backed bins and
ranges supported) — fresh implementation.  The whole histogram is one XLA
program (per-block partial histograms + a tree-sum is what the reference
builds; XLA's fused bucketize+scatter-add does the same on-device).
"""

from __future__ import annotations

import builtins

import functools
from numbers import Integral

import numpy as np

from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr


def _jnp():
    import jax.numpy as jnp

    return jnp


class Histogram(ArrayExpr):
    _parameters = ("array", "bins", "range_", "weights", "density", "nbins")

    def _name_prefix(self):
        return "histogram"

    @functools.cached_property
    def chunks(self):
        return ((self.nbins,),)

    @functools.cached_property
    def _meta(self):
        if self.density:
            dt = np.dtype("f8")
        elif self.weights is not None:
            dt = np.histogram(np.ones(1), weights=np.ones(1, dtype=self.weights.dtype))[0].dtype
        else:
            dt = np.dtype(np.intp)
        return np.empty((0,), dtype=dt)

    def _build(self, ctx):
        jnp = _jnp()
        dense = ctx.build(self.array).dense().ravel()
        if isinstance(self.bins, ArrayExpr):
            edges = ctx.build(self.bins).dense()
        else:
            edges = jnp.asarray(np.asarray(self.bins))
        w = ctx.build(self.weights).dense().ravel() if isinstance(self.weights, ArrayExpr) else None

        from dask_array_tpu.kernels.histogram import histogram as scan_hist

        # the compare-accumulate scan (kernels/histogram.py); None where it
        # declines, and jnp.histogram answers
        counts = scan_hist(dense, edges, w)
        if counts is not None:
            if self.density:
                c = counts.astype(jnp.float64)
                hist = c / jnp.diff(edges.astype(jnp.float64)) / jnp.sum(c)
            else:
                hist = counts
        else:
            hist, _ = jnp.histogram(dense, bins=edges, weights=w, density=self.density)
        if hist.dtype != self.dtype:
            hist = hist.astype(self.dtype)
        return BlockView(self.chunks, dense=hist)


class LinspaceEdges(ArrayExpr):
    """Lazy ``n+1`` evenly spaced bin edges from lazy scalar lo/hi.

    The range stays in the expression tree — no hidden ``.compute()`` at
    graph-build time — so a dask-backed range (or the implicit min/max pass)
    fuses into the same XLA program as the histogram itself.  Parity:
    ``LinspaceDelayed`` (``/root/reference/dask_array/_histogram.py:128``).
    """

    _parameters = ("lo", "hi", "npoints")

    def _name_prefix(self):
        return "linspace-edges"

    @functools.cached_property
    def chunks(self):
        return ((self.npoints,),)

    @functools.cached_property
    def _meta(self):
        return np.empty((0,), dtype="f8")

    def _build(self, ctx):
        jnp = _jnp()
        lo = ctx.build(self.lo).dense().reshape(()).astype("f8")
        hi = ctx.build(self.hi).dense().reshape(()).astype("f8")
        # degenerate range (all values equal) widens by +-0.5, like numpy
        lo, hi = (
            jnp.where(lo == hi, lo - 0.5, lo),
            jnp.where(lo == hi, hi + 0.5, hi),
        )
        return BlockView(self.chunks, dense=jnp.linspace(lo, hi, self.npoints))


def _scalar_expr(v):
    """Lift a range endpoint to a 0-d expression (lazy if already lazy)."""
    from dask_array_tpu._collection import Array
    from dask_array_tpu.ops._from_array import asarray

    if isinstance(v, Array):
        return v.expr
    return asarray(np.asarray(v, dtype="f8")).expr


def _resolve_edges(a, bins, range):
    """Return (edges_spec, nbins, edges_collection_or_None)."""
    from dask_array_tpu._collection import Array, new_collection
    from dask_array_tpu.ops._from_array import from_array

    if isinstance(bins, Array):
        return bins.expr, bins.shape[0] - 1, bins
    if np.ndim(bins) == 1:
        # keep the caller's numeric dtype (numpy returns int edges for int
        # bins; the exact-integer kernel path depends on seeing them) —
        # reference parity: np.asarray(bins), _histogram.py:315
        edges = np.asarray(bins)
        if edges.dtype.kind not in "iuf":
            edges = edges.astype("f8")
        return edges, len(edges) - 1, from_array(edges, chunks=-1)
    # scalar bin count: edges derive from the range — kept LAZY when the
    # range is dask-backed or implicit (min/max of the data)
    n = int(bins)
    if range is not None:
        lo, hi = range
        if not isinstance(lo, Array) and not isinstance(hi, Array):
            lo, hi = float(lo), float(hi)
            if lo == hi:
                lo -= 0.5
                hi += 0.5
            edges = np.linspace(lo, hi, n + 1)
            return edges, n, None
        lo_e, hi_e = _scalar_expr(lo), _scalar_expr(hi)
    else:
        # dask requires range when bins is an int and a is lazy; we take the
        # min/max lazily instead of refusing (it fuses into the program)
        lo_e, hi_e = a.min().expr, a.max().expr
    expr = LinspaceEdges(lo_e, hi_e, n + 1)
    return expr, n, new_collection(expr)


def _validate_bins_range(bins, range, for_histogram=True):
    """Reference-parity argument validation (its ``_histogram.py`` raises
    clear errors naming bins/range; test_histogram_bin_range_raises)."""
    from dask_array_tpu._collection import Array

    if bins is None:
        raise ValueError("histogram requires a bins argument: pass bin edges or a bin count")
    if isinstance(bins, Array):
        if bins.ndim > 1:
            raise ValueError(f"bins must be a scalar count or 1-D edges, got {bins.ndim}-D")
    elif np.ndim(bins) > 1:
        raise ValueError(f"bins must be a scalar count or 1-D edges, got {np.ndim(bins)}-D")
    if range is not None:
        if isinstance(range, Array):
            if range.ndim != 1 or range.shape[0] != 2:
                raise ValueError(
                    f"range must be a pair (lo, hi), got an array of shape {range.shape}"
                )
        elif np.ndim(range) == 0:
            raise TypeError(f"range must be a pair (lo, hi), got {range!r}")
        elif np.ndim(range) > 1 or builtins.len(range) != 2:
            raise ValueError(f"range must be a pair (lo, hi), got {range!r}")


def histogram(a, bins=None, range=None, normed=False, weights=None, density=None):
    from dask_array_tpu._collection import Array, new_collection
    from dask_array_tpu.ops._from_array import asarray, from_array

    if normed:
        raise ValueError(
            "The normed= keyword is deprecated in numpy and unsupported here; "
            "use density=True instead"
        )
    _validate_bins_range(bins, range)
    if isinstance(bins, Array) and bins.ndim == 0:
        # a scalar dask bin COUNT fixes the output shape, so it must be
        # resolved at graph-build time; with density the reference refuses
        # outright (message parity: its _histogram.py:214)
        if density or normed:
            raise NotImplementedError(
                "`bins` cannot be a scalar Dask object when density=True; "
                "compute it first or pass a concrete int"
            )
        bins = int(bins.compute())
    a = asarray(a)
    if weights is not None:
        weights = asarray(weights)
        if weights.shape != a.shape:
            raise ValueError("weights must have the same shape as the data")
    dens = bool(density) if density is not None else bool(normed)
    edges_spec, nbins, edges_coll = _resolve_edges(a, bins, range)
    expr = Histogram(
        a.expr,
        edges_spec,
        None,
        weights.expr if weights is not None else None,
        dens,
        nbins,
    )
    hist = new_collection(expr)
    if edges_coll is None:
        edges_coll = from_array(np.asarray(edges_spec), chunks=-1)
    elif isinstance(edges_spec, np.ndarray):
        pass
    return hist, edges_coll


def histogram2d(x, y, bins=10, range=None, normed=False, weights=None, density=None):
    from dask_array_tpu.ops.stacking import stack

    if isinstance(bins, (list, tuple)) and len(bins) == 2:
        bins_dd = bins
    else:
        bins_dd = (bins, bins)
    counts, edges = histogramdd(
        (x, y), bins=bins_dd, range=range, normed=normed, weights=weights, density=density
    )
    return counts, edges[0], edges[1]


class HistogramDD(ArrayExpr):
    _parameters = ("weights", "density", "edge_arrays", "shape_", "ncoords")
    # operands[5:5+ncoords] are the coordinate expressions (one per
    # dimension); operands[5+ncoords:] are lazy edge expressions, one per
    # None slot in ``edge_arrays`` (they must live in ``operands`` — not
    # nested inside the edge_arrays tuple — so ``dependencies()`` sees
    # them and their leaves join the program).

    @property
    def coords(self):
        return self.operands[5 : 5 + self.ncoords]

    @property
    def lazy_edges(self):
        return self.operands[5 + self.ncoords :]

    @functools.cached_property
    def chunks(self):
        return tuple((s,) for s in self.shape_)

    @functools.cached_property
    def _meta(self):
        # numpy's histogramdd counts are ALWAYS float64 (unlike histogram)
        return np.empty((0,) * len(self.shape_), dtype=np.dtype("f8"))

    def _build(self, ctx):
        jnp = _jnp()
        coords = [ctx.build(c).dense().ravel() for c in self.coords]
        sample = jnp.stack(coords, axis=-1)
        lazy = iter(self.lazy_edges)
        edges = [
            ctx.build(next(lazy)).dense() if e is None else jnp.asarray(e)
            for e in self.edge_arrays
        ]
        w = ctx.build(self.weights).dense().ravel() if isinstance(self.weights, ArrayExpr) else None
        hist, _ = jnp.histogramdd(sample, bins=edges, weights=w, density=self.density)
        if hist.dtype != self.dtype:
            hist = hist.astype(self.dtype)
        return BlockView(self.chunks, dense=hist)


def histogramdd(sample, bins=10, range=None, normed=False, weights=None, density=None):
    from dask_array_tpu._collection import Array, new_collection
    from dask_array_tpu.ops._from_array import asarray, from_array

    if normed and density:
        raise TypeError("Cannot specify both 'normed' and 'density'")
    if isinstance(sample, Array):
        if sample.ndim != 2:
            raise ValueError(
                "Single array input to histogramdd should be columnar, i.e. "
                f"have two dimensions (N, D); got {sample.ndim}-D"
            )
        d = sample.shape[1]
        coords = [sample[:, i] for i in builtins.range(d)]
    else:
        coords = [asarray(s) for s in sample]
        d = len(coords)
    dens = bool(density) if density is not None else bool(normed)

    if isinstance(bins, (list, tuple)):
        if len(bins) != d:
            raise ValueError(
                "The dimension of bins must be equal to the dimension of the "
                f"sample: got {len(bins)} bins for {d} dimensions"
            )
    else:
        bins = [bins] * d
    if range is None:
        ranges = [None] * d
    else:
        ranges = list(range)
        if len(ranges) != d:
            raise ValueError(
                "range argument requires one entry, a min max pair, per "
                f"dimension: got {len(ranges)} entries for {d} dimensions"
            )
        for r in ranges:
            if r is not None and (np.ndim(r) != 1 or builtins.len(r) != 2):
                raise ValueError(
                    f"range argument should be a sequence of pairs, got {r!r}"
                )
    edge_arrays = []
    nbins = []
    for i in builtins.range(d):
        b = bins[i]
        if np.ndim(b) == 1:
            edge_arrays.append(np.asarray(b, dtype="f8"))
            nbins.append(len(edge_arrays[-1]) - 1)
            continue
        n = int(b)
        nbins.append(n)
        r = ranges[i]
        if r is None:
            # implicit range: lazy min/max, fused into the program
            edge_arrays.append(
                LinspaceEdges(coords[i].min().expr, coords[i].max().expr, n + 1)
            )
        else:
            lo, hi = float(r[0]), float(r[1])
            if lo == hi:
                lo -= 0.5
                hi += 0.5
            edge_arrays.append(np.linspace(lo, hi, n + 1))
    w = asarray(weights).expr if weights is not None else None
    shape_ = tuple(nbins)
    static_edges = tuple(None if isinstance(e, ArrayExpr) else e for e in edge_arrays)
    lazy_edges = [e for e in edge_arrays if isinstance(e, ArrayExpr)]
    expr = HistogramDD(
        w, dens, static_edges, shape_, d, *[c.expr for c in coords], *lazy_edges
    )
    hist = new_collection(expr)
    edges = [
        new_collection(e) if isinstance(e, ArrayExpr) else from_array(e, chunks=-1)
        for e in edge_arrays
    ]
    return hist, edges
