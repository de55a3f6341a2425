"""FFT family over jnp.fft.

Parity: ``/root/reference/dask_array/fft.py`` (``fft_wrap`` factory; the
FFT axis must be single-chunk, matching the reference's contract) — fresh
implementation.  XLA lowers these to on-device FFT kernels.
"""

from __future__ import annotations

import functools
from numbers import Integral

import numpy as np

from dask_array_tpu._chunks import validate_axis
from dask_array_tpu._executor import BlockView
from dask_array_tpu._expr import ArrayExpr

_OUT_CHUNK_FNS = {
    "fft": lambda n, param: n if param is None else param,
    "ifft": lambda n, param: n if param is None else param,
    "hfft": lambda n, param: 2 * (n - 1) if param is None else param,
    "ihfft": lambda n, param: (n if param is None else param) // 2 + 1,
    "rfft": lambda n, param: (n if param is None else param) // 2 + 1,
    "irfft": lambda n, param: 2 * (n - 1) if param is None else param,
}

_COMPLEX = {"fft", "ifft", "rfft", "ihfft"}
_REAL_OUT = {"irfft", "hfft"}


class FFT(ArrayExpr):
    _parameters = ("array", "kind", "n_param", "axes", "norm")

    def _name_prefix(self):
        return self.kind

    @functools.cached_property
    def chunks(self):
        kind1 = {"fftn": "fft", "ifftn": "ifft", "rfftn": "rfft", "irfftn": "irfft",
                 "fft2": "fft", "ifft2": "ifft", "rfft2": "rfft", "irfft2": "irfft"}.get(self.kind, self.kind)
        out = list(self.array.chunks)
        ns = self.n_param if isinstance(self.n_param, tuple) else (self.n_param,) * len(self.axes)
        for ax, n in zip(self.axes, ns):
            dim = self.array.shape[ax]
            if self.kind in ("rfftn", "rfft2") and ax != self.axes[-1]:
                size = dim if n is None else n
            elif self.kind in ("irfftn", "irfft2") and ax != self.axes[-1]:
                size = dim if n is None else n
            else:
                size = _OUT_CHUNK_FNS[kind1](dim, n)
            out[ax] = (int(size),)
        return tuple(out)

    @functools.cached_property
    def _meta(self):
        in_dt = self.array.dtype
        if self.kind in ("irfft", "irfftn", "irfft2", "hfft"):
            dt = np.float32 if in_dt in (np.dtype("complex64"), np.dtype("float32")) else np.float64
        else:
            dt = np.complex64 if in_dt in (np.dtype("float32"), np.dtype("complex64")) else np.complex128
        return np.empty((0,) * self.array.ndim, dtype=dt)

    def _build(self, ctx):
        import jax.numpy as jnp

        dense = ctx.build(self.array).dense()
        fn = getattr(jnp.fft, self.kind)
        kw = {"norm": self.norm} if self.norm else {}
        if self.kind in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
            out = fn(dense, n=self.n_param, axis=self.axes[0], **kw)
        elif self.kind in ("fft2", "ifft2", "rfft2", "irfft2"):
            out = fn(dense, s=self.n_param, axes=self.axes, **kw)
        else:
            out = fn(dense, s=self.n_param, axes=self.axes, **kw)
        if out.dtype != self.dtype:
            out = out.astype(self.dtype)
        return BlockView(self.chunks, dense=out)


def _check_single_chunk(a, axes):
    for ax in axes:
        if len(a.chunks[ax]) != 1:
            raise ValueError(
                "Dask-style FFT can only be applied along an axis with a "
                f"single chunk. Rechunk first: axis {ax} has chunks {a.chunks[ax]}"
            )


def fft_wrap(fft_func, kind=None, dtype=None, allow_fftpack=False):
    """Wrap a (numpy/scipy-style) fft function for lazy arrays.

    Parity: ``fft_wrap`` (``/root/reference/dask_array/fft.py:119``):
    ``kind`` defaults to the function's name and must belong to the
    numpy.fft API (unknown kinds raise ValueError); ``scipy.fftpack``
    sources warn unless ``allow_fftpack=True``.  Execution lowers to the
    matching jnp.fft routine (on-device FFT kernels).
    """
    import warnings

    mod = getattr(fft_func, "__module__", "") or ""
    if mod.startswith("scipy.fftpack") and not allow_fftpack:
        warnings.warn(
            f"Function {getattr(fft_func, '__name__', fft_func)} from "
            "`scipy.fftpack` does not match NumPy's API and is considered "
            "legacy. Please use `scipy.fft` instead. To suppress this "
            "warning and allow usage, set `allow_fftpack=True`.",
            FutureWarning,
        )
    name = kind or getattr(fft_func, "__name__", None)
    if not name or name.rstrip("2n") not in _OUT_CHUNK_FNS:
        raise ValueError(f"Given unknown `kind` {name}.")

    if name.endswith("2") or name.endswith("n"):
        def wrapped(a, s=None, axes=None, norm=None):
            return _dispatch(name, a, s=s, axes=axes, norm=norm)
    else:
        def wrapped(a, n=None, axis=-1, norm=None):
            return _dispatch(name, a, n=n, axis=axis, norm=norm)

    wrapped.__name__ = name
    return wrapped


def _dispatch(kind, a, n=None, axis=None, s=None, axes=None, norm=None):
    from dask_array_tpu._collection import new_collection
    from dask_array_tpu.ops._from_array import asarray

    a = asarray(a)
    if kind in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
        ax = validate_axis(-1 if axis is None else axis, a.ndim)
        axes_t = (ax,)
        n_param = n
    else:
        if axes is not None:
            axes_t = tuple(validate_axis(x, a.ndim) for x in axes)
        elif kind.endswith("2") and s is None:
            axes_t = tuple(validate_axis(x, a.ndim) for x in (-2, -1))
        elif s is not None:
            # numpy semantics: s without axes means the LAST len(s) axes
            axes_t = tuple(range(a.ndim - len(s), a.ndim))
        elif kind.endswith("2"):
            axes_t = tuple(validate_axis(x, a.ndim) for x in (-2, -1))
        else:
            axes_t = tuple(range(a.ndim))
        if len(set(axes_t)) != len(axes_t):
            raise ValueError("Duplicate axes not allowed.")
        if kind.endswith("2") and len(axes_t) != 2:
            # numpy's *2 functions accept ANY axes count (they are fftn
            # specializations); jnp's insist on exactly 2 — reroute to *n
            kind = kind[:-1] + "n"
        n_param = tuple(s) if s is not None else None
    _check_single_chunk(a, axes_t)
    return new_collection(FFT(a.expr, kind, n_param, axes_t, norm))


def fft(a, n=None, axis=-1, norm=None):
    return _dispatch("fft", a, n=n, axis=axis, norm=norm)


def ifft(a, n=None, axis=-1, norm=None):
    return _dispatch("ifft", a, n=n, axis=axis, norm=norm)


def rfft(a, n=None, axis=-1, norm=None):
    return _dispatch("rfft", a, n=n, axis=axis, norm=norm)


def irfft(a, n=None, axis=-1, norm=None):
    return _dispatch("irfft", a, n=n, axis=axis, norm=norm)


def hfft(a, n=None, axis=-1, norm=None):
    return _dispatch("hfft", a, n=n, axis=axis, norm=norm)


def ihfft(a, n=None, axis=-1, norm=None):
    return _dispatch("ihfft", a, n=n, axis=axis, norm=norm)


def fft2(a, s=None, axes=(-2, -1), norm=None):
    return _dispatch("fft2", a, s=s, axes=axes, norm=norm)


def ifft2(a, s=None, axes=(-2, -1), norm=None):
    return _dispatch("ifft2", a, s=s, axes=axes, norm=norm)


def rfft2(a, s=None, axes=(-2, -1), norm=None):
    return _dispatch("rfft2", a, s=s, axes=axes, norm=norm)


def irfft2(a, s=None, axes=(-2, -1), norm=None):
    return _dispatch("irfft2", a, s=s, axes=axes, norm=norm)


def fftn(a, s=None, axes=None, norm=None):
    return _dispatch("fftn", a, s=s, axes=axes, norm=norm)


def ifftn(a, s=None, axes=None, norm=None):
    return _dispatch("ifftn", a, s=s, axes=axes, norm=norm)


def rfftn(a, s=None, axes=None, norm=None):
    return _dispatch("rfftn", a, s=s, axes=axes, norm=norm)


def irfftn(a, s=None, axes=None, norm=None):
    return _dispatch("irfftn", a, s=s, axes=axes, norm=norm)


def fftfreq(n, d=1.0, chunks="auto"):
    """One iota of length n with the wrap applied elementwise, so an
    EXPLICIT chunks spec describes the whole output (reference
    ``_fftfreq_block``: r[i >= (n+1)//2] -= n; r /= n*d)."""
    import jax.numpy as jnp

    from dask_array_tpu._blockwise import elemwise
    from dask_array_tpu.ops.creation import arange

    n = int(n)
    i = arange(0, n, chunks=chunks, dtype="f8")
    cut = (n + 1) // 2
    shifted = elemwise(lambda v: jnp.where(v >= cut, v - n, v), i)
    return shifted / (n * d)


def rfftfreq(n, d=1.0, chunks="auto"):
    from dask_array_tpu.ops.creation import arange

    n = int(n)
    return arange(0, n // 2 + 1, chunks=chunks, dtype="f8") / (n * d)


def _shift(a, axes, inverse):
    from dask_array_tpu.ops.manipulation import roll

    if axes is None:
        axes = tuple(range(a.ndim))
    elif isinstance(axes, Integral):
        axes = (axes,)
    out = a
    for ax in axes:
        ax = validate_axis(ax, a.ndim)
        n = a.shape[ax]
        shift = -(n // 2) if inverse else n // 2
        out = roll(out, shift, axis=ax)
    return out


def fftshift(x, axes=None):
    return _shift(x, axes, inverse=False)


def ifftshift(x, axes=None):
    return _shift(x, axes, inverse=True)
