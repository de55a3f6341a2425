"""The elementwise ufunc table (~80 numpy ufuncs) + the ``ufunc`` wrapper class.

Parity: ``/root/reference/dask_array/_ufunc.py`` — fresh implementation.
Each entry wraps the jnp kernel in an ``Elemwise`` expression; dtype rules
follow numpy (see ``compute_meta``).
"""

from __future__ import annotations

from numbers import Number

import numpy as np

from dask_array_tpu._blockwise import elemwise


def _jnp():
    import jax.numpy as jnp

    return jnp


class ufunc:
    """A wrapped elementwise universal function over lazy Arrays."""

    __slots__ = ("_fn", "__name__", "nin")

    def __init__(self, fn, name=None, nin=None):
        self._fn = fn
        self.__name__ = name or getattr(fn, "__name__", "ufunc")
        self.nin = nin if nin is not None else _arity(fn)

    def __repr__(self):
        return f"<dask_array_tpu ufunc '{self.__name__}'>"

    def __call__(self, *args, **kwargs):
        from dask_array_tpu._collection import Array

        if any(isinstance(a, Array) for a in args):
            return elemwise(self._fn, *args, **kwargs)
        # eager on plain numpy/scalars
        np_fn = getattr(np, self.__name__, None)
        if np_fn is not None:
            return np_fn(*args, **kwargs)
        return self._fn(*args, **kwargs)

    def outer(self, A, B, **kwargs):
        from dask_array_tpu._blockwise import blockwise
        from dask_array_tpu.ops._from_array import asarray

        A, B = asarray(A), asarray(B)
        a_ind = tuple(range(A.ndim))
        b_ind = tuple(range(A.ndim, A.ndim + B.ndim))
        fn = self._fn

        def outer_fn(a, b, **kw):
            jnp = _jnp()
            a2 = a.reshape(a.shape + (1,) * b.ndim)
            return fn(a2, b, **kw)

        np_fn = getattr(np, self.__name__, None)
        if isinstance(np_fn, np.ufunc):
            dtype = np_fn(
                np.ones((1,) * A.ndim, A.dtype), np.ones((1,) * B.ndim, B.dtype)
            ).dtype
        else:
            dtype = np.promote_types(A.dtype, B.dtype)
        return blockwise(
            outer_fn, a_ind + b_ind, A, a_ind, B, b_ind, dtype=dtype, token=f"{self.__name__}-outer", **kwargs
        )


def _arity(fn):
    import inspect

    try:
        return len([
            p for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and p.default is p.empty
        ])
    except (ValueError, TypeError):
        return 1


def wrap_elemwise(fn, name=None):
    """Wrap a scalar/elementwise callable as a lazy chunked ufunc.

    The result broadcasts like numpy, participates in blockwise fusion and
    slice pushdown, and exposes ``.outer``.  Reference parity:
    ``_ufunc.py:128``.
    """
    return ufunc(fn, name=name)


def _make(name, jnp_name=None):
    jnp = _jnp()
    return ufunc(getattr(jnp, jnp_name or name), name=name)


# -- the table ------------------------------------------------------------------

import jax.numpy as _jnp_mod

# unary math
abs = _make("abs")
absolute = _make("absolute")
fabs = _make("fabs")
rint = _make("rint")
sign = _make("sign")
exp = _make("exp")
exp2 = _make("exp2")
expm1 = _make("expm1")
log = _make("log")
log2 = _make("log2")
log10 = _make("log10")
log1p = _make("log1p")
sqrt = _make("sqrt")
square = _make("square")
cbrt = _make("cbrt")
reciprocal = _make("reciprocal")
sin = _make("sin")
cos = _make("cos")
tan = _make("tan")
arcsin = _make("arcsin")
arccos = _make("arccos")
arctan = _make("arctan")
sinh = _make("sinh")
cosh = _make("cosh")
tanh = _make("tanh")
arcsinh = _make("arcsinh")
arccosh = _make("arccosh")
arctanh = _make("arctanh")
deg2rad = _make("deg2rad")
rad2deg = _make("rad2deg")
degrees = _make("degrees")
radians = _make("radians")
invert = _make("invert")
bitwise_not = _make("bitwise_not")
negative = _make("negative")
positive = _make("positive")
conj = _make("conj")
conjugate = _make("conjugate")
floor = _make("floor")
ceil = _make("ceil")
trunc = _make("trunc")
isfinite = _make("isfinite")
isinf = _make("isinf")
isnan = _make("isnan")
def _isneginf(x):
    return _jnp_mod.isneginf(x)


def _isposinf(x):
    return _jnp_mod.isposinf(x)


isneginf = ufunc(_isneginf, name="isneginf", nin=1)
isposinf = ufunc(_isposinf, name="isposinf", nin=1)
signbit = _make("signbit")
spacing = _make("spacing")
real = _make("real")
imag = _make("imag")
angle = _make("angle")
i0 = _make("i0")
sinc = _make("sinc")
nan_to_num = _make("nan_to_num")
def _fix(x):
    return _jnp_mod.trunc(x).astype(_jnp_mod.result_type(x, float))


fix = ufunc(_fix, name="fix", nin=1)

# binary
add = _make("add")
subtract = _make("subtract")
multiply = _make("multiply")
divide = _make("divide")
true_divide = _make("true_divide")
floor_divide = _make("floor_divide")
mod = _make("mod")
remainder = _make("remainder")
fmod = _make("fmod")
power = _make("power")
float_power = _make("float_power")
arctan2 = _make("arctan2")
hypot = _make("hypot")
logaddexp = _make("logaddexp")
logaddexp2 = _make("logaddexp2")
maximum = _make("maximum")
minimum = _make("minimum")
fmax = _make("fmax")
fmin = _make("fmin")
copysign = _make("copysign")
nextafter = _make("nextafter")
ldexp = _make("ldexp")
heaviside = _make("heaviside")
bitwise_and = _make("bitwise_and")
bitwise_or = _make("bitwise_or")
bitwise_xor = _make("bitwise_xor")
left_shift = _make("left_shift")
right_shift = _make("right_shift")
greater = _make("greater")
greater_equal = _make("greater_equal")
less = _make("less")
less_equal = _make("less_equal")
equal = _make("equal")
not_equal = _make("not_equal")
logical_and = _make("logical_and")
logical_or = _make("logical_or")
logical_xor = _make("logical_xor")
logical_not = _make("logical_not")
gcd = _make("gcd")
lcm = _make("lcm")

# ternary / special signatures
def clip(a, a_min=None, a_max=None, **kwargs):
    jnp = _jnp()
    return elemwise(jnp.clip, a, a_min, a_max, **kwargs)


def _frexp_mantissa(v):
    return _jnp_mod.frexp(v)[0]


def _frexp_exponent(v):
    return _jnp_mod.frexp(v)[1]


def frexp(x):
    """Returns (mantissa, exponent) as two lazy arrays."""
    from dask_array_tpu._blockwise import elemwise as _ew

    return _ew(_frexp_mantissa, x), _ew(_frexp_exponent, x)


def modf(x):
    jnp = _jnp()
    from dask_array_tpu._blockwise import elemwise as _ew

    frac = _ew(lambda v: jnp.modf(v)[0], x)
    intg = _ew(lambda v: jnp.modf(v)[1], x)
    return frac, intg


def divmod(x, y):
    return (floor_divide(x, y), mod(x, y))


def isreal(x):
    jnp = _jnp()
    return elemwise(jnp.isreal, x)


def iscomplex(x):
    jnp = _jnp()
    return elemwise(jnp.iscomplex, x)


def frompyfunc(func, nin, nout, *, identity=None):
    """Wrap an arbitrary python scalar function as a (vectorized) ufunc.

    ``nout > 1`` returns a callable producing a TUPLE of lazy arrays, one
    elemwise expression per output (numpy frompyfunc parity).
    """
    import jax

    if nout != 1:
        base_name = getattr(func, "__name__", "frompyfunc")

        def multi(*args):
            from dask_array_tpu._blockwise import elemwise as _ew

            outs = []
            for i in range(nout):
                def pick(*blocks, _i=i):
                    import jax.numpy as jnp

                    return jnp.vectorize(func)(*blocks)[_i]

                pick.__name__ = f"{base_name}-out{i}"
                outs.append(_ew(pick, *args))
            return tuple(outs)

        multi.__name__ = base_name
        return multi

    def vec(*args):
        import jax.numpy as jnp

        return jnp.vectorize(func)(*args)

    vec.__name__ = getattr(func, "__name__", "frompyfunc")
    return ufunc(vec, name=vec.__name__, nin=nin)


# numpy-ufunc -> wrapped dispatch for __array_ufunc__
_BY_NAME = {
    name: obj
    for name, obj in list(globals().items())
    if isinstance(obj, ufunc)
}


def wrap_numpy_ufunc(np_ufunc):
    """Our wrapped equivalent of a numpy ufunc (for NEP-13 dispatch)."""
    name = getattr(np_ufunc, "__name__", None)
    got = _BY_NAME.get(name)
    if got is not None:
        return got
    jnp = _jnp()
    jfn = getattr(jnp, name, None) if name else None
    if jfn is not None:
        return ufunc(jfn, name=name)
    return None


__all__ = sorted(_BY_NAME) + [
    "clip", "frexp", "modf", "divmod", "isreal", "iscomplex", "frompyfunc",
    "ufunc", "wrap_elemwise", "wrap_numpy_ufunc",
]
