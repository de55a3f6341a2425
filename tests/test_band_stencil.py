"""2-D ``map_overlap`` stencils: numpy parity across boundary and depth.

Each case runs a Laplace-type stencil through the public ``map_overlap``
on a multi-block grid and compares it with numpy: pad the whole array
with the boundary mode, apply the stencil, trim the halo.
"""

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu import config

_NP_MODE = {"reflect": "symmetric", "nearest": "edge", "periodic": "wrap"}


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _laplace(b):
    import jax.numpy as jnp

    return (
        jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0) + jnp.roll(b, 1, 1) + jnp.roll(b, -1, 1)
        - 4 * b
    )


def _np_stencil(x, func, depth, boundary):
    """numpy reference: pad with the boundary, apply ``func``, trim."""
    pads = [(depth.get(ax, 0),) * 2 for ax in range(x.ndim)]
    if boundary in _NP_MODE:
        p = np.pad(x, pads, mode=_NP_MODE[boundary])
    else:
        p = np.pad(x, pads, mode="constant", constant_values=boundary)
    out = np.asarray(func(p))
    return out[tuple(slice(lo, out.shape[ax] - hi) for ax, (lo, hi) in enumerate(pads))]


def _check(rng, boundary, depth, func=_laplace, shape=(64, 96), chunks=(16, 48)):
    x = rng.standard_normal(shape).astype(np.float32)
    d = da.from_array(x, chunks=chunks)
    got = da.map_overlap(func, d, depth=depth, boundary=boundary, dtype="float32").compute()
    dep = depth if isinstance(depth, dict) else {ax: depth for ax in range(x.ndim)}
    np.testing.assert_allclose(got, _np_stencil(x, func, dep, boundary), atol=1e-5)


@pytest.mark.parametrize("boundary", ["reflect", "nearest", "periodic", 0.0])
def test_band_stencil_boundaries(rng, boundary):
    _check(rng, boundary, 1)


def test_band_stencil_mixed_depth(rng):
    _check(rng, "reflect", {0: 2, 1: 1})


def test_band_stencil_depth_zero_axis(rng):
    # depth-0 axis: the function must be LOCAL along it (the map_overlap
    # contract), so use a vertical-only stencil
    def vert(b):
        import jax.numpy as jnp

        return jnp.roll(b, 1, 0) + jnp.roll(b, -1, 0) - 2 * b

    _check(rng, "reflect", {0: 1, 1: 0}, func=vert)


def test_band_stencil_ineligible_falls_back(rng):
    # 3-D grid
    x3 = rng.standard_normal((8, 8, 8))
    o3 = da.map_overlap(lambda b: b * 2.0, da.from_array(x3, chunks=4), depth=1,
                        boundary="reflect", dtype="float64")
    np.testing.assert_allclose(o3.compute(), x3 * 2.0)
    # asymmetric depth with boundary="none"
    x = rng.standard_normal((64, 64)).astype("f4")
    oa = da.map_overlap(lambda b: b, da.from_array(x, chunks=16), depth={0: (1, 0), 1: 0},
                        boundary="none", dtype="float32")
    np.testing.assert_array_equal(oa.compute(), x)


def test_band_stencil_off_by_default(rng):
    # the shifted-slices form: the function returns the interior (trim=False)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    d = da.from_array(x, chunks=16)

    def slices(p):
        return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * p[1:-1, 1:-1]

    got = da.map_overlap(slices, d, depth=1, boundary="reflect", trim=False,
                         dtype="float32", chunks=d.chunks).compute()
    np.testing.assert_allclose(got, _np_stencil(x, _laplace, {0: 1, 1: 1}, "reflect"),
                               atol=1e-5)


def test_band_stencil_eager_mode_falls_back(rng):
    # the eager lane answers the same as numpy
    with config.set({"tpu.jit": False}):
        _check(rng, "reflect", 1, shape=(64, 64), chunks=(16, 16))
