"""Sliding/moving-window reduction scenario battery.

Ported scenario-for-scenario from the reference spine
``/root/reference/dask_array/tests/test_sliding_window_reductions.py``
(window-spanning-many-chunks native-chunk discipline, irregular chunks,
NaN/all-NaN windows, moment fusion, dtype edges, bottleneck ``move_*``
semantics), adapted to this framework's chunk discipline: the fused
``SlidingWindowReduce`` keeps the input's native chunking with the final
``window-1`` elements trimmed from the END of the axis (no rechunk to a
single block as the reference's moment path does).

The structural assertion everywhere: after ``simplify()`` the plan contains
NO ``SlidingWindowView`` — the window dimension is never materialized.
"""

import warnings

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu._test_utils import assert_eq
from dask_array_tpu.ops._overlap import SlidingWindowView
from dask_array_tpu.ops._sliding import (
    SlidingWindowReduce,
    move_max,
    move_mean,
    move_min,
    move_std,
    move_sum,
    move_var,
)

swv = np.lib.stride_tricks.sliding_window_view


def contains_swv(expr):
    return any(isinstance(n, SlidingWindowView) for n in expr.walk())


def contains_swr(expr):
    return any(isinstance(n, SlidingWindowReduce) for n in expr.walk())


def np_ref(reduction, data, window, axis=0, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return getattr(np, reduction)(swv(data, window, axis=axis), axis=-1, **kw)


# ---------------------------------------------------------------------------
# native-chunk discipline (reference spine lines 34-97)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "reduction",
    ["sum", "mean", "min", "max", "prod", "nansum", "nanmean", "nanmin", "nanmax", "nanprod"],
)
def test_window_spanning_many_chunks_keeps_native_chunks(reduction):
    # the statarb shape: a rolling window several times larger than the time
    # chunks; the fused reduction must keep native chunking and never
    # materialize the window dimension
    rng = np.random.default_rng(42)
    data = rng.normal(size=(13 * 96, 3))
    if reduction in ("prod", "nanprod"):
        data = 1 + data / 100
    if reduction.startswith("nan"):
        data[rng.random(data.shape) < 0.2] = np.nan
        data[100:600, 1] = np.nan  # includes all-NaN windows
    x = da.from_array(data, chunks=(96, 2))
    window = 480  # spans five 96-element chunks

    view = da.sliding_window_view(x, window_shape=window, axis=0)
    result = getattr(da, reduction)(view, axis=-1)
    expected = np_ref(reduction, data, window)

    optimized = result.expr.simplify()
    assert optimized.chunks == ((96,) * 8 + (1,), (2, 1))
    assert not contains_swv(optimized)
    assert contains_swr(optimized)
    assert_eq(result, expected, rtol=1e-11, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("window", [13, 20])
@pytest.mark.parametrize("reduction", ["sum", "min", "nanmean"])
def test_irregular_chunks(reduction, window):
    rng = np.random.default_rng(7)
    data = rng.normal(size=80)
    if reduction == "nanmean":
        data[rng.random(80) < 0.3] = np.nan
    x = da.from_array(data, chunks=((7, 12, 9, 14, 8, 12, 6, 12),))

    view = da.sliding_window_view(x, window_shape=window, axis=0)
    result = getattr(da, reduction)(view, axis=-1)
    expected = np_ref(reduction, data, window)

    if window == 20:
        assert result.expr.simplify().chunks == ((7, 12, 9, 14, 8, 11),)
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=1e-12, equal_nan=True)


def test_window_one_past_chunk():
    # depth == chunk size exactly: trim lands exactly on a block boundary
    data = np.arange(80, dtype=np.float64)
    x = da.from_array(data, chunks=8)

    result = da.sliding_window_view(x, window_shape=9, axis=0).sum(axis=-1)
    expected = np_ref("sum", data, 9)

    assert result.expr.simplify().chunks == ((8,) * 9,)
    assert_eq(result, expected, rtol=1e-13)


def test_sliding_window_sum_large_offset_stays_accurate():
    # a prefix-sum-difference scheme would lose precision here; the direct
    # per-window reduce_window summation must not
    rng = np.random.default_rng(3)
    noise = rng.normal(size=12 * 64)
    data = 1e9 + noise
    x = da.from_array(data, chunks=64)
    window = 256

    result = da.sliding_window_view(x, window_shape=window, axis=0).sum(axis=-1)
    exact = window * 1e9 + swv(noise, window).sum(axis=-1)

    assert result.expr.simplify().chunks == ((64,) * 8 + (1,),)
    assert_eq(result, exact, rtol=1e-13)


# ---------------------------------------------------------------------------
# 3-D grids: non-window chunks preserved, keepdims (spine lines 177-294)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["min", "max", "sum", "prod", "mean"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_reduction_over_window_axis_3d(reduction, keepdims):
    data = (1 + (np.arange(80 * 4 * 5, dtype=np.float32) % 5) / 100).reshape(80, 4, 5)
    x = da.from_array(data, chunks=(16, 4, 5))
    y = da.sliding_window_view(x, window_shape=24, axis=0)

    result = getattr(y, reduction)(axis=-1, keepdims=keepdims)
    expected = np_ref(reduction, data, 24, keepdims=keepdims)

    assert y.chunks == ((16, 16, 16, 9), (4,), (5,), (24,))
    native = ((16, 16, 16, 9), (4,), (5,)) + (((1,),) if keepdims else ())
    assert result.expr.simplify().chunks == native
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=1e-5)


@pytest.mark.parametrize("reduction", ["min", "max", "sum", "prod", "mean"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_reduction_keeps_non_window_chunks(reduction, keepdims):
    data = (1 + (np.arange(96 * 32 * 48, dtype=np.float32) % 5) / 100).reshape(96, 32, 48)
    x = da.from_array(data, chunks=(24, 24, 24))

    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = getattr(windowed, reduction)(axis=-1, keepdims=keepdims)
    expected = np_ref(reduction, data, 72, keepdims=keepdims)

    expected_chunks = ((24, 1), (24, 8), (24, 24)) + (((1,),) if keepdims else ())
    assert result.expr.simplify().chunks == expected_chunks
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=1e-5)


@pytest.mark.parametrize("reduction", ["any", "all"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_boolean_reduction_keeps_non_window_chunks(reduction, keepdims):
    data = (np.arange(96 * 32 * 48).reshape(96, 32, 48) % 5) == 0
    x = da.from_array(data, chunks=(24, 24, 24))

    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = getattr(windowed, reduction)(axis=-1, keepdims=keepdims)
    expected = np_ref(reduction, data, 72, keepdims=keepdims)

    expected_chunks = ((24, 1), (24, 8), (24, 24)) + (((1,),) if keepdims else ())
    assert result.expr.simplify().chunks == expected_chunks
    assert not contains_swv(result.expr.simplify())
    assert result.dtype == expected.dtype
    assert_eq(result, expected)


@pytest.mark.parametrize("reduction", ["nansum", "nanprod", "nanmin", "nanmax", "nanmean"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_nan_reduction_keeps_non_window_chunks(reduction, keepdims):
    data = (1 + (np.arange(96 * 32 * 48, dtype=np.float64) % 5) / 10).reshape(96, 32, 48)
    data[::7, :, :] = np.nan
    data[:80, 0, 0] = np.nan  # all-NaN windows
    x = da.from_array(data, chunks=(24, 24, 24))

    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = getattr(da, reduction)(windowed, axis=-1, keepdims=keepdims)
    expected = np_ref(reduction, data, 72, keepdims=keepdims)

    expected_chunks = ((24, 1), (24, 8), (24, 24)) + (((1,),) if keepdims else ())
    assert result.expr.simplify().chunks == expected_chunks
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, equal_nan=True)


@pytest.mark.parametrize(
    "reduction, axis, expected_chunks",
    [
        ("min", 1, ((20, 20), (9,), (24, 24))),
        ("prod", 2, ((20, 20), (24, 8), (24, 1))),
    ],
)
def test_reduction_keeps_non_leading_non_window_chunks(reduction, axis, expected_chunks):
    data = (1 + (np.arange(40 * 32 * 48, dtype=np.float32) % 5) / 100).reshape(40, 32, 48)
    x = da.from_array(data, chunks=(20, 24, 24))

    windowed = da.sliding_window_view(x, window_shape=24, axis=axis)
    result = getattr(windowed, reduction)(axis=-1)
    expected = np_ref(reduction, data, 24, axis=axis)

    assert result.expr.simplify().chunks == expected_chunks
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=1e-5)


# ---------------------------------------------------------------------------
# moments: var/std families through the decomposition + re-fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["var", "std"])
@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("keepdims", [False, True])
def test_moment_reduction_keeps_non_window_chunks(reduction, ddof, keepdims):
    data = (1 + (np.arange(96 * 32 * 48, dtype=np.float64) % 13) / 10).reshape(96, 32, 48)
    x = da.from_array(data, chunks=(24, 24, 24))

    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = getattr(windowed, reduction)(axis=-1, ddof=ddof, keepdims=keepdims)
    expected = np_ref(reduction, data, 72, ddof=ddof, keepdims=keepdims)

    expected_chunks = ((24, 1), (24, 8), (24, 24)) + (((1,),) if keepdims else ())
    assert result.expr.simplify().chunks == expected_chunks
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=1e-9)


@pytest.mark.parametrize("reduction", ["nanvar", "nanstd"])
@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("keepdims", [False, True])
def test_nan_moment_reduction_keeps_non_window_chunks(reduction, ddof, keepdims):
    data = (1 + (np.arange(96 * 32 * 48, dtype=np.float64) % 13) / 10).reshape(96, 32, 48)
    data[::7, :, :] = np.nan
    data[:80, 0, 0] = np.nan
    x = da.from_array(data, chunks=(24, 24, 24))

    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = getattr(da, reduction)(windowed, axis=-1, ddof=ddof, keepdims=keepdims)
    expected = np_ref(reduction, data, 72, ddof=ddof, keepdims=keepdims)

    expected_chunks = ((24, 1), (24, 8), (24, 24)) + (((1,),) if keepdims else ())
    assert result.expr.simplify().chunks == expected_chunks
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=1e-7, atol=1e-8, equal_nan=True)


def test_var_uses_stable_block_algorithm():
    # 1e9 offset: a naive E[x^2]-E[x]^2 in f64 would still lose ~half the
    # mantissa; the shifted power sums must not
    data = (1e9 + (np.arange(96 * 8, dtype=np.float64) % 13) / 10).reshape(96, 8)
    x = da.from_array(data, chunks=(24, 4))

    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = windowed.var(axis=-1)
    expected = np_ref("var", data, 72)

    assert result.expr.simplify().chunks == ((24, 1), (4, 4))
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=1e-7, atol=1e-8)


def test_nanvar_uses_stable_block_algorithm():
    data = (1e9 + (np.arange(96 * 8, dtype=np.float64) % 13) / 10).reshape(96, 8)
    data[::7, :] = np.nan
    x = da.from_array(data, chunks=(24, 4))

    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = da.nanvar(windowed, axis=-1)
    expected = np_ref("nanvar", data, 72)

    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=5e-7, atol=1e-8)


@pytest.mark.parametrize("data", [np.arange(8, dtype=np.float64), np.ones(8, dtype=np.float64)])
def test_var_ddof_equal_window(data):
    # n - ddof == 0: divide-by-zero semantics (inf for nonzero m2, nan for 0)
    x = da.from_array(data, chunks=4)

    windowed = da.sliding_window_view(x, window_shape=3, axis=0)
    result = windowed.var(axis=-1, ddof=3)
    expected = np_ref("var", data, 3, ddof=3)

    assert_eq(result, expected, equal_nan=True)


@pytest.mark.parametrize(
    "data, expected",
    [
        (
            np.array([np.nan, 1, 2, np.nan, 3, 4, np.nan, 5], dtype=np.float64),
            np.full(6, np.inf),
        ),
        (
            np.array([np.nan, 1, 1, np.nan, 1, 1, np.nan, 1], dtype=np.float64),
            np.full(6, np.nan),
        ),
    ],
)
def test_nanvar_ddof_equal_count(data, expected):
    x = da.from_array(data, chunks=4)

    windowed = da.sliding_window_view(x, window_shape=3, axis=0)
    result = da.nanvar(windowed, axis=-1, ddof=2)

    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, equal_nan=True)


@pytest.mark.parametrize("reduction", ["var", "nanvar", "std", "nanstd"])
def test_var_explicit_integer_dtype(reduction):
    # numpy returns the requested integer dtype (truncating); note our
    # accumulation stays float and truncates only at the end, so values
    # agree whenever the intermediate means are exact (as here)
    data = np.arange(24, dtype=np.int64) * 3
    x = da.from_array(data, chunks=8)

    windowed = da.sliding_window_view(x, window_shape=3, axis=0)
    result = getattr(da, reduction)(windowed, axis=-1, dtype="i8")
    variance = np_ref("nanvar" if reduction.startswith("nan") else "var", data, 3, dtype="i8")
    expected = np.sqrt(variance).astype("i8") if reduction.endswith("std") else variance

    assert result.dtype == expected.dtype
    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected)


def test_slice_of_fused_reduction_keeps_native_rewrite():
    data = (1 + (np.arange(96 * 8, dtype=np.float64) % 13) / 10).reshape(96, 8)
    data[::7, :] = np.nan
    x = da.from_array(data, chunks=(24, 4))

    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = da.nanvar(windowed, axis=-1)[:10]
    expected = np_ref("nanvar", data, 72)[:10]

    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, rtol=1e-9)


def test_left_padding_concat_input():
    # concatenated padding block in front: fusion still fires, values right
    window = 4
    data = np.arange(10 * 2, dtype=np.int64).reshape(10, 2)
    padding = np.full((window - 1, 2), -1, dtype=data.dtype)
    x = da.concatenate(
        [
            da.from_array(padding, chunks=(window - 1, 2)),
            da.from_array(data, chunks=(10, 2)),
        ],
        axis=0,
    )
    full_data = np.concatenate([padding, data])

    result = da.sliding_window_view(x, window_shape=window, axis=0).sum(axis=-1)
    expected = np_ref("sum", full_data, window)

    assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected)


# ---------------------------------------------------------------------------
# complex dtypes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["nansum", "nanprod", "nanmin", "nanmax", "nanmean"])
def test_nan_reduction_complex_values(reduction):
    data = np.array(
        [1 + 1j, np.nan + 2j, 3 + 3j, 4 + np.nan * 1j, 5 + 5j, 6 + 6j,
         np.nan + np.nan * 1j, 8 + 8j],
        dtype="complex128",
    )
    x = da.from_array(data, chunks=4)

    windowed = da.sliding_window_view(x, window_shape=3, axis=0)
    result = getattr(da, reduction)(windowed, axis=-1)
    expected = np_ref(reduction, data, 3)

    if reduction in ("nansum", "nanprod", "nanmean"):
        # ordering kinds decline the reduce_window fusion on complex; the
        # arithmetic kinds fuse
        assert not contains_swv(result.expr.simplify())
    assert_eq(result, expected, equal_nan=True)


@pytest.mark.parametrize("reduction", ["var", "std"])
@pytest.mark.parametrize("dtype", ["f4", "c8"])
def test_var_complex_explicit_dtype(reduction, dtype):
    data = (np.arange(24, dtype=np.float32) + 1j * np.arange(24, dtype=np.float32)).astype("complex64")
    x = da.from_array(data, chunks=8)

    windowed = da.sliding_window_view(x, window_shape=3, axis=0)
    result = getattr(windowed, reduction)(axis=-1, dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        expected = getattr(swv(data, 3), reduction)(axis=-1, dtype=dtype)

    assert result.dtype == expected.dtype
    assert_eq(result, expected, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("reduction", ["nanvar", "nanstd"])
@pytest.mark.parametrize("dtype", ["f4", "c8"])
def test_nanvar_complex_explicit_dtype(reduction, dtype):
    data = (np.arange(24, dtype=np.float32) + 1j * np.arange(24, dtype=np.float32)).astype("complex64")
    data[::5] = np.nan + 0j
    x = da.from_array(data, chunks=8)

    windowed = da.sliding_window_view(x, window_shape=3, axis=0)
    result = getattr(da, reduction)(windowed, axis=-1, dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        expected = getattr(np, reduction)(swv(data, 3), axis=-1, dtype=dtype)

    assert result.dtype == expected.dtype
    assert_eq(result, expected, rtol=1e-5, atol=1e-7, equal_nan=True)


def test_var_complex_large_offset_stays_on_stable_path():
    real = 10_000 + (np.arange(24, dtype=np.float32) % 7) / 10
    imag = (np.arange(24, dtype=np.float32) % 5) / 3
    data = (real + 1j * imag).astype("complex64")
    x = da.from_array(data, chunks=8)

    windowed = da.sliding_window_view(x, window_shape=3, axis=0)
    result = windowed.var(axis=-1, dtype="c8")
    expected = swv(data, 3).var(axis=-1, dtype="c8")

    assert result.dtype == expected.dtype
    assert_eq(result, expected, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# bottleneck move_* semantics (spine lines 99-157), numpy replica reference
# ---------------------------------------------------------------------------


def np_move(kind, data, window, min_count, axis):
    """Replica of bottleneck.move_* semantics: trailing windows, NaN-aware,
    output NaN where the valid count is below min_count (default window)."""
    x = np.moveaxis(np.asarray(data, dtype=np.float64), axis, -1)
    pad = np.full(x.shape[:-1] + (window - 1,), np.nan)
    wins = swv(np.concatenate([pad, x], axis=-1), window, axis=-1)
    cnt = (~np.isnan(wins)).sum(axis=-1)
    mc = min_count if min_count is not None else window
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fn = {"sum": np.nansum, "mean": np.nanmean, "min": np.nanmin,
              "max": np.nanmax, "var": np.nanvar, "std": np.nanstd}[kind]
        r = fn(wins, axis=-1)
    r = np.where(cnt >= mc, r, np.nan)
    return np.moveaxis(r, -1, axis)


@pytest.mark.parametrize("func,kind", [(move_sum, "sum"), (move_mean, "mean"),
                                       (move_min, "min"), (move_max, "max")])
@pytest.mark.parametrize("min_count", [1, None, 300])
def test_move_window_spanning_many_chunks(func, kind, min_count):
    # xarray's rolling path shape: window several times the chunk size,
    # NaN-heavy data including all-NaN windows
    rng = np.random.default_rng(0)
    data = rng.normal(size=(13 * 96, 4))
    data[rng.random(data.shape) < 0.2] = np.nan
    data[100:600, 2] = np.nan
    x = da.from_array(data, chunks=(96, 2))
    window = 480

    result = func(x, window, min_count=min_count, axis=0)
    expected = np_move(kind, data, window, min_count, axis=0)

    assert result.expr.optimize().chunks == x.chunks
    assert_eq(result, expected, rtol=1e-12, atol=1e-12, equal_nan=True)


def test_move_irregular_chunks():
    rng = np.random.default_rng(1)
    data = rng.normal(size=1248)
    data[rng.random(1248) < 0.2] = np.nan
    x = da.from_array(data, chunks=((100, 51, 96, 96, 200, 96, 313, 200, 96),))
    window = 400

    result = move_sum(x, window, min_count=1, axis=0)
    expected = np_move("sum", data, window, 1, axis=0)

    assert result.expr.optimize().chunks == x.chunks
    assert_eq(result, expected, rtol=1e-12, atol=1e-12, equal_nan=True)


def _compiled_hlo(expr):
    import jax

    from dask_array_tpu._executor import collect_leaves, make_compute_fn

    leaves = collect_leaves(expr)
    keys = tuple(k for k, _ in leaves)
    args = tuple(
        np.asarray(b.materialize() if hasattr(b, "materialize") else b)
        for _, b in leaves
    )
    fn = jax.jit(make_compute_fn(expr, keys, None))
    return fn.lower(*args).compile().as_text()


@pytest.mark.parametrize("reduction", ["sum", "nanmean", "nanvar"])
def test_fused_sliding_reduction_hlo_is_reduce_window(reduction):
    # the structural guarantee behind the fusion: the compiled program is
    # reduce-window over the SOURCE — no gather materializing the (n, w)
    # window matrix (same HLO-proof discipline as the rechunk collectives)
    data = np.arange(96 * 2, dtype=np.float64).reshape(96, 2)
    if reduction.startswith("nan"):
        data[::7] = np.nan
    x = da.from_array(data, chunks=(24, 2))
    result = getattr(da, reduction)(da.sliding_window_view(x, 48, axis=0), axis=-1)
    hlo = _compiled_hlo(result.expr.optimize())
    assert "reduce-window" in hlo
    assert "gather(" not in hlo and " iota" not in hlo.split("ENTRY")[0]
    expected = np_ref(reduction, data, 48)
    assert_eq(result, expected, equal_nan=True)


@pytest.mark.parametrize("func,kind", [(move_var, "var"), (move_std, "std")])
def test_move_moments_nan_heavy(func, kind):
    rng = np.random.default_rng(5)
    data = rng.normal(size=(200, 3))
    data[rng.random(data.shape) < 0.3] = np.nan
    data[20:80, 1] = np.nan
    x = da.from_array(data, chunks=(64, 2))

    result = func(x, 40, min_count=2, axis=0)
    expected = np_move(kind, data, 40, 2, axis=0)

    assert_eq(result, expected, rtol=1e-8, atol=1e-10, equal_nan=True)
