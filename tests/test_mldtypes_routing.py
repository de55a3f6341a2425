"""ml_dtypes routing: bfloat16/float8 live OUTSIDE numpy's type hierarchy
(`np.issubdtype(bfloat16, np.floating)` is False, dtype kind is 'V'), so
every kind/issubdtype gate needs the extended predicates
(`_chunks.host_only_dtype`, `_chunks.is_float_dtype`).  These tests pin the
routing decisions where a bare numpy check silently demotes bf16 to host
lanes, f64 promotion, or wrong-method fallbacks.
"""

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu._chunks import is_float_dtype


@pytest.fixture
def bf16():
    import jax.numpy as jnp

    return jnp.bfloat16


def test_is_float_dtype_table(bf16):
    import ml_dtypes

    for dt in (np.float16, np.float32, np.float64, bf16, ml_dtypes.float8_e4m3fn):
        assert is_float_dtype(dt), dt
    for dt in (np.int32, np.int64, bool, ml_dtypes.int4, "U4", object,
               np.dtype([("a", "f4")]), "datetime64[ns]", np.complex64):
        assert not is_float_dtype(dt), dt


def test_sliding_mean_keeps_bf16(bf16):
    """Moving-window reductions must not promote bf16 meta/compute to f64."""
    x = da.ones((32,), chunks=16, dtype=bf16)
    v = da.sliding_window_view(x, 8, axis=0).mean(axis=-1)
    assert np.dtype(v.dtype) == np.dtype(bf16)
    out = v.compute()
    assert np.dtype(out.dtype) == np.dtype(bf16)
    assert np.allclose(np.asarray(out, dtype=np.float32), 1.0)


def test_overlap_push_keeps_bf16(bf16):
    x = da.ones((32,), chunks=16, dtype=bf16)
    out = da.push(x, axis=0)
    assert np.dtype(out.dtype) == np.dtype(bf16)
    got = out.compute()
    assert np.dtype(got.dtype) == np.dtype(bf16)


def test_random_bf16_generates_in_float_lane(bf16):
    """dtype=bfloat16 requests must ride the float generation lane (the
    configured gen dtype), not fall to the f64 branch."""
    rng = da.random.default_rng(7)
    x = rng.standard_normal((64,), chunks=32, dtype=bf16)
    assert np.dtype(x.dtype) == np.dtype(bf16)
    vals = np.asarray(x.compute(), dtype=np.float32)
    assert np.isfinite(vals).all()
    assert vals.std() > 0.5  # actually random, not zeros


def test_percentile_bf16_is_numeric(bf16):
    """bf16 counts as numeric for the approximate-percentile method gate
    (the non-number fallback is for object/datetime inputs)."""
    x_np = np.arange(100, dtype=np.float32)
    x = da.from_array(x_np.astype(bf16), chunks=25)
    got = float(np.asarray(da.percentile(x, 50).compute(), dtype=np.float32)[0])
    assert abs(got - 49.5) <= 1.0  # bf16 resolution around 50


def test_astype_bf16_is_real_bfloat16(bf16):
    """astype must carry the dtype OBJECT: serializing via .str collapses
    bfloat16 to '<V2' (raw void), which then routed every downstream op to
    the structured host lane and broke dtype inference entirely."""
    y = da.eye(4, chunks=4).astype(bf16)
    assert np.dtype(y.dtype) == np.dtype(bf16)
    out = (y + y.T).compute()
    assert np.dtype(out.dtype) == np.dtype(bf16)
    assert float(np.asarray(out, dtype=np.float32)[0, 0]) == 2.0


def test_dtype_key_unique_across_ml_dtypes():
    """14 ml_dtypes scalars share .str '<V1'; dtype_key must keep them (and
    structured layouts of equal itemsize) distinct, or token/plan caches
    could serve a program compiled for the WRONG dtype."""
    import ml_dtypes

    from dask_array_tpu._chunks import dtype_key

    fams = ["float8_e4m3fn", "float8_e5m2", "float8_e4m3", "int4", "uint4",
            "int2", "float4_e2m1fn", "bfloat16"]
    keys = [dtype_key(np.dtype(getattr(ml_dtypes, n))) for n in fams]
    assert len(set(keys)) == len(fams)
    for k, n in zip(keys, fams):
        assert np.dtype(k) == np.dtype(getattr(ml_dtypes, n))  # round-trips
    assert dtype_key(np.dtype([("a", "f4")])) != dtype_key(np.dtype([("b", "f4")]))


def test_tokenize_distinguishes_fp8_variants():
    import ml_dtypes

    from dask_array_tpu.utils._tokenize import tokenize

    a = np.zeros(8, dtype=ml_dtypes.float8_e4m3fn)
    b = np.zeros(8, dtype=ml_dtypes.int4)
    assert tokenize(a) != tokenize(b)
    assert tokenize(np.dtype(ml_dtypes.float8_e4m3fn)) != tokenize(np.dtype(ml_dtypes.uint4))


def test_from_array_bf16_singletons_not_aliased(bf16):
    """Same-bytes arrays of different ml_dtypes must build DISTINCT leaves."""
    raw = np.zeros(8, dtype=np.uint16)
    x = da.from_array(raw.view(bf16), chunks=4)
    import ml_dtypes

    y = da.from_array(raw.view(ml_dtypes.float8_e4m3fn).reshape(8, 2)[:, 0], chunks=4)
    assert x.expr._name != y.expr._name


def test_npy_stack_bf16_round_trip(bf16, tmp_path):
    """np.save writes bfloat16 as a raw-void descr; the loader re-views with
    the pickled logical dtype (reading used to poison the trace with a
    void-dtype numpy leaf)."""
    x = da.full((8, 8), 3, chunks=4, dtype=bf16)
    da.to_npy_stack(str(tmp_path / "n"), x, axis=0)
    back = da.from_npy_stack(str(tmp_path / "n"))
    assert np.dtype(back.dtype) == np.dtype(bf16)
    out = back.compute()
    assert np.dtype(out.dtype) == np.dtype(bf16)
    assert np.allclose(np.asarray(out, dtype=np.float32), 3.0)


def test_zarr_bf16_round_trip(bf16, tmp_path):
    """zarr v2 stores the raw void descr; the logical dtype rides .zattrs
    (real zarr readers still see plain 2-byte void data)."""
    x = da.full((8, 8), 5, chunks=4, dtype=bf16)
    da.to_zarr(x, str(tmp_path / "z"))
    back = da.from_zarr(str(tmp_path / "z"))
    assert np.dtype(back.dtype) == np.dtype(bf16)
    out = back.compute()
    assert np.dtype(out.dtype) == np.dtype(bf16)
    assert np.allclose(np.asarray(out, dtype=np.float32), 5.0)


def test_linalg_bf16_promotes_to_f32_not_f64(bf16):
    """Factorizations of bf16 inputs promote to f32, not f64; numpy's own
    LAPACK refuses sub-f32 floats outright, so f32 is both the capability
    extension and the fast lane."""
    rng = np.random.default_rng(11)
    a_np = rng.standard_normal((16, 8)).astype(np.float32)
    a = da.from_array(a_np.astype(bf16), chunks=(8, 8))
    q, r = da.linalg.qr(a)
    assert np.dtype(q.dtype) == np.dtype("f4")
    got = np.asarray((q @ r).compute(), dtype=np.float32)
    assert np.allclose(got, a_np, atol=0.15)  # bf16 input resolution


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["sum", "mean", "nansum"])
def test_subf32_reductions_accumulate_in_f32(bf16, dt, kind):
    """Sub-f32 float reductions keep the numpy OUTPUT dtype but accumulate
    in f32: a bf16 accumulator stalls once the partial's ulp exceeds the
    addend (64x64 of 256.0 plateaus at 2^19 instead of 2^20), and numpy's
    own sub-f32 accumulation is strictly less accurate — never more."""
    import jax.numpy as jnp

    dtype = jnp.bfloat16 if dt == "bfloat16" else np.float16
    if dt == "float16" and kind != "sum":
        pytest.skip("one dtype x all kinds and one kind x all dtypes suffice")
    fill = 256.0 if dt == "bfloat16" else 0.25  # f16 max is 65504
    x = da.full((64, 64), fill, chunks=16, dtype=dtype)
    out = getattr(da, kind)(x).compute()
    assert np.dtype(out.dtype) == np.dtype(dtype)
    expect = fill if kind == "mean" else fill * 64 * 64
    assert float(np.asarray(out, dtype=np.float64)) == expect
