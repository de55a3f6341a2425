"""Out-of-core block-streaming execution lane (round-4 verdict gap #2).

Pins: engagement policy (auto budget threshold / force / off), panel
pushdown boundedness, single-compile key discipline, map-stream assembly,
reduce-stream combines (incl. mean/nanmean decomposition), resident-leaf
pinning, and the decline matrix (irregular grids, unknown chunks, masked,
Barrier splits).  CPU lane: budgets are set explicitly per test.

Reference bar: bounded-memory streaming via scheduler + expected-nbytes
stamps (``/root/reference/dask_array/_frisky/collect.py:154-182``,
``io/_store.py:168``).
"""

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu import config
from dask_array_tpu._streaming import STREAMED, maybe_stream


def _force():
    return config.set({"tpu.out-of-core": "force"})


def _spy(fn):
    before = dict(STREAMED)
    out = fn()
    return out, {k: STREAMED[k] - before[k] for k in STREAMED}


# ---------------------------------------------------------------------------
# map-stream
# ---------------------------------------------------------------------------


def test_map_stream_elemwise_values_and_panels():
    src = np.random.default_rng(0).standard_normal((64, 6))
    x = da.from_array(src, chunks=(8, 6))
    with _force():
        out, d = _spy(lambda: (x * 2 + 1).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(out, src * 2 + 1, rtol=1e-12)
    assert isinstance(out, np.ndarray)


def test_map_stream_budget_bounds_panel_height():
    # 64 rows x 8 cols f64 = 4096 B; a ~1.5 KiB budget must split into
    # several panels (each panel's leaf+output bytes within budget)
    src = np.arange(64 * 8, dtype="f8").reshape(64, 8)
    x = da.from_array(src, chunks=(4, 8))
    with config.set({"tpu.out-of-core": "force", "tpu.memory-budget": 1536}):
        out, d = _spy(lambda: (x + 1).compute())
    assert d["panels"] >= 4
    np.testing.assert_array_equal(out, src + 1)


def test_auto_engages_only_above_budget():
    src = np.ones((32, 4))
    x = da.from_array(src, chunks=(4, 4))
    with config.set({"tpu.out-of-core": "auto", "tpu.memory-budget": "1 GiB"}):
        _, d = _spy(lambda: (x * 3).compute())
    assert d["count"] == 0  # fits: normal lane
    with config.set({"tpu.out-of-core": "auto", "tpu.memory-budget": 512}):
        out, d = _spy(lambda: (x * 3).compute())
    assert d["count"] == 1
    np.testing.assert_array_equal(out, src * 3)


def test_off_never_engages():
    src = np.ones((32, 4))
    x = da.from_array(src, chunks=(4, 4))
    with config.set({"tpu.out-of-core": "off", "tpu.memory-budget": 64}):
        _, d = _spy(lambda: (x * 3).compute())
    assert d["count"] == 0


def test_map_stream_matmul_panel_sweep_pins_rhs():
    # the classic out-of-core GEMM: row panels of A stream, B pins
    # device-resident once (not re-shipped per panel)
    rng = np.random.default_rng(1)
    a_np = rng.standard_normal((96, 24)).astype(np.float32)
    b_np = rng.standard_normal((24, 5)).astype(np.float32)
    a = da.from_array(a_np, chunks=(8, 24))
    with _force():
        out, d = _spy(lambda: (a @ b_np).compute())
    assert d["count"] == 1 and d["panels"] >= 2 and d["pinned"] >= 1
    np.testing.assert_allclose(out, a_np @ b_np, rtol=1e-4, atol=1e-4)


def test_map_stream_reduction_over_other_axis():
    # x.sum(axis=1): output keeps the chunked row axis -> map-stream over
    # rows, the slice pushes THROUGH the reduction
    src = np.random.default_rng(2).standard_normal((48, 16))
    x = da.from_array(src, chunks=(6, 8))
    with _force():
        out, d = _spy(lambda: x.sum(axis=1).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(out, src.sum(axis=1), rtol=1e-10)


def test_map_stream_stencil_halos_read_correctly():
    # slice-through-overlap pushdown gives each panel its halo rows: the
    # panel boundary is invisible in the result
    import jax.numpy as jnp

    src = np.random.default_rng(3).standard_normal((40, 12)).astype("f4")
    x = da.from_array(src, chunks=(5, 12))

    def laplace(blk):
        return (
            jnp.roll(blk, 1, 0) + jnp.roll(blk, -1, 0)
            + jnp.roll(blk, 1, 1) + jnp.roll(blk, -1, 1) - 4 * blk
        )

    st = da.map_overlap(laplace, x, depth=1, boundary="reflect", dtype="f4")
    with _force():
        out, d = _spy(lambda: st.compute())
    assert d["count"] == 1 and d["panels"] >= 2
    pad = np.pad(src, 1, mode="symmetric")
    want = (
        pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:]
        - 4 * src
    )
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_map_stream_tail_panel():
    # irregular TAIL height is allowed (one extra compile, not a storm)
    src = np.random.default_rng(4).standard_normal((30, 4))
    x = da.from_array(src, chunks=((8, 8, 8, 6), 4))
    with _force():
        out, d = _spy(lambda: (x - 1).compute())
    assert d["count"] == 1
    np.testing.assert_allclose(out, src - 1, rtol=1e-12)


# ---------------------------------------------------------------------------
# reduce-stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kind,np_fn",
    [
        ("sum", np.sum),
        ("prod", np.prod),
        ("min", np.min),
        ("max", np.max),
        ("mean", np.mean),
    ],
)
def test_reduce_stream_full(kind, np_fn):
    src = np.random.default_rng(5).standard_normal((40, 6)) * 0.9
    x = da.from_array(src, chunks=(5, 6))
    with _force():
        out, d = _spy(lambda: getattr(x, kind)().compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(float(out), np_fn(src), rtol=1e-8)


@pytest.mark.parametrize(
    "kind,np_fn",
    [
        ("nansum", np.nansum),
        ("nanmin", np.nanmin),
        ("nanmax", np.nanmax),
        ("nanmean", np.nanmean),
    ],
)
def test_reduce_stream_nan_kinds(kind, np_fn):
    src = np.random.default_rng(6).standard_normal((40, 6))
    src[::3, ::2] = np.nan
    src[0:5] = np.nan  # an ALL-NaN panel: its partial must lose the combine
    x = da.from_array(src, chunks=(5, 6))
    with _force():
        out, d = _spy(lambda: getattr(da, kind)(x).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(float(out), np_fn(src), rtol=1e-8)


def test_reduce_stream_any_all():
    src = np.zeros((24, 4), dtype=bool)
    src[17, 2] = True
    x = da.from_array(src, chunks=(4, 4))
    with _force():
        o1, d1 = _spy(lambda: x.any().compute())
        o2, d2 = _spy(lambda: x.all().compute())
    assert d1["count"] == 1 and d2["count"] == 1
    assert bool(o1) is True and bool(o2) is False


def test_reduce_stream_axis0_keeps_columns():
    src = np.random.default_rng(7).standard_normal((40, 8))
    x = da.from_array(src, chunks=(5, 8))
    with _force():
        out, d = _spy(lambda: x.sum(axis=0).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(out, src.sum(axis=0), rtol=1e-10)


def test_reduce_stream_mean_elemwise_tree():
    # the reduction terminal sits above an elemwise tree: panels stream
    # the leaves, the tree evaluates per panel
    src = np.random.default_rng(8).standard_normal((36, 4))
    x = da.from_array(src, chunks=(6, 4))
    with _force():
        out, d = _spy(lambda: ((x * x) + 1).mean().compute())
    assert d["count"] == 1
    np.testing.assert_allclose(float(out), ((src * src) + 1).mean(), rtol=1e-8)


# ---------------------------------------------------------------------------
# decline matrix: the planner must prove boundedness or stand down
# ---------------------------------------------------------------------------


def test_irregular_grid_declines_but_computes():
    src = np.random.default_rng(9).standard_normal((30, 30))
    x = da.from_array(src, chunks=((7, 11, 3, 9), (13, 4, 9, 4)))
    with _force():
        out, d = _spy(lambda: (x + 2).compute())
    assert d["count"] == 0  # no regular axis: normal lane answers
    np.testing.assert_allclose(out, src + 2, rtol=1e-12)


def test_unknown_chunks_decline():
    src = np.arange(40.0)
    x = da.from_array(src, chunks=(5,))
    with _force():
        out, d = _spy(lambda: x[x > 10].compute())
    assert d["count"] == 0
    np.testing.assert_array_equal(out, src[src > 10])


def test_masked_declines():
    src = np.ma.masked_array(np.arange(24.0), np.arange(24) % 5 == 0)
    x = da.from_array(src, chunks=(4,))
    with _force():
        out, d = _spy(lambda: (x + 1).compute())
    assert d["count"] == 0
    assert isinstance(out, np.ma.MaskedArray)


def test_barrier_splits_stream_inside_not_across():
    src = np.random.default_rng(10).standard_normal((32, 4))
    x = da.from_array(src, chunks=(4, 4))
    y = da.barrier(x * 2) + 1
    with _force():
        # the OUTER program never streams across the split point (its
        # subtree would compute whole on device during leaf collection) ...
        assert maybe_stream(y.expr) is None
        # ... but the barrier's own inner compute may stream its subtree
        out, d = _spy(lambda: y.compute())
    np.testing.assert_allclose(out, src * 2 + 1, rtol=1e-12)


def test_var_declines_but_computes():
    # var has no streamed decomposition yet: documented decline
    src = np.random.default_rng(11).standard_normal((32, 4))
    x = da.from_array(src, chunks=(4, 4))
    with _force():
        out, d = _spy(lambda: x.var().compute())
    assert d["count"] == 0
    np.testing.assert_allclose(float(out), src.var(), rtol=1e-8)


def test_single_chunk_axis_declines():
    src = np.random.default_rng(12).standard_normal((8, 8))
    x = da.from_array(src, chunks=(8, 8))
    with _force():
        out, d = _spy(lambda: (x * 2).compute())
    assert d["count"] == 0
    np.testing.assert_allclose(out, src * 2, rtol=1e-12)


def test_memmap_leaf_streams_from_disk(tmp_path):
    # the leaf region defers all the way to the memmap: each panel reads
    # only its rows from disk (no whole-file materialization)
    path = tmp_path / "big.npy"
    src = np.random.default_rng(13).standard_normal((64, 8))
    np.save(path, src)
    mm = np.load(path, mmap_mode="r")
    x = da.from_array(mm, chunks=(8, 8))
    with _force():
        out, d = _spy(lambda: (x + 0.5).compute())
    assert d["count"] == 1 and d["panels"] >= 2
    np.testing.assert_allclose(out, src + 0.5, rtol=1e-12)


def test_maybe_stream_none_means_untouched():
    # the planner must not leave side effects when it declines
    src = np.ones((4, 4))
    x = da.from_array(src, chunks=(4, 4))
    with _force():
        assert maybe_stream(x.expr) is None


# ---------------------------------------------------------------------------
# automatic budget
# ---------------------------------------------------------------------------


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _auto_budget(monkeypatch, dev):
    import jax

    from dask_array_tpu import _streaming

    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    with config.set({"tpu.memory-budget": "auto"}):
        return _streaming._budget()


@pytest.mark.parametrize("limit", [16 * 2**30, 60 * 2**30])
def test_auto_budget_is_device_limit_less_headroom(monkeypatch, limit):
    from dask_array_tpu._streaming import _HEADROOM

    got = _auto_budget(monkeypatch, _FakeDevice("gpu", {"bytes_limit": limit}))
    assert got == int(limit * (1 - _HEADROOM))
    assert 0 < got < limit


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_auto_budget_without_memory_stats_is_an_error(monkeypatch, stats):
    with pytest.raises(RuntimeError, match="no memory limit"):
        _auto_budget(monkeypatch, _FakeDevice("gpu", stats))


def test_auto_budget_cpu_host_never_engages(monkeypatch):
    assert _auto_budget(monkeypatch, _FakeDevice("cpu", None)) == 1 << 62


def test_explicit_budget_overrides_device(monkeypatch):
    import jax

    from dask_array_tpu import _streaming

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice("gpu", None)])
    with config.set({"tpu.memory-budget": "1 GiB"}):
        assert _streaming._budget() == 2**30
