"""Stable-identity + random behavioral contracts from the reference spines
``tests/test_stable_names.py`` and ``tests/test_random.py``, re-expressed
against this runtime's identity model (content-addressed expressions, raw
root names pinned on collections, persist via device buffers; the
records/dask-protocol halves are N/A — planrec plays that role, proven in
tests/test_planrec.py).
"""

import subprocess
import sys

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu._test_utils import assert_eq


@pytest.fixture
def arr():
    x = da.ones((10, 10), chunks=(5, 5)) + 1
    return (x * 2).sum(axis=0)


def test_name_is_cheap_never_optimizes(arr):
    import dask_array_tpu._materialize as mat

    calls = 0
    orig = mat.optimize_expr

    def counting(*a, **k):
        nonlocal calls
        calls += 1
        return orig(*a, **k)

    mat.optimize_expr = counting
    try:
        assert arr.name == arr.expr._name
        _ = arr.name
        assert calls == 0
    finally:
        mat.optimize_expr = orig


def test_compute_entry_points_agree(arr):
    expected = np.full((10,), 40.0)
    (via_many,) = da.compute(arr)
    np.testing.assert_array_equal(np.asarray(via_many), expected)
    np.testing.assert_array_equal(np.asarray(arr.compute()), expected)


def test_persist_preserves_name_and_composes(arr):
    p = arr.persist()
    assert p.name == arr.name
    assert_eq(p, np.full((10,), 40.0))
    p2 = p.persist()
    assert p2.name == p.name == arr.name
    np.testing.assert_array_equal(np.asarray((p + 1).compute()), np.full((10,), 41.0))
    assert float(p.sum().compute()) == float(arr.sum().compute())


def test_compute_after_persist_of_same_expression(arr):
    # persisting must not poison shared caches for later trees over the
    # same raw subtree
    arr.persist()
    assert float(arr.sum().compute()) == 400.0


def test_optimization_changing_chunks_is_bridged():
    # the sliding-window fusion rewrite changes the plan's chunking; the
    # collection must still deliver its advertised chunks
    data = np.arange(96.0 * 8).reshape(96, 8)
    x = da.from_array(data, chunks=(24, 4))
    windowed = da.sliding_window_view(x, window_shape=72, axis=0)
    result = windowed.var(axis=-1)
    out = np.asarray(result.compute())
    expected = np.lib.stride_tricks.sliding_window_view(data, 72, axis=0).var(axis=-1)
    np.testing.assert_allclose(out, expected, rtol=1e-10)
    assert out.shape == result.shape


def test_optimize_roundtrip_keeps_chunks():
    x = da.from_array(np.arange(12), chunks=3).rechunk((4,))
    optimized = x.optimize()
    assert_eq(optimized, np.arange(12))
    assert optimized.chunks == ((4, 4, 4),)


def test_zero_dim_identity(arr):
    s = arr.sum()
    assert s.shape == ()
    assert s.name == s.expr._name
    assert float(s.compute()) == 400.0


# ---------------------------------------------------------------------------
# random behavioral contract (reference test_random.py): deterministic on
# recompute, seed-controlled, independent blocks, sane moments
# ---------------------------------------------------------------------------


def test_random_deterministic_on_recompute():
    x = da.random.random((100, 100), chunks=(50, 50))
    assert np.array_equal(np.asarray(x.compute()), np.asarray(x.compute()))


def test_random_seed_is_reproducible():
    a = da.random.RandomState(42).random((100, 100), chunks=(50, 50))
    b = da.random.RandomState(42).random((100, 100), chunks=(50, 50))
    c = da.random.RandomState(43).random((100, 100), chunks=(50, 50))
    assert np.array_equal(np.asarray(a.compute()), np.asarray(b.compute()))
    assert not np.array_equal(np.asarray(a.compute()), np.asarray(c.compute()))


def test_random_seed_reproducible_across_processes():
    code = (
        "import numpy as np, dask_array_tpu as da\n"
        "v = da.random.RandomState(42).random((10,), chunks=5).compute()\n"
        "print(','.join(f'{x:.17g}' for x in np.asarray(v)))\n"
    )
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = []
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert r.returncode == 0, r.stderr[-500:]
        outs.append(r.stdout.strip())
    assert outs[0] == outs[1] != ""


def test_random_blocks_are_independent():
    x = np.asarray(da.random.RandomState(0).random((200, 200), chunks=(40, 40)).compute())
    blocks = [x[i:i + 40, j:j + 40].ravel() for i in range(0, 200, 40) for j in range(0, 200, 40)]
    corr = np.corrcoef(np.array(blocks))
    off_diag = corr[~np.eye(len(blocks), dtype=bool)]
    assert np.abs(off_diag).max() < 0.2


def test_random_chunk_grid_does_not_change_values():
    # STRONGER than the reference: values are a pure function of the seed
    # and shape — the chunk grid does not participate (whole-array keyed
    # generation, docs/inventory.md §2.3)
    a = da.random.RandomState(5).random((60, 60), chunks=(30, 30))
    b = da.random.RandomState(5).random((60, 60), chunks=(20, 60))
    assert np.array_equal(np.asarray(a.compute()), np.asarray(b.compute()))


@pytest.mark.parametrize(
    "build",
    [
        lambda: da.random.normal(10.0, 2.0, size=(20000,), chunks=5000),
        lambda: da.random.poisson(3.0, size=(20000,), chunks=5000),
        lambda: da.random.random((20000,), chunks=5000),
    ],
)
def test_random_distributions_unchanged_shape_and_stats(build):
    v = np.asarray(build().compute())
    assert v.shape == (20000,)
    assert np.isfinite(v).all()


def test_choice_deterministic_and_seeded():
    x = da.random.choice(100, size=(300,), chunks=100)
    assert np.array_equal(np.asarray(x.compute()), np.asarray(x.compute()))
    a = da.random.RandomState(7).choice(100, size=(500,), chunks=500)
    b = da.random.RandomState(7).choice(100, size=(500,), chunks=500)
    c = da.random.RandomState(8).choice(100, size=(500,), chunks=500)
    assert np.array_equal(np.asarray(a.compute()), np.asarray(b.compute()))
    assert not np.array_equal(np.asarray(a.compute()), np.asarray(c.compute()))


def test_choice_array_with_p():
    population = da.from_array(np.arange(20) * 10, chunks=20)
    p = np.ones(20) / 20
    x = da.random.choice(population, size=(300,), chunks=100, p=p)
    v = np.asarray(x.compute())
    assert v.shape == (300,)
    assert set(np.unique(v)).issubset(set((np.arange(20) * 10).tolist()))
