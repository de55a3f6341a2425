"""Rechunk-as-collective: the executor must emit a real all-to-all.

VERDICT round-1 item 1: a rechunk that moves the sharded mesh axis between
array axes must lower to an ``all-to-all`` HLO (bisection-bandwidth
optimal), NOT an all-gather + dynamic-slice (full replication through HBM),
and the multi-stage schedule must drive execution.  Parity target:
``/root/reference/dask_array/_rechunk.py:442-638,1326`` (plan_rechunk /
_choose_rechunk_method / P2PRechunk).
"""

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu import config
from dask_array_tpu._diagnostics import compiled_hlo
from dask_array_tpu._test_utils import assert_eq
from dask_array_tpu.parallel import use_mesh


@pytest.fixture
def rng():
    return np.random.default_rng(3)


@pytest.fixture
def ring8():
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices("cpu")[:8])
    return Mesh(devs, ("r",))


@pytest.fixture
def mesh2x4():
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices("cpu")[:8]).reshape(2, 4)
    return Mesh(devs, ("x", "y"))


def _axis_move_case(rng):
    """Rows-sharded -> cols-sharded: the canonical all-to-all relayout.

    The producer is a scan (cumsum) so the optimizer cannot absorb the
    rechunk into the IO leaf — the layout change must actually execute.
    """
    x = rng.standard_normal((256, 256))
    d = da.from_array(x, chunks=(32, 256))  # 8 row blocks -> mesh axis on rows
    s = d.cumsum(axis=1)  # scan along the UNSHARDED axis: fully local
    r = s.rechunk((256, 32))  # 8 col blocks -> mesh axis on cols
    return np.cumsum(x, axis=1), d, r


def test_rechunk_axis_move_emits_all_to_all(ring8, rng):
    x, d, r = _axis_move_case(rng)
    with use_mesh(ring8):
        hlo = compiled_hlo(r + 0.0)
    assert "all-to-all" in hlo, "axis-moving rechunk must lower to all-to-all"
    # the explicit schedule must not degrade to replicate-then-slice
    assert "all-gather" not in hlo


def test_rechunk_axis_move_values(ring8, rng):
    x, d, r = _axis_move_case(rng)
    out = r * 2.0
    with use_mesh(ring8):
        assert_eq(out, x * 2.0)


def test_rechunk_tasks_method_still_correct(ring8, rng):
    x, d, r = _axis_move_case(rng)
    with config.set({"array.rechunk.method": "tasks"}):
        with use_mesh(ring8):
            assert_eq(r, x)


def test_rechunk_no_move_emits_no_collective(ring8, rng):
    # merging row blocks while rows stay the sharded axis: local reslicing
    x0 = rng.standard_normal((256, 64))
    d = da.from_array(x0, chunks=(16, 64))
    x = np.cumsum(x0, axis=1)
    r = d.cumsum(axis=1).rechunk((32, 64))
    with use_mesh(ring8):
        hlo = compiled_hlo(r + 0.0)
    assert "all-to-all" not in hlo
    with use_mesh(ring8):
        assert_eq(r, x)


def test_rechunk_2d_mesh_chain_move(mesh2x4, rng):
    # 3-D case: y moves from axis 1 to the FREE axis 2 (acyclic chain) —
    # the explicit staged schedule applies
    x = rng.standard_normal((4, 64, 64))
    d = da.from_array(x, chunks=(2, 16, 64))  # x(2) on axis0, y(4) on axis1
    s = d.cumsum(axis=2)
    r = s.rechunk((2, 64, 16))  # y -> axis 2
    with use_mesh(mesh2x4):
        hlo = compiled_hlo(r + 0.0)
        assert "all-to-all" in hlo
        assert_eq(r, np.cumsum(x, axis=2))


def test_rechunk_2d_mesh_swap_explicit_no_allgather(mesh2x4, rng):
    # cyclic swap (x<->y trade axes): the 3-stage nested-sharding schedule
    # (swap_reshard) owns the boundary — values exact AND the rechunk adds
    # ZERO all-gathers over the scan-only baseline (GSPMD's generic swap
    # schedule adds 3 on this mesh)
    x0 = rng.standard_normal((64, 128))
    d = da.from_array(x0, chunks=(32, 32))  # x(2) on rows, y(4) on cols
    x = np.cumsum(x0, axis=1)
    r = d.cumsum(axis=1).rechunk((16, 64))  # -> y on rows, x on cols
    with use_mesh(mesh2x4):
        base = compiled_hlo(d.cumsum(axis=1) + 0.0)
        hlo = compiled_hlo(r + 0.0)
        assert hlo.count("all-gather") == base.count("all-gather")
        assert "all-to-all" in hlo
        assert_eq(r, x)


def test_swap_reshard_square_single_permute(rng):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from dask_array_tpu.parallel.collectives import swap_reshard

    mesh = Mesh(np.asarray(jax.devices("cpu")[:4]).reshape(2, 2), ("x", "y"))
    a = jax.device_put(
        jnp.asarray(rng.standard_normal((64, 128))), NamedSharding(mesh, P("x", "y"))
    )
    out = swap_reshard(a, mesh, "x", "y", 0, 1)
    assert out.sharding.spec == P("y", "x")
    np.testing.assert_allclose(np.asarray(out), np.asarray(a))
    hlo = jax.jit(lambda v: swap_reshard(v, mesh, "x", "y", 0, 1)).lower(a).compile().as_text()
    # square swap = whole-shard permute: NO all-gather, NO all-to-all
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo
    assert "all-to-all" not in hlo


def test_swap_reshard_nonsquare_no_allgather(rng):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from dask_array_tpu.parallel.collectives import swap_reshard

    mesh = Mesh(np.asarray(jax.devices("cpu")[:8]).reshape(2, 4), ("x", "y"))
    a = jax.device_put(
        jnp.asarray(rng.standard_normal((64, 128))), NamedSharding(mesh, P("x", "y"))
    )
    for roles in (("x", "y", 0, 1), ("y", "x", 1, 0)):
        out = swap_reshard(a, mesh, *roles)
        assert out.sharding.spec == P("y", "x")
        np.testing.assert_allclose(np.asarray(out), np.asarray(a))
    hlo = jax.jit(lambda v: swap_reshard(v, mesh, "x", "y", 0, 1)).lower(a).compile().as_text()
    assert "all-gather" not in hlo
    assert "all-to-all" in hlo


def test_swap_reshard_indivisible_declines(rng):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from dask_array_tpu.parallel.collectives import swap_reshard

    mesh = Mesh(np.asarray(jax.devices("cpu")[:8]).reshape(2, 4), ("x", "y"))
    # cols = 8 shards under nested (y,x) needs % 8 == 0; 12 cols fails
    a = jax.device_put(
        jnp.asarray(rng.standard_normal((8, 12))), NamedSharding(mesh, P("x", "y"))
    )
    assert swap_reshard(a, mesh, "x", "y", 0, 1) is None


def test_choose_rechunk_method_mesh(ring8):
    from dask_array_tpu._rechunk import _choose_rechunk_method

    old = ((32,) * 8, (256,))
    new = ((256,), (32,) * 8)
    assert _choose_rechunk_method(old, new, mesh=ring8) == "collective"
    # same-axis merge: no move
    old2 = ((16,) * 16, (64,))
    new2 = ((32,) * 8, (64,))
    assert _choose_rechunk_method(old2, new2, mesh=ring8) == "tasks"


def test_rechunk_collective_pipeline_end_to_end(ring8, rng):
    # relayout in the middle of a pipeline: reduce over the new layout
    x = rng.standard_normal((256, 256))
    d = da.from_array(x, chunks=(32, 256))
    out = d.cumsum(axis=1).rechunk((256, 32)).sum(axis=0)
    with use_mesh(ring8):
        assert_eq(out, np.cumsum(x, axis=1).sum(axis=0))


def test_alltoall_reshard_keeps_other_axes_sharded(mesh2x4, rng):
    """spec= carries non-moving mesh axes through the exchange."""
    import jax

    from dask_array_tpu.parallel.collectives import alltoall_reshard

    x = np.arange(64 * 64, dtype="f8").reshape(64, 64)
    from jax.sharding import NamedSharding, PartitionSpec as P

    xs = jax.device_put(x, NamedSharding(mesh2x4, P("x", "y")))
    # move y from axis 1 to axis 0 while x stays on axis 0? -> collision;
    # instead: 3-D case, move y from axis 1 to axis 2, x pinned on axis 0
    z = np.arange(4 * 8 * 8, dtype="f8").reshape(4, 8, 8)
    zs = jax.device_put(z, NamedSharding(mesh2x4, P("x", "y", None)))
    out = alltoall_reshard(zs, mesh2x4, "y", from_axis=1, to_axis=2, spec=["x", "y", None])
    np.testing.assert_allclose(np.asarray(out), z)
    assert out.sharding.spec == P("x", None, "y")


def test_rechunk_square_mesh_swap_end_to_end(rng):
    # chunk-grid regularity flips the layout planner's assignment between
    # equal-sized mesh axes -> a pure swap cycle -> single whole-shard
    # permute stage (no all-gather added over the scan-only baseline)
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices("cpu")[:4]).reshape(2, 2), ("x", "y"))
    x1 = rng.standard_normal((64, 128))
    d1 = da.from_array(x1, chunks=(32, (100, 28)))  # irregular cols
    r1 = d1.cumsum(axis=1).freeze_chunks().rechunk(((50, 14), 64))
    with use_mesh(mesh):
        base = compiled_hlo(d1.cumsum(axis=1) + 0.0)
        hlo = compiled_hlo(r1 + 0.0)
        assert hlo.count("all-gather") == base.count("all-gather")
        assert "collective-permute" in hlo
        assert_eq(r1 + 0.0, np.cumsum(x1, axis=1))
