"""Multi-slice (DCN) topology discipline.

Multi-slice pods connect slices over DCN, ~10-100x slower than
intra-slice ICI.  The framework's discipline (SURVEY.md §2.6 "multi-pod /
DCN", scaling-book data-parallel-over-DCN recipe):

- ``multislice_mesh`` builds a mesh with a leading ``dcn`` axis;
- ``plan_layout`` pins DCN axes to a STABLE chunk-grid-independent array
  axis (and lets ICI axes nest under them), so rechunk relayouts move data
  over ICI only;
- ``mesh_collective_relayout`` schedules any unavoidable DCN stage last;
- ``halo_exchange`` over a nested ``("dcn", "x")`` group crosses DCN only
  at the ``n_slices - 1`` slice-boundary pairs.

The reference's analog is its p2p/tasks rechunk split tuned for worker
networks (``/root/reference/dask_array/_rechunk.py:563``); DCN staging has
no direct reference counterpart (its clusters are flat).
"""

import re

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu import config
from dask_array_tpu._diagnostics import compiled_hlo
from dask_array_tpu._test_utils import assert_eq
from dask_array_tpu.parallel import dcn_axis_names, multislice_mesh, use_mesh
from dask_array_tpu.parallel.collectives import halo_exchange, mesh_collective_relayout
from dask_array_tpu.parallel.layout import plan_layout


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _devices(n=8):
    import jax

    return jax.devices("cpu")[:n]


@pytest.fixture
def mesh_dcn2x4():
    from jax.sharding import Mesh

    return Mesh(np.asarray(_devices()).reshape(2, 4), ("dcn", "x"))


def test_multislice_mesh_constructor():
    m = multislice_mesh(2, devices=_devices())
    assert tuple(m.shape.keys())[0] == "dcn"
    assert m.shape["dcn"] == 2
    assert int(np.prod(list(m.shape.values()))) == 8
    m4 = multislice_mesh(4, devices=_devices())
    assert m4.shape["dcn"] == 4 and m4.shape["x"] == 2


def test_multislice_mesh_bad_split():
    with pytest.raises(ValueError):
        multislice_mesh(3, devices=_devices(8))


def test_dcn_axis_names_detection(mesh_dcn2x4):
    assert dcn_axis_names(mesh_dcn2x4) == {"dcn"}
    m = multislice_mesh(2, devices=_devices())
    assert dcn_axis_names(m) == {"dcn"}
    with config.set({"tpu.dcn-axes": ("x",)}):
        assert dcn_axis_names(mesh_dcn2x4) == {"x"}


def test_plan_layout_dcn_stable_across_grids(mesh_dcn2x4):
    # the DCN assignment must NOT depend on the chunk grid: rows-chunked and
    # cols-chunked grids agree on where 'dcn' lives, so a rechunk between
    # them moves zero bytes across slices
    rows = plan_layout((256, 256), ((32,) * 8, (256,)), mesh_dcn2x4)
    cols = plan_layout((256, 256), ((256,), (32,) * 8), mesh_dcn2x4)
    assert rows[0] in ("dcn", ("dcn", "x")) and rows[1] is None
    assert cols[0] == "dcn" and cols[1] == "x"


def test_plan_layout_nests_ici_under_dcn(mesh_dcn2x4):
    # an 8-block leading grid on a (dcn=2, x=4) mesh wants all 8 devices on
    # that axis: the ICI axis nests as the minor divisor
    spec = plan_layout((256, 256), ((32,) * 8, (256,)), mesh_dcn2x4)
    assert spec[0] == ("dcn", "x")


def test_plan_layout_no_nesting_without_dcn():
    # DCN-free meshes keep the one-mesh-axis-per-array-axis rule
    from jax.sharding import Mesh

    m = Mesh(np.asarray(_devices()).reshape(2, 4), ("a", "b"))
    spec = plan_layout((256, 256), ((32,) * 8, (256,)), m)
    assert all(not isinstance(s, tuple) for s in spec)


def _groups_intra_slice(hlo, n_devices=8, n_slices=2):
    """Every explicit all-to-all replica group stays within one slice."""
    per = n_devices // n_slices
    ok = True
    found = False
    for m in re.finditer(r"all-to-all[^\n]*replica_groups=\{([^}]*(?:\},\{[^}]*)*)\}\}", hlo):
        found = True
        body = m.group(1)
        for grp in body.split("},{"):
            ids = [int(v) for v in re.findall(r"\d+", grp)]
            if len({i // per for i in ids}) > 1:
                ok = False
    # iota form: replica_groups=[4,2]<=[8] etc. — groups of stride 1 within
    # slices iff the minor dimension divides per-slice count; check pairs
    for m in re.finditer(r"all-to-all[^\n]*replica_groups=\[(\d+),(\d+)\]<=\[(\d+)\]", hlo):
        found = True
        ngroups, gsize = int(m.group(1)), int(m.group(2))
        # contiguous linearisation: group g = [g*gsize, (g+1)*gsize)
        for g in range(ngroups):
            ids = range(g * gsize, (g + 1) * gsize)
            if len({i // per for i in ids}) > 1:
                ok = False
    return found, ok


def test_relayout_rows_to_cols_no_dcn_traffic(mesh_dcn2x4, rng):
    # rows-sharded P(('dcn','x')) -> cols-sharded P('dcn','x'): only the
    # ICI axis moves; the all-to-all groups must be intra-slice and no
    # all-gather may appear
    x = rng.standard_normal((256, 256))
    d = da.from_array(x, chunks=(32, 256))
    r = d.cumsum(axis=1).rechunk((256, 32))
    with use_mesh(mesh_dcn2x4):
        hlo = compiled_hlo(r + 0.0)
    assert "all-gather" not in hlo
    found, intra = _groups_intra_slice(hlo)
    assert found, "expected an explicit all-to-all relayout"
    assert intra, "relayout crossed the DCN slice boundary"
    with use_mesh(mesh_dcn2x4):
        assert_eq(r + 0.0, np.cumsum(x, axis=1), check_chunks=False)


def test_relayout_cols_to_rows_values(mesh_dcn2x4, rng):
    x = rng.standard_normal((256, 256))
    d = da.from_array(x, chunks=(256, 32))
    r = d.cumsum(axis=0).rechunk((32, 256))
    with use_mesh(mesh_dcn2x4):
        hlo = compiled_hlo(r + 0.0)
        # the scan itself gathers (axis 0 is dcn-sharded on the cols grid);
        # the RELAYOUT must not — every all-gather line is the cumsum's
        for line in hlo.splitlines():
            if "all-gather" in line and "%all-gather" in line:
                assert "CumReduction" in line, line
        assert_eq(r + 0.0, np.cumsum(x, axis=0), check_chunks=False)


def test_mesh_collective_relayout_dcn_stage_last(mesh_dcn2x4):
    # force a layout where the dcn axis itself must move: with stability
    # pinned by plan_layout this needs a hand-shaped grid — verify via the
    # scheduler's stage order hook by checking a no-dcn-move case emits
    # pure ICI stages (the common path) and the scheduler still declines
    # nothing it used to handle on flat meshes
    import jax

    @jax.jit
    def run(xv):
        out = mesh_collective_relayout(
            xv, ((32,) * 8, (256,)), ((256,), (32,) * 8), mesh_dcn2x4
        )
        assert out is not None
        return out

    with mesh_dcn2x4:
        xv = np.arange(256 * 256, dtype=np.float64).reshape(256, 256)
        hlo = run.lower(xv).compile().as_text()
    assert "all-gather" not in hlo
    found, intra = _groups_intra_slice(hlo)
    assert found and intra


def test_halo_exchange_nested_group_values(mesh_dcn2x4, rng):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = rng.standard_normal((32, 6))
    xs = jax.device_put(x, NamedSharding(mesh_dcn2x4, P(("dcn", "x"), None)))
    out = np.asarray(halo_exchange(xs, mesh_dcn2x4, ("dcn", "x"), axis=0, depth=1))
    assert out.shape == (48, 6)
    shards = x.reshape(8, 4, 6)
    for i in range(8):
        got = out[i * 6 : (i + 1) * 6]
        left = shards[i - 1][-1:] if i > 0 else np.zeros((1, 6))
        right = shards[i + 1][:1] if i < 7 else np.zeros((1, 6))
        np.testing.assert_allclose(
            got, np.concatenate([left, shards[i], right]), atol=0
        )


def test_halo_exchange_nested_group_wrap(mesh_dcn2x4, rng):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = rng.standard_normal((16, 3))
    xs = jax.device_put(x, NamedSharding(mesh_dcn2x4, P(("dcn", "x"), None)))
    out = np.asarray(
        halo_exchange(xs, mesh_dcn2x4, ("dcn", "x"), axis=0, depth=1, wrap=True)
    )
    shards = x.reshape(8, 2, 3)
    np.testing.assert_allclose(
        out[:4], np.concatenate([shards[-1][-1:], shards[0], shards[1][:1]])
    )


def _permute_pairs(hlo):
    """Every collective-permute (source, target) pair in the HLO text."""
    pairs = []
    for m in re.finditer(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}", hlo):
        pairs += [
            (int(s), int(t)) for s, t in re.findall(r"\{(\d+),(\d+)\}", m.group(1))
        ]
    return pairs


def test_halo_exchange_dcn_crossings_minimal(mesh_dcn2x4, rng):
    # of the 7 forward ring pairs only ONE crosses the slice boundary
    # (device 3 -> 4); assert from the compiled collective-permute pairs
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = rng.standard_normal((32, 6))
    xs = jax.device_put(x, NamedSharding(mesh_dcn2x4, P(("dcn", "x"), None)))

    @jax.jit
    def run(v):
        return halo_exchange(v, mesh_dcn2x4, ("dcn", "x"), axis=0, depth=1)

    hlo = run.lower(xs).compile().as_text()
    pairs = _permute_pairs(hlo)
    assert pairs, "expected collective-permute pairs"
    crossings = sum(1 for s, t in pairs if s // 4 != t // 4)
    assert crossings <= 2, (crossings, pairs)  # one fwd + one bwd boundary pair


def _stencil(b):
    import jax.numpy as jnp

    return b + jnp.roll(b, 1, axis=0) + jnp.roll(b, -1, axis=0)


@pytest.mark.parametrize("bd", ["periodic", "reflect", "nearest", 0.0])
def test_shard_stencil_nested_group_values(mesh_dcn2x4, rng, bd):
    # ShardStencil over a NESTED ("dcn", "x") sharded axis: the ring
    # schedule runs over the linearised group (r5: this KeyError'd before)
    src = rng.standard_normal((64, 16))
    x = da.from_array(src, chunks=(8, 16))
    with use_mesh(mesh_dcn2x4), config.set({"tpu.overlap-method": "shard"}):
        y = x.map_overlap(_stencil, depth={0: 1}, boundary={0: bd})
        from dask_array_tpu.ops._overlap import ShardStencil

        assert isinstance(y.expr, ShardStencil)
        got = np.asarray(y.compute())
    mode = {"periodic": "wrap", "reflect": "symmetric", "nearest": "edge"}.get(bd)
    if mode is None:
        p = np.pad(src, ((1, 1), (0, 0)), constant_values=bd)
    else:
        p = np.pad(src, ((1, 1), (0, 0)), mode=mode)
    want = (p + np.roll(p, 1, axis=0) + np.roll(p, -1, axis=0))[1:-1]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_shard_stencil_dcn_crossings_minimal(mesh_dcn2x4, rng):
    # the halo over the nested group must cross DCN only at the slice
    # boundary: 2 crossings non-wrap (3<->4), 4 with the periodic wrap
    # pair (7<->0) — and never gather
    src = rng.standard_normal((64, 16))
    x = da.from_array(src, chunks=(8, 16))
    with use_mesh(mesh_dcn2x4), config.set({"tpu.overlap-method": "shard"}):
        hlo_r = compiled_hlo(
            x.map_overlap(_stencil, depth={0: 1}, boundary={0: "reflect"})
        )
        hlo_p = compiled_hlo(
            x.map_overlap(_stencil, depth={0: 1}, boundary={0: "periodic"})
        )
    for hlo, max_cross in ((hlo_r, 2), (hlo_p, 4)):
        assert "all-gather" not in hlo
        pairs = _permute_pairs(hlo)
        assert pairs, "expected collective-permute pairs"
        crossings = sum(1 for s, t in pairs if s // 4 != t // 4)
        assert crossings <= max_cross, (crossings, pairs)


def test_multislice_end_to_end_pipeline(mesh_dcn2x4, rng):
    # elemwise -> rechunk -> contraction -> reduction under the dcn mesh
    a = rng.standard_normal((128, 64))
    b = rng.standard_normal((64, 32))
    x = da.from_array(a, chunks=(16, 64))
    y = da.from_array(b, chunks=(64, 8))
    z = ((x - x.mean()) @ y).rechunk((128, 8)).sum(axis=0)
    with use_mesh(mesh_dcn2x4):
        assert_eq(z, ((a - a.mean()) @ b).sum(axis=0), rtol=1e-10)


def test_multislice_mesh_three_axis(rng):
    m = multislice_mesh(2, devices=_devices())  # (dcn=2, x=2, y=2)
    a = rng.standard_normal((64, 64))
    x = da.from_array(a, chunks=(8, 8))
    with use_mesh(m):
        assert_eq((x + 1).sum(), (a + 1).sum(), rtol=1e-10)
