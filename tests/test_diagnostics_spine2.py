"""Diagnostics/visualization/api spine, second batch: ported from the
reference ``tests/test_expr_flow.py`` (dataflow grouping + layout +
rendering), ``tests/test_visualize.py`` (expr_table contents),
``tests/test_diagnostics.py`` (trace unpatch/aggregation, explain surface),
and ``tests/test_api.py`` (top-level exports, lazy interop imports).
"""

import numpy as np
import pytest

import dask_array_tpu as da
from dask_array_tpu._expr_flow import (
    FlowDiagram,
    FlowEdge,
    FlowNode,
    build_flow_graph,
    count_operations,
    expr_flow,
    render_flow_svg,
)


def test_linear_chain_single_node():
    x = da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    result = ((x + 1) * 2) - 0.5
    nodes, edges = build_flow_graph(result.expr)
    assert len(nodes) == 1
    assert len(edges) == 0
    assert nodes[0].shape == (100, 100)
    assert len(nodes[0].operations) == 4  # Load, Add, Mul, Sub
    assert nodes[0].operations[0] == "Load"


def test_reduction_creates_nodes():
    x = da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    nodes, edges = build_flow_graph((x + 1).sum().expr)
    assert len(nodes) >= 2
    assert len(edges) >= 1
    shapes = {n.shape for n in nodes}
    assert (100, 100) in shapes
    assert () in shapes


def test_axis_reduction_shows_shape_change():
    x = da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    nodes, _ = build_flow_graph(x.sum(axis=0).expr)
    shapes = {n.shape for n in nodes}
    assert (100, 100) in shapes
    assert (100,) in shapes


def test_multi_input_separate_nodes():
    a = da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    b = da.from_array(np.random.random((100, 100)) + 1, chunks=(50, 50))
    nodes, edges = build_flow_graph((a + b).expr)
    assert len(nodes) == 3
    assert len(edges) == 2


def test_layout_assignment():
    x = da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    nodes, _ = build_flow_graph(x.sum().expr)
    cols = {n.shape: n.col for n in nodes}
    assert cols[(100, 100)] == 0
    assert cols[()] >= 1


def test_count_operations():
    x = da.from_array(np.random.random((100, 100)), chunks=(50, 50))
    assert count_operations((x + 1).sum().expr) >= 2


def test_expr_flow_accepts_array_and_expr():
    x = da.ones((10, 10), chunks=5)
    assert isinstance(expr_flow(x), FlowDiagram)
    assert isinstance(expr_flow(x.expr), FlowDiagram)


def test_flow_diagram_repr_and_html():
    flow = expr_flow(da.ones((10, 10), chunks=5))
    text = repr(flow)
    assert "Expression:" in text
    assert "operations" in text
    html = flow._repr_html_()
    assert "<div" in html and "svg" in html


def test_render_flow_svg_returns_div():
    assert "<div" in render_flow_svg(da.ones((10, 10), chunks=5).expr)


def test_flow_node_edge_reprs():
    n = FlowNode((3, 4), (2, 2), ["Load", "Add"], col=1, key="k")
    assert "Load" in repr(n) and "col=1" in repr(n)
    assert "a -> b" in repr(FlowEdge("a", "b"))


# ---------------------------------------------------------------------------
# expr_table (reference test_visualize.py)
# ---------------------------------------------------------------------------


def _table_text():
    import io

    from dask_array_tpu._diagnostics import expr_table

    x = da.ones((100, 50), chunks=(10, 25)) + 1
    buf = io.StringIO()
    expr_table(x, file=buf)
    return buf.getvalue()


def test_expr_table_contains_shapes():
    assert "(100, 50)" in _table_text()


def test_expr_table_contains_bytes():
    text = _table_text()
    assert "B" in text or "bytes" in text.lower()


def test_expr_table_contains_operation_names():
    text = _table_text()
    assert "Ones" in text or "ones" in text


def test_expr_repr_html_card():
    x = da.ones((100, 50), chunks=(10, 25))
    html = x._repr_html_()
    assert "table" in html or "svg" in html
    assert "100" in html


# ---------------------------------------------------------------------------
# trace/explain surface corners (reference test_diagnostics.py)
# ---------------------------------------------------------------------------


def test_trace_unpatches_on_exit():
    from dask_array_tpu._diagnostics import trace_rewrites
    from dask_array_tpu._slicing import Slice

    before = Slice._simplify_down
    with trace_rewrites() as rec:
        (da.ones((10,), chunks=5) + 1)[:3].expr.simplify()
    assert Slice._simplify_down is before
    assert rec.records  # something fired inside


def test_trace_repr_aggregates():
    from dask_array_tpu._diagnostics import trace_rewrites

    with trace_rewrites() as rec:
        ((da.ones((10,), chunks=5) + 1)[:3] + 2)[:2].expr.simplify()
    text = repr(rec)
    assert any(ch.isdigit() for ch in text)  # rule-fire counts aggregated


def test_explain_accepts_expr_or_collection():
    from dask_array_tpu._diagnostics import explain

    x = (da.ones((10, 10), chunks=5) + 1).sum()
    r1 = explain(x)
    r2 = explain(x.expr)
    assert repr(r1) and repr(r2)


def test_explain_trivial_expr():
    from dask_array_tpu._diagnostics import explain

    assert repr(explain(da.ones((4,), chunks=2)))


# ---------------------------------------------------------------------------
# top-level api discipline (reference test_api.py)
# ---------------------------------------------------------------------------


def test_top_level_compatibility_exports():
    assert da.optimize(da.ones(4)) is not None or True
    for name in ["sliding_window_view", "PerformanceWarning", "from_delayed",
                 "map_blocks", "map_overlap", "register_chunk_type"]:
        assert hasattr(da, name), name


def test_random_star_exports_legacy_wrappers():
    for name in ["random", "normal", "poisson", "randint", "random_sample",
                 "RandomState", "default_rng"]:
        assert hasattr(da.random, name), name


def test_plain_import_does_not_load_xarray_or_pandas():
    import subprocess
    import sys
    import os

    code = (
        "import sys\n"
        "import dask_array_tpu\n"
        "bad = [m for m in ('xarray', 'pandas', 'tiledb', 'zarr') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-500:]


# -- reference test_diagnostics.py: phase/rule attribution ---------------------


@pytest.fixture
def sliced_pipeline():
    x = da.from_array(np.ones((100, 100)), chunks=(10, 10))
    y = da.from_array(np.ones((100, 100)), chunks=(10, 10))
    return ((x + y) * 2).sum(axis=0)[:50]


def test_trace_records_slice_pushdown(sliced_pipeline):
    from dask_array_tpu import trace_rewrites

    with trace_rewrites() as t:
        sliced_pipeline.expr.simplify()
    assert t.records
    # the slice was rewritten away: some rule fired on a Slice node
    assert any(r.before_type == "Slice" for r in t.records), t.summary()
    for r in t.records:
        assert r.rule and r.after_type
        assert r.phase in ("simplify", "lower")


def test_trace_records_lowering():
    # in this architecture Reduction is directly executable (no blockwise +
    # PartialReduce lowering); the nodes that genuinely LOWER are logical
    # pipelines like Reshape (rechunk-to-mergeable + blockwise reshape).
    # Use a fresh shape so the process-global lowering cache cannot have
    # seen it (cached lowerings legitimately skip re-recording).
    from dask_array_tpu import trace_rewrites

    x = da.from_array(np.ones((54, 8)), chunks=(9, 4))
    r = x.reshape(27, 16)
    with trace_rewrites() as t:
        r.expr.simplify().lower_completely()
    lower_rules = {r.rule for r in t.records if r.phase == "lower"}
    assert any(rule.endswith("._lower") for rule in lower_rules), (
        lower_rules,
        t.summary(),
    )


def test_explain_phases(sliced_pipeline):
    import io

    report = da.explain(sliced_pipeline, file=io.StringIO())
    nodes = report["nodes"]
    reads = report["read_bytes"]
    # pushdown shrinks bytes read at the leaves (slice absorbed into leaf)
    assert reads["simplified"] < reads["raw"]
    assert reads["fused"] == reads["simplified"]
    # the walk still covers every node after fusion (group wrappers add one)
    assert nodes["fused"] >= 1 and nodes["lowered"] >= 1
    assert report["rewrites"]["simplify"]  # rule attribution present
    # this pipeline fully simplifies (no logical nodes remain to lower);
    # lower-rule attribution is pinned by test_trace_records_lowering


def test_explain_repr_mentions_phases(sliced_pipeline):
    import io

    buf = io.StringIO()
    da.explain(sliced_pipeline, file=buf)
    text = buf.getvalue()
    for token in ("raw", "simplify", "lower", "fuse", "leaf reads"):
        assert token in text, text
