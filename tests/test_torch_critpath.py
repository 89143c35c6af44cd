"""Span-DAG reconstruction and critical-path analysis of both packages
(``repro.obs.critpath`` and ``repro_torch.obs.critpath``): the reference's
cases of ``test_critpath.py``, each run through both — per-track nesting,
cross-track containment, instant attachment, exclusive self-time as an
interval union, straggler selection among parallel lanes, untraced-gap
accounting, and the analyze() digest over the committed golden fixture
records — and the port's digest equal to the reference's on both."""
import dataclasses
import importlib
import json
from pathlib import Path

import pytest

from repro.obs import critpath as ref_critpath
from repro_torch.obs import critpath as port_critpath

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data"


@pytest.fixture(params=["repro", "repro_torch"])
def critpath(request):
    return importlib.import_module(f"{request.param}.obs.critpath")


def _x(name, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "pid": 0, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _meta(tid, name):
    return {"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
            "args": {"name": name}}


def _trace(*events):
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# build: nesting / cross-track attachment / instants
# ---------------------------------------------------------------------------


def test_build_empty_or_spanless_returns_none(critpath):
    assert critpath.build(None) is None
    assert critpath.build({}) is None
    assert critpath.build(_trace(_meta(1, "Main"))) is None


def test_same_track_nesting_is_innermost_container(critpath):
    dag = critpath.build(_trace(
        _x("outer", 0, 1000),
        _x("mid", 100, 500),
        _x("inner", 200, 100),
        _x("sibling", 700, 200),
    ))
    by_name = {s.name: s for s in dag.nodes}
    assert by_name["mid"].parent is by_name["outer"]
    assert by_name["inner"].parent is by_name["mid"]
    assert by_name["sibling"].parent is by_name["outer"]
    # the virtual root owns the single real root
    assert by_name["outer"].parent is dag.root
    assert dag.root.name == critpath.UNTRACED
    assert dag.wall_us == 1000


def test_cross_track_lane_attaches_to_containing_span(critpath):
    dag = critpath.build(_trace(
        _meta(1, "Main"), _meta(1000001, "shard0"),
        _x("cluster/mine", 0, 1000, tid=1),
        _x("cluster/mine", 0, 800, tid=1000001),
    ))
    main = next(s for s in dag.nodes if s.tid == 1)
    lane = next(s for s in dag.nodes if s.tid == 1000001)
    assert lane.parent is main
    assert lane.track == "shard0" and main.track == "Main"


def test_cross_track_attach_tolerates_eps_overhang(critpath):
    # the lane starts slightly before its host (clock skew < _EPS_US)
    dag = critpath.build(_trace(
        _x("host", 1000, 5000, tid=1),
        _x("lane", 1000 - critpath._EPS_US / 2, 5000, tid=2),
    ))
    lane = next(s for s in dag.nodes if s.name == "lane")
    assert lane.parent.name == "host"


def test_disjoint_cross_track_span_stays_a_root(critpath):
    dag = critpath.build(_trace(
        _x("a", 0, 1000, tid=1),
        _x("b", 50_000, 1000, tid=2),
    ))
    roots = [s for s in dag.nodes if s.parent is dag.root]
    assert sorted(s.name for s in roots) == ["a", "b"]
    assert dag.wall_us == 51_000


def test_instants_annotate_innermost_enclosing_span(critpath):
    dag = critpath.build(_trace(
        _x("outer", 0, 1000),
        _x("inner", 200, 400),
        {"ph": "i", "name": "cluster/donate", "pid": 0, "tid": 1, "ts": 300,
         "s": "t", "args": {"src": 1, "dst": 0}},
    ))
    by_name = {s.name: s for s in dag.nodes}
    assert [i["name"] for i in by_name["inner"].instants] == \
        ["cluster/donate"]
    assert by_name["outer"].instants == []


# ---------------------------------------------------------------------------
# exclusive self-time: union of child intervals, never a naive sum
# ---------------------------------------------------------------------------


def test_exclusive_subtracts_union_of_overlapping_children(critpath):
    dag = critpath.build(_trace(
        _x("parent", 0, 10_000, tid=1),
        # two parallel lanes overlapping on [3000, 5000): union 9000, not
        # the naive sum 11000 (which would clamp the parent to zero)
        _x("lane", 0, 5000, tid=2),
        _x("lane", 3000, 6000, tid=3),
    ))
    parent = next(s for s in dag.nodes if s.name == "parent")
    assert [c.name for c in parent.children] == ["lane", "lane"]
    assert parent.exclusive_us() == 10_000 - 9000
    totals = critpath.exclusive_totals(dag)
    assert totals["parent"]["self_ms"] == 1.0
    assert totals["lane"]["count"] == 2
    assert totals["lane"]["total_ms"] == 11.0


def test_exclusive_clips_children_to_parent_interval(critpath):
    # a child overhanging the parent's end (eps attach slack) only erases
    # the part of itself inside the parent
    dag = critpath.build(_trace(
        _x("parent", 0, 5000, tid=1),
        _x("lane", 2500, 3000, tid=2),       # ends 500 us past the parent
    ))
    parent = next(s for s in dag.nodes if s.name == "parent")
    assert [c.name for c in parent.children] == ["lane"]
    assert parent.exclusive_us() == 5000 - 2500     # not 5000 - 3000


def test_union_len(critpath):
    assert critpath._union_len([]) == 0.0
    assert critpath._union_len([(0, 10), (20, 30)]) == 20.0
    assert critpath._union_len([(0, 10), (5, 15), (15, 20)]) == 20.0
    assert critpath._union_len([(0, 10), (2, 3)]) == 10.0


# ---------------------------------------------------------------------------
# critical path: straggler lanes, untraced gaps, full accounting
# ---------------------------------------------------------------------------


def test_parallel_lanes_resolve_to_the_straggler(critpath):
    dag = critpath.build(_trace(
        _meta(1000001, "shard0"), _meta(1000002, "shard1"),
        _x("round", 0, 1000, tid=1),
        _x("mine", 0, 1000, tid=1000001),     # straggler
        _x("mine", 0, 400, tid=1000002),      # shadowed: slack, not critical
    ))
    segs = critpath.critical_path(dag)
    on_path = [(s.name, s.track) for s in segs]
    assert ("mine", "shard0") in on_path
    assert ("mine", "shard1") not in on_path
    # the straggler covers the round: the round has no on-path self time
    round_seg = next(s for s in segs if s.name == "round")
    assert round_seg.self_us == 0.0


def test_untraced_gaps_become_root_self_time(critpath):
    dag = critpath.build(_trace(
        _x("a", 0, 1000),
        _x("b", 3000, 1000),
    ))
    segs = critpath.critical_path(dag)
    root = segs[0]
    assert root.name == critpath.UNTRACED
    assert root.self_us == 2000.0           # the [1000, 3000) gap
    # self times over the path account the full wall exactly
    assert sum(s.self_us for s in segs) == dag.wall_us


def test_sequential_chain_fully_selected(critpath):
    dag = critpath.build(_trace(
        _x("outer", 0, 1000),
        _x("s1", 0, 300),
        _x("s2", 300, 700),
    ))
    segs = critpath.critical_path(dag)
    assert [s.name for s in segs] == [critpath.UNTRACED, "outer", "s1", "s2"]
    assert segs[1].self_us == 0.0


def test_path_table_aggregates_and_ranks(critpath):
    dag = critpath.build(_trace(
        _x("big", 0, 1000),
        _x("small", 2000, 100),
    ))
    rows = critpath.path_table(critpath.critical_path(dag))
    assert rows[0]["name"] in (critpath.UNTRACED, "big")
    names = [r["name"] for r in rows]
    assert "big" in names and "small" in names
    assert abs(sum(r["share"] for r in rows) - 1.0) < 1e-9
    # top_n truncates
    assert len(critpath.path_table(critpath.critical_path(dag), top_n=1)) == 1


# ---------------------------------------------------------------------------
# analyze() over the committed golden fixtures
# ---------------------------------------------------------------------------


def _fixture_trace(name):
    return json.loads((FIXTURES / name / "trace.json").read_text())


def test_analyze_healthy_fixture(critpath):
    cp = critpath.analyze(_fixture_trace("run_healthy"))
    assert cp is not None
    assert abs(cp["wall_ms"] - 108.2) < 1e-6
    # the straggler shard lane IS the mine phase's critical time
    top = cp["table"][0]
    assert top["name"] == "cluster/mine"
    assert abs(top["self_ms"] - 100.0) < 1e-6
    assert "shard0" in top["tracks"]
    # the shadowed shard1 lane never appears on the path
    assert not any(seg["track"] == "shard1" for seg in cp["path"])
    # exclusive totals: both lanes fully cover the main-track mine span
    assert cp["exclusive"]["cluster/mine"]["count"] == 3
    # on-path self times account the full wall
    assert abs(sum(s["self_ms"] for s in cp["path"]) - cp["wall_ms"]) < 1e-6


def test_analyze_skewed_fixture_counts_both_rounds(critpath):
    cp = critpath.analyze(_fixture_trace("run_skewed_cluster"))
    top = cp["table"][0]
    assert top["name"] == "cluster/mine"
    assert abs(top["self_ms"] - 200.0) < 1e-6     # straggler lane, 2 rounds
    ex = cp["exclusive"]["cluster/exchange"]
    assert ex["count"] == 2 and abs(ex["total_ms"] - 2.0) < 1e-6


def test_analyze_no_trace_returns_none(critpath):
    assert critpath.analyze(None) is None
    assert critpath.analyze({"traceEvents": []}) is None


# ---------------------------------------------------------------------------
# the port's digest is the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["run_healthy", "run_skewed_cluster"])
def test_port_analysis_equals_reference(name):
    trace = _fixture_trace(name)
    assert port_critpath.analyze(trace, top_n=20) == ref_critpath.analyze(trace, top_n=20)
    ref_dag, port_dag = ref_critpath.build(trace), port_critpath.build(trace)
    assert port_critpath.exclusive_totals(port_dag) == ref_critpath.exclusive_totals(ref_dag)
    assert [dataclasses.astuple(s) for s in port_critpath.critical_path(port_dag)] == \
        [dataclasses.astuple(s) for s in ref_critpath.critical_path(ref_dag)]
