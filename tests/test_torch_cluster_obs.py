"""The cluster executor's observability in the port against the reference
(``repro.cluster.execute`` under vmap, CPU).

* Handed the reference's plan, the port's ``ClusterReport.snapshot()``
  equals the reference's in its counters, its ``cluster/round_makespan_trips``
  histogram and every gauge that holds no time; both packages'
  ``speedup.from_snapshot`` give one waterfall on the port's snapshot;
  ``execute`` publishes the snapshot (``emit``), feeds ``progress_cb`` once a
  round and traces ``cluster/plan``, ``cluster/exchange``, ``cluster/mine``
  and a modeled lane a miner.
* ``cluster_mine --device cpu --trace DIR --doctor``, healthy and with
  ``--force-skew``: the reference's ``obs_report`` (``summary``,
  ``critpath``, ``doctor --format json``) reads the port's record as the
  port's ``obs_report`` does; the skewed run is gated by the doctor.

Everything the runs write goes under ``tmp_path``.
"""
import json
import tempfile

import jax
import pytest

from repro import cluster as ref_cluster
from repro.core import eclat as ref_eclat
from repro.core import fimi as ref_fimi
from repro.data.ibm_gen import IBMParams, generate_dense
from repro.launch import obs_report as ref_report
from repro.obs import speedup as ref_speedup
from repro_torch import cluster
from repro_torch.core import eclat, fimi
from repro_torch.launch import cluster_mine
from repro_torch.launch import obs_report as port_report
from repro_torch.obs import metrics
from repro_torch.obs import speedup as port_speedup
from repro_torch.obs import trace

N_ITEMS = 24
PLANNER = dict(min_support_rel=0.08, n_db_sample=256, n_fi_sample=32, alpha=0.7)
ECLAT = dict(max_out=1 << 12, max_stack=1024, frontier_size=8)
DB_ARGS = ["--device", "cpu", "--db", "T1I0.032P20PL6TL10", "--support", "0.08", "-P", "4"]


@pytest.fixture(scope="module")
def dense():
    return generate_dense(IBMParams(n_tx=512, n_items=N_ITEMS, n_patterns=8,
                                    avg_pattern_len=5, avg_tx_len=8, seed=3))


def holds_time(gauge: str) -> bool:
    return "phase_ms" in gauge or gauge.endswith("mine_ms") or gauge.startswith("speedup/")


def numbers(wf):
    """A waterfall's numbers and terms, without their explanatory text."""
    return (wf.P, wf.ideal_x, wf.measured_x, wf.wall_ms, wf.ideal_ms, wf.gauges(),
            [(t.name, t.loss_x, t.ms, t.evidence) for t in wf.terms])


def test_snapshot_equals_reference_on_one_plan(dense):
    want = ref_cluster.execute(
        ref_fimi.shard_db(dense, 2), N_ITEMS,
        ref_cluster.ClusterParams(planner=ref_cluster.PlannerParams(**PLANNER),
                                  eclat=ref_eclat.EclatConfig(**ECLAT), skew_threshold=1.05),
        jax.random.PRNGKey(0))
    metrics.reset()
    trace.TRACER.clear()
    trace.TRACER.enable()
    snaps = []
    try:
        got = cluster.execute(
            fimi.shard_db(dense, 2, "cpu"), N_ITEMS,
            cluster.ClusterParams(planner=cluster.PlannerParams(**PLANNER),
                                  eclat=eclat.EclatConfig(**ECLAT), skew_threshold=1.05),
            device="cpu", plan=cluster.plan_from_reference(want.plan), progress_cb=snaps.append)
        events = trace.TRACER.export()["traceEvents"]
    finally:
        trace.TRACER.disable()
        trace.TRACER.clear()
    snap, ref_snap = got.report.snapshot(), want.report.snapshot()
    assert got.report.n_rounds >= 2 and got.report.donations
    assert snap["counters"] == ref_snap["counters"]
    assert snap["histograms"] == ref_snap["histograms"]
    assert snap["histograms"]["cluster/round_makespan_trips"]["count"] == got.report.n_rounds
    assert set(snap["gauges"]) == set(ref_snap["gauges"])
    assert any(name.startswith("speedup/loss/") for name in snap["gauges"])
    for name, value in snap["gauges"].items():
        if not holds_time(name):
            assert value == ref_snap["gauges"][name], name

    # one waterfall, whichever package reads the port's snapshot
    port_wf, ref_wf = port_speedup.from_snapshot(snap), ref_speedup.from_snapshot(snap)
    assert numbers(port_wf) == numbers(ref_wf)
    assert port_wf.additivity_error() < 1e-9
    assert {k: v for k, v in snap["gauges"].items() if k.startswith("speedup/")} == \
        port_wf.gauges()

    # emit(): the registry holds the snapshot, the histogram counted once
    published = metrics.snapshot()
    assert published["histograms"]["cluster/round_makespan_trips"] == \
        snap["histograms"]["cluster/round_makespan_trips"]
    for name in ("cluster/rounds", "cluster/donations"):
        assert published["counters"][name] == snap["counters"][name]
    assert published["gauges"]["speedup/measured_x"] == snap["gauges"]["speedup/measured_x"]
    got.report.republish_gauges()
    assert metrics.snapshot()["histograms"] == published["histograms"]

    # progress once a round, and the spans: a lane a miner a round
    assert len(snaps) == got.report.n_rounds and snaps[-1].frac == pytest.approx(1.0)
    spans = [e for e in events if e.get("ph") == "X"]
    names = [e["name"] for e in spans]
    assert names.count("cluster/plan") == 1
    assert names.count("cluster/exchange") == got.report.n_rounds
    assert names.count("cluster/mine") == got.report.n_rounds * (1 + 2)
    assert any(e["name"] == "cluster/donate" for e in events)


def report_numbers(report):
    wf = report["waterfall"]
    if wf is not None:
        wf = {**wf, "terms": [{k: v for k, v in t.items() if k != "detail"}
                              for t in wf["terms"]]}
    return report["findings"], report["worst"], report["critpath"], wf


def both(argv, capsys):
    """(exit code, output) of the reference's and the port's obs_report."""
    want = ref_report.main(argv)
    want_out = capsys.readouterr().out
    got = port_report.main(argv)
    return (want, want_out), (got, capsys.readouterr().out)


@pytest.mark.parametrize("skew", [False, True], ids=["healthy", "force_skew"])
def test_cluster_mine_record_reads_alike_in_both_reports(skew, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)   # the doctor's default history, if any, lives here
    run = str(tmp_path / "run")
    res = cluster_mine.main(DB_ARGS + ["--trace", run, "--doctor"]
                            + (["--force-skew"] if skew else []))
    out = capsys.readouterr().out
    assert res.table.n_fis == 3370 and res.report.backend == "local"
    assert out.count("progress") >= res.report.n_rounds
    assert "doctor:" in out and "speedup waterfall (run)" in out
    history = ["--history", str(tmp_path / "history.jsonl")]

    for argv in (["summary", run, "--format", "json"], ["summary", run],
                 ["critpath", run], ["critpath", run, "--format", "json", "--path"]):
        want, got = both(argv, capsys)
        assert got == want, argv
    cp = json.loads(both(["critpath", run, "--format", "json"], capsys)[1][1])
    assert "cluster/mine" in [r["name"] for r in cp["table"]]
    summary = json.loads(both(["summary", run, "--format", "json"], capsys)[1][1])
    assert summary["backend"] == "local"
    assert [e["kind"] for e in summary["events"]].count("round") == res.report.n_rounds
    assert "cluster/round_makespan_trips" in summary["histograms"]

    (want_rc, want_out), (got_rc, got_out) = both(
        ["doctor", run, "--format", "json", *history], capsys)
    assert got_rc == want_rc == 0
    report = json.loads(got_out)
    assert report_numbers(report) == report_numbers(json.loads(want_out))
    (want_rc, _), (got_rc, _) = both(["doctor", run, "--gate", *history], capsys)
    assert got_rc == want_rc
    rules = {f["rule"]: f["severity"] for f in report["findings"]}
    if skew:
        assert rules["rebalance-not-engaging"] == "error" and got_rc == 1
    else:
        assert "rebalance-not-engaging" not in rules


def test_doctor_alone_records_to_a_temporary_directory(tmp_path, monkeypatch, capsys):
    """``--doctor`` without ``--trace``/``--metrics``: the run is traced into
    a temporary record, diagnosed at exit, and nothing else is written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    cluster_mine.main(DB_ARGS + ["--doctor"])
    out = capsys.readouterr().out
    assert "critical path" in out and "speedup waterfall (run)" in out and "doctor: " in out
    records = list((tmp_path / "tmp").glob("doctor-cluster_mine-*"))
    assert len(records) == 1 and (records[0] / "trace.json").is_file()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["tmp"]
    assert not trace.TRACER.enabled
