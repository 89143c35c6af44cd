"""The performance doctor of both packages (``repro.obs.doctor`` and
``repro_torch.obs.doctor``): the reference's cases of ``test_doctor.py``,
each run through both packages — golden finding sets over the two committed
fixture run records, each rule's trigger on synthetic snapshots, severity
ranking, the renderers, and the ``obs_report doctor`` / ``critpath`` CLI
exit-code contract (``--gate``) — and the port's report equal to the
reference's on both fixtures: findings, severities, evidence, waterfall
terms, critical path and exit codes.  Histories and outputs go under
``tmp_path``."""
import importlib
import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data"
HEALTHY = str(FIXTURES / "run_healthy")
SKEWED = str(FIXTURES / "run_skewed_cluster")


@pytest.fixture(params=["repro", "repro_torch"])
def pkg(request):
    return request.param


@pytest.fixture
def doctor(pkg):
    return importlib.import_module(f"{pkg}.obs.doctor")


@pytest.fixture
def runlog(pkg):
    return importlib.import_module(f"{pkg}.obs.runlog")


@pytest.fixture
def obs_report(pkg):
    return importlib.import_module(f"{pkg}.launch.obs_report")


def _rules(report):
    return [f["rule"] for f in report["findings"]]


def _snap(gauges=None, counters=None, histograms=None):
    return {"counters": counters or {}, "gauges": gauges or {},
            "histograms": histograms or {}}


# ---------------------------------------------------------------------------
# Golden fixtures: the exact finding sets are part of the contract —
# a rule change must show up here as a reviewable diff.
# ---------------------------------------------------------------------------


def test_healthy_fixture_exact_findings(doctor, runlog, obs_report):
    report = doctor.diagnose(runlog.load_run(HEALTHY))
    assert _rules(report) == [
        "cluster-imbalance", "healthy", "thm61-estimation-error",
    ]
    assert report["worst"] == "info"
    assert all(f["severity"] == "info" for f in report["findings"])
    # both analysis digests ride along, self-contained
    assert report["critpath"]["table"][0]["name"] == "cluster/mine"
    assert report["waterfall"]["additivity_err"] < 0.05
    assert report["waterfall"]["measured_x"] == pytest.approx(200 / 106)
    # the Thm 6.1 finding is keyed to the paper's own gauges
    thm = next(f for f in report["findings"]
               if f["rule"] == "thm61-estimation-error")
    assert "cluster/load/estimation_error" in thm["evidence"]
    assert "cluster/shard0/est_load" in thm["evidence"]


def test_skewed_fixture_exact_findings(doctor, runlog, obs_report):
    report = doctor.diagnose(runlog.load_run(SKEWED))
    assert _rules(report) == [
        "rebalance-not-engaging", "cluster-imbalance",
        "thm61-estimation-error",
    ]
    sev = {f["rule"]: f["severity"] for f in report["findings"]}
    assert sev == {"rebalance-not-engaging": "error",
                   "cluster-imbalance": "warn",
                   "thm61-estimation-error": "info"}
    assert report["worst"] == "error"
    imb = next(f for f in report["findings"]
               if f["rule"] == "cluster-imbalance")
    assert "dominant" in imb["title"]
    assert imb["evidence"]["cluster/imbalance"] == 2.0
    reb = next(f for f in report["findings"]
               if f["rule"] == "rebalance-not-engaging")
    assert reb["evidence"]["cluster/donations"] == 0
    # the waterfall blames imbalance for > half the gap, estimation for none
    terms = {t["name"]: t for t in report["waterfall"]["terms"]}
    assert terms["imbalance"]["loss_x"] > \
        0.5 * report["waterfall"]["gap_x"]
    assert terms["estimation"]["loss_x"] == pytest.approx(0.0)


# ---------------------------------------------------------------------------
# Individual rules on synthetic run dicts
# ---------------------------------------------------------------------------


def test_non_cluster_run_is_healthy(doctor, runlog, obs_report):
    report = doctor.diagnose({"manifest": {}, "metrics": _snap(
        {"fimi/n_fis": 42.0})})
    assert _rules(report) == ["healthy"]
    assert report["critpath"] is None and report["waterfall"] is None


def test_prefetch_stall_warns_then_escalates_on_the_critical_path(doctor, runlog, obs_report):
    hist = {"store/prefetch_stall_s": {
        "count": 10, "sum": 0.3, "mean": 0.03, "min": 0.01, "max": 0.06,
        "p50": 0.03, "p95": 0.05, "p99": 0.06}}
    run = {"manifest": {}, "metrics": _snap(histograms=hist)}
    report = doctor.diagnose(run)
    f = next(f for f in report["findings"] if f["rule"] == "prefetch-stall")
    assert f["severity"] == "warn"          # no trace: can't see the path
    assert f["evidence"]["store/prefetch_stall_s.p95"] == 0.05
    assert "--budget-blocks" in f["remediation"]

    # same stalls, but store reads sit on the critical path → error
    run["trace"] = {"traceEvents": [
        {"ph": "X", "name": "store/read_block", "pid": 0, "tid": 7,
         "ts": 0, "dur": 50_000, "args": {}},
    ]}
    report = doctor.diagnose(run)
    f = next(f for f in report["findings"] if f["rule"] == "prefetch-stall")
    assert f["severity"] == "error"
    assert "critical path" in f["title"]


def test_prefetch_stall_quiet_below_threshold(doctor, runlog, obs_report):
    hist = {"store/prefetch_stall_s": {
        "count": 10, "sum": 0.001, "mean": 1e-4, "min": 0.0, "max": 2e-3,
        "p50": 1e-4, "p95": 2e-3, "p99": 2e-3}}
    report = doctor.diagnose({"manifest": {}, "metrics": _snap(
        histograms=hist)})
    assert "prefetch-stall" not in _rules(report)


def test_retry_rules(doctor, runlog, obs_report):
    r = doctor.diagnose({"manifest": {}, "metrics": _snap(
        counters={"store/retry/exhausted": 2, "store/retry/attempts": 9})})
    f = next(f for f in r["findings"] if f["rule"] == "retry-exhausted")
    assert f["severity"] == "error" and r["worst"] == "error"
    r = doctor.diagnose({"manifest": {}, "metrics": _snap(
        counters={"store/retry/retried_errors": 3})})
    f = next(f for f in r["findings"] if f["rule"] == "retry-exhausted")
    assert f["severity"] == "warn"


def test_capacity_overflow_rule(doctor, runlog, obs_report):
    r = doctor.diagnose({"manifest": {}, "metrics": _snap(
        counters={"fimi/exchange_overflow": 5})})
    f = next(f for f in r["findings"] if f["rule"] == "capacity-overflow")
    assert f["severity"] == "error"
    assert f["evidence"] == {"fimi/exchange_overflow": 5}


def test_serve_rules(doctor, runlog, obs_report):
    r = doctor.diagnose({"manifest": {}, "metrics": _snap(
        counters={"service/errors": 1, "service/shed": 7},
        histograms={"service/latency_ms": {
            "count": 100, "sum": 500, "mean": 5, "min": 1, "max": 40,
            "p50": 4, "p95": 20, "p99": 35}})})
    rules = _rules(r)
    assert "service-errors" in rules and "service-shed" in rules
    shed = next(f for f in r["findings"] if f["rule"] == "service-shed")
    assert shed["evidence"]["service/latency_ms.p95"] == 20


def test_trace_truncated_rule_scales_severity(doctor, runlog, obs_report):
    r = doctor.diagnose({"manifest": {}, "metrics": _snap(
        counters={"trace/dropped_events": 100})})
    f = next(f for f in r["findings"] if f["rule"] == "trace-truncated")
    assert f["severity"] == "info"
    r = doctor.diagnose({"manifest": {}, "metrics": _snap(
        counters={"trace/dropped_events": 50_000})})
    f = next(f for f in r["findings"] if f["rule"] == "trace-truncated")
    assert f["severity"] == "warn"


def test_roofline_regression_needs_history(doctor, runlog, obs_report):
    snap = _snap({"kernels/phase4/achieved_frac": 0.4})
    run = {"manifest": {}, "metrics": snap}
    # no history / too little history: the rule stays silent
    assert "roofline-regression" not in _rules(doctor.diagnose(run))
    short = [{"suite": "kernels", "keys": {"phase4_achieved_frac": 0.8}}] * 2
    assert "roofline-regression" not in _rules(
        doctor.diagnose(run, history_rows=short))
    hist = [{"suite": "kernels", "keys": {"phase4_achieved_frac": v}}
            for v in (0.78, 0.80, 0.82, 0.79)]
    r = doctor.diagnose(run, history_rows=hist)
    f = next(f for f in r["findings"] if f["rule"] == "roofline-regression")
    assert f["severity"] == "warn"
    assert f["evidence"]["kernels/phase4/achieved_frac"] == 0.4
    # at the trailing median: no finding
    snap["gauges"]["kernels/phase4/achieved_frac"] = 0.80
    assert "roofline-regression" not in _rules(
        doctor.diagnose(run, history_rows=hist))


def test_thresholds_are_tunable(doctor, runlog, obs_report):
    # the healthy fixture's 1.0 imbalance warns under a paranoid threshold
    th = doctor.Thresholds(imbalance_warn=0.5)
    report = doctor.diagnose(runlog.load_run(HEALTHY), thresholds=th)
    f = next(f for f in report["findings"]
             if f["rule"] == "cluster-imbalance")
    assert f["severity"] == "warn"
    assert "healthy" not in _rules(report)


def test_worst_severity_and_ordering(doctor, runlog, obs_report):
    assert doctor.worst_severity([]) == "info"
    f = [doctor.Finding("a", "warn", "", "", {}, ""),
         doctor.Finding("b", "error", "", "", {}, "")]
    assert doctor.worst_severity(f) == "error"


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------


def test_render_text_and_markdown(doctor, runlog, obs_report):
    report = doctor.diagnose(runlog.load_run(SKEWED))
    txt = doctor.render_text(report)
    assert "critical path" in txt and "speedup waterfall" in txt
    assert "worst = error" in txt
    assert "rebalance-not-engaging" in txt
    assert "evidence:" in txt and "fix:" in txt
    md = doctor.render_markdown(report)
    assert md.startswith("## Performance doctor")
    assert "| sev | rule | finding | remediation |" in md
    assert "### Critical path" in md and "### Speedup waterfall" in md
    assert "`rebalance-not-engaging`" in md


# ---------------------------------------------------------------------------
# CLI: obs_report doctor / critpath
# ---------------------------------------------------------------------------


def test_cli_doctor_gate_exit_codes(doctor, runlog, obs_report, tmp_path, capsys):
    no_hist = str(tmp_path / "no_history.jsonl")
    assert obs_report.main(
        ["doctor", HEALTHY, "--history", no_hist, "--gate"]) == 0
    capsys.readouterr()
    assert obs_report.main(
        ["doctor", SKEWED, "--history", no_hist, "--gate"]) == 1
    err = capsys.readouterr().err
    assert "DOCTOR GATE" in err
    # without --gate even an error-severity report exits 0 (report-only)
    assert obs_report.main(["doctor", SKEWED, "--history", no_hist]) == 0


def test_cli_doctor_format_json_and_markdown(doctor, runlog, obs_report, tmp_path, capsys):
    no_hist = str(tmp_path / "no_history.jsonl")
    assert obs_report.main(
        ["doctor", SKEWED, "--history", no_hist, "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["worst"] == "error"
    assert [f["rule"] for f in report["findings"]][0] == \
        "rebalance-not-engaging"
    assert obs_report.main(
        ["doctor", HEALTHY, "--history", no_hist, "--format",
         "markdown"]) == 0
    assert "## Performance doctor" in capsys.readouterr().out


def test_cli_critpath(doctor, runlog, obs_report, tmp_path, capsys):
    assert obs_report.main(["critpath", HEALTHY]) == 0
    out = capsys.readouterr().out
    assert "cluster/mine" in out and "shard0" in out
    assert obs_report.main(["critpath", HEALTHY, "--format", "json"]) == 0
    cp = json.loads(capsys.readouterr().out)
    assert cp["table"][0]["name"] == "cluster/mine"
    assert obs_report.main(["critpath", HEALTHY, "--path"]) == 0
    assert "pre-order" in capsys.readouterr().out
    # a record without a trace exits 2, like other unusable inputs
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "manifest.json").write_text(json.dumps(
        {"name": "x", "config": {}}))
    assert obs_report.main(["critpath", str(bare)]) == 2


# ---------------------------------------------------------------------------
# the port's report and exit codes are the reference's, on both fixtures
# ---------------------------------------------------------------------------


def _report_numbers(report):
    """Findings (rule, severity, title, detail, evidence, remediation), the
    worst severity, the critical path and the waterfall's numbers and terms;
    only a term's explanatory text may differ."""
    wf = report["waterfall"]
    if wf is not None:
        wf = {**wf, "terms": [{k: v for k, v in t.items() if k != "detail"}
                              for t in wf["terms"]]}
    return report["findings"], report["worst"], report["critpath"], wf


@pytest.mark.parametrize("run", [HEALTHY, SKEWED])
def test_port_diagnosis_equals_reference(run):
    from repro.obs import doctor as ref_doctor
    from repro.obs import runlog as ref_runlog
    from repro_torch.obs import doctor as port_doctor
    from repro_torch.obs import runlog as port_runlog

    want = ref_doctor.diagnose(ref_runlog.load_run(run))
    got = port_doctor.diagnose(port_runlog.load_run(run))
    assert _report_numbers(got) == _report_numbers(want)
    assert [f["rule"] for f in got["findings"]] == [f["rule"] for f in want["findings"]]


@pytest.mark.parametrize("run", [HEALTHY, SKEWED])
@pytest.mark.parametrize("argv", [
    ["doctor", "--gate"], ["doctor"], ["doctor", "--format", "json", "--gate"],
    ["critpath"], ["critpath", "--path"], ["summary", "--format", "json"],
    ["kernels"],
])
def test_port_cli_exit_codes_equal_reference(run, argv, tmp_path, capsys):
    from repro.launch import obs_report as ref_report
    from repro_torch.launch import obs_report as port_report

    history = ["--history", str(tmp_path / "history.jsonl")] if argv[0] == "doctor" else []
    full = [argv[0], run, *argv[1:], *history]
    want = ref_report.main(full)
    want_out = capsys.readouterr().out
    got = port_report.main(full)
    got_out = capsys.readouterr().out
    assert got == want
    if argv[0] != "doctor" or "json" not in argv:
        return
    got_json, want_json = json.loads(got_out), json.loads(want_out)
    assert _report_numbers(got_json) == _report_numbers(want_json)


def test_port_cli_history_regress_exit_codes_equal_reference(tmp_path, capsys):
    from repro.launch import obs_report as ref_report
    from repro_torch.launch import obs_report as port_report

    history = tmp_path / "history.jsonl"
    rows = [{"ts": f"2026-01-0{i}T00:00:00Z", "sha": f"{i:07x}", "backend": "cuda",
             "suite": "serve_load", "keys": {"slo_p99_ms": 10.0 + i}} for i in range(1, 6)]
    history.write_text("".join(json.dumps(r) + "\n" for r in rows))
    for argv in (["history", "--history", str(history)],
                 ["regress", "--history", str(history)],
                 ["regress", "--history", str(history), "--degrade", "3.0"],
                 ["history", "--history", str(tmp_path / "missing.jsonl")]):
        try:
            want = ref_report.main(argv)
        except SystemExit as e:
            want = e.code
        want_out = capsys.readouterr().out
        try:
            got = port_report.main(argv)
        except SystemExit as e:
            got = e.code
        assert (got, capsys.readouterr().out) == (want, want_out), argv


def test_port_cli_diff_inject_baseline_equal_reference(tmp_path, capsys):
    """``diff``, ``inject-slowdown`` and ``baseline`` on a fixture and a
    ``BENCH_torch_*.json`` payload: the port's exit codes and output are the
    reference's."""
    from repro.launch import obs_report as ref_report
    from repro_torch.launch import obs_report as port_report

    bench = tmp_path / "BENCH_torch_serve.json"
    bench.write_text(json.dumps({"suite": "serve_load", "entries": [
        {"name": "service", "dispatch_overhead": 1.02, "p99_slowdown": 1.3}]}))
    for pkg, report in (("ref", ref_report), ("port", port_report)):
        assert report.main(["inject-slowdown", HEALTHY, str(tmp_path / f"slow_{pkg}"),
                            "--factor", "1.5"]) == 0
    capsys.readouterr()
    for argv in (["diff", HEALTHY, HEALTHY], ["diff", HEALTHY, str(tmp_path / "slow_ref")],
                 ["diff", HEALTHY, str(tmp_path / "slow_port")],
                 ["baseline", "--bench", str(bench)],
                 ["baseline", "--bench", str(bench), "--match", "overhead"],
                 ["baseline", HEALTHY, "--bench", str(bench), "--threshold", "0.5"]):
        want = ref_report.main(argv)
        want_out = capsys.readouterr().out.replace("slow_ref", "slow_port")
        got = port_report.main(argv)
        got_out = capsys.readouterr().out.replace("slow_ref", "slow_port")
        assert (got, got_out) == (want, want_out), argv
    assert port_report.main(["diff", HEALTHY, str(tmp_path / "slow_port")]) == 1
