"""The port's SLO-gated load harness (``launch/serve_load.py``).

Twins of ``tests/test_serve_load.py``'s four cases on the CPU, with the same
argv: a healthy run passes the gate and records the windowed SLO keys, an
injected overload trips the burn-rate alert and exits 1, ``--trace`` yields
a per-request Perfetto timeline, and ``merge_bench`` keeps existing keys.
Against the JAX package: ``build_pools`` and ``Workload.draw`` give the
reference's masks and kinds for the same seed, and ``merge_bench`` the
reference's file.  Every run writes only under ``tmp_path`` (the working
directory is moved there: the gated run appends to the port's history file
in the working directory).
"""
import json

import numpy as np
import pytest

from repro.core import eclat as ref_eclat
from repro.data.ibm_gen import generate_dense, params_from_name
from repro.launch import serve_load as ref_serve_load
from repro.obs import perfdb as ref_perfdb
from repro_torch.launch import serve_load
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

DB = "T0.25I0.016P6PL4TL6"      # 250 tx, 16 items: serving is under test


@pytest.fixture(autouse=True)
def _fresh_obs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    obs_metrics.reset()
    obs_trace.TRACER.disable()
    obs_trace.TRACER.clear()
    yield
    obs_metrics.reset()
    obs_trace.TRACER.disable()
    obs_trace.TRACER.clear()


def _argv(tmp_path, **over):
    base = {
        "--db": DB, "--qps": "150", "--duration": "1.5", "--ramp": "0.5",
        "--window": "1.0", "--report-every": "0.25", "--replicas": "2",
        "--batch": "32", "--deadline-ms": "4.0",
        "--slo-p99-ms": "500", "--availability": "0.99",
        "--bench-out": str(tmp_path / "BENCH_torch_serve.json"),
        "--device": "cpu",
    }
    base.update({k: str(v) for k, v in over.items()})
    argv = [a for kv in base.items() for a in kv if a != ""]
    return argv + ["--no-dashboard", "--gate"]


def _files(tmp_path):
    return sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*"))


def test_healthy_load_passes_gate_and_records_slo_keys(tmp_path, capsys):
    rc = serve_load.main(_argv(tmp_path) + ["--compare-dispatch"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "SLO gate: ok" in out
    bench = json.loads((tmp_path / "BENCH_torch_serve.json").read_text())
    for k in ("slo_target_qps", "slo_qps", "slo_p99_ms",
              "slo_p99_objective_ms", "slo_shed_rate", "slo_burn_rate",
              "slo_alerts_fired", "slo_gate_ok"):
        assert k in bench, k
    assert bench["slo_gate_ok"] is True
    assert bench["slo_alerts_fired"] == 0
    assert bench["slo_p99_ms"] is not None
    assert bench["slo_p99_ms"] <= bench["slo_p99_objective_ms"]
    # the fused micro-batch sweep beats per-query dispatch
    assert bench["slo_microbatch_speedup"] > 1.0
    # the gated run appended one row to the port's own history, which the
    # reference loads; nothing else landed in the working directory
    rows, corrupt = ref_perfdb.load(str(tmp_path / "BENCH_torch_HISTORY.jsonl"))
    assert corrupt == 0 and len(rows) == 1
    assert rows[0]["suite"] == "serve_load" and rows[0]["backend"] == "cpu"
    assert rows[0]["keys"]["slo_p99_ms"] == bench["slo_p99_ms"]
    assert _files(tmp_path) == ["BENCH_torch_HISTORY.jsonl", "BENCH_torch_serve.json"]


def test_injected_overload_trips_burn_alert_and_gate(tmp_path, capsys):
    run = serve_load.run(_argv(tmp_path, **{"--qps": "30000", "--max-queue": "32"}))
    cap = capsys.readouterr()
    assert run.rc == 1, cap.out
    assert "SLO GATE FAILED" in cap.err
    assert "[slo] slo_alert (availability)" in cap.err
    bench = json.loads((tmp_path / "BENCH_torch_serve.json").read_text())
    assert bench["slo_gate_ok"] is False
    # cumulative, not the final-window rate: once the generator stops the
    # service catches up and the windowed shed rate can decay back to zero
    assert bench["slo_shed_total"] > 0
    assert bench["slo_shed_rate"] >= 0.0
    # what the run hands back: the service, its tickets, the alerts
    st = run.svc.stats()
    assert st["shed"] == bench["slo_shed_total"] and st["errors"] == 0
    assert run.unresolved == 0 and all(t.done() for t in run.tickets)
    assert run.measure_alerts and run.slo_keys == {
        k: v for k, v in bench.items() if k.startswith("slo_")}


def test_trace_run_records_per_request_timeline(tmp_path, capsys):
    run_dir = tmp_path / "rec"
    rc = serve_load.main(_argv(tmp_path) + ["--trace", str(run_dir)])
    assert rc == 0, capsys.readouterr().out
    trace = json.loads((run_dir / "trace.json").read_text())
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    assert {"service/enqueue", "service/flush", "service/assemble",
            "service/sweep", "service/respond"} <= names
    # request ids thread the chain: every swept id was enqueued
    enq_ids = {e["args"]["req"] for e in spans
               if e["name"] == "service/enqueue"}
    sweep_ids = {i for e in spans if e["name"] == "service/sweep"
                 for i in e["args"]["reqs"]}
    assert sweep_ids and sweep_ids <= enq_ids
    man = json.loads((run_dir / "manifest.json").read_text())
    assert man["name"] == "serve_load" and "partial" not in man
    assert man["slo_gate_ok"] is True and "slo_p99_ms" in man
    metrics = json.loads((run_dir / "metrics.json").read_text())
    assert metrics["counters"]["service/flushes"] > 0
    assert "service/latency_ms" in metrics["histograms"]


def test_merge_bench_preserves_existing_keys(tmp_path):
    p = tmp_path / "BENCH_torch_serve.json"
    p.write_text(json.dumps({"bench": "serve", "entries": [1, 2],
                             "engine_us": 42.0}))
    serve_load.merge_bench(str(p), {"slo_qps": 99.0})
    d = json.loads(p.read_text())
    assert d["entries"] == [1, 2] and d["engine_us"] == 42.0
    assert d["slo_qps"] == 99.0
    # and a fresh file self-initializes
    p2 = tmp_path / "new.json"
    serve_load.merge_bench(str(p2), {"slo_qps": 1.0})
    assert json.loads(p2.read_text())["bench"] == "serve"


@pytest.mark.parametrize("existing", [None, {"bench": "serve", "entries": [1], "x_us": 3.0,
                                             "meta": {"git_sha": "a", "backend": "cpu",
                                                      "ts": "T"}}])
def test_merge_bench_equals_the_reference(tmp_path, existing):
    files = [tmp_path / "port.json", tmp_path / "ref.json"]
    for f, merge in zip(files, (serve_load.merge_bench, ref_serve_load.merge_bench)):
        if existing is not None:
            f.write_text(json.dumps(existing))
        merge(str(f), {"slo_qps": 5.0, "slo_p99_ms": None, "slo_gate_ok": True})
    got, want = (json.loads(f.read_text()) for f in files)
    if existing is None:   # stamped fresh: the time differs, the rest not
        assert got["meta"].pop("ts") and want["meta"].pop("ts")
    assert got == want


@pytest.mark.parametrize("db,support,pool,seed", [
    (DB, 0.08, 64, 0), ("T0.5I0.024P8PL5TL8", 0.08, 16, 3), ("T0.3I0.05P8PL5TL8", 0.05, 40, 7)])
def test_pools_and_draws_equal_the_reference(db, support, pool, seed):
    dense = generate_dense(params_from_name(db, seed=seed))
    n_tx, n_items = dense.shape
    fis = ref_eclat.brute_force_fis(dense, int(np.ceil(support * n_tx)))
    want = ref_serve_load.build_pools(np.random.default_rng(seed), fis, dense, n_items, pool)
    got = serve_load.build_pools(np.random.default_rng(seed), fis, dense, n_items, pool)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.uint32
        np.testing.assert_array_equal(got[k], want[k])
    workloads = [mod.Workload(np.random.default_rng(seed + 1), pools, zipf_a=1.3,
                              drift_every=0.5, drift_step=7)
                 for mod, pools in ((ref_serve_load, want), (serve_load, got))]
    workloads[1].t0 = workloads[0].t0 = 100.0
    for now in np.linspace(100.0, 104.0, 400):
        (wk, wm), (gk, gm) = (w.draw(float(now)) for w in workloads)
        assert gk == wk
        np.testing.assert_array_equal(gm, wm)
    assert serve_load.KINDS == ref_serve_load.KINDS
    assert serve_load.KIND_MIX == ref_serve_load.KIND_MIX


def test_parser_defaults_equal_the_reference_but_the_files():
    """The same flags and defaults; ``--device`` stands for ``--devices``
    and the port writes its own BENCH file."""
    got = vars(serve_load.build_parser().parse_args([]))
    assert got.pop("device") == "cuda" and got.pop("bench_out") == "BENCH_torch_serve.json"
    for k in ("trace", "metrics", "profile", "torch_profile", "doctor"):
        got.pop(k)
    assert got == {
        "db": "T0.5I0.024P8PL5TL8", "support": 0.08, "minconf": 0.3, "replicas": 2,
        "batch": 64, "deadline_ms": 4.0, "max_queue": 1024, "cache": 2048, "topk": 5,
        "qps": 200.0, "closed": 0, "duration": 10.0, "ramp": 2.0, "pool": 64, "zipf": 1.3,
        "drift_every": 5.0, "window": 5.0, "slo_p99_ms": 200.0, "availability": 0.99,
        "burn_hi": 2.0, "burn_lo": 1.0, "report_every": 0.5, "no_dashboard": False,
        "gate": False, "compare_dispatch": False, "seed": 0}
