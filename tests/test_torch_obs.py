"""The port's observability layer against the JAX package's.

* The tracer nests spans, caps its buffer and exports Chrome trace JSON as
  the reference's does, event for event (times aside).
* A run record of the port's launchers is one the reference's
  ``repro.launch.obs_report`` reads: ``summary`` and ``diff`` on
  ``mine --trace``, ``kernels --require … --check-model`` on the demo's.
* Handed the reference's Phase-1 draws, the port's ``fimi/*`` counters,
  gauges and occupancy histogram equal the reference's (wall times aside).
* A session killed by SIGTERM still leaves a loadable partial record.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eclat as ref_eclat
from repro.core import fimi as ref_fimi
from repro.data.ibm_gen import IBMParams, generate_dense
from repro.launch import obs_report
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace
from repro_torch.core import eclat, fimi
from repro_torch.launch import mine, profile_demo
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import runlog
from repro_torch.obs import trace as obs_trace

REPO = Path(__file__).resolve().parents[1]
PHASE_SPANS = {"fimi/phase1_sample", "fimi/phase2_partition", "fimi/phase3_exchange",
               "fimi/phase4_mine"}


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Every test starts (and leaves) with clean registries and tracers."""
    for m, t in ((obs_metrics, obs_trace), (ref_metrics, ref_trace)):
        m.reset()
        t.TRACER.disable()
        t.TRACER.clear()
    yield
    for m, t in ((obs_metrics, obs_trace), (ref_metrics, ref_trace)):
        m.reset()
        t.TRACER.disable()
        t.TRACER.clear()


# ---------------------------------------------------------------------------
# Tracer: the same events as the reference's
# ---------------------------------------------------------------------------


def _drive(tr, value):
    """One sequence of tracer calls; returns what ``sync`` gave back."""
    with tr.span("outer", P=4):
        with tr.span("inner"):
            got = tr.sync(value)
        tr.instant("tick", round=1)
        tr.counter("mining progress", percent=50.0, eta_s=1)
    tr.add_span("modeled", 0.0, 0.25, track="shard1", args={"trips": 9})
    return got


def _shape(export):
    """An export without its clock and thread values."""
    keep = ("ph", "name", "cat", "pid", "args", "s")
    events = [{k: e[k] for k in keep if k in e} for e in export["traceEvents"]]
    return events, export.get("truncated_events"), export["displayTimeUnit"]


def test_tracer_nesting_and_export_match_the_reference():
    ours, ref = obs_trace.Tracer(enabled=True), ref_trace.Tracer(enabled=True)
    value = torch.arange(3)
    assert _drive(ours, value) is value
    _drive(ref, np.arange(3))
    out = json.loads(json.dumps(ours.export()))      # byte round-trip
    assert _shape(out) == _shape(ref.export())
    evs = {e["name"]: e for e in out["traceEvents"] if e["ph"] == "X"}
    assert set(evs) == {"outer", "inner", "device_sync", "modeled"}
    outer, inner = evs["outer"], evs["inner"]
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"] <= inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert evs["modeled"]["dur"] == pytest.approx(0.25e6)
    assert "shard1" in {e["args"]["name"] for e in out["traceEvents"] if e["ph"] == "M"}


def test_disabled_tracer_is_inert():
    tr = obs_trace.Tracer(enabled=False)
    assert tr.span("a") is tr.span("b") is obs_trace._NULL_SPAN
    sentinel = object()
    assert _drive(tr, sentinel) is sentinel
    assert tr.n_events == 0


@pytest.mark.parametrize("cap,n,recap", [(5, 8, None), (100, 10, 4), (2, 5, None), (100, 1, None)])
def test_tracer_cap_matches_the_reference(cap, n, recap):
    exports, dropped = [], []
    for mod, metrics in ((obs_trace, obs_metrics), (ref_trace, ref_metrics)):
        tr = mod.Tracer(enabled=True, max_events=cap)
        for i in range(n):
            tr.instant(f"ev{i}")
        if recap is not None:
            tr.set_max_events(recap)
        exports.append(_shape(tr.export()))
        dropped.append((tr.dropped_events, tr.n_events,
                        metrics.snapshot()["counters"].get("trace/dropped_events")))
        tr.clear()
        assert tr.dropped_events == 0 and tr.n_events == 0
    assert exports[0] == exports[1]
    assert dropped[0] == dropped[1]


# ---------------------------------------------------------------------------
# Run records read by the reference's report CLI
# ---------------------------------------------------------------------------


def test_mine_record_reads_with_the_reference_report(tmp_path, capsys):
    rec = str(tmp_path / "mine")
    res = mine.main(["--device", "cpu", "--db", "T0.25I0.016P6PL4TL6", "--support", "0.15",
                     "-P", "2", "--trace", rec])
    run = runlog.load_run(rec)
    man = run["manifest"]
    assert man["name"] == "mine" and man["n_fis"] == res.n_fis and "mine_wall_s" in man
    assert (man["backend"], man["n_devices"]) == ("cpu", 1)
    assert [e["kind"] for e in run["events"]] == ["mined"]
    assert PHASE_SPANS <= {e["name"] for e in run["trace"]["traceEvents"] if e["ph"] == "X"}
    assert run["metrics"]["counters"]["fimi/runs"] == 1
    assert "fimi/frontier_occupancy" in run["metrics"]["histograms"]
    capsys.readouterr()
    assert obs_report.main(["summary", rec]) == 0
    out = capsys.readouterr().out
    assert "run: mine" in out and "fimi/phase4_mine" in out and "fimi/runs" in out
    assert obs_report.main(["diff", rec, rec]) == 0


def test_demo_record_passes_the_reference_kernel_check(tmp_path, capsys):
    rec = str(tmp_path / "demo")
    assert profile_demo.main(["--device", "cpu", "--trace", rec]) == 0
    assert obs_report.main(["kernels", rec, "--require", "bitmap,multi,pair,subset,delta",
                            "--check-model"]) == 0
    assert "ok: kernel attribution complete and model-consistent" in capsys.readouterr().out
    gauges = runlog.load_run(rec)["metrics"]["gauges"]
    assert gauges["kernels/machine/word_ops_peak"] == 5e10      # the CPU run's host model


def test_mine_without_a_flag_records_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mine.main(["--device", "cpu", "--db", "T0.25I0.016P6PL4TL6", "--support", "0.15", "-P", "2"])
    assert os.listdir(tmp_path) == []
    assert not obs_trace.TRACER.enabled


# ---------------------------------------------------------------------------
# fimi/* run metrics: the reference's, handed its draws
# ---------------------------------------------------------------------------

N_ITEMS, SUPPORT, P, SEED = 16, 0.12, 2, 1
ECLAT = dict(max_out=1 << 12, max_stack=1024, frontier_size=8)
SAMPLE = dict(n_db_sample=128, n_fi_sample=128)
N_DRAWS = 1 << 12


def _reference_draws(T):
    """The reference's Phase-1 draws for miner p: the sample rows from
    ``k_samp`` and the Algorithm-R draws from ``k_res``, where
    ``k_samp, k_res = split(fold_in(PRNGKey(SEED), p))``."""
    per_proc = max(1, min(SAMPLE["n_db_sample"], P * T) // P)

    def res_step(k, t):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (), 0, t)

    idx, draws = [], []
    for p in range(P):
        k_samp, k_res = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), p))
        idx.append(np.asarray(jax.random.randint(k_samp, (per_proc,), 0, T)))
        _, js = jax.lax.scan(res_step, k_res, jnp.arange(1, N_DRAWS + 1, dtype=jnp.int32))
        draws.append(torch.from_numpy(np.asarray(js).astype(np.int64)))
    return torch.from_numpy(np.stack(idx).astype(np.int64)), draws


# gauges read from a clock
WALL_GAUGES = {"progress/elapsed_s"}


def test_fimi_run_metrics_equal_the_reference():
    dense = generate_dense(IBMParams(n_tx=400, n_items=N_ITEMS, n_patterns=8,
                                     avg_pattern_len=4, avg_tx_len=6, seed=5))
    ref = ref_fimi.run(ref_fimi.shard_db(dense, P), N_ITEMS,
                       ref_fimi.FimiParams(min_support_rel=SUPPORT, **SAMPLE,
                                           eclat=ref_eclat.EclatConfig(**ECLAT)),
                       jax.random.PRNGKey(SEED))
    want = ref_metrics.snapshot()
    sample_idx, draws = _reference_draws(len(dense) // P)
    got_res = fimi.run(fimi.shard_db(dense, P, "cpu"), N_ITEMS,
                       fimi.FimiParams(min_support_rel=SUPPORT, **SAMPLE,
                                       eclat=eclat.EclatConfig(**ECLAT)),
                       seed=SEED, device="cpu", sample_idx=sample_idx, reservoir_draws=draws)
    got = obs_metrics.snapshot()
    assert got_res.n_fis == ref.n_fis
    np.testing.assert_array_equal(got_res.work_iters, np.asarray(ref.work_iters))
    assert got["counters"] == want["counters"]
    assert {k: v for k, v in got["gauges"].items() if k not in WALL_GAUGES} == \
        {k: v for k, v in want["gauges"].items() if k not in WALL_GAUGES}
    assert set(got["gauges"]) == set(want["gauges"])
    assert any(k.startswith("fimi/shard") for k in got["gauges"])
    assert got["histograms"]["fimi/frontier_occupancy"] == \
        want["histograms"]["fimi/frontier_occupancy"]
    assert got_res.progress.stragglers == pytest.approx(ref.progress.stragglers, rel=0, abs=0)


# ---------------------------------------------------------------------------
# Crash-safe sessions
# ---------------------------------------------------------------------------

_VICTIM = """\
import sys, time
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.session import ObsSession

s = ObsSession(sys.argv[1], "victim", {"x": 1}, trace_on=True, device="cpu")
obs_metrics.registry().counter("victim/progress").inc(3)
with obs_trace.TRACER.span("victim/work"):
    pass
s.event("tick", n=1)
print("READY", flush=True)
@TAIL@
"""


@pytest.mark.parametrize("tail,reason,code", [("time.sleep(120)", "sigterm", -15),
                                              ("pass", "atexit", 0)])
def test_session_flushes_a_partial_record(tmp_path, tail, reason, code):
    run_dir = tmp_path / "rec"
    proc = subprocess.Popen(
        [sys.executable, "-c", _VICTIM.replace("@TAIL@", tail), str(run_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src"}, cwd=str(REPO),
    )
    assert proc.stdout.readline().strip() == "READY"
    if reason == "sigterm":
        proc.terminate()                  # SIGTERM mid-run
    proc.wait(timeout=120)
    assert proc.returncode == code
    man = json.loads((run_dir / "manifest.json").read_text())
    assert man["name"] == "victim" and man["backend"] == "cpu"
    assert man["partial"] is True and man["partial_reason"] == reason
    run = runlog.load_run(str(run_dir))
    assert run["metrics"]["counters"]["victim/progress"] == 3
    assert "victim/work" in {e["name"] for e in run["trace"]["traceEvents"]}
    assert [e["kind"] for e in run["events"]] == ["tick"]


def test_session_finish_seals_and_disarms_crash_hooks(tmp_path):
    from repro_torch.obs.session import ObsSession

    s = ObsSession(str(tmp_path / "rec"), "ok", {}, trace_on=False, device="cpu")
    obs_metrics.registry().counter("ok/n").inc()
    s.finish(n_fis=7)
    man = json.loads((tmp_path / "rec" / "manifest.json").read_text())
    assert "partial" not in man and man["n_fis"] == 7
    s._atexit_flush()
    assert "partial" not in json.loads((tmp_path / "rec" / "manifest.json").read_text())
