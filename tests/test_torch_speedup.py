"""The speedup-loss waterfall of both packages (``repro.obs.speedup`` and
``repro_torch.obs.speedup``): the reference's cases of ``test_speedup.py``,
each run through both — exact additivity of the decomposition, the
compile/estimation/imbalance term math on synthetic snapshots, the coarse
BENCH-entry split, the perf-ledger key naming, and the committed golden
fixture records — and the port's waterfall equal to the reference's on
both fixtures."""
import dataclasses
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data"


@pytest.fixture(params=["repro", "repro_torch"])
def pkg(request):
    return request.param


@pytest.fixture
def speedup(pkg):
    return importlib.import_module(f"{pkg}.obs.speedup")


@pytest.fixture
def perfdb(pkg):
    return importlib.import_module(f"{pkg}.obs.perfdb")


@pytest.fixture
def runlog(pkg):
    return importlib.import_module(f"{pkg}.obs.runlog")


def _snap(gauges, counters=None):
    return {"counters": counters or {}, "gauges": gauges, "histograms": {}}


def _balanced_gauges(P=2, load=100.0, mine_ms=100.0):
    g = {
        "cluster/imbalance": 1.0,
        "cluster/makespan_trips": load,
        "cluster/load/estimation_error": 0.0,
        "cluster/phase_ms/plan": 1.0,
        "cluster/phase_ms/exchange": 2.0,
        "cluster/phase_ms/mine": mine_ms,
        "cluster/phase_ms/merge": 1.0,
    }
    for p in range(P):
        g[f"cluster/shard{p}/est_load"] = load
        g[f"cluster/shard{p}/obs_load"] = load
    return g


# ---------------------------------------------------------------------------
# from_snapshot: the per-run decomposition
# ---------------------------------------------------------------------------


def test_not_a_cluster_run_returns_none(speedup, perfdb, runlog):
    assert speedup.from_snapshot(_snap({})) is None
    assert speedup.from_snapshot(
        _snap({"fimi/n_fis": 3.0, "cluster/phase_ms/mine": 10.0})) is None


def test_balanced_run_decomposes_exactly(speedup, perfdb, runlog):
    wf = speedup.from_snapshot(_snap(_balanced_gauges()))
    assert wf is not None and wf.source == "run"
    assert wf.P == 2 and wf.ideal_x == 2.0
    # rho = 100ms / 100 trips; T_ideal = (200/2)*1 = 100ms; TP = 104ms
    assert wf.ideal_ms == pytest.approx(100.0)
    assert wf.wall_ms == pytest.approx(104.0)
    assert wf.measured_x == pytest.approx(2 * 100.0 / 104.0)
    by_name = {t.name: t for t in wf.terms}
    assert by_name["imbalance"].loss_x == pytest.approx(0.0)
    assert by_name["estimation"].loss_x == pytest.approx(0.0)
    assert by_name["exchange"].ms == pytest.approx(2.0)
    assert by_name["host_tail"].ms == pytest.approx(2.0)
    # the gate the acceptance criteria check: terms sum to the gap
    assert wf.additivity_error() < 1e-9


def test_unpredicted_skew_prices_the_estimation_term(speedup, perfdb, runlog):
    # planner predicted balance, one shard got all the work
    g = _balanced_gauges()
    g.update({
        "cluster/shard0/obs_load": 200.0,
        "cluster/shard1/obs_load": 0.0,
        "cluster/makespan_trips": 200.0,
        "cluster/phase_ms/mine": 200.0,
        "cluster/imbalance": 2.0,
        "cluster/load/estimation_error": 0.5,
    })
    wf = speedup.from_snapshot(_snap(g))
    by_name = {t.name: t for t in wf.terms}
    # rho = 1 ms/trip, t_ideal 100; obs max share 1.0 vs est 0.5 →
    # d_est = 0.5 * 200 * 1 = 100 ms: ALL the skew was unpredicted
    assert by_name["estimation"].ms == pytest.approx(100.0)
    assert by_name["imbalance"].ms == pytest.approx(0.0)
    assert wf.additivity_error() < 1e-9


def test_planned_skew_stays_in_the_imbalance_term(speedup, perfdb, runlog):
    # estimates already said shard0 gets everything: nothing unpredicted
    g = _balanced_gauges()
    g.update({
        "cluster/shard0/est_load": 200.0, "cluster/shard0/obs_load": 200.0,
        "cluster/shard1/est_load": 0.0, "cluster/shard1/obs_load": 0.0,
        "cluster/makespan_trips": 200.0,
        "cluster/phase_ms/mine": 200.0,
        "cluster/imbalance": 2.0,
    })
    wf = speedup.from_snapshot(_snap(g))
    by_name = {t.name: t for t in wf.terms}
    assert by_name["estimation"].ms == pytest.approx(0.0)
    assert by_name["imbalance"].ms == pytest.approx(100.0)
    assert wf.measured_x == pytest.approx(2 * 100.0 / 204.0)
    assert wf.additivity_error() < 1e-9


def test_round0_excess_becomes_the_compile_term(speedup, perfdb, runlog):
    g = _balanced_gauges(mine_ms=150.0)
    # two rounds of 50 trips each; round 0 took 100 ms, round 1 took 50:
    # the steady rate is 1 ms/trip, so 50 ms of round 0 is jit warm-up
    g.update({
        "cluster/round0/mine_ms": 100.0, "cluster/round0/max_trips": 50.0,
        "cluster/round1/mine_ms": 50.0, "cluster/round1/max_trips": 50.0,
    })
    wf = speedup.from_snapshot(_snap(g))
    by_name = {t.name: t for t in wf.terms}
    assert by_name["compile"].ms == pytest.approx(50.0)
    # priced at rho: t_ideal = (200/2) * 1 = 100, imbalance absorbs the rest
    assert by_name["imbalance"].ms == pytest.approx(0.0)
    assert wf.additivity_error() < 1e-9


def test_wall_clock_residual_becomes_the_driver_term(speedup, perfdb, runlog):
    wf = speedup.from_snapshot(_snap(_balanced_gauges()), wall_ms=110.0)
    by_name = {t.name: t for t in wf.terms}
    assert by_name["driver"].ms == pytest.approx(6.0)   # 110 - 104 in phases
    assert wf.wall_ms == pytest.approx(110.0)
    assert wf.additivity_error() < 1e-9


def test_from_run_uses_manifest_mine_wall(speedup, perfdb, runlog, tmp_path):
    run = {
        "manifest": {"mine_wall_s": 0.110},
        "metrics": _snap(_balanced_gauges()),
    }
    wf = speedup.from_run(run)
    assert wf.wall_ms == pytest.approx(110.0)
    assert speedup.from_run({"manifest": {}, "metrics": {}}) is None


def test_gauges_and_publish_roundtrip(speedup, perfdb, runlog):
    wf = speedup.from_snapshot(_snap(_balanced_gauges()))
    g = wf.gauges()
    assert g["speedup/ideal_x"] == 2.0
    assert g["speedup/measured_x"] == pytest.approx(wf.measured_x)
    assert g["speedup/gap_x"] == pytest.approx(wf.gap_x)
    assert g["speedup/additivity_err"] < 1e-9
    for t in wf.terms:
        assert g[f"speedup/loss/{t.name}_x"] == pytest.approx(t.loss_x)

    class _FakeReg:
        def __init__(self):
            self.vals = {}

        def gauge(self, name):
            reg = self

            class _G:
                def set(self, v, _n=name):
                    reg.vals[_n] = v
            return _G()

    reg = _FakeReg()
    wf.publish(reg)
    assert reg.vals == pytest.approx(g)


def test_renderers_mention_every_term(speedup, perfdb, runlog):
    wf = speedup.from_snapshot(_snap(_balanced_gauges()))
    txt = wf.render_text()
    md = wf.render_markdown()
    for t in wf.terms:
        assert t.name in txt and t.name in md
    assert "ideal 2.00x" in txt
    assert "| term | Δ speedup | why |" in md


# ---------------------------------------------------------------------------
# from_bench_entries: the coarse two-term split over BENCH_cluster.json
# ---------------------------------------------------------------------------

_ENTRIES = [
    {"name": "cluster_speedup", "P": 1, "makespan_trips": 1000.0,
     "imbalance": 1.0},
    {"name": "cluster_speedup", "P": 4, "makespan_trips": 400.0,
     "imbalance": 1.25, "wall_s": 0.5},
    {"name": "cluster_rebalanced", "P": 4, "makespan_trips": 390.0},
]


def test_bench_split_is_exact(speedup, perfdb, runlog):
    wfs = speedup.from_bench_entries(_ENTRIES)
    assert sorted(wfs) == [4]           # P=1 is the baseline, not a point
    wf = wfs[4]
    S = 1000.0 / 400.0
    assert wf.measured_x == pytest.approx(S)
    by_name = {t.name: t for t in wf.terms}
    assert by_name["inflation"].loss_x == pytest.approx(4 - S * 1.25)
    assert by_name["imbalance"].loss_x == pytest.approx(S * 0.25)
    assert wf.additivity_error() < 1e-12
    assert wf.source == "bench"


def test_bench_without_baseline_is_empty(speedup, perfdb, runlog):
    assert speedup.from_bench_entries(_ENTRIES[1:]) == {}
    assert speedup.from_bench_entries([]) == {}


def test_bench_loss_keys_are_lower_better_for_the_ledger(speedup, perfdb, runlog):
    keys = speedup.bench_loss_keys(_ENTRIES)
    assert set(keys) == {"loss_inflation_x_p4", "loss_imbalance_x_p4",
                         "loss_total_x_p4"}
    assert keys["loss_total_x_p4"] == pytest.approx(
        keys["loss_inflation_x_p4"] + keys["loss_imbalance_x_p4"], abs=1e-5)
    # perfdb must read every loss key as lower-is-better — a rising loss
    # is a regression even though it comes from the speedup curve
    for k in keys:
        assert perfdb.direction(k) == "lower"


# ---------------------------------------------------------------------------
# golden fixture records
# ---------------------------------------------------------------------------


def _load_fixture(runlog, name):
    return runlog.load_run(str(FIXTURES / name))


def test_healthy_fixture_waterfall(speedup, perfdb, runlog):
    wf = speedup.from_run(_load_fixture(runlog, "run_healthy"))
    assert wf.P == 2
    assert wf.measured_x == pytest.approx(2 * 100.0 / 106.0)
    by_name = {t.name: t for t in wf.terms}
    assert by_name["imbalance"].loss_x == pytest.approx(0.0)
    assert by_name["driver"].ms == pytest.approx(2.0)
    assert wf.additivity_error() < 0.05        # the acceptance gate


def test_skewed_fixture_waterfall_dominated_by_imbalance(speedup, perfdb, runlog):
    wf = speedup.from_run(_load_fixture(runlog, "run_skewed_cluster"))
    assert wf.measured_x == pytest.approx(2 * 100.0 / 206.0)
    by_name = {t.name: t for t in wf.terms}
    # planned skew: the estimation term must NOT absorb it
    assert by_name["estimation"].loss_x == pytest.approx(0.0)
    assert by_name["imbalance"].loss_x == pytest.approx(2 * 100.0 / 206.0)
    assert by_name["imbalance"].loss_x > 0.5 * wf.gap_x
    assert wf.additivity_error() < 0.05


# ---------------------------------------------------------------------------
# the port's waterfall is the reference's
# ---------------------------------------------------------------------------


def _numbers(wf):
    """A waterfall's numbers and terms, without their explanatory text (the
    port's ``compile`` term explains a warm-up that is not a jit)."""
    terms = [{k: v for k, v in dataclasses.asdict(t).items() if k != "detail"}
             for t in wf.terms]
    return (wf.P, wf.ideal_x, wf.measured_x, wf.wall_ms, wf.ideal_ms, wf.source,
            wf.gap_x, wf.additivity_error(), terms, wf.gauges())


@pytest.mark.parametrize("name", ["run_healthy", "run_skewed_cluster"])
def test_port_waterfall_equals_reference(name):
    from repro.obs import runlog as ref_runlog
    from repro.obs import speedup as ref_speedup
    from repro_torch.obs import runlog as port_runlog
    from repro_torch.obs import speedup as port_speedup

    want = ref_speedup.from_run(ref_runlog.load_run(str(FIXTURES / name)))
    got = port_speedup.from_run(port_runlog.load_run(str(FIXTURES / name)))
    assert _numbers(got) == _numbers(want)
    assert [t.name for t in got.terms] == [t.name for t in want.terms]
    # the bench split too
    assert {P: _numbers(w) for P, w in port_speedup.from_bench_entries(_ENTRIES).items()} == \
        {P: _numbers(w) for P, w in ref_speedup.from_bench_entries(_ENTRIES).items()}
    assert port_speedup.bench_loss_keys(_ENTRIES) == ref_speedup.bench_loss_keys(_ENTRIES)
