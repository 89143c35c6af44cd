"""The port's sliding-window SLO engine against the JAX package's.

Both packages' :class:`WindowedHistogram`, :class:`WindowedCounter` and
:class:`SLOTracker` are driven by one script of records, sheds, errors and
clock advances on two fake clocks that read the same time.  Every percentile,
count, rate, burn rate, status field, alert transition and ``alerts_since``
answer must be equal, tolerance 0: the scripts are the reference tests'
scenarios (``tests/test_slo.py``) and random ones.
"""
import dataclasses

import numpy as np
import pytest

from repro.obs import slo as ref_slo
from repro_torch.obs import slo


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _policy(mod, **kw):
    base = dict(p99_ms=50.0, availability=0.9, window_s=30.0, slots=6,
                burn_hi=2.0, burn_lo=1.0, latency_clear=0.8, min_requests=10)
    base.update(kw)
    return mod.SLOPolicy(**base)


def _status(st) -> dict:
    return dataclasses.asdict(st)


def _tracker_pair(**policy):
    clocks = FakeClock(), FakeClock()
    want = ref_slo.SLOTracker(_policy(ref_slo, **policy), clock=clocks[0])
    got = slo.SLOTracker(_policy(slo, **policy), clock=clocks[1])
    fired = ([], [])
    want.on_alert(fired[0].append)
    got.on_alert(fired[1].append)
    return clocks, want, got, fired


def _play(script, **policy):
    """Run one script on both trackers; every evaluation compared."""
    clocks, want, got, fired = _tracker_pair(**policy)
    n_eval = 0
    for op, *arg in script:
        if op == "ok":
            want.record_ok(arg[0])
            got.record_ok(arg[0])
        elif op == "shed":
            want.record_shed()
            got.record_shed()
        elif op == "err":
            want.record_error()
            got.record_error()
        elif op == "adv":
            for c in clocks:
                c.t += arg[0]
        else:
            assert _status(got.evaluate()) == _status(want.evaluate())
            n_eval += 1
    assert _status(got.evaluate()) == _status(want.evaluate())
    assert got.alerts == want.alerts and fired[1] == fired[0]
    for t in (0.0, 100.0, 131.0, 1e9) + tuple(ev["t"] for ev in want.alerts):
        assert got.alerts_since(t) == want.alerts_since(t)
    return n_eval, want.alerts


def _repeat(op, n, *arg):
    return [(op, *arg)] * n


SCRIPTS = {
    # the reference's burn-rate hysteresis scenario
    "burn_hysteresis": (
        _repeat("ok", 40, 5.0) + [("eval",)] + _repeat("shed", 18) + [("eval",), ("eval",)]
        + [("adv", 31.0)] + _repeat("ok", 85, 5.0) + _repeat("shed", 15) + [("eval",)]
        + [("adv", 31.0)] + _repeat("ok", 50, 5.0) + [("eval",), ("eval",)]),
    "latency_hysteresis": (
        _repeat("ok", 30, 100.0) + [("eval",), ("adv", 31.0)] + _repeat("ok", 30, 45.0)
        + [("eval",), ("adv", 31.0)] + _repeat("ok", 30, 10.0) + [("eval",)]),
    "min_requests": _repeat("shed", 3) + [("eval",)],
    "errors_and_rates": ([("adv", 10.0)] + _repeat("ok", 80, 5.0) + _repeat("err", 10)
                         + _repeat("shed", 10) + [("eval",)]),
    "alerts_since": (_repeat("shed", 20) + [("eval",), ("adv", 31.0)]
                     + _repeat("ok", 50, 1.0) + [("eval",)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tracker_scenarios_equal_the_reference(name):
    n_eval, alerts = _play(SCRIPTS[name])
    assert n_eval >= 1
    if name in ("burn_hysteresis", "latency_hysteresis", "alerts_since"):
        assert [e["kind"] for e in alerts] == ["slo_alert", "slo_clear"]


def _random_script(seed: int, n: int = 600):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            ops.append(("ok", float(rng.lognormal(3.0, 1.2))))
        elif r < 0.72:
            ops.append(("shed",))
        elif r < 0.8:
            ops.append(("err",))
        elif r < 0.9:
            ops.append(("adv", float(rng.choice([0.5, 2.0, 4.9, 5.0, 7.3, 31.0]))))
        else:
            ops.append(("eval",))
    return ops


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", [
    {},
    {"p99_ms": 20.0, "availability": 0.99, "window_s": 5.0, "slots": 5, "min_requests": 20},
    {"burn_hi": 1.5, "burn_lo": 0.5, "latency_clear": 0.5, "window_s": 12.0, "slots": 4},
])
def test_tracker_random_scripts_equal_the_reference(seed, policy):
    n_eval, alerts = _play(_random_script(seed), **policy)
    assert n_eval > 10


@pytest.mark.parametrize("window_s,slots", [(30.0, 6), (10.0, 5), (12.0, 4), (5.0, 2)])
def test_windowed_histogram_and_counter_equal_the_reference(window_s, slots):
    """Rotating windows, bursts and gaps longer than the window: every
    percentile, summary, count, value and rate is the reference's."""
    clocks = FakeClock(), FakeClock()
    hists = (ref_slo.WindowedHistogram("t/lat", window_s, slots, clock=clocks[0]),
             slo.WindowedHistogram("t/lat", window_s, slots, clock=clocks[1]))
    counters = (ref_slo.WindowedCounter("t/n", window_s, slots, clock=clocks[0]),
                slo.WindowedCounter("t/n", window_s, slots, clock=clocks[1]))
    rng = np.random.default_rng(int(window_s * 10 + slots))
    assert hists[1].window_s == hists[0].window_s
    for step in range(60):
        for v in rng.lognormal(0.0, 1.5, size=int(rng.integers(0, 40))):
            for h in hists:
                h.record(float(v))
        k = int(rng.integers(0, 5))
        for c in counters:
            c.inc(k)
        for q in (50, 95, 99):
            assert hists[1].percentile(q) == hists[0].percentile(q)
        assert hists[1].summary() == hists[0].summary()
        assert hists[1].count == hists[0].count
        assert counters[1].value == counters[0].value
        assert counters[1].rate() == counters[0].rate()
        dt = float(rng.choice([window_s / slots, 0.3, window_s, 2 * window_s, 0.0]))
        for c in clocks:
            c.t += dt


def test_policy_budget_and_defaults_equal_the_reference():
    assert dataclasses.asdict(slo.SLOPolicy()) == dataclasses.asdict(ref_slo.SLOPolicy())
    for a in (0.9, 0.99, 0.999, 1.0):
        assert slo.SLOPolicy(availability=a).budget == ref_slo.SLOPolicy(availability=a).budget
    assert [f.name for f in dataclasses.fields(slo.SLOStatus)] == \
        [f.name for f in dataclasses.fields(ref_slo.SLOStatus)]
