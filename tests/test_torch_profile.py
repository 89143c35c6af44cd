"""The port's kernel profiler against the JAX package's (``tests/test_profile.py``'s
twin): the same cost model and shape buckets, the same report and gauges
for one sequence of recordings, a transparent disabled path (bit-identical
results, < 2 % of a dispatch), and the machine read from the device.
"""
import time

import numpy as np
import pytest
import torch

from repro.obs import metrics as ref_metrics
from repro.obs import profile as ref_profile
from repro.obs.machine import CPU_HOST as REF_CPU_HOST
from repro_torch.core import bitmap as bm
from repro_torch.kernels import ops
from repro_torch.obs import machine
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile


@pytest.fixture(autouse=True)
def _fresh_profiler():
    """Every test starts (and leaves) with a disabled, empty profiler."""
    for prof in (obs_profile.PROFILER, ref_profile.PROFILER):
        prof.disable()
        prof.clear()
    obs_metrics.reset()
    ref_metrics.reset()
    yield
    obs_profile.PROFILER.disable()
    obs_profile.PROFILER.clear()
    obs_metrics.reset()
    ref_metrics.reset()


def _db(n_tx=96, n_items=12, seed=0):
    rng = np.random.default_rng(seed)
    return bm.BitmapDB.from_dense(torch.from_numpy(rng.random((n_tx, n_items)) < 0.35))


DIMS = {
    "bitmap": [{"I": 4, "W": 2}, {"I": 100, "W": 15625}],
    "multi": [{"K": 2, "I": 4, "W": 2}, {"K": 5, "I": 100, "W": 3}, {"K": 16, "I": 100, "W": 64}],
    "pair": [{"I": 4, "W": 2}, {"I": 100, "W": 15625}, {"I": 1, "W": 1}],
    "subset": [{"Q": 2, "F": 3, "IW": 2}, {"Q": 256, "F": 293608, "IW": 4}],
    "delta": [{"S": 2, "T": 3, "F": 4, "IW": 2}, {"S": 2, "T": 65536, "F": 15324, "IW": 4}],
}


def test_cost_model_and_buckets_equal_the_reference():
    assert obs_profile.FAMILIES == ref_profile.FAMILIES
    assert obs_profile.DIM_ORDER == ref_profile.DIM_ORDER
    for family, cases in DIMS.items():
        for dims in cases:
            assert obs_profile.cost_model(family, dims) == ref_profile.cost_model(family, dims)
            assert obs_profile._bucket_label(family, dims) == \
                ref_profile._bucket_label(family, dims)
    assert obs_profile._bucket_label("multi", {"K": 5, "I": 100, "W": 3}) == \
        "multi[K=8,I=128,W=4]"
    with pytest.raises(ValueError):
        obs_profile.cost_model("nope", {})


def _feed(prof):
    """One sequence of recordings: timed calls of every family in several
    buckets, and loop attributions (one of them empty)."""
    prof.enable()
    walls = iter(np.random.default_rng(3).uniform(1e-6, 5e-3, size=64))
    for family, cases in DIMS.items():
        for dims in cases:
            for _ in range(3):
                prof.record_call(family, dims, float(next(walls)))
    prof.observe_loop("multi", {"K": 16, "I": 100, "W": 15625}, n_exec=1144, wall_s=0.25)
    prof.observe_loop("bitmap", {"I": 100, "W": 64}, n_exec=0, wall_s=1.0)


def test_report_and_publish_equal_the_reference():
    """Fed one sequence, both profilers report and publish the same numbers,
    priced against the same host model."""
    ours = obs_profile.KernelProfiler(machine=machine.CPU_HOST)
    ref = ref_profile.KernelProfiler(machine=REF_CPU_HOST)
    _feed(ours)
    _feed(ref)
    assert ours.report() == ref.report()
    ours.publish(obs_metrics.registry())
    ref.publish(ref_metrics.registry())
    assert obs_metrics.snapshot() == ref_metrics.snapshot()


def test_disabled_dispatch_bit_identical():
    """Wrapped dispatch == the naked function, profiler off or on."""
    db = _db()
    all_t = db.all_tids()
    cases = [
        (ops.extension_supports, (db.item_bits, all_t)),
        (ops.multi_extension_supports, (db.item_bits, all_t[None, :].repeat(4, 1))),
        (ops.pair_supports, (db.item_bits, all_t)),
        (ops.subset_superset_counts, (db.tx_bits[:8], db.tx_bits[:16])),
        (ops.block_itemset_supports, (db.tx_bits[:32].reshape(2, 16, -1), db.tx_bits[:16])),
    ]
    for fn, args in cases:
        want = fn.__wrapped__(*args)
        got_off = fn(*args)
        obs_profile.PROFILER.enable()
        got_on = fn(*args)
        obs_profile.PROFILER.disable()
        for w, a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (want, got_off, got_on))):
            assert torch.equal(w, a) and torch.equal(w, b)
    rep = obs_profile.PROFILER.report()
    assert all(f["calls"] == 1 for f in rep["families"].values())
    assert set(rep["families"]) == set(obs_profile.FAMILIES)
    assert rep["machine"]["name"] == "cpu-host"     # the first call's device


def test_disabled_overhead_under_2pct():
    """The disabled wrapper adds < 2 % to a real dispatch's time: its
    per-call cost on a pure-Python stub (the identical code path) against an
    eager dispatch of the plain sweep."""
    def stub(a, b):
        return a

    wrapped = ops._profiled("bitmap", lambda a, b: {"I": 1, "W": 1})(stub)
    n = 100_000

    def loop(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(1, 2)
        return time.perf_counter() - t0

    t_stub = min(loop(stub) for _ in range(5))
    t_wrapped = min(loop(wrapped) for _ in range(5))
    overhead_s = max(t_wrapped - t_stub, 0.0) / n

    db = _db()
    all_t = db.all_tids()
    ops.extension_supports(db.item_bits, all_t)
    t0 = time.perf_counter()
    for _ in range(50):
        ops.extension_supports(db.item_bits, all_t)
    dispatch_s = (time.perf_counter() - t0) / 50
    assert overhead_s < 0.02 * dispatch_s, (
        f"disabled-profiler wrapper costs {overhead_s * 1e9:.0f}ns/call = "
        f"{overhead_s / dispatch_s:.2%} of a {dispatch_s * 1e6:.0f}us dispatch")


def test_eager_call_measured_vs_modeled():
    db = _db()
    obs_profile.PROFILER.enable()
    for _ in range(3):
        ops.pair_supports(db.item_bits, db.all_tids())
    fam = obs_profile.PROFILER.report()["families"]["pair"]
    assert fam["calls"] == 3 and fam["loop_execs"] == 0 and fam["trace_dispatches"] == 0
    assert fam["measured_ms"] > 0.0
    assert fam["modeled_ms"] == pytest.approx(max(fam["compute_ms"], fam["memory_ms"]))
    assert fam["achieved_frac"] == pytest.approx(fam["modeled_ms"] / fam["measured_ms"])
    b = fam["buckets"][0]
    assert b["min_us"] is not None and b["max_us"] >= b["min_us"]


def test_machine_for_device(monkeypatch):
    assert machine.machine_for_device("cpu") is machine.CPU_HOST
    for field in ("peak_flops", "hbm_bw", "link_bw", "word_ops_peak"):
        assert getattr(machine.CPU_HOST, field) == getattr(REF_CPU_HOST, field)
    h = machine.H100_SXM
    assert (h.hbm_bw, h.peak_flops) == (3.35e12, 989e12)
    assert h.word_ops_peak == 132 * 1.98e9 * 64
    assert h.balance_word_ops_per_byte > machine.CPU_HOST.balance_word_ops_per_byte

    class Props:
        multi_processor_count = 114

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda index: Props())
    card = machine.machine_for_device(torch.device("cuda", 0))
    assert card.name == "h100-sxm" and card.word_ops_peak == 114 * 1.98e9 * 64
    Props.multi_processor_count = 132
    assert machine.machine_for_device(torch.device("cuda", 0)) == machine.H100_SXM


def test_machine_comes_from_the_first_call_or_enable():
    prof = obs_profile.KernelProfiler()
    prof.enable()
    prof.call("bitmap", {"I": 1, "W": 1}, lambda: 0, torch.device("cpu"))
    assert prof.machine is machine.CPU_HOST
    prof.clear()
    named = obs_profile.KernelProfiler()
    named.enable(machine.H100_SXM)
    named.call("bitmap", {"I": 1, "W": 1}, lambda: 0, torch.device("cpu"))
    assert named.report()["machine"]["name"] == "h100-sxm"
