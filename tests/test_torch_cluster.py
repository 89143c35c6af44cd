"""The port's cluster executor against ``repro.cluster.execute`` (vmap, CPU).

* For each seed, ``use_mxu`` and rebalancing on or off, the port's FITable
  ``{frozenset: support}`` equals the reference's: the sample only steers the
  plan, and Phase 4 mines the whole database.
* Handed the reference's plan (``plan_from_reference``), or the reference's
  threefry draws for its own planner, the port mines the same classes in
  the same rounds: each round's classes, DFS trips, estimated units and
  replication, the donations, the imbalance, the modeled makespan and the
  merged table, row for row, are equal.
* ``cluster_mine --device cpu --parity`` exits 0 and imports neither JAX nor
  the JAX package.

P = 2 here; ``test_torch_cluster_p4.py`` runs P = 4 in another worker.
Supports and trips are integers, so every comparison is exact.
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

from repro import cluster as ref_cluster
from repro.core import eclat as ref_eclat
from repro.core import fimi as ref_fimi
from repro.data.ibm_gen import IBMParams, generate_dense
from repro_torch import cluster
from repro_torch.core import eclat, fimi
from repro_torch.obs import speedup

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS = 24
# a small FI sample and a low skew threshold make the estimates skewed
# enough for the rebalancer to donate
PLANNER = dict(min_support_rel=0.08, n_db_sample=256, n_fi_sample=32, alpha=0.7)
ECLAT = dict(max_out=1 << 12, max_stack=1024, frontier_size=8)
N_DRAWS = 1 << 12  # Algorithm-R draws handed over (more than a sample streams)
CASES = [(seed, use_mxu, rebalance) for seed in (0, 1) for use_mxu in (False, True)
         for rebalance in (True, False)]


@pytest.fixture(scope="module")
def dense():
    return generate_dense(IBMParams(n_tx=512, n_items=N_ITEMS, n_patterns=8,
                                    avg_pattern_len=5, avg_tx_len=8, seed=3))


def ref_params(use_mxu, rebalance):
    return ref_cluster.ClusterParams(
        planner=ref_cluster.PlannerParams(**PLANNER), eclat=ref_eclat.EclatConfig(**ECLAT),
        rebalance=rebalance, skew_threshold=1.05, use_mxu=use_mxu,
    )


def port_params(use_mxu, rebalance):
    return cluster.ClusterParams(
        planner=cluster.PlannerParams(**PLANNER), eclat=eclat.EclatConfig(**ECLAT),
        rebalance=rebalance, skew_threshold=1.05, use_mxu=use_mxu,
    )


_DRAWS = {}


def reference_draws(seed, n_tx, n_db):
    """The reference planner's draws for ``PRNGKey(seed)``: the sample rows
    from ``k_samp`` and the Algorithm-R draws of the sample Eclat from
    ``k_mine``, where ``k_samp, k_mine = split(key)`` (``planner.py:141,150``)."""
    if (seed, n_tx, n_db) not in _DRAWS:
        def res_step(k, t):
            k, sub = jax.random.split(k)
            return k, jax.random.randint(sub, (), 0, t)

        k_samp, k_mine = jax.random.split(jax.random.PRNGKey(seed))
        idx = np.asarray(jax.random.randint(k_samp, (n_db,), 0, n_tx))
        _, js = jax.lax.scan(res_step, k_mine, jnp.arange(1, N_DRAWS + 1, dtype=jnp.int32))
        _DRAWS[seed, n_tx, n_db] = (torch.from_numpy(idx.astype(np.int64)),
                                    torch.from_numpy(np.asarray(js).astype(np.int64)))
    return _DRAWS[seed, n_tx, n_db]


def assert_same_run(got, want):
    """Rounds, donations, load telemetry and the table, row for row."""
    g, w = got.report, want.report
    assert g.n_rounds == w.n_rounds
    for a, b in zip(g.rounds, w.rounds):
        assert a.round_index == b.round_index
        assert a.classes_mined == b.classes_mined
        np.testing.assert_array_equal(a.work_iters, np.asarray(b.work_iters))
        np.testing.assert_array_equal(a.est_mined, b.est_mined)
        assert a.replication == b.replication
        assert a.donations == b.donations
    assert g.donations == w.donations
    np.testing.assert_array_equal(g.observed_loads, w.observed_loads)
    assert g.imbalance == w.imbalance
    assert g.makespan_trips == w.makespan_trips
    assert g.estimation_error() == w.estimation_error()
    assert (g.exchange_overflow, g.mine_overflow) == (w.exchange_overflow, w.mine_overflow)
    np.testing.assert_array_equal(got.table.masks, want.table.masks)
    np.testing.assert_array_equal(got.table.supports, want.table.supports)
    assert got.table.to_dict() == want.table.to_dict()

    snap, ref_snap = g.snapshot(), w.snapshot()
    assert snap["counters"] == ref_snap["counters"]
    assert snap["histograms"] == ref_snap["histograms"]
    assert set(snap["gauges"]) == set(ref_snap["gauges"])
    for name, value in snap["gauges"].items():
        if not holds_time(name):
            assert value == ref_snap["gauges"][name], name
    # the waterfall's speedup/* gauges hold times; on the reference's phase
    # and round times, the port's waterfall gives the reference's gauges
    at_ref_times = {name: ref_snap["gauges"][name] if holds_time(name) else value
                    for name, value in snap["gauges"].items()
                    if not name.startswith("speedup/")}
    wf = speedup.from_snapshot({"counters": snap["counters"], "gauges": at_ref_times,
                                "histograms": {}})
    assert wf.gauges() == {name: value for name, value in ref_snap["gauges"].items()
                           if name.startswith("speedup/")}


def holds_time(gauge: str) -> bool:
    return "phase_ms" in gauge or gauge.endswith("mine_ms") or gauge.startswith("speedup/")


def check_against_reference(dense, P, seed, use_mxu, rebalance):
    want = ref_cluster.execute(ref_fimi.shard_db(dense, P), N_ITEMS,
                               ref_params(use_mxu, rebalance), jax.random.PRNGKey(seed))
    shards = fimi.shard_db(dense, P, "cpu")
    params = port_params(use_mxu, rebalance)

    # the port's own plan: the same FITable
    free = cluster.execute(shards, N_ITEMS, params, seed=seed, device="cpu")
    assert free.table.to_dict() == want.table.to_dict()
    assert free.table.n_fis == want.table.n_fis
    assert free.report.exchange_overflow == free.report.mine_overflow == 0

    # the reference's plan: the same rounds, donations and table, row for row
    got = cluster.execute(shards, N_ITEMS, params, device="cpu",
                          plan=cluster.plan_from_reference(want.plan))
    assert_same_run(got, want)

    # the reference's draws: the port's planner makes the reference's plan
    sample_idx, draws = reference_draws(seed, len(dense) // P * P, PLANNER["n_db_sample"])
    drawn = cluster.execute(shards, N_ITEMS, params, device="cpu",
                            sample_idx=sample_idx, reservoir_draws=draws)
    assert drawn.plan.scheduler_used == want.plan.scheduler_used
    np.testing.assert_array_equal(drawn.plan.assignment, want.plan.assignment)
    assert_same_run(drawn, want)
    return want


@pytest.mark.parametrize("seed,use_mxu,rebalance", CASES)
def test_executor_equals_reference(dense, seed, use_mxu, rebalance):
    want = check_against_reference(dense, 2, seed, use_mxu, rebalance)
    if rebalance:  # the case is one where the rebalancer moves work
        assert want.report.donations


@pytest.mark.parametrize("overflow,exchange_capacity,max_out",
                         [("exchange", 48, ECLAT["max_out"]), ("mine", None, 16)])
def test_executor_without_strict_under_overflow_equals_reference(
        dense, overflow, exchange_capacity, max_out):
    """``strict=False`` with the exchange's slabs or the miners' FI buffers
    too small: no exception, and the overflow counters, the rounds' trips
    and the (truncated) table equal the reference's, row for row."""
    small = dict(ECLAT, max_out=max_out)
    knobs = dict(exchange_capacity=exchange_capacity, skew_threshold=1.05, strict=False)
    want = ref_cluster.execute(
        ref_fimi.shard_db(dense, 2), N_ITEMS,
        ref_cluster.ClusterParams(planner=ref_cluster.PlannerParams(**PLANNER),
                                  eclat=ref_eclat.EclatConfig(**small), **knobs),
        jax.random.PRNGKey(0))
    assert getattr(want.report, f"{overflow}_overflow") > 0

    def port(strict):
        return cluster.execute(
            fimi.shard_db(dense, 2, "cpu"), N_ITEMS,
            cluster.ClusterParams(planner=cluster.PlannerParams(**PLANNER),
                                  eclat=eclat.EclatConfig(**small), **dict(knobs, strict=strict)),
            device="cpu", plan=cluster.plan_from_reference(want.plan))

    assert_same_run(port(strict=False), want)
    with pytest.raises(RuntimeError, match="overflow"):
        port(strict=True)


def test_cluster_mine_parity_on_cpu_imports_neither_jax_nor_repro():
    code = (
        "import json, sys\n"
        "from repro_torch.launch import cluster_mine\n"
        "res = cluster_mine.main(['--device', 'cpu', '--db', 'T1I0.032P20PL6TL10',"
        " '--support', '0.08', '-P', '4', '--parity'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=240)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "|F| = 3370" in done.stdout
    assert "parity vs single-device fimi.run: OK (3370 itemsets" in done.stdout
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


def test_cluster_entry_points_raise_without_cuda(monkeypatch):
    """Without ``--device`` / ``device`` they ask for CUDA, and raise without it."""
    import torch

    from repro_torch.launch import cluster_mine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shards = torch.zeros((2, 4, 1), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster_mine.main(["--db", "T0.1I0.01P5PL3TL4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.execute(shards, 8, port_params(False, True))
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.plan(shards, 8, cluster.PlannerParams())
