"""The port's cluster planner against ``repro.cluster.plan``.

Handed the reference's threefry draws (the Thm 6.1 sample rows from
``k_samp`` and the Algorithm-R draws of the sample Eclat from ``k_mine``,
where ``k_samp, k_mine = split(key)``, ``planner.py:141,150``), the port
builds the same plan for every scheduler: the FI sample, the classes, their
estimated sizes, the assignment and loads, the scheduler chosen, both
replicated volumes and the ancestor masks.  ``plan_from_reference`` carries a
plan across unchanged.  Every comparison is exact.
"""
import jax
import numpy as np
import pytest

from repro import cluster as ref_cluster
from repro.core import fimi as ref_fimi
from repro.data.ibm_gen import IBMParams, generate_dense
from repro_torch import cluster
from repro_torch.core import fimi
from test_torch_cluster import reference_draws

N_ITEMS = 24
P = 4
PLANNER = dict(min_support_rel=0.08, n_db_sample=256, n_fi_sample=128, alpha=0.7)


@pytest.fixture(scope="module")
def dense():
    return generate_dense(IBMParams(n_tx=512, n_items=N_ITEMS, n_patterns=8,
                                    avg_pattern_len=5, avg_tx_len=8, seed=3))


def assert_same_plan(got, want):
    for name in ("n_items", "n_tx", "P", "abs_minsup", "scheduler_used", "n_ancestors",
                 "n_db_sample", "n_fi_sample", "eps_db_effective", "lpt_volume"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_equal(got.repl_volume, want.repl_volume)   # NaN under "lpt"
    for name in ("sample_masks", "est_sizes", "assignment", "est_loads",
                 "ancestor_masks", "sample_item_rel"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
    assert len(got.classes) == len(want.classes)
    for a, b in zip(got.classes, want.classes):
        np.testing.assert_array_equal(a.prefix, b.prefix)
        np.testing.assert_array_equal(a.ext, b.ext)
        assert (a.est_count, a.seq) == (b.est_count, b.seq)
    assert got.shard_queues() == want.shard_queues()


@pytest.mark.parametrize("scheduler", ["lpt", "repl_min", "auto"])
@pytest.mark.parametrize("seed", [0, 3])
def test_plan_equals_reference_with_its_draws(dense, seed, scheduler):
    params = dict(PLANNER, scheduler=scheduler)
    want = ref_cluster.plan(ref_fimi.shard_db(dense, P), N_ITEMS,
                            ref_cluster.PlannerParams(**params), jax.random.PRNGKey(seed))
    sample_idx, draws = reference_draws(seed, len(dense) // P * P, PLANNER["n_db_sample"])
    got = cluster.plan(fimi.shard_db(dense, P, "cpu"), N_ITEMS, cluster.PlannerParams(**params),
                       device="cpu", sample_idx=sample_idx, reservoir_draws=draws)
    assert got.scheduler_used == (scheduler if scheduler != "auto" else want.scheduler_used)
    assert_same_plan(got, want)
    assert_same_plan(cluster.plan_from_reference(want), want)

    # the seeds each round hands Phase 4 are the same arrays
    take = [q[:3] for q in want.shard_queues()]
    for a, b in zip(cluster.pack_seeds(got.classes, take, N_ITEMS, 4),
                    ref_cluster.pack_seeds(want.classes, take, N_ITEMS, 4)):
        np.testing.assert_array_equal(a, b)


def test_plan_from_its_own_generators_is_deterministic(dense):
    """Without injected draws the plan comes from the seed's generators: the
    same seed gives the same plan."""
    shards = fimi.shard_db(dense, P, "cpu")
    a, b = (cluster.plan(shards, N_ITEMS, cluster.PlannerParams(**PLANNER), seed=5,
                         device="cpu") for _ in range(2))
    assert_same_plan(a, b)
    assert sorted(c for q in a.shard_queues() for c in q) == list(range(len(a.classes)))
