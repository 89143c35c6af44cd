"""Round checkpoints of the port's cluster executor, across both packages.

* ``plan_fingerprint`` gives the reference's string for the same plan.
* A checkpoint the reference writes before a death resumes in the port to
  the reference's unbroken FITable, row for row, and one the port writes
  resumes in the reference: one format, ``cluster-ckpt-v1``.
* The port's own kill and resume is bit-exact, and it refuses a checkpoint
  of another run or with a corrupt payload, as ``tests/test_faults.py``
  holds the reference to.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro import cluster as ref_cluster
from repro.core import eclat as ref_eclat
from repro.core import fimi as ref_fimi
from repro_torch import cluster
from repro_torch.cluster import checkpoint
from repro_torch.core import eclat, fimi

N_ITEMS = 16
P = 2
PLANNER = dict(min_support_rel=0.15, n_db_sample=128, n_fi_sample=128)
ECLAT = dict(max_out=1 << 13, max_stack=2048, frontier_size=8)


class SimulatedCrash(Exception):
    """Raised by the round hook: the process died between rounds."""


def kill_after_round(r):
    def hook(done):
        if done >= r:
            raise SimulatedCrash(f"simulated death after round {done}")
    return hook


@pytest.fixture(scope="module")
def dense():
    return np.random.default_rng(14).random((128, N_ITEMS)) < 0.35


def ref_params(use_mxu=False):
    return ref_cluster.ClusterParams(
        planner=ref_cluster.PlannerParams(**PLANNER), eclat=ref_eclat.EclatConfig(**ECLAT),
        chunk=1, use_mxu=use_mxu,       # chunk=1 forces several rounds
    )


def port_params(use_mxu=False):
    return cluster.ClusterParams(
        planner=cluster.PlannerParams(**PLANNER), eclat=eclat.EclatConfig(**ECLAT),
        chunk=1, use_mxu=use_mxu,
    )


_UNBROKEN = {}


def reference_unbroken(dense, use_mxu):
    """The reference's uninterrupted run, once per ``use_mxu``."""
    if use_mxu not in _UNBROKEN:
        _UNBROKEN[use_mxu] = ref_cluster.execute(
            ref_fimi.shard_db(dense, P), N_ITEMS, ref_params(use_mxu), jax.random.PRNGKey(1))
    return _UNBROKEN[use_mxu]


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.table.masks, want.table.masks)
    np.testing.assert_array_equal(got.table.supports, want.table.supports)
    assert got.report.n_rounds == want.report.n_rounds
    np.testing.assert_array_equal(got.report.observed_loads, want.report.observed_loads)
    assert got.report.donations == want.report.donations
    assert [r.classes_mined for r in got.report.rounds] == \
        [r.classes_mined for r in want.report.rounds]


def test_plan_fingerprint_equals_reference(dense):
    want = reference_unbroken(dense, False).plan
    got = cluster.plan_from_reference(want)
    assert checkpoint.plan_fingerprint(got) == ref_cluster.plan_fingerprint(want)
    other = dataclasses.replace(got, abs_minsup=got.abs_minsup + 1)
    assert checkpoint.plan_fingerprint(other) != ref_cluster.plan_fingerprint(want)


@pytest.mark.parametrize("use_mxu", [False, True])
def test_reference_checkpoint_resumes_in_port(dense, tmp_path, use_mxu):
    want = reference_unbroken(dense, use_mxu)
    assert want.report.n_rounds >= 3          # the death must land mid-run
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedCrash):
        ref_cluster.execute(ref_fimi.shard_db(dense, P), N_ITEMS, ref_params(use_mxu),
                            jax.random.PRNGKey(1), checkpoint_dir=ck,
                            round_hook=kill_after_round(1))
    got = cluster.execute(fimi.shard_db(dense, P, "cpu"), N_ITEMS, port_params(use_mxu),
                          device="cpu", plan=cluster.plan_from_reference(want.plan),
                          checkpoint_dir=ck, resume=True)
    assert_same_result(got, want)
    with open(os.path.join(ck, checkpoint.META_NAME)) as f:
        assert json.load(f)["round"] == want.report.n_rounds


def test_port_checkpoint_resumes_in_reference(dense, tmp_path):
    want = reference_unbroken(dense, False)
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedCrash):
        cluster.execute(fimi.shard_db(dense, P, "cpu"), N_ITEMS, port_params(),
                        device="cpu", plan=cluster.plan_from_reference(want.plan),
                        checkpoint_dir=ck, round_hook=kill_after_round(0))
    state = checkpoint.load(ck)
    assert state.round_index == 1
    assert state.observed.dtype == state.est_mined.dtype == np.float64
    got = ref_cluster.execute(ref_fimi.shard_db(dense, P), N_ITEMS, ref_params(),
                              jax.random.PRNGKey(1), plan=want.plan, checkpoint_dir=ck,
                              resume=True)
    assert_same_result(got, want)


def test_port_kill_and_resume_is_bit_exact(dense, tmp_path):
    shards = fimi.shard_db(dense, P, "cpu")
    want = cluster.execute(shards, N_ITEMS, port_params(), seed=1, device="cpu")
    assert want.report.n_rounds >= 3
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedCrash):
        cluster.execute(shards, N_ITEMS, port_params(), seed=1, device="cpu",
                        checkpoint_dir=ck, round_hook=kill_after_round(1))
    got = cluster.execute(shards, N_ITEMS, port_params(), seed=1, device="cpu",
                          checkpoint_dir=ck, resume=True)
    assert_same_result(got, want)
    fresh = cluster.execute(shards, N_ITEMS, port_params(), seed=1, device="cpu",
                            checkpoint_dir=str(tmp_path / "empty"), resume=True)
    assert fresh.table.to_dict() == want.table.to_dict()


def test_port_refuses_foreign_or_corrupt_checkpoint(dense, tmp_path):
    shards = fimi.shard_db(dense, P, "cpu")
    ck = str(tmp_path / "ck")
    with pytest.raises(SimulatedCrash):
        cluster.execute(shards, N_ITEMS, port_params(), seed=1, device="cpu",
                        checkpoint_dir=ck, round_hook=kill_after_round(0))
    # another support threshold is another plan: refused
    other = dataclasses.replace(port_params(), planner=dataclasses.replace(
        port_params().planner, min_support_rel=0.3))
    with pytest.raises(cluster.CheckpointError, match="different run"):
        cluster.execute(shards, N_ITEMS, other, seed=1, device="cpu", checkpoint_dir=ck,
                        resume=True)
    # one flipped payload bit fails the CRC32C: refused
    payload = [f for f in os.listdir(ck) if f.endswith(".npz")][0]
    with open(os.path.join(ck, payload), "r+b") as f:
        raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0x01
        f.seek(0)
        f.write(raw)
    with pytest.raises(cluster.CheckpointError, match="corrupt"):
        cluster.execute(shards, N_ITEMS, port_params(), seed=1, device="cpu",
                        checkpoint_dir=ck, resume=True)
    # another format is refused before anything is read
    meta = os.path.join(ck, checkpoint.META_NAME)
    with open(meta) as f:
        doc = json.load(f)
    with open(meta, "w") as f:
        json.dump(dict(doc, format="cluster-ckpt-v0"), f)
    with pytest.raises(cluster.CheckpointError, match="not a cluster-ckpt-v1"):
        checkpoint.load(ck)
