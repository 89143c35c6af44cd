"""The miners across real ranks: ``DistCollectives`` over four gloo ranks on
the CPU (``launch/ranks.py``) against the local backend and the reference.

* On the reference's shard_map parity database (``test_cluster.py``:
  256 x 16, seed 11, support 0.1), ``cluster.execute`` across four ranks
  gives the brute-force FITable and the reference's; handed the reference's
  plan, its rounds, trips and donations equal ``LocalCollectives``'; with
  its own plan, the whole report equals the local run's.
* ``fimi.run`` across four ranks equals the local run: FITable, ``n_total``
  a miner, overflow counters, trips and the sampled plan.
* ``mine --devices 4 --device cpu`` prints ``backend=gloo`` and the FITable
  of ``--devices 0``; a rank that raises makes the launcher exit non-zero
  within its time limit.

The four ranks run in one ``ranks.spawn``; every subprocess has its timeout.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import cluster as ref_cluster
from repro.core import eclat as ref_eclat
from repro.core import fimi as ref_fimi
from repro.data.ibm_gen import IBMParams, generate_dense
from repro_torch import cluster
from repro_torch.core import fimi
from repro_torch.launch import ranks

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
P = 4
SEED = 2
PLANNER = dict(min_support_rel=0.1, n_db_sample=128, n_fi_sample=64, alpha=0.7)
FIMI = dict(min_support_rel=0.1, n_db_sample=128, n_fi_sample=64, alpha=0.7)

# One rank: the executor (its own plan and the reference's) and the pipeline
# over the rank group; rank 0 writes what the test compares.
WORKER = """
import pickle, sys
import numpy as np
from repro_torch import cluster
from repro_torch.core import fimi
from repro_torch.launch import ranks

inp = pickle.load(open(sys.argv[1], "rb"))
coll = ranks.collectives(4, "cpu")
shards = fimi.shard_db(inp["dense"], 4, "cpu")
own = cluster.execute(shards, 16, inp["cluster_params"], seed=inp["seed"], device="cpu",
                      coll=coll)
handed = cluster.execute(shards[coll.rank:coll.rank + 1], 16, inp["cluster_params"],
                         device="cpu", plan=inp["plan"], coll=coll)
held = fimi.shard_db(inp["dense"], 4, "cpu", miners=coll.miners)
mined = fimi.run(held, 16, inp["fimi_params"], seed=inp["seed"], device="cpu",
                 materialize=True, coll=coll)
out = {"rank": coll.rank, "backend": coll.backend, "own": own, "handed": handed,
       "fimi": mined}
if coll.rank == 0:
    pickle.dump(out, open(sys.argv[2], "wb"))
ranks.finish()
"""


@pytest.fixture(scope="module")
def dense():
    return generate_dense(IBMParams(n_tx=256, n_items=16, n_patterns=6, avg_pattern_len=4,
                                    avg_tx_len=6, seed=11))


def cluster_params():
    return cluster.ClusterParams(planner=cluster.PlannerParams(**PLANNER))


def fimi_params():
    return fimi.FimiParams(**FIMI)


@pytest.fixture(scope="module")
def across_ranks(dense, tmp_path_factory):
    """The reference's run, and rank 0's results of the four gloo ranks."""
    want = ref_cluster.execute(
        ref_fimi.shard_db(dense, P), 16,
        ref_cluster.ClusterParams(planner=ref_cluster.PlannerParams(**PLANNER)),
        jax.random.PRNGKey(SEED))
    tmp = tmp_path_factory.mktemp("ranks")
    inp, out, script = tmp / "in.pkl", tmp / "out.pkl", tmp / "worker.py"
    with open(inp, "wb") as f:
        pickle.dump({"dense": dense, "seed": SEED, "cluster_params": cluster_params(),
                     "fimi_params": fimi_params(),
                     "plan": cluster.plan_from_reference(want.plan)}, f)
    script.write_text(WORKER)
    t0 = time.monotonic()
    assert ranks.spawn([sys.executable, str(script), str(inp), str(out)], P, timeout=240,
                       env=ENV) == 0
    assert time.monotonic() - t0 < 240
    with open(out, "rb") as f:
        return want, pickle.load(f)


def same_rounds(got, want):
    g, w = got.report, want.report
    assert g.n_rounds == w.n_rounds
    for a, b in zip(g.rounds, w.rounds):
        assert a.classes_mined == b.classes_mined
        np.testing.assert_array_equal(a.work_iters, np.asarray(b.work_iters))
        np.testing.assert_array_equal(a.est_mined, b.est_mined)
        assert a.replication == b.replication
        assert a.donations == b.donations
    assert g.donations == w.donations
    np.testing.assert_array_equal(g.observed_loads, w.observed_loads)
    assert (g.exchange_overflow, g.mine_overflow) == (w.exchange_overflow, w.mine_overflow)
    np.testing.assert_array_equal(got.table.masks, want.table.masks)
    np.testing.assert_array_equal(got.table.supports, want.table.supports)


def test_executor_across_ranks_equals_reference_and_oracle(dense, across_ranks):
    want, got = across_ranks
    assert got["backend"] == "gloo"
    oracle = ref_eclat.brute_force_fis(dense, int(np.ceil(0.1 * 256)))
    for res in (got["own"], got["handed"]):
        assert res.report.backend == "gloo"
        assert res.table.to_dict() == oracle == want.table.to_dict()


def test_executor_across_ranks_equals_local_on_one_plan(dense, across_ranks):
    want, got = across_ranks
    shards = fimi.shard_db(dense, P, "cpu")
    local = cluster.execute(shards, 16, cluster_params(), device="cpu",
                            plan=cluster.plan_from_reference(want.plan))
    same_rounds(got["handed"], local)
    same_rounds(got["handed"], want)
    # its own plan: the sample drawn alike on every rank, the same run
    own_local = cluster.execute(shards, 16, cluster_params(), seed=SEED, device="cpu")
    np.testing.assert_array_equal(got["own"].plan.assignment, own_local.plan.assignment)
    np.testing.assert_array_equal(got["own"].plan.est_loads, own_local.plan.est_loads)
    same_rounds(got["own"], own_local)
    snap, local_snap = got["own"].report.snapshot(), own_local.report.snapshot()
    assert snap["counters"] == local_snap["counters"]
    assert snap["histograms"] == local_snap["histograms"]


def test_fimi_across_ranks_equals_local(dense, across_ranks):
    _, got = across_ranks
    res = got["fimi"]
    local = fimi.run(fimi.shard_db(dense, P, "cpu"), 16, fimi_params(), seed=SEED,
                     device="cpu", materialize=True)
    assert res.backend == "gloo" and local.backend == "local"
    assert res.fi_dict == local.fi_dict and res.n_fis == local.n_fis
    assert [r.n_total for r in res.phase4] == [r.n_total for r in local.phase4]
    for name in ("work_iters", "nodes_popped", "phase1_iters", "phase1_overflow",
                 "phase4_overflow", "assignment", "est_loads", "sample_masks",
                 "ancestor_masks", "ancestor_supports"):
        np.testing.assert_array_equal(getattr(res, name), getattr(local, name), name)
    assert res.exchange_overflow == local.exchange_overflow == 0
    assert res.replication == local.replication
    assert [(c.prefix.tolist(), c.ext.tolist(), c.est_count) for c in res.classes] == \
        [(c.prefix.tolist(), c.ext.tolist(), c.est_count) for c in local.classes]


def test_shard_db_puts_only_the_held_shards_on_the_device(dense):
    """A rank packs its own shard alone; it is that row of the whole stack."""
    whole = fimi.shard_db(dense, P, "cpu")
    for miners in ([0], [3], [1, 2]):
        held = fimi.shard_db(dense, P, "cpu", miners=miners)
        assert held.shape == (len(miners),) + tuple(whole.shape[1:])
        np.testing.assert_array_equal(held.numpy(), whole[miners].numpy())


def test_mine_devices_prints_gloo_and_the_local_fitable(capsys):
    from repro_torch.launch import mine

    flags = ["--device", "cpu", "--db", "T1I0.032P20PL6TL10", "--support", "0.08", "-P",
             "4", "--digest"]
    done = subprocess.run([sys.executable, "-m", "repro_torch.launch.mine", *flags,
                           "--devices", "4"], capture_output=True, text=True, env=ENV,
                          cwd=ROOT, timeout=180)
    assert done.returncode == 0, done.stderr[-3000:]
    capsys.readouterr()
    mine.main(flags + ["--devices", "0"])   # the local backend, in this process
    dist, local = done.stdout, capsys.readouterr().out
    assert "|F| = 3370" in dist and "backend=gloo" in dist
    assert "|F| = 3370" in local and "backend=local" in local
    digest = [line for line in local.splitlines() if line.startswith("FITable sha256=")]
    assert len(digest) == 1 and digest[0] in dist.splitlines()


FAILING = """
import torch
from repro_torch.launch import ranks

coll = ranks.collectives(2, "cpu")
if coll.rank == 1:
    raise RuntimeError("rank 1 fails")
coll.psum(torch.ones((1, 1)))   # would wait for rank 1 for ever
"""


def test_a_failing_rank_fails_the_launcher(tmp_path):
    script = tmp_path / "failing.py"
    script.write_text(FAILING)
    t0 = time.monotonic()
    code = ranks.spawn([sys.executable, str(script)], 2, timeout=120, env=ENV)
    assert code not in (0, 124)
    assert time.monotonic() - t0 < 120
    # and through a launcher: a bad flag value fails every rank, the launcher too
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--device", "cpu", "--db",
         "T0.1I0.01P5PL3TL4", "-P", "2", "--devices", "2", "--variant", "nope"],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=120)
    assert done.returncode != 0


def test_devices_checks_and_the_local_fallback(monkeypatch, tmp_path):
    import torch

    assert not ranks.wants_ranks(0, 4) and not ranks.wants_ranks(2, 4)
    assert ranks.wants_ranks(4, 4) and ranks.wants_ranks(8, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="more CUDA devices"):
        ranks.check_devices(4, "cuda")
    ranks.check_devices(1, "cuda")
    ranks.check_devices(64, "cpu")
    from argparse import Namespace

    from repro_torch.launch import data_source
    from repro_torch.store import TxStore

    # a --store or --dataset source is made once, before the ranks start, and
    # the ranks get --store DIR alone; any other command line goes unchanged
    store_dir = str(tmp_path / "st")
    argv = ["--device", "cpu", "--store", store_dir, "--blocktx", "32", "-P", "2",
            "--devices", "2"]
    args = Namespace(dataset="", store=store_dir, db="T0.1I0.01P5PL3TL4", blocktx=32, seed=0)
    assert data_source.store_argv(args, argv) == [
        "--device", "cpu", "--blocktx", "32", "-P", "2", "--devices", "2", "--store", store_dir]
    assert TxStore.open(store_dir).n_tx == 100
    dense = ["--device", "cpu", "-P", "2", "--devices", "2"]
    assert data_source.store_argv(Namespace(dataset="", store="", db="T0.1I0.01P5PL3TL4",
                                            blocktx=32, seed=0), dense) == dense
    retail = str(tmp_path / "retail")
    argv = ["--dataset=" + str(ROOT / "examples" / "retail_tiny.dat"), "-P", "2"]
    args = Namespace(dataset=str(ROOT / "examples" / "retail_tiny.dat"), store=retail, db="",
                     blocktx=256, seed=0)
    assert data_source.store_argv(args, argv + ["--store", retail]) == \
        ["-P", "2", "--store", retail]
    assert TxStore.open(retail).n_tx > 0


SMALL = ["--device", "cpu", "--db", "T1I0.032P20PL6TL10", "--support", "0.08"]


def local_digest():
    from repro_torch.data.ibm_gen import generate_dense as port_generate
    from repro_torch.data.ibm_gen import params_from_name
    from repro_torch.launch import mine

    res, _ = mine.mine_dense(port_generate(params_from_name("T1I0.032P20PL6TL10", seed=0)),
                             support=0.08, P=2, device="cpu", materialize=True)
    return fimi.fitable_digest(res.fi_dict)


def test_torchrun_ranks_join_alike():
    """An environment ``torchrun`` set up: its two workers join one gloo group."""
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.mine", *SMALL, "-P", "2", "--devices", "2", "--digest"],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=180)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "backend=gloo" in done.stdout
    assert f"FITable sha256={local_digest()}" in done.stdout.splitlines()


def test_cluster_mine_across_ranks_resumes_and_serve_mine_serves(tmp_path):
    """Killed after round 0 and resumed across two ranks (rank 0 writes the
    checkpoints): the parity gate holds; ``serve_mine`` mines across two
    ranks and rank 0 serves."""
    ck = str(tmp_path / "ck")
    argv = [sys.executable, "-m", "repro_torch.launch.cluster_mine", *SMALL, "-P", "2",
            "--devices", "2", "--checkpoint", ck]
    killed = subprocess.run(argv + ["--kill-after-round", "0"], capture_output=True,
                            text=True, env=ENV, cwd=ROOT, timeout=180)
    assert killed.returncode == 0, killed.stderr[-3000:]
    assert "KILLED after round 0" in killed.stdout and "|F| =" not in killed.stdout
    resumed = subprocess.run(argv + ["--resume", "--parity"], capture_output=True, text=True,
                             env=ENV, cwd=ROOT, timeout=180)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "backend=gloo" in resumed.stdout
    assert "parity vs single-device fimi.run: OK (3370 itemsets" in resumed.stdout
    served = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_mine", *SMALL, "--queries", "300",
         "-P", "2", "--devices", "2"], capture_output=True, text=True, env=ENV, cwd=ROOT,
        timeout=180)
    assert served.returncode == 0, served.stderr[-3000:]
    assert "mine: |F| = 3370" in served.stdout and "backend=gloo" in served.stdout
    assert served.stdout.count("R=18206 rules") == 1
