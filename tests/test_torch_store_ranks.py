"""The out-of-core store across real ranks: four gloo ranks on the CPU mine
one on-disk store, each reading its own shard's blocks through a reader of
its own (``launch/ranks.py``, ``store/reader.to_device_shards(miners=)``).

* ``fimi.run`` on the store across four ranks gives the FITable of the
  one-device store mine and of the reference's ``fimi.run`` on
  ``store.to_dense()``; so does ``cluster.execute`` on the plan the ranks
  sample off disk, and that plan is the one-device store plan.
* Each rank's reader stays within its 2-block budget and reads only the
  blocks that hold its shard's rows.
* ``mine`` and ``cluster_mine --store --devices 4 --digest --parity`` print
  ``backend=gloo``, the digest of that FITable and a passing parity gate.

The four ranks of the pipeline run in one ``ranks.spawn``; every subprocess
has its timeout.
"""
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import fimi as ref_fimi
from repro_torch import cluster
from repro_torch.core import eclat, fimi
from repro_torch.data.ibm_gen import IBMParams, generate_dense
from repro_torch.launch import ranks
from repro_torch.store import BlockReader, TxStore, to_device_shards
from test_torch_planner import assert_same_plan
from test_torch_store import _fimi_params, _ref_fimi_params, _store_from_dense

ROOT = Path(__file__).resolve().parents[1]
# one thread a rank: the ranks share the test worker's cores
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
P = 4
N_TX = 300            # T = 75 rows a shard
SIZES = [40] * 7 + [20]   # 8 blocks; shards straddle block boundaries
PLANNER = dict(min_support_rel=0.1, n_db_sample=128, n_fi_sample=256)

# One rank: the pipeline and the executor on the store, each rank through its
# own reader; every rank writes what the test compares.
WORKER = """
import pickle, sys
from repro_torch import cluster
from repro_torch.core import fimi
from repro_torch.launch import ranks
from repro_torch.store import BlockReader, TxStore, to_device_shards

inp = pickle.load(open(sys.argv[1], "rb"))
coll = ranks.collectives(4, "cpu")
store = TxStore.open(inp["dir"])
reader = BlockReader(store, device="cpu")
mined = fimi.run(store, None, inp["fimi_params"], device="cpu", materialize=True, P=4,
                 reader=reader, coll=coll)
plan = cluster.plan(store, None, inp["planner"], seed=5, device="cpu", P=4, coll=coll)
exec_reader = BlockReader(store, device="cpu")
shards = to_device_shards(store, 4, miners=coll.miners, reader=exec_reader)
done = cluster.execute(shards, store.n_items, inp["cluster_params"],
                       device="cpu", plan=plan, coll=coll)
out = {"rank": coll.rank, "backend": coll.backend, "fis": mined.fi_dict,
       "n_fis": mined.n_fis, "peak": reader.peak_host_bytes, "budget": reader.budget_bytes,
       "blocks": sorted({b for b, *_ in reader.refills}),
       "exec_blocks": sorted({b for b, *_ in exec_reader.refills}),
       "plan": plan, "table": done.table.to_dict(), "cluster_backend": done.report.backend}
pickle.dump(out, open(sys.argv[2] + f".{coll.rank}", "wb"))
ranks.finish()
"""


@pytest.fixture(scope="module")
def dense():
    return generate_dense(IBMParams(n_tx=N_TX, n_items=24, n_patterns=8, avg_pattern_len=5,
                                    avg_tx_len=8, seed=3))


@pytest.fixture(scope="module")
def store_dir(dense, tmp_path_factory):
    d = tmp_path_factory.mktemp("store_ranks") / "st"
    _store_from_dense(d, dense, SIZES)
    return str(d)


@pytest.fixture(scope="module")
def reference_fis(dense):
    return ref_fimi.run(ref_fimi.shard_db(dense, P), 24, _ref_fimi_params(),
                        jax.random.PRNGKey(0), materialize=True).fi_dict


def cluster_params():
    return cluster.ClusterParams(
        planner=cluster.PlannerParams(**PLANNER),
        eclat=eclat.EclatConfig(max_out=1 << 14, max_stack=2048, frontier_size=8))


@pytest.fixture(scope="module")
def across_ranks(store_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("store_ranks_run")
    inp, out, script = tmp / "inp.pkl", tmp / "out.pkl", tmp / "worker.py"
    script.write_text(WORKER)
    with open(inp, "wb") as f:
        pickle.dump({"dir": store_dir, "fimi_params": _fimi_params(),
                     "planner": cluster.PlannerParams(**PLANNER),
                     "cluster_params": cluster_params()}, f)
    assert ranks.spawn([sys.executable, str(script), str(inp), str(out)], P, timeout=240,
                       env=ENV) == 0
    return [pickle.load(open(f"{out}.{r}", "rb")) for r in range(P)]


def test_the_store_mined_across_ranks_equals_one_device_and_reference(
        store_dir, dense, reference_fis, across_ranks):
    store = TxStore.open(store_dir)
    one = fimi.run(store, None, _fimi_params(), device="cpu", materialize=True, P=P)
    assert one.fi_dict == reference_fis
    for out in across_ranks:
        assert out["backend"] == "gloo"
        assert out["fis"] == reference_fis and out["n_fis"] == one.n_fis
        assert out["table"] == reference_fis and out["cluster_backend"] == "gloo"


def test_the_plan_sampled_off_disk_across_ranks_is_the_one_device_plan(
        store_dir, across_ranks):
    want = cluster.plan(TxStore.open(store_dir), None, cluster.PlannerParams(**PLANNER),
                        seed=5, device="cpu", P=P)
    for out in across_ranks:
        assert_same_plan(out["plan"], want)


def test_each_rank_reads_its_own_blocks_within_its_budget(store_dir, across_ranks):
    starts = np.concatenate([[0], np.cumsum(SIZES)])
    T = N_TX // P
    for out in across_ranks:
        r = out["rank"]
        assert 0 < out["peak"] <= out["budget"] == 2 * 40 * 4
        own = [i for i in range(len(SIZES))
               if starts[i] < (r + 1) * T and starts[i + 1] > r * T]
        assert out["blocks"] == own == out["exec_blocks"]
        assert len(own) < len(SIZES)


def test_to_device_shards_for_held_miners_is_their_rows(store_dir, dense):
    store = TxStore.open(store_dir)
    whole = fimi.shard_db(dense, P, "cpu")
    for miners in ([0], [2], [3], [1, 3]):
        reader = BlockReader(store, device="cpu")
        got = to_device_shards(store, P, miners=miners, reader=reader)
        assert torch.equal(got, whole[miners])
        assert reader.peak_host_bytes <= reader.budget_bytes
    with pytest.raises(ValueError, match="miner 4"):
        to_device_shards(store, P, miners=[4], device="cpu")


def _launch(module, *argv):
    done = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}", *argv],
                          capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=180)
    assert done.returncode == 0, done.stderr[-3000:]
    return done.stdout


@pytest.mark.parametrize("module", ["mine", "cluster_mine"])
def test_launchers_mine_the_store_across_ranks(store_dir, reference_fis, module):
    out = _launch(module, "--device", "cpu", "--store", store_dir, "--support", "0.1", "-P",
                  str(P), "--devices", str(P), "--digest", "--parity")
    assert "backend=gloo" in out
    assert f"|F| = {len(reference_fis)} " in out
    assert f"FITable sha256={fimi.fitable_digest(reference_fis)}" in out.splitlines()
    assert "parity vs " in out and ": OK (" in out
    if module == "mine":   # every rank's reader within its budget
        # not an exact figure: whether the prefetch of the next block comes
        # before the copy frees the last one is the threads' timing
        m = re.search(r"streamed host high-water: (\d+) bytes "
                      r"\(budget 320; by rank \[(\d+), (\d+), (\d+), (\d+)\]\)", out)
        assert m is not None, out
        peaks = [int(v) for v in m.groups()[1:]]
        assert all(0 < p <= 320 for p in peaks) and int(m.group(1)) == max(peaks)
