"""The port's main path as a whole, against ``repro.core.fimi.run``.

* For every seed and P, the port's FITable ``{frozenset: support}`` equals the
  reference's: the sample only steers the partition, Phase 4 mines the whole
  database, so the result is exact whatever the draws.
* Handed the reference's threefry draws (the Phase-1 sample rows and the
  Algorithm-R draws of each miner), the port also reproduces the plan: the
  classes, the assignment, the estimated loads, the replication and the
  per-miner Phase-4 trips.
* The port imports nothing of JAX or of ``repro``, and its entry points do
  not fall back to the CPU.
"""
import ast
import json
import os
import re
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
from repro_torch.core import eclat, fimi
from repro_torch.launch import mine
from test_torch_store import honest_high_waters

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS = 20
SUPPORT = 0.1
ECLAT = dict(max_out=1 << 13, max_stack=2048, frontier_size=16)
SAMPLE = dict(n_db_sample=256, n_fi_sample=256)
N_DRAWS = 1 << 13  # Algorithm-R draws handed to each miner (more than it streams)


@pytest.fixture(scope="module")
def dense():
    # 600 rows: 300 or 150 per miner, so the per-miner word count is ragged
    return generate_dense(IBMParams(n_tx=600, n_items=N_ITEMS, n_patterns=10,
                                    avg_pattern_len=5, avg_tx_len=8, seed=4))


_REFERENCE = {}


def reference_run(dense, P, seed):
    """``repro.core.fimi.run`` once per (P, seed) for the whole module."""
    if (P, seed) not in _REFERENCE:
        params = ref_fimi.FimiParams(min_support_rel=SUPPORT, **SAMPLE,
                                     eclat=ref_eclat.EclatConfig(**ECLAT))
        _REFERENCE[P, seed] = ref_fimi.run(ref_fimi.shard_db(dense, P), N_ITEMS, params,
                                           jax.random.PRNGKey(seed), materialize=True)
    return _REFERENCE[P, seed]


def port_params(scheduler="lpt"):
    return fimi.FimiParams(min_support_rel=SUPPORT, **SAMPLE, scheduler=scheduler,
                           eclat=eclat.EclatConfig(**ECLAT))


def reference_draws(seed, P, T):
    """The reference's Phase-1 draws: for miner p, the sample rows from
    ``k_samp`` and the Algorithm-R draws j_t ~ U[0, t) from ``k_res``, where
    ``k_samp, k_res = split(fold_in(PRNGKey(seed), p))`` (``phases.py:151``)."""
    per_proc = max(1, min(SAMPLE["n_db_sample"], P * T) // P)

    def res_step(k, t):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (), 0, t)

    idx, draws = [], []
    for p in range(P):
        k_samp, k_res = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), p))
        idx.append(np.asarray(jax.random.randint(k_samp, (per_proc,), 0, T)))
        _, js = jax.lax.scan(res_step, k_res, jnp.arange(1, N_DRAWS + 1, dtype=jnp.int32))
        draws.append(torch.from_numpy(np.asarray(js).astype(np.int64)))
    return torch.from_numpy(np.stack(idx).astype(np.int64)), draws


def check_fitable(dense, P, seed, scheduler="lpt"):
    """The port's FITable equals the reference's.  The reference runs its
    default scheduler: its FITable is exact, so it is every scheduler's."""
    want = reference_run(dense, P, seed)
    got = fimi.run(fimi.shard_db(dense, P, "cpu"), N_ITEMS, port_params(scheduler),
                   seed=seed, device="cpu", materialize=True)
    assert got.fi_dict == want.fi_dict
    assert got.n_fis == want.n_fis == len(want.fi_dict)
    assert got.exchange_overflow == want.exchange_overflow == 0
    assert not got.phase1_overflow.any() and not got.phase4_overflow.any()


def check_plan(dense, P, seed):
    want = reference_run(dense, P, seed)
    sample_idx, draws = reference_draws(seed, P, len(dense) // P)
    got = fimi.run(fimi.shard_db(dense, P, "cpu"), N_ITEMS, port_params(), seed=seed,
                   device="cpu", materialize=True, sample_idx=sample_idx,
                   reservoir_draws=draws)
    np.testing.assert_array_equal(got.sample_masks, want.sample_masks)
    assert len(got.classes) == len(want.classes)
    for a, b in zip(got.classes, want.classes):
        np.testing.assert_array_equal(a.prefix, b.prefix)
        np.testing.assert_array_equal(a.ext, b.ext)
        assert (a.est_count, a.seq) == (b.est_count, b.seq)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.est_loads, want.est_loads)
    assert got.replication == want.replication
    np.testing.assert_array_equal(got.work_iters, np.asarray(want.work_iters))
    np.testing.assert_array_equal(got.nodes_popped, want.nodes_popped)
    np.testing.assert_array_equal(got.ancestor_supports, want.ancestor_supports)
    assert got.fi_dict == want.fi_dict


# P = 2 here; test_torch_fimi_p4.py runs P = 4 in another worker, since each P
# costs the reference its own compilation.
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fitable_equals_reference(dense, seed):
    check_fitable(dense, 2, seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_equals_reference_with_its_draws(dense, seed):
    check_plan(dense, 2, seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_repl_min_fitable_equals_reference(dense, seed):
    check_fitable(dense, 2, seed, scheduler="repl_min")


def test_launcher_raises_without_cuda(monkeypatch):
    """With no ``--device`` the launcher asks for CUDA, and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mine.main(["--db", "T0.1I0.01P5PL3TL4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fimi.run(torch.zeros((2, 4, 1), dtype=torch.int32), 8, port_params())


@pytest.mark.parametrize("launcher", ["serve_mine", "stream_mine"])
def test_serving_launchers_raise_without_cuda(launcher, monkeypatch):
    """Without ``--device cpu`` the serving and streaming launchers ask for
    CUDA and raise without it; with it they run on the CPU."""
    import importlib

    module = importlib.import_module(f"repro_torch.launch.{launcher}")
    small = {"serve_mine": ["--db", "T0.2I0.01P5PL3TL4", "--support", "0.2", "--queries", "40"],
             "stream_mine": ["--db", "T0.1I0.01P5PL3TL4", "--support", "0.2", "--blocks", "2",
                             "--blocktx", "32", "--stream", "3", "-P", "2"]}[launcher]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(small)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(small + ["--device", "cuda"])
    assert module.main(small + ["--device", "cpu"]) is not None


RANK_CHILD = """
import json, sys
from repro_torch.launch import mine
mine.main(['--device', 'cpu', '--db', 'T1I0.032P20PL6TL10', '--support', '0.08', '-P', '2',
           '--devices', '2'])
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
print('rank modules: ' + json.dumps(bad), flush=True)
"""


def test_launcher_imports_neither_jax_nor_repro(tmp_path):
    (tmp_path / "rank_child.py").write_text(RANK_CHILD)
    healthy = str(ROOT / "tests" / "data" / "run_healthy")
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['mine', '--device', 'cpu', '--db', 'T1I0.032P20PL6TL10',"
        " '--support', '0.08']\n"
        "runpy.run_module('repro_torch.launch.mine', run_name='__main__')\n"
        f"store_dir = {str(tmp_path / 'store')!r}\n"
        "sys.argv = ['mine', '--device', 'cpu', '--db', 'T0.5I0.024P8PL5TL8', '--support',"
        " '0.08', '--store', store_dir, '--blocktx', '64', '--parity']\n"
        "runpy.run_module('repro_torch.launch.mine', run_name='__main__')\n"
        "import repro_torch.cluster, repro_torch.launch.cluster_mine, repro_torch.store.checksum\n"
        "import repro_torch.store.reader, repro_torch.launch.fsck\n"
        "sys.argv = ['serve_mine', '--device', 'cpu', '--db', 'T1I0.032P20PL6TL10',"
        " '--support', '0.08', '--queries', '300']\n"
        "runpy.run_module('repro_torch.launch.serve_mine', run_name='__main__')\n"
        "sys.argv = ['stream_mine', '--device', 'cpu', '--db', 'T1I0.02P6PL4TL7',"
        " '--support', '0.15', '--blocks', '4', '--blocktx', '128', '--stream', '8',"
        " '--breaks', '5', '-P', '2']\n"
        "runpy.run_module('repro_torch.launch.stream_mine', run_name='__main__')\n"
        "sys.argv = ['stream_mine', '--device', 'cpu', '--db', 'T1I0.02P6PL4TL7',"
        " '--support', '0.15', '--blocks', '4', '--blocktx', '128', '--stream', '8',"
        f" '--breaks', '5', '--cluster', '2', '--spill', {str(tmp_path / 'spill')!r}]\n"
        "runpy.run_module('repro_torch.launch.stream_mine', run_name='__main__')\n"
        "from repro_torch.launch import serve_load\n"
        "assert serve_load.main(['--device', 'cpu', '--db', 'T0.25I0.016P6PL4TL6', '--qps',"
        " '100', '--duration', '0.5', '--ramp', '0.2', '--window', '1.0', '--report-every',"
        " '0.25', '--batch', '32', '--slo-p99-ms', '60000', '--no-dashboard', '--gate']) == 0\n"
        "import repro_torch.obs, repro_torch.obs.session\n"
        "from repro_torch.launch import profile_demo\n"
        "assert profile_demo.main(['--device', 'cpu']) == 0\n"
        "from repro_torch.launch import obs_report, ranks\n"
        f"assert obs_report.main(['critpath', {healthy!r}]) == 0\n"
        f"assert obs_report.main(['doctor', {healthy!r}, '--history', 'none.jsonl']) == 0\n"
        f"assert ranks.spawn([sys.executable, {str(tmp_path / 'rank_child.py')!r}], 2,"
        " timeout=120) == 0\n"
        "import repro_torch.distributed.sharding, repro_torch.distributed.dtensor\n"
        "import repro_torch.launch.mesh, repro_torch.launch.input_specs\n"
        "import repro_torch.distributed.hlo, repro_torch.launch.dryrun\n"
        "from repro_torch.launch import train\n"
        "train.main(['--smoke', '--steps', '2', '--batch', '2', '--seq', '16', '--device', 'cpu',"
        f" '--ckpt-dir', {str(tmp_path / 'ckpt')!r}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # from a working directory of its own: the gated serve_load run writes
    # its BENCH file and history row there
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=240)
    assert done.returncode == 0, done.stderr
    lines = done.stdout.strip().splitlines()
    assert "|F| = 3370" in done.stdout
    # the store mine streamed a store larger than its host budget, exactly
    assert "parity vs dense in-RAM fimi.run: OK (1847 itemsets, bit-exact supports" in done.stdout
    # one block or two consecutive ones, with the sizes of the store's manifest
    high = re.search(r"streamed host high-water: (\d+) bytes \(budget 512\)", done.stdout)
    assert high and int(high.group(1)) in honest_high_waters(tmp_path / "store", 512)
    # the CPU run launches no kernel, and the launcher prints its own run's counts
    assert "kernel launches: multi_extension_supports=0 extension_supports=0" in done.stdout
    # serving and streaming ran, on the plain versions
    assert "R=18206 rules" in done.stdout and "torn-index parity failures: 0" in done.stdout
    assert "subset_superset_counts=0 block_itemset_supports=0" in done.stdout
    # the cluster re-miner and the spill, and the load harness behind its gate
    assert "spill: 4 expired blocks persisted to" in done.stdout
    assert "SLO gate: ok" in done.stdout
    assert (tmp_path / "BENCH_torch_serve.json").is_file()
    assert (tmp_path / "BENCH_torch_HISTORY.jsonl").is_file()
    # and the profiled demo, every family timed
    assert "pair_supports=0 pair_supports_mxu=0" in done.stdout
    assert "profile_demo: families without measured time" not in done.stdout
    # the port's obs_report, and a rank's child process (two gloo ranks)
    assert "doctor: 3 finding(s), worst = info" in done.stdout
    assert "backend=gloo" in done.stdout and "rank modules: []" in done.stdout
    # the LM training launcher: two steps of the smoke config
    assert "arch=llama3.2-3b-smoke params=0.4M devices=1" in done.stdout
    assert "step     1 loss" in done.stdout and "done" in lines
    assert json.loads(lines[-1]) == []


def test_run_counts_its_own_launches(dense, monkeypatch):
    """``FimiResult.launches`` is what this run launched, not the process total."""
    from repro_torch.kernels import bitmap_support as bs
    from repro_torch.kernels import multi_support as ms

    monkeypatch.setattr(ms.multi_extension_supports_cuda, "launches", 40)
    monkeypatch.setattr(bs.extension_supports_cuda, "launches", 3)
    res = fimi.run(fimi.shard_db(dense, 2, "cpu"), N_ITEMS, port_params(), device="cpu")
    assert res.launches == {"multi_extension_supports": 0, "extension_supports": 0,
                            "multi_extension_supports_mxu": 0, "subset_superset_counts": 0,
                            "block_itemset_supports": 0, "pair_supports": 0,
                            "pair_supports_mxu": 0}
    assert ms.multi_extension_supports_cuda.launches == 40


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
        (ROOT / "probes").glob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    for module in ("launch/obs_report.py", "launch/ranks.py", "obs/doctor.py",
                   "launch/serve.py", "models/model.py", "models/convert.py",
                   "configs/registry.py", "optim/adamw.py", "data/lm_pipeline.py",
                   "checkpoint/manager.py", "launch/train.py", "models/steps.py",
                   "distributed/sharding.py", "distributed/dtensor.py", "launch/mesh.py",
                   "launch/input_specs.py", "distributed/hlo.py", "launch/dryrun.py"):
        assert ROOT / "src" / "repro_torch" / module in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{path} imports {mod}"
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro.", "from repro.", "from repro ",
                    "import ml_dtypes", "from ml_dtypes"):
            assert bad not in text, f"{path} contains {bad!r}"
