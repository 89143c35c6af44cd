"""The thesis' three Phase-1 methods in the port (``FimiParams.variant``:
``seq``, ``par``, ``reservoir``) against ``repro.core.fimi.run``.

* For every variant, seed and P, the port's FITable equals the reference's:
  the sample only steers the partition.
* Handed the reference's draws (the Phase-1 sample rows, and the coverage
  picks and random words computed from the reference's own candidate list
  M), the port reproduces the plan: the FI sample, the classes, the
  assignment, the estimated loads; and for ``par`` each miner's MFI buffer
  (``Phase1DeviceOut.mfi_*``).
* At 150 items (5 mask words) the FITable is equal too, for ``reservoir``
  and ``par``.  The reference's first run at that width costs some 13 s a
  P (its eager operations compile for the new shapes), so P = 4 runs in the
  other file, and ``reservoir`` first pays it.
* The launchers take ``--variant`` on the CPU and import no JAX.

P = 2 here; ``test_torch_variants_p4.py`` runs P = 4 in another worker.
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

from repro.core import bitmap as ref_bm
from repro.core import eclat as ref_eclat
from repro.core import fimi as ref_fimi
from repro.data.ibm_gen import IBMParams, generate_dense
from repro.data.ibm_gen import params_from_name as ref_params_from_name
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, fimi, phases
from repro_torch.core.phases import LocalCollectives

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS = 20
SUPPORT = 0.1
ECLAT = dict(max_out=1 << 13, max_stack=2048, frontier_size=16)
SAMPLE = dict(n_db_sample=256, n_fi_sample=256)
VARIANTS = ["seq", "par", "reservoir"]


@pytest.fixture(scope="module")
def dense():
    return generate_dense(IBMParams(n_tx=600, n_items=N_ITEMS, n_patterns=10,
                                    avg_pattern_len=5, avg_tx_len=8, seed=4))


@pytest.fixture(scope="module")
def dense150():
    # 150 items: every itemset mask spans 5 words
    return generate_dense(IBMParams(n_tx=400, n_items=150, n_patterns=8,
                                    avg_pattern_len=6, avg_tx_len=10, seed=7))


_REFERENCE = {}


def reference_run(dense, variant, P, seed):
    """``repro.core.fimi.run`` once per case for the whole module, with what
    its Phase 1 produced (``Phase1DeviceOut``, stacked over P) and the
    arguments of its coverage sampler (M, |F̃s|, key) recorded."""
    case = (dense.shape, variant, P, seed)
    if case not in _REFERENCE:
        outs, coverage = [], []

        def recording_spmd(fn, P, mesh=None):
            mapped = jax.vmap(fn, axis_name=ref_fimi.AXIS)

            def call(*args):
                outs.append(mapped(*args))
                return outs[-1]

            return call

        sampler = ref_fimi._coverage_sample_host

        def recording_sampler(M, n_fs, n_items, key):
            coverage.append((np.asarray(M), n_fs, key))
            return sampler(M, n_fs, n_items, key)

        params = ref_fimi.FimiParams(variant=variant, min_support_rel=SUPPORT, **SAMPLE,
                                     eclat=ref_eclat.EclatConfig(**ECLAT))
        ref_fimi._coverage_sample_host = recording_sampler
        try:
            res = ref_fimi.run(ref_fimi.shard_db(dense, P), dense.shape[1], params,
                               jax.random.PRNGKey(seed), spmd=recording_spmd,
                               materialize=True)
        finally:
            ref_fimi._coverage_sample_host = sampler
        _REFERENCE[case] = (res, outs[0], coverage[0] if coverage else None)
    return _REFERENCE[case]


def port_params(variant):
    return fimi.FimiParams(variant=variant, min_support_rel=SUPPORT, **SAMPLE,
                           eclat=eclat.EclatConfig(**ECLAT))


def check_fitable(dense, variant, P, seed):
    """The port's FITable equals the reference's, with no Phase-3 or Phase-4
    overflow."""
    want = reference_run(dense, variant, P, seed)[0]
    got = fimi.run(fimi.shard_db(dense, P, "cpu"), dense.shape[1], port_params(variant),
                   seed=seed, device="cpu", materialize=True)
    assert got.variant == variant
    assert got.fi_dict == want.fi_dict
    assert got.n_fis == want.n_fis == len(want.fi_dict) > 0
    assert got.exchange_overflow == want.exchange_overflow == 0
    assert not got.phase4_overflow.any()
    if variant != "reservoir":
        assert got.n_mfi > 0 and got.mfi_count.sum() > 0


def reference_draws(dense, variant, P, seed):
    """The reference's Phase-1 sample rows (``k_samp`` of
    ``split(fold_in(PRNGKey(seed), p))``) and its coverage draws: the
    categorical picks over 2^|m| and the random words of
    ``split(PRNGKey(seed))`` (``core/sampling.py:75-83``)."""
    T = len(dense) // P
    per_proc = max(1, min(SAMPLE["n_db_sample"], P * T) // P)
    idx = [np.asarray(jax.random.randint(
        jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), p))[0],
        (per_proc,), 0, T)) for p in range(P)]
    M, n_fs, key = reference_run(dense, variant, P, seed)[2]
    n = int(n_fs * 1.3) + 8
    logits = ref_bm.popcount_u32(jnp.asarray(M)).sum(axis=-1).astype(jnp.float32) * jnp.log(2.0)
    k_pick, k_bits = jax.random.split(key)
    picks = np.array(jax.random.categorical(k_pick, logits, shape=(n,)))
    bits = np.array(jax.random.bits(k_bits, (n, M.shape[-1]), dtype=jnp.uint32))
    return torch.from_numpy(np.stack(idx).astype(np.int64)), torch.from_numpy(picks), bits


def check_plan(dense, variant, P, seed):
    want, out1, (M, _, _) = reference_run(dense, variant, P, seed)
    n_items = dense.shape[1]
    sample_idx, picks, bits = reference_draws(dense, variant, P, seed)
    got = fimi.run(fimi.shard_db(dense, P, "cpu"), n_items, port_params(variant), seed=seed,
                   device="cpu", materialize=True, sample_idx=sample_idx,
                   coverage_picks=picks, coverage_bits=bm.from_reference(bits))
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
    np.testing.assert_array_equal(got.ancestor_supports, want.ancestor_supports)
    assert got.n_mfi == len(M)
    assert got.fi_dict == want.fi_dict
    if variant == "par":
        np.testing.assert_array_equal(got.mfi_count, np.asarray(out1.mfi_count))
        np.testing.assert_array_equal(got.phase1_overflow, np.asarray(out1.overflow))
        # each miner's candidate buffer, from Phase 1 alone
        mine = phases.phase1_device(
            fimi.shard_db(dense, P, "cpu"), SUPPORT, coll=LocalCollectives(P), n_items=n_items,
            n_sample_per_proc=sample_idx.shape[1], reservoir_size=1,
            eclat_cfg=eclat.EclatConfig(**ECLAT), mfi_cfg=port_params("par").mfi,
            variant="par", generators=[None] * P, sample_idx=sample_idx)
        np.testing.assert_array_equal(bm.to_reference(mine.sample_db),
                                      np.asarray(out1.sample_db)[0])
        np.testing.assert_array_equal(bm.to_reference(mine.mfi_items),
                                      np.asarray(out1.mfi_items))
        np.testing.assert_array_equal(mine.mfi_supports.numpy(),
                                      np.asarray(out1.mfi_supports))
        np.testing.assert_array_equal(mine.mfi_count, np.asarray(out1.mfi_count))
        np.testing.assert_array_equal(mine.overflow, np.asarray(out1.overflow))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_fitable_equals_reference(dense, variant, seed):
    check_fitable(dense, variant, 2, seed)


@pytest.mark.parametrize("variant", ["seq", "par"])
def test_plan_equals_reference_with_its_draws(dense, variant):
    check_plan(dense, variant, 2, 0)


# reservoir first: its test pays the reference's first run at this width
@pytest.mark.parametrize("variant", ["reservoir", "par"])
def test_fitable_at_150_items(dense150, variant):
    check_fitable(dense150, variant, 2, 0)


def test_unknown_variant_raises(dense):
    with pytest.raises(ValueError, match="variant"):
        fimi.run(fimi.shard_db(dense, 2, "cpu"), N_ITEMS, port_params("mfi"), device="cpu")


def test_launchers_take_variant_without_jax():
    """``mine --variant seq`` and ``serve_mine --variant par`` on the CPU find
    the reference's |F| (brute force: the FITable is exact), import no JAX,
    and without ``--device cpu`` raise for want of CUDA."""
    db = "T1I0.032P20PL6TL10"
    dense = generate_dense(ref_params_from_name(db, seed=0))
    n_fis = len(ref_eclat.brute_force_fis(dense, int(np.ceil(0.08 * len(dense)))))
    code = (
        "import json, runpy, sys, torch\n"
        f"common = ['--db', '{db}', '--support', '0.08']\n"
        "sys.argv = ['mine', '--variant', 'seq', '--device', 'cpu'] + common\n"
        "runpy.run_module('repro_torch.launch.mine', run_name='__main__')\n"
        "sys.argv = ['serve_mine', '--variant', 'par', '--device', 'cpu', '--queries', '200']"
        " + common\n"
        "runpy.run_module('repro_torch.launch.serve_mine', run_name='__main__')\n"
        "from repro_torch.launch import mine, serve_mine\n"
        "torch.cuda.is_available = lambda: False\n"
        "for main in (mine.main, serve_mine.main):\n"
        "    try:\n"
        "        main(['--variant', 'par'] + common)\n"
        "        raise SystemExit('ran without CUDA')\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=240)
    assert done.returncode == 0, done.stderr
    out = done.stdout
    assert "variant=seq" in out and "phase 1 (seq): MFI candidates kept per miner" in out
    assert "variant=par" in out and f"mine: |F| = {n_fis} " in out
    assert f"|F| = {n_fis}  in" in out
    assert json.loads(out.strip().splitlines()[-1]) == []
