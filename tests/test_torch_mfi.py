"""The port's MFI DFS (``repro_torch.core.mfi``) against ``repro.core.mfi``.

The candidate buffers (items, supports, ``n_out``, ``overflow``, ``n_iters``)
must be the reference's trip for trip, tolerance 0: on the thesis example,
on random databases, on seeded 1-prefix classes, and when the output buffer
or the stack overflows.  ``filter_maximal`` and ``powerset_log2_sizes`` equal
the reference's, and the candidates obey Thm 7.5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as ref_bm
from repro.core import mfi as ref_mfi
from repro_torch.core import bitmap as bm
from repro_torch.core import mfi

# one configuration per reference compile: the while loop compiles per shape
BIG = dict(max_out=4096, max_stack=2048)


def port_db(ref_db):
    return bm.BitmapDB.from_dense(torch.from_numpy(np.array(ref_db.dense())))


def assert_same(got: mfi.MFIResult, want: ref_mfi.MFIResult):
    assert (got.n_out, got.overflow, got.n_iters) == (
        int(want.n_out), int(want.overflow), int(want.n_iters))
    np.testing.assert_array_equal(bm.to_reference(got.items), np.asarray(want.items))
    np.testing.assert_array_equal(got.supports.numpy(), np.asarray(want.supports))


def mined_sets(r, n_items):
    masks = bm.unpack_bool(r.items[: r.n_out], n_items).numpy()
    return [frozenset(np.flatnonzero(m).tolist()) for m in masks]


def test_thesis_example(thesis_db):
    """M = {134, 234, 245, 3456} (thesis Example 2.1, 1-based), buffer equal."""
    cfg = dict(max_out=256)
    want = ref_mfi.mine_all_candidates(thesis_db, 5, config=ref_mfi.MFIConfig(**cfg))
    got = mfi.mine_all_candidates(port_db(thesis_db), 5, config=mfi.MFIConfig(**cfg))
    assert_same(got, want)
    valid = torch.arange(256) < got.n_out
    keep = mfi.filter_maximal(got.items, valid)
    np.testing.assert_array_equal(
        keep.numpy(), np.asarray(ref_mfi.filter_maximal(want.items, jnp.asarray(valid.numpy()))))
    kept = {tuple(sorted(i + 1 for i in s)) for s, k in zip(mined_sets(got, 6), keep) if k}
    assert kept == {(1, 3, 4), (2, 3, 4), (2, 4, 5), (3, 4, 5, 6)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_databases(seed):
    rng = np.random.default_rng(seed)
    dense = rng.random((64, 12)) < rng.uniform(0.25, 0.5)
    minsup = int(rng.integers(6, 16))
    want = ref_mfi.mine_all_candidates(ref_bm.BitmapDB.from_dense(jnp.asarray(dense)), minsup,
                                       config=ref_mfi.MFIConfig(**BIG))
    got = mfi.mine_all_candidates(bm.BitmapDB.from_dense(torch.from_numpy(dense)), minsup,
                                  config=mfi.MFIConfig(**BIG))
    assert_same(got, want)
    assert got.overflow == 0


def seeded_inputs(dense, P, p):
    """Miner p's 1-prefix classes of a round-robin split over the items in
    support order (as Phase 1's ``par`` variant forms them), a few invalid."""
    n_tx, I = dense.shape
    supp = dense.sum(axis=0)
    order = np.argsort(supp, kind="stable")
    slots = np.arange(p, I, P)
    prefix = np.zeros((len(slots), I), bool)
    ext = np.zeros((len(slots), I), bool)
    for k, j in enumerate(slots):
        prefix[k, order[j]] = True
        ext[k, order[j + 1:]] = True
    valid = np.ones(len(slots), bool)
    valid[1::3] = False
    tids = np.stack([np.asarray(ref_bm.pack_bool(jnp.asarray(dense[:, pr].all(axis=1))))
                     for pr in prefix])
    return prefix, ext, tids, (prefix * supp).sum(axis=1).astype(np.int32), valid


@pytest.mark.parametrize("cfg", [BIG, dict(max_out=8, max_stack=2048),
                                 dict(max_out=4096, max_stack=12)],
                         ids=["complete", "output_overflow", "stack_overflow"])
def test_seeded_classes(small_db, cfg):
    dense, ref_db, minsup, _ = small_db
    I = dense.shape[1]
    db = bm.BitmapDB.from_dense(torch.from_numpy(dense))
    for p in range(2):
        prefix, ext, tids, supp, valid = seeded_inputs(dense, 2, p)
        want = ref_mfi.mine_candidates_seeded(
            ref_db.item_bits, jnp.asarray(prefix), jnp.asarray(ext), jnp.asarray(tids),
            jnp.asarray(supp), jnp.asarray(valid), jnp.asarray(minsup, jnp.int32),
            config=ref_mfi.MFIConfig(**cfg), n_items=I)
        got = mfi.mine_candidates_seeded(
            db.item_bits, torch.from_numpy(prefix), torch.from_numpy(ext),
            bm.from_reference(tids), torch.from_numpy(supp), torch.from_numpy(valid), minsup,
            config=mfi.MFIConfig(**cfg), n_items=I)
        assert_same(got, want)
        if cfg is not BIG:
            assert got.overflow > 0


def test_single_class_and_max_iters(small_db):
    """``mine_candidates`` on one PBEC, and a loop stopped at ``max_iters``."""
    dense, ref_db, minsup, _ = small_db
    I = dense.shape[1]
    prefix = np.zeros(I, bool)
    prefix[3] = True
    ext = np.zeros(I, bool)
    ext[4:] = True
    tid = ref_bm.tidlist_of_itemset(ref_db, jnp.asarray(prefix))
    supp = int(dense[:, 3].sum())
    db = port_db(ref_db)
    for cfg in (BIG, dict(max_out=4096, max_stack=2048, max_iters=7)):
        want = ref_mfi.mine_candidates(ref_db.item_bits, jnp.asarray(prefix), jnp.asarray(ext),
                                       tid, supp, jnp.asarray(minsup, jnp.int32),
                                       config=ref_mfi.MFIConfig(**cfg), n_items=I)
        got = mfi.mine_candidates(db.item_bits, torch.from_numpy(prefix),
                                  torch.from_numpy(ext), bm.from_reference(np.asarray(tid)),
                                  supp, minsup, config=mfi.MFIConfig(**cfg), n_items=I)
        assert_same(got, want)
    assert got.n_iters == 7


def test_filter_maximal_and_sizes():
    rng = np.random.default_rng(5)
    masks = rng.random((300, 40)) < 0.3
    masks[50:60] = masks[:10] & (rng.random((10, 40)) < 0.7)   # strict subsets
    masks[60:65] = masks[:5]                                    # duplicates
    packed = np.asarray(ref_bm.pack_bool(jnp.asarray(masks)))
    valid = rng.random(300) < 0.8
    want = np.asarray(ref_mfi.filter_maximal(jnp.asarray(packed), jnp.asarray(valid)))
    got = mfi.filter_maximal(bm.from_reference(packed), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() < valid.sum()
    np.testing.assert_array_equal(
        mfi.powerset_log2_sizes(bm.from_reference(packed), 40).numpy(),
        np.asarray(ref_mfi.powerset_log2_sizes(jnp.asarray(packed), 40)))


def test_candidates_thm_7_5(small_db):
    """Candidates are frequent with their supports, cover M̃, and the
    maximal ones among them are exactly M̃ (Thm 7.5 with P = 1)."""
    dense, ref_db, minsup, oracle = small_db
    I = dense.shape[1]
    r = mfi.mine_all_candidates(port_db(ref_db), minsup, config=mfi.MFIConfig(**BIG))
    assert r.overflow == 0
    assert_same(r, ref_mfi.mine_all_candidates(ref_db, minsup, config=ref_mfi.MFIConfig(**BIG)))
    cands = mined_sets(r, I)
    for s, supp in zip(cands, r.supports[: r.n_out].tolist()):
        assert oracle[s] == supp
    mfis_true = {fs for fs in oracle if not any(fs < other for other in oracle)}
    assert mfis_true <= set(cands)
    keep = mfi.filter_maximal(r.items, torch.arange(r.items.shape[0]) < r.n_out)
    assert {s for s, k in zip(cands, keep) if k} == mfis_true
