"""The Apriori and Count-Distribution baselines and the small helpers of
``core/`` in the port, against the reference, tolerance 0.

* ``generate_candidates`` and ``apriori`` equal ``repro.core.apriori``'s;
  P-shard ``count_distribution_supports`` equals the reference's ``psum``
  under ``vmap``.
* ``eclat.mine``, ``pbec.verify_disjoint_cover``,
  ``schedule.lpt_makespan_bound_ok`` and the bitmap helpers
  (``support_of_itemset``, ``support_of_tidlist``, ``pair_supports``,
  ``itemset_mask_to_packed``) equal the reference's on the inputs of its own
  tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apriori as ref_apriori
from repro.core import bitmap as ref_bm
from repro.core import eclat as ref_eclat
from repro.core import pbec as ref_pbec
from repro.core import schedule as ref_schedule
from repro_torch.core import apriori, eclat, pbec, schedule
from repro_torch.core import bitmap as bm
from repro_torch.core.phases import LocalCollectives


@pytest.fixture(scope="module")
def db(small_db):
    return bm.BitmapDB.from_dense(torch.from_numpy(small_db[0]))


def test_generate_candidates(small_db):
    _, _, _, oracle = small_db
    for k in (1, 2, 3, 4):
        level = sorted((s for s in oracle if len(s) == k), key=lambda s: tuple(sorted(s)))
        want = ref_apriori.generate_candidates(level)
        assert apriori.generate_candidates(level) == want
        assert apriori.generate_candidates(level[: len(level) // 2]) == \
            ref_apriori.generate_candidates(level[: len(level) // 2])
    assert apriori.generate_candidates([]) == []


def test_apriori_equals_reference(small_db, db, thesis_db):
    _, ref_db, minsup, oracle = small_db
    got = apriori.apriori(db, minsup)
    assert got == ref_apriori.apriori(ref_db, minsup) == oracle
    thesis = bm.BitmapDB.from_dense(torch.from_numpy(np.array(thesis_db.dense())))
    assert apriori.apriori(thesis, 5) == ref_apriori.apriori(thesis_db, 5)


def test_count_distribution_equals_reference_psum(small_db):
    """Alg. 2: per-shard counts + all-reduce == the reference's psum."""
    dense, _, _, oracle = small_db
    P = 4
    T = dense.shape[0] // P
    shards = dense[: P * T].reshape(P, T, -1)
    cands = sorted(oracle, key=lambda s: (len(s), tuple(sorted(s))))[:64]
    masks = np.zeros((len(cands) + 2, dense.shape[1]), bool)
    for i, c in enumerate(cands):
        masks[i, sorted(c)] = True
    masks[-1, [0, 5, 9, 13, 21]] = True        # an infrequent one; row -2 is ∅

    def shard_fn(sh):
        sdb = ref_bm.BitmapDB.from_dense(sh)
        return ref_apriori.count_distribution_supports(
            sdb.item_bits, jnp.asarray(masks), sdb.all_tids(), "p")

    want = np.asarray(jax.vmap(shard_fn, axis_name="p")(jnp.asarray(shards)))[0]
    locals_ = [bm.BitmapDB.from_dense(torch.from_numpy(sh)) for sh in shards]
    got = apriori.count_distribution_supports(
        torch.stack([d.item_bits for d in locals_]), torch.from_numpy(masks),
        torch.stack([d.all_tids() for d in locals_]), coll=LocalCollectives(P))
    np.testing.assert_array_equal(got.numpy(), want)
    assert [int(v) for v in got[: len(cands)]] == [oracle[c] for c in cands]


def test_eclat_mine_single_class(small_db, db):
    """``eclat.mine`` on one PBEC equals the reference's buffer."""
    _, ref_db, minsup, _ = small_db
    I = db.n_items
    prefix = np.zeros(I, bool)
    prefix[3] = True
    ext = np.zeros(I, bool)
    ext[4:] = True
    cfg = dict(max_out=4096, max_stack=1024)
    want = ref_eclat.mine(
        ref_db.item_bits, jnp.asarray(prefix), jnp.asarray(ext),
        ref_bm.tidlist_of_itemset(ref_db, jnp.asarray(prefix)),
        jnp.asarray(minsup, jnp.int32), jax.random.PRNGKey(0),
        config=ref_eclat.EclatConfig(**cfg), n_items=I)
    got = eclat.mine(db.item_bits, torch.from_numpy(prefix), torch.from_numpy(ext),
                     bm.tidlist_of_itemset(db, torch.from_numpy(prefix)), minsup,
                     config=eclat.EclatConfig(**cfg), n_items=I)
    assert (got.n_out, got.n_total, got.stack_overflow, got.n_iters) == (
        int(want.n_out), int(want.n_total), int(want.stack_overflow), int(want.n_iters))
    np.testing.assert_array_equal(bm.to_reference(got.items), np.asarray(want.items))
    np.testing.assert_array_equal(got.supports.numpy(), np.asarray(want.supports))


@pytest.mark.parametrize("P,alpha,seed", [(2, 0.3, 0), (4, 0.5, 1), (8, 1.0, 2)])
def test_verify_disjoint_cover(P, alpha, seed):
    """On the reference's partition property inputs; a dropped class breaks
    the cover and a repeated one the disjointness, in both packages."""
    rng = np.random.default_rng(seed)
    dense = rng.random((64, 10)) < 0.45
    ref_db = ref_bm.BitmapDB.from_dense(jnp.asarray(dense))
    oracle = ref_eclat.brute_force_fis(dense, 8)
    masks = np.zeros((len(oracle), 10), bool)
    for i, s in enumerate(oracle):
        masks[i, sorted(s)] = True

    def ref_ext(prefix):
        tid = ref_bm.tidlist_of_itemset(ref_db, jnp.asarray(prefix))
        return np.asarray(ref_bm.extension_supports(ref_db.item_bits, tid))

    port_db = bm.BitmapDB.from_dense(torch.from_numpy(dense))

    def port_ext(prefix):
        tid = bm.tidlist_of_itemset(port_db, torch.from_numpy(prefix))
        return bm.extension_supports(port_db.item_bits, tid).numpy()

    ref_classes = ref_pbec.partition(masks, P, alpha, ref_ext, 10)
    classes = pbec.partition(masks, P, alpha, port_ext, 10)
    assert [(c.seq, c.est_count) for c in classes] == \
        [(c.seq, c.est_count) for c in ref_classes]
    deep = max(range(len(classes)), key=lambda k: (classes[k].ext.sum(), -k))
    cases = [slice(None), [k for k in range(len(classes)) if k != deep],
             list(range(len(classes))) + [deep]]
    seen = []
    for sel in cases:
        pick = (lambda cs: cs[sel]) if isinstance(sel, slice) else (lambda cs: [cs[k] for k in sel])
        got = pbec.verify_disjoint_cover(pick(classes), 10, masks)
        assert got == ref_pbec.verify_disjoint_cover(pick(ref_classes), 10, masks)
        seen.append(got)
    assert seen[0] == (True, True)
    assert seen[1][1] is False and seen[2][0] is False


def test_lpt_makespan_bound_ok():
    rng = np.random.default_rng(0)
    for trial in range(40):
        P = int(rng.integers(1, 12))
        sizes = rng.uniform(0, 100, int(rng.integers(0, 60))).tolist()
        for a in (schedule.lpt_schedule(sizes, P), np.zeros(len(sizes), np.int64),
                  rng.integers(0, P, len(sizes))):
            assert schedule.lpt_makespan_bound_ok(sizes, a, P) == \
                ref_schedule.lpt_makespan_bound_ok(sizes, a, P)
    assert not schedule.lpt_makespan_bound_ok([5.0] * 8, np.zeros(8, np.int64), 4)
    assert schedule.lpt_makespan_bound_ok([], np.zeros(0, np.int64), 3)


def test_bitmap_helpers(small_db, db, thesis_db):
    dense, ref_db, _, _ = small_db
    rng = np.random.default_rng(0)
    for _ in range(25):
        mask = np.zeros(db.n_items, bool)
        mask[rng.choice(db.n_items, size=int(rng.integers(0, 6)), replace=False)] = True
        want = int(ref_bm.support_of_itemset(ref_db, jnp.asarray(mask)))
        got = bm.support_of_itemset(db, torch.from_numpy(mask))
        assert got.dtype == torch.int32 and int(got) == want
        tid = bm.tidlist_of_itemset(db, torch.from_numpy(mask))
        assert int(bm.support_of_tidlist(tid)) == want == int(dense[:, mask].all(axis=1).sum())
    thesis = bm.BitmapDB.from_dense(torch.from_numpy(np.array(thesis_db.dense())))
    assert int(bm.support_of_tidlist(thesis.all_tids())) == thesis_db.n_tx == 15
    for port, ref in ((db, ref_db), (thesis, thesis_db)):
        valid = port.all_tids().clone()
        valid[0] &= 0x0F0F0F0F
        np.testing.assert_array_equal(
            bm.pair_supports(port.item_bits, valid).numpy(),
            np.asarray(ref_bm.pair_supports(ref.item_bits, jnp.asarray(bm.to_reference(valid)))))
    masks = rng.random((9, 70)) < 0.4
    np.testing.assert_array_equal(
        bm.to_reference(bm.itemset_mask_to_packed(torch.from_numpy(masks))),
        np.asarray(ref_bm.itemset_mask_to_packed(jnp.asarray(masks))))
