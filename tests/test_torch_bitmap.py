"""The port's packed-bitmap layer is bit-equal to ``repro.core.bitmap``.

Inputs come from numpy with a fixed seed and go through both packages; words
cross between them as ``uint32`` numpy arrays (``from_reference`` /
``to_reference``).  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as ref_bm
from repro_torch.core import bitmap as bm

# (n_tx, n_items): T not a multiple of 32, I = 33 (one bit into a second word),
# I = 32 (bit 31 is the int32 sign bit), tiny and word-aligned shapes.
SHAPES = [(1, 1), (31, 33), (64, 32), (97, 7), (300, 33), (1000, 31)]


def _dense(n_tx, n_items, seed, density=0.35):
    return np.random.default_rng(seed).random((n_tx, n_items)) < density


@pytest.mark.parametrize("n_tx,n_items", SHAPES)
def test_pack_unpack_bit_equal(n_tx, n_items):
    dense = _dense(n_tx, n_items, seed=n_tx * 131 + n_items)
    for arr in (dense, dense.T):
        want = np.asarray(ref_bm.pack_bool(jnp.asarray(arr)))
        got = bm.pack_bool(torch.from_numpy(arr))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(bm.to_reference(got), want)
        back = bm.unpack_bool(bm.from_reference(want), arr.shape[-1]).numpy()
        np.testing.assert_array_equal(back, arr)


@pytest.mark.parametrize("n_tx,n_items", SHAPES)
def test_bitmapdb_from_dense_and_all_tids(n_tx, n_items):
    dense = _dense(n_tx, n_items, seed=n_tx + 7 * n_items)
    want = ref_bm.BitmapDB.from_dense(jnp.asarray(dense))
    got = bm.BitmapDB.from_dense(torch.from_numpy(dense))
    assert (got.n_tx, got.n_items, got.n_tx_words) == (
        want.n_tx, want.n_items, want.n_tx_words
    )
    np.testing.assert_array_equal(bm.to_reference(got.item_bits), np.asarray(want.item_bits))
    np.testing.assert_array_equal(bm.to_reference(got.tx_bits), np.asarray(want.tx_bits))
    np.testing.assert_array_equal(bm.to_reference(got.all_tids()), np.asarray(want.all_tids()))


def test_popcount_every_bit_position():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555], np.uint32),
        np.uint32(1) << np.arange(32, dtype=np.uint32),
        rng.integers(0, 2**32, size=500, dtype=np.uint32),
    ])
    want = np.asarray(ref_bm.popcount_u32(jnp.asarray(words)))
    got = bm.popcount(bm.from_reference(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_tx,n_items", SHAPES[1:])
def test_tidlist_of_itemset_bit_equal(n_tx, n_items):
    dense = _dense(n_tx, n_items, seed=3 * n_tx + n_items, density=0.6)
    want_db = ref_bm.BitmapDB.from_dense(jnp.asarray(dense))
    got_db = bm.BitmapDB.from_dense(torch.from_numpy(dense))
    rng = np.random.default_rng(n_items)
    for size in (0, 1, 2, 3):
        mask = np.zeros(n_items, bool)
        mask[rng.choice(n_items, size=min(size, n_items), replace=False)] = True
        want = np.asarray(ref_bm.tidlist_of_itemset(want_db, jnp.asarray(mask)))
        got = bm.tidlist_of_itemset(got_db, torch.from_numpy(mask))
        np.testing.assert_array_equal(bm.to_reference(got), want)


@pytest.mark.parametrize("n_items", [7, 32, 33, 70])
def test_is_subset_packed_bit_equal(n_items):
    rng = np.random.default_rng(n_items)
    a = rng.random((40, n_items)) < 0.1
    b = rng.random((40, n_items)) < 0.7
    b[:10] |= a[:10]  # make some pairs real subsets
    pa = np.asarray(ref_bm.pack_bool(jnp.asarray(a)))
    pb = np.asarray(ref_bm.pack_bool(jnp.asarray(b)))
    want = np.asarray(ref_bm.is_subset_packed(jnp.asarray(pa)[:, None], jnp.asarray(pb)[None]))
    got = bm.is_subset_packed(bm.from_reference(pa)[:, None], bm.from_reference(pb)[None])
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:10].diagonal().all()


@pytest.mark.parametrize("n_tx,n_items", SHAPES)
def test_rebuild_vertical_bit_equal(n_tx, n_items):
    dense = _dense(n_tx + 5, n_items, seed=n_tx)
    tx_bits = np.asarray(ref_bm.pack_bool(jnp.asarray(dense)))
    want = ref_bm.rebuild_vertical(jnp.asarray(tx_bits), n_items, n_tx)
    got = bm.rebuild_vertical(bm.from_reference(tx_bits), n_items, n_tx)
    assert got.n_tx == want.n_tx == n_tx
    np.testing.assert_array_equal(bm.to_reference(got.item_bits), np.asarray(want.item_bits))
    np.testing.assert_array_equal(bm.to_reference(got.tx_bits), np.asarray(want.tx_bits))


@pytest.mark.parametrize("n_tx,n_items", SHAPES)
def test_support_sweeps_bit_equal(n_tx, n_items):
    """The sweeps of core/bitmap (plain versions on the CPU) match the jnp oracles."""
    dense = _dense(n_tx, n_items, seed=11 * n_tx + n_items)
    want_db = ref_bm.BitmapDB.from_dense(jnp.asarray(dense))
    items = bm.from_reference(np.asarray(want_db.item_bits))
    tids = np.stack([
        np.asarray(ref_bm.tidlist_of_itemset(want_db, jnp.asarray(m)))
        for m in np.eye(n_items, dtype=bool)[:5]
    ] + [np.asarray(want_db.all_tids())])
    want = np.asarray(ref_bm.multi_extension_supports(want_db.item_bits, jnp.asarray(tids)))
    got = bm.multi_extension_supports(items, bm.from_reference(tids))
    np.testing.assert_array_equal(got.numpy(), want)
    want1 = np.asarray(ref_bm.extension_supports(want_db.item_bits, jnp.asarray(tids[-1])))
    got1 = bm.extension_supports(items, bm.from_reference(tids[-1]))
    np.testing.assert_array_equal(got1.numpy(), want1)
    np.testing.assert_array_equal(want1, dense.sum(axis=0))


def test_sample_transactions_takes_injected_rows():
    dense = _dense(50, 9, seed=1)
    tx_bits = bm.pack_bool(torch.from_numpy(dense))
    idx = torch.tensor([3, 3, 0, 49, 17])
    np.testing.assert_array_equal(
        bm.sample_transactions(tx_bits, 5, idx=idx).numpy(), tx_bits[idx].numpy()
    )
    with pytest.raises(ValueError):
        bm.sample_transactions(tx_bits, 4, idx=idx)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = bm.sample_transactions(tx_bits, 20, generator=g1)
    b = bm.sample_transactions(tx_bits, 20, generator=g2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.shape == (20, 1)


def test_reference_views_keep_bits():
    words = np.array([[0, 1, 0x80000000, 0xFFFFFFFF]], np.uint32)
    t = bm.from_reference(words)
    assert t.dtype == torch.int32
    assert t.tolist() == [[0, 1, -(2**31), -1]]
    back = bm.to_reference(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, words)
