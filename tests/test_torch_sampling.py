"""The port's samplers (``repro_torch.core.sampling``) against
``repro.core.sampling``, tolerance 0.

* ``modified_coverage_sample`` handed the reference's picks and random words
  gives the reference's draws.  The picks are computed from the reference's
  own candidate list: ``jax.random.categorical`` depends on its length and
  weights.  With the port's own generator, every draw is a subset of a valid
  candidate, so a frequent itemset.
* ``coverage_sample_uniform`` and ``reservoir_sample_np`` with the same numpy
  generator, ``coverage_sample_size`` and ``sample_db`` with the reference's
  row draws give the reference's outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as ref_bm
from repro.core import mfi as ref_mfi
from repro.core import sampling as ref_sampling
from repro_torch.core import bitmap as bm
from repro_torch.core import mfi, sampling


def reference_picks_and_bits(key, items, valid, n):
    """The draws ``repro.core.sampling.modified_coverage_sample`` makes."""
    sizes = ref_bm.popcount_u32(items).sum(axis=-1).astype(jnp.float32)
    logits = jnp.where(valid, sizes * jnp.log(2.0), -jnp.inf)
    k_pick, k_bits = jax.random.split(key)
    picks = jax.random.categorical(k_pick, logits, shape=(n,))
    bits = jax.random.bits(k_bits, (n, items.shape[-1]), dtype=jnp.uint32)
    return np.array(picks), np.array(bits)


@pytest.fixture(scope="module")
def candidates(small_db):
    """The reference's MFI candidates of the small database (a valid mask
    with some rows switched off), and the port's."""
    dense, ref_db, minsup, oracle = small_db
    cfg = dict(max_out=4096, max_stack=2048)
    r = ref_mfi.mine_all_candidates(ref_db, minsup, config=ref_mfi.MFIConfig(**cfg))
    n = int(r.n_out)
    valid = np.zeros(r.items.shape[0], bool)
    valid[:n] = True
    valid[: n: 5] = False
    mine = mfi.mine_all_candidates(bm.BitmapDB.from_dense(torch.from_numpy(dense)), minsup,
                                   config=mfi.MFIConfig(**cfg))
    return np.asarray(r.items), valid, mine, oracle, dense.shape[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_modified_coverage_with_reference_draws(candidates, seed):
    items, valid, _, _, n_items = candidates
    key = jax.random.PRNGKey(seed)
    want = np.asarray(ref_sampling.modified_coverage_sample(
        key, jnp.asarray(items), jnp.asarray(valid), 300, n_items))
    picks, bits = reference_picks_and_bits(key, jnp.asarray(items), jnp.asarray(valid), 300)
    assert valid[picks].all()
    got = sampling.modified_coverage_sample(
        bm.from_reference(items), torch.from_numpy(valid), 300, n_items,
        picks=torch.from_numpy(picks), bits=bm.from_reference(bits))
    np.testing.assert_array_equal(bm.to_reference(got), want)


def test_modified_coverage_own_draws_are_frequent(candidates):
    """Every draw from the port's generator is a subset of a valid candidate,
    and so, when nonempty, a frequent itemset."""
    _, _, mine, oracle, n_items = candidates
    valid = torch.arange(mine.items.shape[0]) < mine.n_out
    valid[: mine.n_out: 5] = False
    g = torch.Generator().manual_seed(3)
    draws = sampling.modified_coverage_sample(mine.items, valid, 512, n_items, generator=g)
    assert draws.shape == (512, bm.n_words(n_items))
    inside = bm.is_subset_packed(draws[:, None, :], mine.items[None, :, :]) & valid[None, :]
    assert inside.any(dim=1).all()
    for row in bm.unpack_bool(draws, n_items).numpy():
        fs = frozenset(np.flatnonzero(row).tolist())
        assert not fs or fs in oracle
    again = sampling.modified_coverage_sample(mine.items, valid, 512, n_items,
                                              generator=torch.Generator().manual_seed(3))
    assert torch.equal(draws, again)
    with pytest.raises(ValueError, match="picks"):
        sampling.modified_coverage_sample(mine.items, valid, 4, n_items,
                                          picks=torch.zeros(3, dtype=torch.int64))


def test_coverage_uniform_and_reservoir_np():
    mfis = np.zeros((3, 7), bool)
    mfis[0, :3] = True
    mfis[1, 2:5] = True
    mfis[2, [0, 4, 5, 6]] = True
    want = ref_sampling.coverage_sample_uniform(np.random.default_rng(0), mfis, 500)
    got = sampling.coverage_sample_uniform(np.random.default_rng(0), mfis, 500)
    np.testing.assert_array_equal(got, want)
    stream = np.arange(1000)
    for n in (1, 10, 64):
        np.testing.assert_array_equal(
            sampling.reservoir_sample_np(np.random.default_rng(n), stream, n),
            ref_sampling.reservoir_sample_np(np.random.default_rng(n), stream, n))


def test_sample_sizes_and_sample_db(small_db):
    for eps, delta, rho in ((0.05, 0.1, 0.01), (0.1, 0.05, 0.2), (0.01, 0.01, 0.5)):
        assert (sampling.coverage_sample_size(eps, delta, rho)
                == ref_sampling.coverage_sample_size(eps, delta, rho))
        assert (sampling.reservoir_sample_size(eps, delta, rho)
                == ref_sampling.reservoir_sample_size(eps, delta, rho))
        assert sampling.db_sample_size(eps, delta) == ref_sampling.db_sample_size(eps, delta)
    dense, ref_db, _, _ = small_db
    key = jax.random.PRNGKey(7)
    want = ref_sampling.sample_db(ref_db, key, 200)
    idx = np.asarray(jax.random.randint(key, (200,), 0, ref_db.n_tx))
    got = sampling.sample_db(bm.BitmapDB.from_dense(torch.from_numpy(dense)), 200,
                             idx=torch.from_numpy(idx))
    assert (got.n_tx, got.n_items) == (want.n_tx, want.n_items)
    np.testing.assert_array_equal(bm.to_reference(got.item_bits), np.asarray(want.item_bits))
    np.testing.assert_array_equal(bm.to_reference(got.tx_bits), np.asarray(want.tx_bits))
