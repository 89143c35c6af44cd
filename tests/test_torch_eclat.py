"""The port's frontier-batched Eclat against ``repro.core.eclat``.

Both miners run on the same database from numpy.  The port's host loop must
reproduce the reference's ``lax.while_loop`` trip for trip: the same output
buffer in the same order, the same counters, and, fed the reference's
Algorithm-R draws, the same reservoir.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as ref_bm
from repro.core import eclat as ref_eclat
from repro.data.ibm_gen import IBMParams, generate_dense
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat

N_ITEMS = 24


@pytest.fixture(scope="module")
def db():
    dense = generate_dense(IBMParams(n_tx=512, n_items=N_ITEMS, n_patterns=8,
                                     avg_pattern_len=5, avg_tx_len=8, seed=3))
    minsup = int(np.ceil(0.08 * 512))
    return dense, ref_bm.BitmapDB.from_dense(jnp.asarray(dense)), minsup


def reference_draws(key, n):
    """The j of Algorithm R that ``repro.core.eclat`` draws for the t-th FI."""

    def step(k, t):
        k, sub = jax.random.split(k)
        return k, jax.random.randint(sub, (), 0, t)

    _, js = jax.lax.scan(step, key, jnp.arange(1, n + 1, dtype=jnp.int32))
    return torch.from_numpy(np.asarray(js).astype(np.int64))


def assert_same_result(got, want, n_items, *, count_only=False):
    assert got.n_out == int(want.n_out)
    assert got.n_total == int(want.n_total)
    assert got.stack_overflow == int(want.stack_overflow)
    assert got.n_iters == int(want.n_iters)
    assert got.n_popped == int(want.n_popped)
    if not count_only:
        n = got.n_out
        np.testing.assert_array_equal(bm.to_reference(got.items[:n]), np.asarray(want.items)[:n])
        np.testing.assert_array_equal(got.supports[:n].numpy(), np.asarray(want.supports)[:n])


@pytest.mark.parametrize("frontier", [1, 16, 64])
def test_mine_all_matches_reference(db, frontier):
    dense, ref_db, minsup = db
    cfg = dict(max_out=4096, max_stack=1024, frontier_size=frontier)
    want = ref_eclat.mine_all(ref_db, minsup, config=ref_eclat.EclatConfig(**cfg))
    got = eclat.mine_all(bm.BitmapDB.from_dense(torch.from_numpy(dense)), minsup,
                         config=eclat.EclatConfig(**cfg))
    assert_same_result(got, want, N_ITEMS)
    assert got.stack_overflow == 0 and got.n_out == got.n_total
    fis = eclat.result_fis(got, N_ITEMS)
    assert len(fis) == got.n_total  # every FI emitted once
    if frontier == 1:
        oracle = ref_eclat.brute_force_fis(dense, minsup)
        assert eclat.brute_force_fis(dense, minsup) == oracle
        # mine_all does not emit the root ∅; brute force has no ∅ either
        assert fis == oracle


def _seeds(ref_db, n_seeds, seed):
    """1-prefix seed classes in a random item order, some of them invalid."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(N_ITEMS)[:n_seeds]
    prefix = np.zeros((n_seeds, N_ITEMS), bool)
    ext = np.zeros((n_seeds, N_ITEMS), bool)
    for k, b in enumerate(order):
        prefix[k, b] = True
        ext[k, order[k + 1:]] = True
    valid = rng.random(n_seeds) < 0.8
    tids = np.stack([np.asarray(ref_bm.tidlist_of_itemset(ref_db, jnp.asarray(p))) for p in prefix])
    return prefix, ext, tids, valid


@pytest.mark.parametrize(
    "frontier,max_stack,max_out",
    [(1, 1024, 4096), (16, 1024, 4096), (64, 1024, 4096),
     (16, 24, 4096),   # the stack overflows: pushes are counted, not lost silently
     (16, 1024, 200)], # the output buffer fills: n_total runs on past n_out
)
def test_mine_seeded_matches_reference(db, frontier, max_stack, max_out):
    dense, ref_db, _ = db
    minsup = 16
    prefix, ext, tids, valid = _seeds(ref_db, N_ITEMS, seed=frontier + max_stack)
    cfg = dict(max_out=max_out, max_stack=max_stack, frontier_size=frontier)
    want = ref_eclat.mine_seeded(
        ref_db.item_bits, jnp.asarray(prefix), jnp.asarray(ext), jnp.asarray(tids),
        jnp.asarray(valid), jnp.asarray(minsup, jnp.int32), jax.random.PRNGKey(0),
        config=ref_eclat.EclatConfig(**cfg), n_items=N_ITEMS,
    )
    got = eclat.mine_seeded(
        bm.from_reference(np.asarray(ref_db.item_bits)), torch.from_numpy(prefix),
        torch.from_numpy(ext), bm.from_reference(tids), torch.from_numpy(valid), minsup,
        config=eclat.EclatConfig(**cfg), n_items=N_ITEMS,
    )
    assert_same_result(got, want, N_ITEMS)
    if max_stack == 24:
        assert got.stack_overflow > 0
    if max_out == 200:
        assert got.n_total > got.n_out == 200


@pytest.mark.parametrize("frontier", [1, 16])
def test_reservoir_replays_reference_draws(db, frontier):
    dense, ref_db, _ = db
    minsup = 16
    prefix, ext, tids, valid = _seeds(ref_db, N_ITEMS, seed=5)
    key = jax.random.PRNGKey(11)
    cfg = dict(max_out=16, max_stack=1024, frontier_size=frontier,
               reservoir_size=64, count_only=True)
    want = ref_eclat.mine_seeded(
        ref_db.item_bits, jnp.asarray(prefix), jnp.asarray(ext), jnp.asarray(tids),
        jnp.asarray(valid), jnp.asarray(minsup, jnp.int32), key,
        config=ref_eclat.EclatConfig(**cfg), n_items=N_ITEMS,
    )
    n = int(want.n_total)
    assert n > 64  # the reservoir really replaces entries
    got = eclat.mine_seeded(
        bm.from_reference(np.asarray(ref_db.item_bits)), torch.from_numpy(prefix),
        torch.from_numpy(ext), bm.from_reference(tids), torch.from_numpy(valid), minsup,
        config=eclat.EclatConfig(**cfg), n_items=N_ITEMS,
        reservoir_draws=reference_draws(key, n),
    )
    assert_same_result(got, want, N_ITEMS, count_only=True)
    np.testing.assert_array_equal(bm.to_reference(got.reservoir_items),
                                  np.asarray(want.reservoir_items))
    np.testing.assert_array_equal(got.reservoir_supports.numpy(),
                                  np.asarray(want.reservoir_supports))
    with pytest.raises(ValueError):  # too few draws is an error, not a silent reuse
        eclat.mine_seeded(
            bm.from_reference(np.asarray(ref_db.item_bits)), torch.from_numpy(prefix),
            torch.from_numpy(ext), bm.from_reference(tids), torch.from_numpy(valid), minsup,
            config=eclat.EclatConfig(**cfg), n_items=N_ITEMS,
            reservoir_draws=reference_draws(key, n - 1),
        )


def test_reservoir_from_generator_is_a_sample_of_the_stream(db):
    """With a torch generator the reservoir holds R distinct FIs of the stream."""
    dense, ref_db, minsup = db
    torch_db = bm.BitmapDB.from_dense(torch.from_numpy(dense))
    full = eclat.result_fis(eclat.mine_all(torch_db, minsup, config=eclat.EclatConfig(
        max_out=4096, frontier_size=16)), N_ITEMS)
    res = eclat.mine_all(torch_db, minsup, config=eclat.EclatConfig(
        max_out=1, frontier_size=16, reservoir_size=50, count_only=True),
        generator=torch.Generator().manual_seed(0))
    masks = bm.unpack_bool(res.reservoir_items, N_ITEMS).numpy()
    sampled = {frozenset(np.flatnonzero(m).tolist()) for m in masks}
    assert len(sampled) == 50
    assert all(full[s] == int(v) for s, v in zip(
        (frozenset(np.flatnonzero(m).tolist()) for m in masks), res.reservoir_supports))
