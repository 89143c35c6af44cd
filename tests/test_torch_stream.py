"""The port's streaming subsystem against the JAX package's.

* ``drifting_stream`` gives the reference's blocks, bit for bit.
* The window's ring order, evictions and views equal the reference's, and
  supports kept by ``ops.delta_supports`` equal a full recompute.
* The drift monitor draws the reference's sample and gives its verdicts.
* ``StreamingMiner`` on a small stream (window 4×128) gives the reference's
  events block for block: the delta-updated supports, the drift verdicts,
  the re-mine reasons and the generations, with 0 torn-index failures.  The
  re-miner is the brute-force oracle in both, and once the port's own
  Parallel-FIMI re-miner: every FITable is exact, so the events are the same.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as ref_bm
from repro.core import eclat as ref_eclat
from repro.data import ibm_gen as ref_gen
from repro.stream import DriftMonitor as RefMonitor
from repro.stream import SlidingWindow as RefWindow
from repro.stream import StreamingMiner as RefMiner
from repro.stream import StreamParams as RefParams
from repro.stream.monitor import chernoff_eps as ref_chernoff_eps
from repro_torch.core import bitmap as bm
from repro_torch.data import ibm_gen
from repro_torch.kernels import ops
from repro_torch.launch import stream_mine
from repro_torch.stream import DriftMonitor, SlidingWindow, StreamingMiner, StreamParams
from repro_torch.stream import fimi_mine_fn
from repro_torch.stream.monitor import chernoff_eps


def _packed_blocks(n, t, n_items, seed, density=0.3):
    """uint32 packed blocks [n, t, IW] of random rows, as the reference packs."""
    rng = np.random.default_rng(seed)
    dense = rng.random((n, t, n_items)) < rng.uniform(0.1, 0.5, size=(n, 1, 1)) + density / 3
    return np.asarray(ref_bm.pack_bool(jnp.asarray(dense)))


def test_drifting_stream_is_bit_equal():
    p = ref_gen.IBMParams(n_tx=0, n_items=40, n_patterns=6, avg_pattern_len=4, avg_tx_len=7,
                          seed=5)
    q = ibm_gen.IBMParams(**dataclasses.asdict(p))
    for breaks in ((), (2, 4), (0,)):
        want = list(ref_gen.drifting_stream(p, n_blocks=6, block_tx=33, breaks=breaks))
        got = list(ibm_gen.drifting_stream(q, n_blocks=6, block_tx=33, breaks=breaks))
        assert [s for _, s in got] == [s for _, s in want]
        for (a, _), (b, _) in zip(got, want):
            assert a.dtype == b.dtype == bool
            np.testing.assert_array_equal(a, b)


def test_window_ring_order_and_views_equal_the_reference():
    n_items, T, B = 40, 16, 3
    blocks = _packed_blocks(8, T, n_items, seed=5)
    want = RefWindow.empty(B, T, n_items)
    got = SlidingWindow.empty(B, T, n_items, device="cpu")
    for block in blocks:
        want, want_expired = want.admit(jnp.asarray(block))
        got_expired = got.admit(bm.from_reference(block))
        assert (got_expired is None) == (want_expired is None)
        if got_expired is not None:
            np.testing.assert_array_equal(bm.to_reference(got_expired), np.asarray(want_expired))
        assert (got.head, got.count, got.full, got.n_tx) == (want.head, want.count, want.full,
                                                             want.n_tx)
        assert got.slot_order() == want.slot_order()
        np.testing.assert_array_equal(got.to_reference()["blocks"], np.asarray(want.blocks))
        np.testing.assert_array_equal(bm.to_reference(got.stacked()), np.asarray(want.stacked()))
        np.testing.assert_array_equal(bm.to_reference(got.rows()), np.asarray(want.rows()))
    np.testing.assert_array_equal(bm.to_reference(got.to_bitmap_db().item_bits),
                                  np.asarray(want.to_bitmap_db().item_bits))
    # carried across: the same ring, and the same next eviction
    fields = {f: getattr(want, f) for f in ("head", "count", "n_items")}
    back = SlidingWindow.from_reference(blocks=np.asarray(want.blocks), device="cpu", **fields)
    assert back.to_reference()["head"] == want.head
    np.testing.assert_array_equal(bm.to_reference(back.admit(bm.from_reference(blocks[0]))),
                                  np.asarray(want.admit(jnp.asarray(blocks[0]))[1]))
    with pytest.raises(ValueError):
        got.admit(torch.zeros((T + 1, 2), dtype=torch.int32))


def test_window_delta_invariant():
    """Any admit sequence: delta-accumulated supports == full recompute."""
    n_items, T, B = 20, 32, 4
    sets = bm.from_reference(_packed_blocks(1, 11, n_items, seed=6, density=0.1)[0])
    sets[0] = 0                                                     # ∅
    w = SlidingWindow.empty(B, T, n_items, device="cpu")
    acc = None
    for block in _packed_blocks(B + 6, T, n_items, seed=9):
        block = bm.from_reference(block)
        expired = w.admit(block)
        if expired is None:
            if w.full:
                acc = ops.block_itemset_supports(w.stacked(), sets).sum(dim=0)
            continue
        counts = ops.delta_supports(block, expired, sets)
        acc = acc + counts[0] - counts[1]
        assert torch.equal(acc, ops.block_itemset_supports(w.stacked(), sets).sum(dim=0))
    assert acc is not None and acc[0] == w.n_tx


def _bernoulli_block(t, n_items, item, p, rng):
    dense = rng.random((t, n_items)) < 0.05
    dense[:, item] = False
    dense[rng.choice(t, size=int(round(p * t)), replace=False), item] = True
    return np.asarray(ref_bm.pack_bool(jnp.asarray(dense)))


@pytest.mark.parametrize("eps,margin", [(0.2, 0.0), (2.0, 0.05)])
def test_monitor_draws_and_fires_as_the_reference(eps, margin):
    n_items, T, B = 8, 200, 4
    kw = dict(eps=eps, delta=0.05, border_margin=margin, border_hysteresis=0.02, seed=3)
    want, got = RefMonitor(B, T, **kw), DriftMonitor(B, T, **kw)
    assert got.rows_per_block == want.rows_per_block
    rng = np.random.default_rng(1)
    masks = np.asarray(ref_bm.pack_bool(jnp.asarray(np.eye(n_items, dtype=bool)[:2])))
    verdicts = []
    for p, current in ((0.5, None), (0.9, None), (0.9, [0.5, 0.09]), (0.9, [0.5, 0.07])):
        for _ in range(B):
            block = _bernoulli_block(T, n_items, 0, p, rng)
            want.admit(block)
            got.admit(bm.from_reference(block))
        np.testing.assert_array_equal(bm.to_reference(got.sample_rows()), want.sample_rows())
        if not verdicts:
            want.rearm(np.asarray([0.5, 0.12]), minsup_rel=0.1)
            got.rearm(np.asarray([0.5, 0.12]), minsup_rel=0.1)
        cur = None if current is None else np.asarray(current)
        v_want = want.check(jnp.asarray(masks), current_rel=cur)
        v_got = got.check(bm.from_reference(masks), current_rel=cur)
        assert dataclasses.astuple(v_got) == dataclasses.astuple(v_want)
        verdicts.append(v_got)
    assert any(v.fired for v in verdicts) and not verdicts[0].fired
    assert chernoff_eps(738, 0.05) == ref_chernoff_eps(738, 0.05)


def _ref_brute(window, abs_minsup):
    return ref_eclat.brute_force_fis(np.asarray(window.to_bitmap_db().dense()), abs_minsup)


def _port_brute(window, abs_minsup):
    dense = bm.unpack_bool(window.rows(), window.n_items).numpy()
    return ref_eclat.brute_force_fis(dense, abs_minsup)


STREAM = dict(n_items=20, n_patterns=6, avg_pattern_len=4, avg_tx_len=7, seed=3)
PARAMS = dict(n_blocks=4, block_tx=128, min_support_rel=0.15, min_confidence=0.6, eps=0.125,
              delta=0.05, border_margin=0.03, border_hysteresis=0.02, cooldown_blocks=1,
              batch=32, seed=0)


def _run(miner, blocks, exact_every_block):
    """Admit each block; record each event, the supports, and torn-index
    failures (the launcher's check, before and after a swap)."""
    rng = np.random.default_rng(7)
    events, torn = [], 0
    for block in blocks:
        if miner.engine is not None:
            torn += stream_mine.parity_failures(miner, rng)
        ev = miner.admit(block)
        if ev.remined:
            torn += stream_mine.parity_failures(miner, rng)
        supports = None if miner.engine is None else miner.current_supports.copy()
        if exact_every_block and miner.engine is not None:
            np.testing.assert_array_equal(miner.exact_window_supports(), supports)
        events.append((ev, supports))
    return events, torn


@pytest.fixture(scope="module")
def reference_events():
    blocks = [b for b, _ in ref_gen.drifting_stream(ref_gen.IBMParams(**STREAM), n_blocks=12,
                                                     block_tx=128, breaks=(6,))]
    ref = RefMiner(RefParams(**PARAMS), STREAM["n_items"], mine_fn=_ref_brute)
    events = []
    for block in blocks:
        ev = ref.admit(block)
        events.append((ev, None if ref.engine is None else ref.current_supports.copy()))
    return blocks, events, ref


def _assert_same_events(got, want):
    assert len(got) == len(want)
    for (g, g_supp), (w, w_supp) in zip(got, want):
        assert (g.block_index, g.expired, g.delta_applied, g.remined, g.remine_reason,
                g.generation) == (w.block_index, w.expired, w.delta_applied, w.remined,
                                  w.remine_reason, w.generation)
        assert (g.verdict is None) == (w.verdict is None)
        if g.verdict is not None:
            assert dataclasses.astuple(g.verdict) == dataclasses.astuple(w.verdict)
        if w_supp is None:
            assert g_supp is None
        else:
            np.testing.assert_array_equal(g_supp, w_supp)


@pytest.mark.parametrize("remine", ["brute_force", "fimi"])
def test_streaming_miner_events_equal_the_reference(reference_events, remine):
    blocks, want, ref = reference_events
    mine_fn = _port_brute if remine == "brute_force" else fimi_mine_fn(P=2)
    miner = StreamingMiner(StreamParams(**PARAMS), STREAM["n_items"], mine_fn=mine_fn,
                           device="cpu")
    got, torn = _run(miner, blocks, exact_every_block=True)
    _assert_same_events(got, want)
    assert torn == 0
    reasons = [ev.remine_reason for ev, _ in got if ev.remined]
    assert reasons[0] == "initial" and len(reasons) >= 2   # the drift re-mines
    assert dataclasses.asdict(miner.stats) == dataclasses.asdict(ref.stats) | {
        "mine_ms": miner.stats.mine_ms, "swap_ms": miner.stats.swap_ms}
    want_fi = {f.name: getattr(ref.engine.index, f.name)
               for f in dataclasses.fields(ref.engine.index)}
    got_fi = miner.engine.index.to_reference()
    np.testing.assert_array_equal(got_fi["masks"], np.asarray(want_fi["masks"]))
    np.testing.assert_array_equal(got_fi["supports"], np.asarray(want_fi["supports"]))
    assert miner.cache.stats.invalidations == miner.engine.generation


def test_fimi_mine_fn_keeps_itemsets_at_exactly_minsup():
    """The re-miner's ``(abs − 0.5)/n_tx`` support: an itemset whose support is
    exactly ``abs_minsup`` is mined, one below it is not."""
    w = SlidingWindow.empty(2, 64, 12, device="cpu")
    for block in _packed_blocks(2, 64, 12, seed=4):
        w.admit(bm.from_reference(block))
    dense = bm.unpack_bool(w.rows(), 12).numpy()
    counts = sorted(set(int(c) for c in dense.sum(axis=0)))
    abs_minsup = counts[len(counts) // 2]       # an item's support, exactly
    got = fimi_mine_fn(P=2)(w, abs_minsup)
    assert got == ref_eclat.brute_force_fis(dense, abs_minsup)
    assert abs_minsup in got.values()


def test_streaming_miner_requires_a_full_window_and_reports_staleness():
    miner = StreamingMiner(StreamParams(**PARAMS), STREAM["n_items"], mine_fn=_port_brute,
                           device="cpu")
    blocks = [b for b, _ in ibm_gen.drifting_stream(ibm_gen.IBMParams(**STREAM), n_blocks=5,
                                                     block_tx=128)]
    for block in blocks[:3]:
        assert miner.admit(block).generation == -1 and miner.engine is None
    assert miner.staleness() == 0.0
    ev = miner.admit(np.asarray(ref_bm.pack_bool(jnp.asarray(blocks[3]))))  # packed uint32
    assert ev.remined and ev.remine_reason == "initial" and miner.staleness() == 0.0
    miner.admit(torch.from_numpy(blocks[4]))                                # a bool tensor
    assert miner.staleness() == pytest.approx(
        np.abs(miner.served_rel_supports() - miner.exact_window_supports() / miner.window.n_tx)
        .max())
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingMiner(StreamParams(**PARAMS), STREAM["n_items"])
