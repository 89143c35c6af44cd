"""The port's serving engine against the JAX package's, on one index.

An index is built once in JAX, carried over with ``from_reference``, and both
engines answer the same queries: exact for rows and supports, bit-equal for
float32 confidences, with NaN slots in the same places.  The cases are the
places where the two could differ: a float32 score tie in the rules query
(``jax.lax.top_k`` puts the lower column first), the two-key sort of the
superset query, ``k`` past the columns, zero rules and zero itemsets,
``novel_only`` and ``proper`` both ways, the swap, and the cache keys.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import eclat as ref_eclat
from repro.core import rules as ref_rules
from repro.data.ibm_gen import IBMParams, generate_dense
from repro.serve import cache as ref_cache
from repro.serve import engine as ref_engine
from repro.serve import index as ref_index
from repro_torch.core import rules
from repro_torch.serve import QueryCache, QueryEngine
from repro_torch.serve.cache import query_key
from repro_torch.serve.index import FIIndex, RuleIndex, build_indexes

N_ITEMS, N_TX, BATCH = 24, 512, 64


def fields(ref) -> dict:
    """A reference index's fields, arrays as numpy."""
    out = {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        out[f.name] = np.asarray(v) if isinstance(v, jnp.ndarray) else v
    return out


def carry(ref_fi, ref_rl):
    fi = FIIndex.from_reference(**fields(ref_fi), device="cpu")
    rl = None if ref_rl is None else RuleIndex.from_reference(**fields(ref_rl), device="cpu")
    return fi, rl


def to_jax(cls, fields_: dict):
    """A reference index from the port's ``to_reference`` fields."""
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in fields_.items()})


@pytest.fixture(scope="module")
def served():
    dense = generate_dense(IBMParams(n_tx=N_TX, n_items=N_ITEMS, n_patterns=8,
                                     avg_pattern_len=5, avg_tx_len=8, seed=3))
    fis = ref_eclat.brute_force_fis(dense, int(np.ceil(0.08 * N_TX)))
    ref_fi, ref_rl = ref_index.build_indexes(fis, N_ITEMS, N_TX, min_confidence=0.5)
    fi, rl = carry(ref_fi, ref_rl)
    return dense, fis, ref_fi, ref_rl, fi, rl


def engines(ref_fi, ref_rl, fi, rl, top_k=5):
    return (ref_engine.QueryEngine(ref_fi, ref_rl, batch=BATCH, top_k=top_k),
            QueryEngine(fi, rl, batch=BATCH, top_k=top_k))


def chunks(masks):
    for lo in range(0, len(masks), BATCH):
        yield masks[lo: lo + BATCH]


def assert_conf_equal(got, want):
    """float32 confidences: NaN slots in the same places, the rest bit-equal."""
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.where(np.isnan(got), 0, got).view(np.uint32),
                                  np.where(np.isnan(want), 0, want).view(np.uint32))


def baskets(dense, n=150):
    return rules.pack_itemsets([frozenset(np.nonzero(r)[0].tolist()) for r in dense[:n]],
                               N_ITEMS)


def test_carried_index_equals_the_ports_own_build(served):
    _, fis, ref_fi, ref_rl, fi, rl = served
    own_fi, own_rl = build_indexes(fis, N_ITEMS, N_TX, min_confidence=0.5, device="cpu")
    for got, want in ((own_fi.to_reference(), fields(ref_fi)),
                      (own_rl.to_reference(), fields(ref_rl)),
                      (fi.to_reference(), fields(ref_fi))):
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k], k
    assert fi.masks.dtype == torch.int32 and fi.n_fis == len(fis) and rl.n_rules > 100
    assert fi.size_band(2) == ref_fi.size_band(2) and fi.max_size == ref_fi.max_size
    assert fi.itemset(fi.n_fis - 1) == ref_fi.itemset(ref_fi.n_fis - 1)
    assert dataclasses.astuple(rl.rule(3)) == dataclasses.astuple(ref_rl.rule(3))
    # and back into JAX
    back = to_jax(ref_index.FIIndex, fi.to_reference())
    np.testing.assert_array_equal(np.asarray(back.masks), np.asarray(ref_fi.masks))


def test_support_lookup_equals_reference(served):
    dense, fis, ref_fi, ref_rl, fi, rl = served
    want_e, got_e = engines(ref_fi, ref_rl, fi, rl)
    rng = np.random.default_rng(0)
    probes = [frozenset(rng.choice(N_ITEMS, size=int(rng.integers(1, 7)), replace=False)
                        .tolist()) for _ in range(60)]
    queries = np.concatenate([np.asarray(ref_fi.masks)[: ref_fi.n_fis],
                              rules.pack_itemsets(probes + [frozenset()], N_ITEMS)])
    for part in chunks(queries):
        got, want = got_e.support(part), want_e.support(part)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # the empty query never matches the zero pad row
    assert got_e.support(rules.pack_itemsets([frozenset()], N_ITEMS))[0] == -1


@pytest.mark.parametrize("novel_only", [True, False])
def test_top_rules_equal_reference(served, novel_only):
    dense, _, ref_fi, ref_rl, fi, rl = served
    want_e, got_e = engines(ref_fi, ref_rl, fi, rl)
    hits = 0
    for part in chunks(baskets(dense)):
        got_rows, got_conf = got_e.rules_for(part, novel_only=novel_only)
        want_rows, want_conf = want_e.rules_for(part, novel_only=novel_only)
        assert got_rows.dtype == np.int32 and got_rows.shape == (len(part), 5)
        np.testing.assert_array_equal(got_rows, want_rows)
        assert_conf_equal(got_conf, want_conf)
        hits += int((got_rows >= 0).sum())
    assert hits > 0
    assert hits < 150 * 5 or not novel_only    # novel_only leaves NaN slots


@pytest.mark.parametrize("proper", [False, True])
def test_top_supersets_equal_reference(served, proper):
    _, fis, ref_fi, ref_rl, fi, rl = served
    want_e, got_e = engines(ref_fi, ref_rl, fi, rl)
    small = sorted((s for s in fis if len(s) <= 2), key=lambda s: (len(s), sorted(s)))
    queries = rules.pack_itemsets(small + [frozenset(), frozenset(range(N_ITEMS))], N_ITEMS)
    for part in chunks(queries):
        got_rows, got_supp = got_e.supersets(part, proper=proper)
        want_rows, want_supp = want_e.supersets(part, proper=proper)
        assert got_rows.dtype == got_supp.dtype == np.int32
        np.testing.assert_array_equal(got_rows, want_rows)
        np.testing.assert_array_equal(got_supp, want_supp)


def _table(ref_mod, ants, cons, conf, n_items=8):
    R = len(ants)
    return ref_mod.RuleTable(
        antecedents=ref_mod.pack_itemsets(ants, n_items),
        consequents=ref_mod.pack_itemsets(cons, n_items),
        supports=np.arange(R, 0, -1, dtype=np.int32) + 10,
        confidence=np.asarray(conf, np.float32),
        lift=np.ones(R, np.float32), leverage=np.zeros(R, np.float32),
        n_items=n_items, n_tx=100)


def test_float32_score_ties_rank_by_row_as_reference():
    """Confidences 0.75 + 2⁻²³, 0.75 + 2⁻²⁴ and 0.75 differ in float32, but
    their scores 2.75 + … round to one value (its step is 2⁻²²): the tie goes
    to the lower row, and the confidence returned is the score's, 0.75."""
    conf = [0.75 + 2**-23, 0.75 + 2**-24, 0.75, 0.75, 0.5]
    assert len(set(np.float32(conf).tolist())) == 4
    assert len(set((np.float32(conf[:4]) + np.float32(2.0)).tolist())) == 1
    ants = [frozenset({i}) for i in (3, 2, 1, 0, 4)]
    cons = [frozenset({5})] * 5
    ref_rl = ref_index.RuleIndex.from_table(_table(ref_rules, ants, cons, conf))
    fi = ref_index.FIIndex.from_fi_dict({frozenset({i}): 10 for i in range(8)}, 8, 100)
    got_fi, got_rl = carry(fi, ref_rl)
    basket = rules.pack_itemsets([frozenset({0, 1, 2, 3, 4}), frozenset({1, 3}),
                                  frozenset({6})], 8)
    for k in (2, 5, 7):   # 7 > R: padded with -1 / NaN
        want = ref_engine.QueryEngine(fi, ref_rl, batch=4, top_k=k)
        want_rows, want_conf = want.rules_for(basket)
        got_rows, got_conf = QueryEngine(got_fi, got_rl, batch=4, top_k=k).rules_for(basket)
        np.testing.assert_array_equal(got_rows, want_rows)
        assert_conf_equal(got_conf, want_conf)
    np.testing.assert_array_equal(got_rows[0], [0, 1, 2, 3, 4, -1, -1])
    np.testing.assert_array_equal(got_conf[0][:4], np.float32(0.75))
    np.testing.assert_array_equal(got_rows[1], [0, 2, -1, -1, -1, -1, -1])
    assert (got_rows[2] == -1).all() and np.isnan(got_conf[2]).all()


def test_superset_ties_break_on_miss_then_row_and_k_past_the_columns():
    fis = {frozenset({0}): 9, frozenset({1}): 7, frozenset({0, 1}): 7, frozenset({0, 2}): 7,
           frozenset({0, 1, 2}): 7}
    ref_fi = ref_index.FIIndex.from_fi_dict(fis, 8, 10)
    fi, _ = carry(ref_fi, None)
    queries = rules.pack_itemsets([frozenset({0}), frozenset(), frozenset({5})], 8)
    for k, proper in ((3, False), (4, True), (9, False), (9, True)):
        want = ref_engine.QueryEngine(ref_fi, None, batch=4, top_k=k).supersets(queries,
                                                                              proper=proper)
        got = QueryEngine(fi, None, batch=4, top_k=k).supersets(queries, proper=proper)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # proper supersets of {0}, all of support 7: fewest missing items, then row
    np.testing.assert_array_equal(got[0][0][:5], [2, 3, 4, -1, -1])


def test_zero_rules_and_zero_itemsets_never_match_the_pad_row():
    empty_fi = ref_index.FIIndex.from_fi_dict({}, 8, 10)
    empty_rl = ref_index.RuleIndex.from_table(ref_rules.RuleTable.from_rules([], 8, 10))
    fi, rl = carry(empty_fi, empty_rl)
    assert fi.n_fis == 0 and rl.n_rules == 0 and fi.masks.shape == (1, 1)
    queries = rules.pack_itemsets([frozenset(), frozenset({1, 2})], 8)
    want_e = ref_engine.QueryEngine(empty_fi, empty_rl, batch=4, top_k=3)
    got_e = QueryEngine(fi, rl, batch=4, top_k=3)
    np.testing.assert_array_equal(got_e.support(queries), want_e.support(queries))
    np.testing.assert_array_equal(got_e.support(queries), [-1, -1])
    for novel_only in (True, False):
        got_rows, got_conf = got_e.rules_for(queries, novel_only=novel_only)
        want_rows, want_conf = want_e.rules_for(queries, novel_only=novel_only)
        np.testing.assert_array_equal(got_rows, want_rows)
        assert_conf_equal(got_conf, want_conf)
        assert (got_rows == -1).all()
    got = got_e.supersets(queries)
    np.testing.assert_array_equal(got[0], want_e.supersets(queries)[0])
    assert (got[0] == -1).all() and (got[1] == -1).all()


def test_swap_bumps_generation_and_clears_the_cache(served):
    _, fis, ref_fi, ref_rl, fi, rl = served
    cache = QueryCache(capacity=8)
    eng = QueryEngine(fi, rl, batch=BATCH, cache=cache)
    ref_c = ref_cache.QueryCache(capacity=8)
    ref_e = ref_engine.QueryEngine(ref_fi, ref_rl, batch=BATCH, cache=ref_c)
    mask = rules.pack_itemsets([sorted(fis)[0]], N_ITEMS)[0]
    for c, e in ((cache, eng), (ref_c, ref_e)):
        key = query_key("support", mask, e.top_k, e.generation)
        c.put(key, int(e.support(mask[None])[0]))
        assert c.get(key) is not None
    smaller = {s: v for s, v in fis.items() if len(s) <= 1}
    new_fi, new_rl = build_indexes(smaller, N_ITEMS, N_TX, device="cpu")
    ref_new = ref_index.build_indexes(smaller, N_ITEMS, N_TX)
    assert eng.swap_indexes(new_fi, new_rl) == ref_e.swap_indexes(*ref_new) == 1
    assert len(cache) == len(ref_c) == 0
    assert eng.stats() == ref_e.stats()
    snap = eng.snapshot()
    eng.swap_indexes(fi, rl)
    assert snap.generation == 1 and eng.generation == 2 and snap.index is new_fi
    with pytest.raises(ValueError):
        eng.swap_indexes(FIIndex.from_fi_dict({}, N_ITEMS + 1, N_TX, device="cpu"))


def test_cache_keys_equal_the_reference_and_keep_the_bits():
    row = rules.pack_itemsets([frozenset({0, 31, 40})], 64)[0]
    assert row.dtype == np.uint32 and row[0] >= 2**31
    want = ref_cache.query_key("rules", row, 5, 3)
    assert query_key("rules", row, 5, 3) == want
    assert query_key("rules", rules.int32_words(row), 5, 3) == want
    assert query_key("rules", row, 5, 4) != want and query_key("support", row, 5, 3) != want
