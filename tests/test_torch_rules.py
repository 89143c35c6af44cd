"""The port's copy of ``core/rules.py`` against the JAX package's.

On one FITable, ``generate_rules`` gives the reference's rules in the
reference's order, and ``RuleTable`` the reference's packed masks, supports
and float32 metrics, compared bit for bit; both agree with
``brute_force_rules``.  The packed words keep their bits between the
reference's uint32 and the port's int32.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import eclat as ref_eclat
from repro.core import rules as ref_rules
from repro.data.ibm_gen import IBMParams, generate_dense
from repro_torch.core import bitmap as bm
from repro_torch.core import rules


@pytest.fixture(scope="module")
def table():
    dense = generate_dense(IBMParams(n_tx=400, n_items=40, n_patterns=8, avg_pattern_len=5,
                                     avg_tx_len=9, seed=2))
    fis = ref_eclat.brute_force_fis(dense, int(np.ceil(0.06 * 400)))
    return fis, 400, 40


@pytest.mark.parametrize("min_conf", [0.3, 0.6, 0.9])
def test_generate_rules_equals_reference(table, min_conf):
    fis, n_tx, _ = table
    got = rules.generate_rules(fis, n_tx, min_conf)
    want = ref_rules.generate_rules(fis, n_tx, min_conf)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.antecedent, a.consequent, a.support) == (b.antecedent, b.consequent, b.support)
        assert (a.confidence, a.lift, a.leverage) == (b.confidence, b.lift, b.leverage)
    # and both are the brute-force enumeration
    brute = rules.brute_force_rules(fis, n_tx, min_conf)
    assert {r.key() for r in got} == set(brute)
    assert set(brute) == set(ref_rules.brute_force_rules(fis, n_tx, min_conf))


def test_rule_table_equals_reference_bit_for_bit(table):
    fis, n_tx, n_items = table
    got = rules.RuleTable.from_rules(rules.generate_rules(fis, n_tx, 0.5), n_items, n_tx)
    want = ref_rules.RuleTable.from_rules(ref_rules.generate_rules(fis, n_tx, 0.5), n_items,
                                          n_tx)
    assert got.n_rules == want.n_rules > 100
    for name in ("antecedents", "consequents", "supports", "confidence", "lift", "leverage"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        # float32 metrics compared as their bits
        np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                                      b.view(np.uint32) if b.dtype == np.float32 else b)
    for r in (0, got.n_rules // 2, got.n_rules - 1):
        assert dataclasses.astuple(got.rule(r)) == dataclasses.astuple(want.rule(r))
        assert rules.format_rule(got.rule(r), n_tx) == ref_rules.format_rule(want.rule(r), n_tx)
    top = rules.top_rules(rules.generate_rules(fis, n_tx), 7)
    ref_top = ref_rules.top_rules(ref_rules.generate_rules(fis, n_tx), 7)
    assert [dataclasses.astuple(r) for r in top] == [dataclasses.astuple(r) for r in ref_top]


def test_generate_rules_empty_and_singletons():
    assert rules.generate_rules({}, 10) == []
    assert rules.generate_rules({frozenset([1]): 3, frozenset([2]): 4}, 10) == []


def test_pack_itemsets_and_int32_words_keep_the_bits():
    sets = [frozenset(), frozenset({0}), frozenset({31}), frozenset({0, 31, 32, 63, 99})]
    packed = rules.pack_itemsets(sets, 100)
    np.testing.assert_array_equal(packed, ref_rules.pack_itemsets(sets, 100))
    assert packed.dtype == np.uint32 and packed.shape == (4, 4)
    words = rules.int32_words(packed)
    assert words.dtype == np.int32 and words[2, 0] < 0          # bit 31: the sign
    np.testing.assert_array_equal(words.view(np.uint32), packed)
    np.testing.assert_array_equal(rules.int32_words(words), words)
    # the device words unpack to the same items
    unpacked = bm.unpack_bool(torch.from_numpy(words), 100).numpy()
    assert [frozenset(np.nonzero(row)[0].tolist()) for row in unpacked] == sets
