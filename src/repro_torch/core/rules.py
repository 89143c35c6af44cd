"""Association-rule generation over a mined FI table (ap-genrules).

The thesis' motivating scenario is a store owner asking "which goods are
bought together in ≥ p% of baskets" — a *query* against the mined result.
Association rules X → Y (X, Y disjoint, X ∪ Y frequent) are the canonical
consumer of a frequent-itemset table (Agrawal & Srikant '94, and the survey
framing of arXiv:1402.1814): mining runs once, rule generation and serving
run many times.

The port's own copy of the JAX package's ``core/rules.py``, with the same
behaviour: this module is the host-side half of the serving subsystem
(:mod:`repro_torch.serve`):

  * :func:`generate_rules` — the ap-genrules recursion.  For each frequent Z
    it grows *consequents* level-wise with an apriori join, pruning on
    confidence: conf(Z∖h → h) is antitone in h (shrinking the antecedent can
    only lower confidence), so a consequent that fails min-confidence never
    has a superset that passes.  Exact — verified against the brute-force
    enumeration below.
  * metrics per rule: confidence, lift, leverage (support is that of X ∪ Y).
  * :class:`RuleTable` — the rules packed into uint32 itemset masks + metric
    vectors, sorted by (confidence, support) descending: the array form the
    device-resident query engine (:mod:`repro_torch.serve.engine`) consumes;
    :func:`int32_words` gives the same bits as the port's int32 device words.
  * :func:`brute_force_rules` — exponential all-splits oracle for tests.

Supports are absolute transaction counts throughout (as in `core/eclat.py`);
relative forms divide by ``n_tx`` at the metric boundary only.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple

import numpy as np

Itemset = FrozenSet[int]


@dataclasses.dataclass(frozen=True)
class Rule:
    """An association rule X → Y with its interestingness metrics.

    Attributes:
      antecedent: X (non-empty, disjoint from Y).
      consequent: Y (non-empty).
      support:    absolute support of X ∪ Y.
      confidence: supp(X∪Y) / supp(X)           — P(Y | X).
      lift:       conf / (supp(Y)/n)            — independence ratio.
      leverage:   supp(X∪Y)/n − supp(X)·supp(Y)/n²   — additive form.
    """

    antecedent: Itemset
    consequent: Itemset
    support: int
    confidence: float
    lift: float
    leverage: float

    def key(self) -> Tuple[Itemset, Itemset]:
        return (self.antecedent, self.consequent)


def _metrics(
    supp_z: int, supp_x: int, supp_y: int, n_tx: int
) -> Tuple[float, float, float]:
    conf = supp_z / supp_x
    lift = conf * n_tx / supp_y
    leverage = supp_z / n_tx - (supp_x / n_tx) * (supp_y / n_tx)
    return conf, lift, leverage


def _apriori_gen(consequents: List[Itemset]) -> List[Itemset]:
    """Level-wise candidate join over consequents (Apriori-gen, Alg. 1).

    Join pairs sharing all but their largest item, then prune candidates
    with an m-subset not in the previous level.
    """
    prev = set(consequents)
    seqs = sorted(tuple(sorted(h)) for h in consequents)
    out: List[Itemset] = []
    for a, b in itertools.combinations(seqs, 2):
        if a[:-1] != b[:-1]:
            continue
        cand = frozenset(a + b[-1:])
        if all(cand - {i} in prev for i in cand):
            out.append(cand)
    return out


def generate_rules(
    fis: Dict[Itemset, int],
    n_tx: int,
    min_confidence: float = 0.5,
) -> List[Rule]:
    """All rules X → Y with conf ≥ ``min_confidence`` from an FI table.

    ``fis`` must be downward closed (every subset of a frequent itemset
    present) — true of any complete mining result, e.g. ``fimi.run(...,
    materialize=True).fi_dict`` or ``eclat.brute_force_fis``.
    """
    rules: List[Rule] = []

    def emit(z: Itemset, supp_z: int, h: Itemset) -> bool:
        x = z - h
        supp_x = fis[x]
        conf = supp_z / supp_x
        if conf < min_confidence:
            return False
        _, lift, lev = _metrics(supp_z, supp_x, fis[h], n_tx)
        rules.append(Rule(x, h, supp_z, conf, lift, lev))
        return True

    for z, supp_z in fis.items():
        if len(z) < 2:
            continue
        # level 1: single-item consequents
        level = [h for i in z if emit(z, supp_z, h := frozenset([i]))]
        # ap-genrules: join surviving consequents level-wise
        while level and len(level[0]) + 1 < len(z):
            level = [h for h in _apriori_gen(level) if emit(z, supp_z, h)]
    return rules


def brute_force_rules(
    fis: Dict[Itemset, int], n_tx: int, min_confidence: float = 0.5
) -> Dict[Tuple[Itemset, Itemset], Rule]:
    """Oracle: every (X, Z∖X) split of every frequent Z, filtered on conf."""
    out: Dict[Tuple[Itemset, Itemset], Rule] = {}
    for z, supp_z in fis.items():
        if len(z) < 2:
            continue
        items = sorted(z)
        for r in range(1, len(items)):
            for ysel in itertools.combinations(items, r):
                y = frozenset(ysel)
                x = z - y
                conf, lift, lev = _metrics(supp_z, fis[x], fis[y], n_tx)
                if conf >= min_confidence:
                    out[(x, y)] = Rule(x, y, supp_z, conf, lift, lev)
    return out


# ---------------------------------------------------------------------------
# Packed array form for the serving engine
# ---------------------------------------------------------------------------


def pack_itemsets(sets: Sequence[Iterable[int]], n_items: int) -> np.ndarray:
    """Pack itemsets into little-endian uint32 masks ``[N, n_words]`` (host).

    Same layout as ``core.bitmap.pack_bool`` — bit ``i % 32`` of word
    ``i // 32`` — on the host.  The words are the reference's uint32, so
    cache keys and masks equal the JAX package's; :func:`int32_words` views
    them as the port's device words.
    """
    W = (n_items + 31) // 32
    out = np.zeros((len(sets), W), np.uint32)
    for r, s in enumerate(sets):
        for i in s:
            out[r, i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return out


def int32_words(packed: np.ndarray) -> np.ndarray:
    """Packed words as int32 with the same bits (a view where it can be).

    The port's device words are int32, since torch's uint32 lacks ``~``,
    shifts and ``+`` on the CPU; ``torch.from_numpy`` of the result is the
    device-side mask.  Values are cast to uint32 first, wrapping as C does,
    so int32 input passes through unchanged.
    """
    return np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)


@dataclasses.dataclass(frozen=True)
class RuleTable:
    """Rules as parallel arrays, sorted by (confidence, support) descending.

    The immutable host-side artifact :class:`repro_torch.serve.index.RuleIndex` puts on
    device.  ``antecedents``/``consequents`` are packed uint32 masks
    ``[R, n_words(n_items)]``; metric vectors are ``[R]``.
    """

    antecedents: np.ndarray
    consequents: np.ndarray
    supports: np.ndarray
    confidence: np.ndarray
    lift: np.ndarray
    leverage: np.ndarray
    n_items: int
    n_tx: int

    @property
    def n_rules(self) -> int:
        return int(self.antecedents.shape[0])

    @classmethod
    def from_rules(cls, rules: List[Rule], n_items: int, n_tx: int) -> "RuleTable":
        order = sorted(
            range(len(rules)),
            key=lambda r: (
                -rules[r].confidence,
                -rules[r].support,
                tuple(sorted(rules[r].antecedent)),
                tuple(sorted(rules[r].consequent)),
            ),
        )
        rs = [rules[r] for r in order]
        return cls(
            antecedents=pack_itemsets([r.antecedent for r in rs], n_items),
            consequents=pack_itemsets([r.consequent for r in rs], n_items),
            supports=np.asarray([r.support for r in rs], np.int32),
            confidence=np.asarray([r.confidence for r in rs], np.float32),
            lift=np.asarray([r.lift for r in rs], np.float32),
            leverage=np.asarray([r.leverage for r in rs], np.float32),
            n_items=n_items,
            n_tx=n_tx,
        )

    def rule(self, r: int) -> Rule:
        """Unpack row ``r`` back into a :class:`Rule` (debug/printing)."""
        ant = _unpack_row(self.antecedents[r], self.n_items)
        con = _unpack_row(self.consequents[r], self.n_items)
        return Rule(
            ant, con, int(self.supports[r]), float(self.confidence[r]),
            float(self.lift[r]), float(self.leverage[r]),
        )


def _unpack_row(words: np.ndarray, n_items: int) -> Itemset:
    items = [
        i for i in range(n_items)
        if (int(words[i // 32]) >> (i % 32)) & 1
    ]
    return frozenset(items)


def format_rule(r: Rule, n_tx: int) -> str:
    ant = ",".join(map(str, sorted(r.antecedent)))
    con = ",".join(map(str, sorted(r.consequent)))
    return (
        f"{{{ant}}} -> {{{con}}}  supp={r.support} ({r.support / n_tx:.1%})"
        f"  conf={r.confidence:.2f}  lift={r.lift:.2f}  lev={r.leverage:+.4f}"
    )


def top_rules(rules: List[Rule], k: int = 5) -> List[Rule]:
    """The k most confident rules (support breaks ties) — printing helper."""
    return sorted(
        rules, key=lambda r: (-r.confidence, -r.support,
                              tuple(sorted(r.antecedent)))
    )[:k]
