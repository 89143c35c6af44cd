"""Batched query engine over the FI/rule indexes.

The port of the JAX package's ``serve/engine.py``.  It answers Q queries per
dispatch with one ``[Q, F]`` subset/superset sweep (kernel B4,
``kernels/subset_query.py``) instead of Q per-query launches.  Three query
kinds, all over packed query masks ``[Q, IW]``:

  * :func:`support_lookup` — exact support of each queried itemset (-1 if
    not frequent): equality is ``miss == 0 & extra == 0`` plus a size match.
  * :func:`top_rules_for_baskets` — top-K rules by confidence whose
    antecedent ⊆ basket; ``novel_only`` drops rules whose consequent is
    already fully in the basket.  One sweep over the stacked ``[2R, IW]``
    antecedent ∥ consequent slab answers both tests.
  * :func:`top_supersets` — top-K frequent supersets of an itemset, by
    support; ties prefer fewer missing items, then the lower row.

Results are (rows, values) pairs with row -1 ⇔ "no more hits".  The answers
equal the reference's, ties included: scores are computed in float32 as the
reference computes them, and every ranking is a stable sort, so equal keys
resolve by column as ``jax.lax.top_k`` and the stable ``jax.lax.sort`` do.

The sweep is dispatched by the index tensors' device (``kernels/ops.py``):
on the card it is kernel B4, on the CPU its plain version.  There is no
override.

:class:`QueryEngine` pads every dispatch to a fixed batch width Q and is the
streaming subsystem's swap point: the index pair lives in ONE reference
(``_state``) that :meth:`~QueryEngine.swap_indexes` replaces with a fully
built standby pair, bumping a ``generation`` counter and clearing the
attached query cache; a query reads one snapshot of the state, so it never
sees a torn FI/rule index.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rules as rules_mod
from repro_torch.kernels import ops
from repro_torch.kernels.bitmap_support import popcount
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.index import FIIndex, RuleIndex

NOT_FOUND = -1
_INT32_MAX = torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# Batched query primitives
# ---------------------------------------------------------------------------


def support_lookup(
    index: FIIndex,
    query_masks: torch.Tensor,      # int32[Q, IW]
    query_sizes: torch.Tensor,      # int32[Q] — |q| (popcount of the mask)
) -> torch.Tensor:
    """int32[Q] absolute supports; ``NOT_FOUND`` for non-frequent queries."""
    miss, extra = ops.subset_superset_counts(query_masks, index.masks)
    # the size check keeps the match honest on the all-zero pad row
    eq = (
        (miss == 0)
        & (extra == 0)
        & (index.sizes[None, :] == query_sizes[:, None])
        & index.valid()[None, :]
    )
    # the first matching row, as argmax of a bool matrix gives in the
    # reference; torch.argmax returns the first maximum, on an integer type
    row = eq.to(torch.uint8).argmax(dim=1)
    found = eq.any(dim=1)
    return torch.where(found, index.supports[row], NOT_FOUND).to(torch.int32)


def top_rules_for_baskets(
    rules: RuleIndex,
    basket_masks: torch.Tensor,     # int32[Q, IW]
    *,
    k: int = 5,
    novel_only: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rule_rows int32[Q, k], confidence float32[Q, k]); row -1 ⇔ no hit.

    A rule applies to basket q iff antecedent ⊆ q.  Ranking is by
    confidence with support as tie-break (the RuleIndex row order).
    """
    R = rules.r_pad
    miss, _ = ops.subset_superset_counts(basket_masks, rules.ant_con)
    applies = (miss[:, :R] == 0) & rules.valid()[None, :]
    if novel_only:
        applies &= miss[:, R:] > 0
    # rows are confidence-sorted, so rank by (applies, confidence): boosting
    # applicable rows by 2 (> max confidence 1) keeps relative order.  The
    # sum is float32, as in the reference, so two close confidences may tie.
    score = rules.confidence[None, :] + 2.0 * applies.to(torch.float32)
    top_score, top_row = _top_k_padded(score, k)
    hit = top_score >= 2.0
    return (
        torch.where(hit, top_row, NOT_FOUND).to(torch.int32),
        torch.where(hit, top_score - 2.0, torch.full_like(top_score, float("nan"))),
    )


def top_supersets(
    index: FIIndex,
    query_masks: torch.Tensor,      # int32[Q, IW]
    *,
    k: int = 5,
    proper: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fi_rows int32[Q, k], supports int32[Q, k]); row -1 ⇔ no hit.

    Frequent supersets of each query, by support descending; among equal
    supports, fewer missing items (|f ∖ q|) first — the closest completion
    wins.  ``proper`` excludes the queried itemset itself.
    """
    miss, extra = ops.subset_superset_counts(query_masks, index.masks)
    is_sup = (extra == 0) & index.valid()[None, :]
    if proper:
        is_sup &= miss > 0
    key_supp = torch.where(is_sup, -index.supports[None, :], _INT32_MAX)
    key_miss = torch.where(is_sup, miss, _INT32_MAX)
    top_key, top_row = _lex_smallest_k(key_supp, key_miss, k)
    hit = top_key != _INT32_MAX
    return (
        torch.where(hit, top_row, NOT_FOUND).to(torch.int32),
        torch.where(hit, -top_key, NOT_FOUND).to(torch.int32),
    )


def _top_k_padded(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores of each row and their columns, ties to the lower
    column (``jax.lax.top_k``'s order), for any k: columns past the end are
    -inf.  A stable descending sort gives that order; ``torch.topk`` on the
    card promises none for ties."""
    cols = score.shape[-1]
    if k > cols:
        pad = torch.full(score.shape[:-1] + (k - cols,), float("-inf"),
                         dtype=score.dtype, device=score.device)
        score = torch.cat([score, pad], dim=-1)
    values, rows = torch.sort(score, dim=-1, descending=True, stable=True)
    return values[..., :k], rows[..., :k]


def _lex_smallest_k(key1: torch.Tensor, key2: torch.Tensor, k: int):
    """Per row, the k columns with lexicographically smallest (key1, key2).

    Returns ``(key1 values, column indices)``, both ``[Q, k]``.  Both keys
    are int32 and key2 is never negative, so ``key1·2³² + key2`` orders as
    the pair does in int64; a stable sort of it resolves equal pairs by
    column, as the reference's stable two-key sort does.  ``k`` beyond the
    column count pads with int32 max / -1.
    """
    Q, F = key1.shape
    composite = key1.to(torch.int64) * (1 << 32) + key2.to(torch.int64)
    _, rows = torch.sort(composite, dim=-1, stable=True)
    s1 = torch.gather(key1, 1, rows)
    if k > F:
        s1 = torch.nn.functional.pad(s1, (0, k - F), value=_INT32_MAX)
        rows = torch.nn.functional.pad(rows, (0, k - F), value=NOT_FOUND)
    return s1[:, :k], rows[:, :k]


# ---------------------------------------------------------------------------
# Fixed-batch engine
# ---------------------------------------------------------------------------


class QueryEngine:
    """Serving facade with a fixed dispatch width and hot-swappable indexes.

    Every call pads its query rows to ``batch`` and slices real rows back
    out.  The queries go to the indexes' device.

    The FI/rule index pair and the swap ``generation`` live in a single
    tuple reference; each query method reads it ONCE, so a concurrent
    :meth:`swap_indexes` can never pair an old FIIndex with a new RuleIndex
    mid-query.  An optional ``cache`` (:class:`repro_torch.serve.cache.
    QueryCache`) attached here is cleared on every swap; cache keys should
    also include :attr:`generation` (see ``query_key``).
    """

    def __init__(
        self,
        index: FIIndex,
        rules: Optional[RuleIndex] = None,
        batch: int = 256,
        top_k: int = 5,
        cache=None,
    ):
        self._state: Tuple[FIIndex, Optional[RuleIndex], int] = (index, rules, 0)
        self.batch = batch
        self.top_k = top_k
        self.cache = cache

    # -- swappable state -------------------------------------------------------
    @property
    def index(self) -> FIIndex:
        return self._state[0]

    @property
    def rules(self) -> Optional[RuleIndex]:
        return self._state[1]

    @property
    def generation(self) -> int:
        """Number of completed index hot-swaps (0 = the launch indexes)."""
        return self._state[2]

    def swap_indexes(self, index: FIIndex, rules: Optional[RuleIndex] = None) -> int:
        """Atomically publish a fully built standby index pair.

        The caller builds the new indexes off to the side; this single
        reference assignment makes them live together.  Bumps and returns the
        generation counter and clears the attached cache.
        """
        if index.n_items != self.index.n_items:
            raise ValueError(
                f"item universe changed: {index.n_items} items, was {self.index.n_items}"
            )
        t0 = time.perf_counter()
        self._state = (index, rules, self._state[2] + 1)
        if self.cache is not None:
            self.cache.clear()
        reg = obs_metrics.registry()
        reg.counter("serve/swaps").inc()
        reg.histogram("serve/swap_ms").record((time.perf_counter() - t0) * 1e3)
        return self._state[2]

    def snapshot(self) -> "EngineSnapshot":
        """One coherent (index, rules, generation) view, frozen at call time,
        for a consumer that makes several calls that must see one state."""
        return EngineSnapshot(self, self._state)

    def stats(self) -> dict:
        index, rules, gen = self._state
        out = {
            "generation": gen,
            "n_fis": index.n_fis,
            "n_rules": rules.n_rules if rules is not None else 0,
        }
        if self.cache is not None:
            out.update(self.cache.stats.as_dict())
        return out

    def _observe(self, kind: str, n: int, t0: float) -> None:
        """One dispatched query batch → latency histogram + query counter."""
        reg = obs_metrics.registry()
        reg.counter("serve/queries").inc(n)
        reg.histogram(f"serve/{kind}_ms").record((time.perf_counter() - t0) * 1e3)

    def _pad(self, masks: np.ndarray, index: FIIndex) -> Tuple[torch.Tensor, int]:
        """Host masks (uint32 or int32 words) → int32 ``[batch, IW]`` on the
        indexes' device, and the count of real rows."""
        q = rules_mod.int32_words(masks)
        if q.ndim != 2 or q.shape[1] != index.n_words:
            raise ValueError(f"query masks of shape {q.shape}, want [n, {index.n_words}]")
        n = q.shape[0]
        if n > self.batch:
            raise ValueError(f"query batch {n} exceeds width {self.batch}")
        padded = np.zeros((self.batch, q.shape[1]), np.int32)
        padded[:n] = q
        return torch.from_numpy(padded).to(index.device), n

    # -- typed entry points (packed masks in, numpy out) ---------------------
    def support(self, masks: np.ndarray, *, _state=None) -> np.ndarray:
        """int32[n] supports (NOT_FOUND = not frequent / not indexed)."""
        index, _, _ = _state if _state is not None else self._state
        t0 = time.perf_counter()
        qp, n = self._pad(masks, index)
        sizes = popcount(qp).sum(dim=-1, dtype=torch.int32)
        out = support_lookup(index, qp, sizes)
        res = out.cpu().numpy()[:n]     # the copy to the host is the sync
        self._observe("support", n, t0)
        return res

    def rules_for(
        self, masks: np.ndarray, *, novel_only: bool = True, _state=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(rule rows [n, k], confidences [n, k]) for basket masks."""
        index, rules, _ = _state if _state is not None else self._state
        if rules is None:
            raise ValueError("engine built without a RuleIndex")
        t0 = time.perf_counter()
        qp, n = self._pad(masks, index)
        rows, conf = top_rules_for_baskets(rules, qp, k=self.top_k, novel_only=novel_only)
        out = rows.cpu().numpy()[:n], conf.cpu().numpy()[:n]
        self._observe("rules", n, t0)
        return out

    def supersets(
        self, masks: np.ndarray, *, proper: bool = False, _state=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(FI rows [n, k], supports [n, k]) for itemset masks."""
        index, _, _ = _state if _state is not None else self._state
        t0 = time.perf_counter()
        qp, n = self._pad(masks, index)
        rows, supp = top_supersets(index, qp, k=self.top_k, proper=proper)
        out = rows.cpu().numpy()[:n], supp.cpu().numpy()[:n]
        self._observe("supersets", n, t0)
        return out

    # -- convenience: python itemsets in --------------------------------------
    def pack(self, itemsets) -> np.ndarray:
        return rules_mod.pack_itemsets(list(itemsets), self.index.n_items)


class EngineSnapshot:
    """A :class:`QueryEngine` view pinned to one (index, rules, generation).

    Same typed entry points as the engine; every call resolves against the
    state captured by :meth:`QueryEngine.snapshot`, however many hot-swaps
    land meanwhile.
    """

    __slots__ = ("_engine", "_st")

    def __init__(self, engine: QueryEngine, state):
        self._engine = engine
        self._st = state

    @property
    def index(self) -> FIIndex:
        return self._st[0]

    @property
    def rules(self) -> Optional[RuleIndex]:
        return self._st[1]

    @property
    def generation(self) -> int:
        return self._st[2]

    @property
    def top_k(self) -> int:
        return self._engine.top_k

    def support(self, masks: np.ndarray) -> np.ndarray:
        return self._engine.support(masks, _state=self._st)

    def rules_for(self, masks: np.ndarray, *, novel_only: bool = True):
        return self._engine.rules_for(masks, novel_only=novel_only, _state=self._st)

    def supersets(self, masks: np.ndarray, *, proper: bool = False):
        return self._engine.supersets(masks, proper=proper, _state=self._st)
