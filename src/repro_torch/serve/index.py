"""Immutable device-resident indexes over a mined FI table.

The port of the JAX package's ``serve/index.py``.  Both structures are frozen
dataclasses of dense tensors on one device (the card unless the caller names
the CPU), so a query batch is pure vector work against them:

  * :class:`FIIndex` — the F frequent itemsets as packed int32 masks
    ``[F, IW]`` (the reference's uint32 bits, see ``core/bitmap.py``) plus a
    support vector, a per-itemset size vector, and **per-size offsets**: rows
    are sorted by (|itemset|, lexicographic), so all size-s itemsets form the
    contiguous band ``[size_offsets[s], size_offsets[s+1])``.
  * :class:`RuleIndex` — a :class:`repro_torch.core.rules.RuleTable` on the
    device, antecedent and consequent masks stacked into ONE ``[2R, IW]``
    slab so a basket query answers "which antecedents apply" and "which
    consequents are already owned" from a single sweep of kernel B4.

Row counts F and R are python ints; tensors are padded to at least one row,
as in the reference, and padded rows are excluded through the count
(``valid()``), never by a device-side sentinel scan.

``from_reference`` / ``to_reference`` carry an index across packages: they
take and give the reference dataclass's fields by name, arrays as numpy
(masks as uint32), so a test builds one index in JAX and asks both engines.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import bitmap as bm
from repro_torch.core import rules as rules_mod


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 up to ``n`` rows with zeros (no-op if already there)."""
    if a.shape[0] >= n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; uint32 words become int32 with the same bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = rules_mod.int32_words(a)
    return torch.from_numpy(np.array(a)).to(dev)


def _host(t: torch.Tensor, words: bool = False) -> np.ndarray:
    """A tensor on the host; with ``words``, int32 words as uint32."""
    return bm.to_reference(t) if words else t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class FIIndex:
    """The mined FI table as a queryable device structure.

    Attributes:
      masks:    ``int32[Fp, IW]`` packed itemset masks, sorted by
                (size, lexicographic); ``Fp = max(F, 1)``.
      supports: ``int32[Fp]`` absolute supports.
      sizes:    ``int32[Fp]`` itemset cardinalities (|f|).
      n_fis:    F — number of valid rows.
      n_items:  |B|.
      n_tx:     |D| — denominator for relative support.
      size_offsets: size-s rows live at
                ``[size_offsets[s], size_offsets[s+1])``, s ∈ [0, max_size].
    """

    masks: torch.Tensor
    supports: torch.Tensor
    sizes: torch.Tensor
    n_fis: int
    n_items: int
    n_tx: int
    size_offsets: Tuple[int, ...]

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_fi_dict(
        cls, fis: Dict[frozenset, int], n_items: int, n_tx: int, device=None
    ) -> "FIIndex":
        """Build from a materialized ``{frozenset: support}`` table on
        ``device`` (CUDA unless the caller names another)."""
        dev = device_mod.resolve(device)
        order = sorted(fis, key=lambda s: (len(s), tuple(sorted(s))))
        F = len(order)
        masks = rules_mod.pack_itemsets(order, n_items)
        supports = np.asarray([fis[s] for s in order], np.int32)
        sizes = np.asarray([len(s) for s in order], np.int32)
        max_size = int(sizes.max()) if F else 0
        offsets = tuple(
            int(np.searchsorted(sizes, s)) for s in range(max_size + 1)
        ) + (F,)
        return cls(
            masks=_tensor(_pad_rows(masks, 1), dev),
            supports=_tensor(_pad_rows(supports, 1), dev),
            sizes=_tensor(_pad_rows(sizes, 1), dev),
            n_fis=F,
            n_items=n_items,
            n_tx=n_tx,
            size_offsets=offsets,
        )

    @classmethod
    def from_reference(
        cls, *, masks, supports, sizes, n_fis, n_items, n_tx, size_offsets, device=None
    ) -> "FIIndex":
        """The reference ``FIIndex``'s fields (arrays as numpy, masks uint32)
        on ``device``."""
        dev = device_mod.resolve(device)
        return cls(
            masks=_tensor(masks, dev),
            supports=_tensor(np.asarray(supports, np.int32), dev),
            sizes=_tensor(np.asarray(sizes, np.int32), dev),
            n_fis=int(n_fis),
            n_items=int(n_items),
            n_tx=int(n_tx),
            size_offsets=tuple(int(o) for o in size_offsets),
        )

    def to_reference(self) -> dict:
        """The reference ``FIIndex``'s fields: arrays as numpy, masks uint32."""
        return dict(
            masks=_host(self.masks, words=True),
            supports=_host(self.supports),
            sizes=_host(self.sizes),
            n_fis=self.n_fis,
            n_items=self.n_items,
            n_tx=self.n_tx,
            size_offsets=self.size_offsets,
        )

    def to(self, device) -> "FIIndex":
        """The same index on another device."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, masks=self.masks.to(dev), supports=self.supports.to(dev),
            sizes=self.sizes.to(dev),
        )

    # -- views ----------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.masks.device

    @property
    def n_words(self) -> int:
        return int(self.masks.shape[-1])

    @property
    def max_size(self) -> int:
        return len(self.size_offsets) - 2

    def valid(self) -> torch.Tensor:
        """bool[Fp] — True for real rows, False for shape padding."""
        return torch.arange(self.masks.shape[0], device=self.device) < self.n_fis

    def size_band(self, s: int) -> Tuple[int, int]:
        """Row range [lo, hi) of size-s itemsets (empty if s out of range)."""
        if s < 0 or s > self.max_size:
            return (0, 0)
        return (self.size_offsets[s], self.size_offsets[s + 1])

    def itemset(self, row: int) -> frozenset:
        """Unpack row back to a python itemset (debug/printing)."""
        return rules_mod._unpack_row(_host(self.masks[row], words=True), self.n_items)


@dataclasses.dataclass(frozen=True)
class RuleIndex:
    """A :class:`~repro_torch.core.rules.RuleTable` as device tensors.

    ``ant_con`` stacks antecedent masks (rows ``[0, R)``) and consequent
    masks (rows ``[R, 2R)``) so the engine's basket query computes
    applicability and novelty with one ``[Q, 2R]`` sweep.  Rows are sorted
    by (confidence, support) descending — ties aside, row order IS rule
    rank.
    """

    ant_con: torch.Tensor      # int32[2·Rp, IW]
    supports: torch.Tensor     # int32[Rp]
    confidence: torch.Tensor   # float32[Rp]
    lift: torch.Tensor         # float32[Rp]
    leverage: torch.Tensor     # float32[Rp]
    n_rules: int
    n_items: int
    n_tx: int

    @classmethod
    def from_table(cls, table: rules_mod.RuleTable, device=None) -> "RuleIndex":
        """The table on ``device`` (CUDA unless the caller names another)."""
        dev = device_mod.resolve(device)
        Rp = max(table.n_rules, 1)
        ant = _pad_rows(table.antecedents, Rp)
        con = _pad_rows(table.consequents, Rp)
        return cls(
            ant_con=_tensor(np.concatenate([ant, con], axis=0), dev),
            supports=_tensor(_pad_rows(table.supports, Rp), dev),
            confidence=_tensor(_pad_rows(table.confidence, Rp), dev),
            lift=_tensor(_pad_rows(table.lift, Rp), dev),
            leverage=_tensor(_pad_rows(table.leverage, Rp), dev),
            n_rules=table.n_rules,
            n_items=table.n_items,
            n_tx=table.n_tx,
        )

    @classmethod
    def from_reference(
        cls, *, ant_con, supports, confidence, lift, leverage, n_rules, n_items, n_tx,
        device=None,
    ) -> "RuleIndex":
        """The reference ``RuleIndex``'s fields (arrays as numpy, masks
        uint32) on ``device``."""
        dev = device_mod.resolve(device)
        return cls(
            ant_con=_tensor(ant_con, dev),
            supports=_tensor(np.asarray(supports, np.int32), dev),
            confidence=_tensor(np.asarray(confidence, np.float32), dev),
            lift=_tensor(np.asarray(lift, np.float32), dev),
            leverage=_tensor(np.asarray(leverage, np.float32), dev),
            n_rules=int(n_rules),
            n_items=int(n_items),
            n_tx=int(n_tx),
        )

    def to_reference(self) -> dict:
        """The reference ``RuleIndex``'s fields: arrays as numpy, masks uint32."""
        return dict(
            ant_con=_host(self.ant_con, words=True),
            supports=_host(self.supports),
            confidence=_host(self.confidence),
            lift=_host(self.lift),
            leverage=_host(self.leverage),
            n_rules=self.n_rules,
            n_items=self.n_items,
            n_tx=self.n_tx,
        )

    def to(self, device) -> "RuleIndex":
        """The same index on another device."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, ant_con=self.ant_con.to(dev), supports=self.supports.to(dev),
            confidence=self.confidence.to(dev), lift=self.lift.to(dev),
            leverage=self.leverage.to(dev),
        )

    # -- views ----------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.ant_con.device

    @property
    def r_pad(self) -> int:
        """Padded row count Rp (``ant_con`` holds 2·Rp rows)."""
        return int(self.ant_con.shape[0]) // 2

    def valid(self) -> torch.Tensor:
        return torch.arange(self.r_pad, device=self.device) < self.n_rules

    def antecedents(self) -> torch.Tensor:
        return self.ant_con[: self.r_pad]

    def consequents(self) -> torch.Tensor:
        return self.ant_con[self.r_pad:]

    def rule(self, row: int) -> rules_mod.Rule:
        """Unpack rule ``row`` for printing (host round-trip)."""
        return rules_mod.Rule(
            rules_mod._unpack_row(_host(self.antecedents()[row], words=True), self.n_items),
            rules_mod._unpack_row(_host(self.consequents()[row], words=True), self.n_items),
            int(self.supports[row]),
            float(self.confidence[row]),
            float(self.lift[row]),
            float(self.leverage[row]),
        )


def build_indexes(
    fis: Dict[frozenset, int],
    n_items: int,
    n_tx: int,
    min_confidence: float = 0.5,
    device=None,
) -> Tuple[FIIndex, RuleIndex]:
    """One-call build: FI index + rules (ap-genrules) + rule index, on
    ``device`` (CUDA unless the caller names another)."""
    dev = device_mod.resolve(device)
    fi_index = FIIndex.from_fi_dict(fis, n_items, n_tx, dev)
    rl = rules_mod.generate_rules(fis, n_tx, min_confidence)
    table = rules_mod.RuleTable.from_rules(rl, n_items, n_tx)
    return fi_index, RuleIndex.from_table(table, dev)
