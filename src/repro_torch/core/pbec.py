"""Prefix-based equivalence classes: membership, size estimation, Partition.

Thesis §2.4 (Defs 2.20/2.21, Props 2.22/2.23) and Phase 2 (Alg. 15/17).
A PBEC ``[U|Σ] = {U ∪ Y : ∅ ≠ Y ⊆ Σ}`` is a pair of bool masks
``(prefix, ext)``.  Partitioning is host-side control plane (numpy) over the
FI sample; the support counts it asks for come from the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm


@dataclasses.dataclass
class PBEC:
    prefix: np.ndarray       # bool [I]
    ext: np.ndarray          # bool [I]
    est_count: float         # |[U|Σ] ∩ F̃s| (absolute sample count)
    seq: Tuple[int, ...] = ()  # order in which prefix items were added (DFS path)

    @property
    def depth(self) -> int:
        return int(self.prefix.sum())


def member_mask(sample_masks: np.ndarray, prefix: np.ndarray, ext: np.ndarray) -> np.ndarray:
    """bool [N]: which sample itemsets lie in [prefix | ext]."""
    has_prefix = ~(prefix[None, :] & ~sample_masks).any(axis=1)
    inside = ~(sample_masks & ~(prefix | ext)[None, :]).any(axis=1)
    proper = (sample_masks & ~prefix[None, :]).any(axis=1)  # exclude W == U
    return has_prefix & inside & proper


def estimate_size(sample_masks: np.ndarray, prefix, ext) -> int:
    return int(member_mask(sample_masks, prefix, ext).sum())


def member_self(sample_masks: np.ndarray, prefix: np.ndarray) -> int:
    """# sample itemsets exactly equal to the prefix."""
    return int((sample_masks == prefix[None, :]).all(axis=1).sum())


SupportFn = Callable[[np.ndarray], np.ndarray]
# maps a prefix bool[I] -> supports of prefix ∪ {b} for all b, int[I]


def partition(
    sample_masks: np.ndarray,      # bool [N, I] — the F̃s sample
    n_processors: int,
    alpha: float,
    ext_supports: SupportFn,
    n_items: int,
    max_classes: int = 4096,
) -> List[PBEC]:
    """Alg. 17 (Phase-2-FI-Partitioning) + Alg. 15 (Partition).

    Starts from the 1-prefix classes, ordered by support ascending, and
    splits any class whose estimated size exceeds ``α·N/P``, ordering each
    split's extensions by support in D̃ ascending (stable).
    """
    N = max(len(sample_masks), 1)
    threshold = alpha * N / n_processors
    I = n_items

    root_supp = ext_supports(np.zeros(I, dtype=bool))
    order = np.argsort(root_supp, kind="stable")
    classes: List[PBEC] = []
    work: List[PBEC] = []
    for pos, b in enumerate(order):
        prefix = np.zeros(I, dtype=bool)
        prefix[b] = True
        ext = np.zeros(I, dtype=bool)
        ext[order[pos + 1:]] = True
        s = estimate_size(sample_masks, prefix, ext)
        s_with_self = s + int(member_self(sample_masks, prefix))
        work.append(PBEC(prefix, ext, s_with_self, seq=(int(b),)))

    while work:
        c = work.pop()
        if c.est_count <= threshold or not c.ext.any() or (
            len(classes) + len(work) >= max_classes
        ):
            classes.append(c)
            continue
        supp = ext_supports(c.prefix)
        ext_items = np.nonzero(c.ext)[0]
        ext_sorted = ext_items[np.argsort(supp[ext_items], kind="stable")]
        for pos, b in enumerate(ext_sorted):
            prefix = c.prefix.copy()
            prefix[b] = True
            ext = np.zeros(I, dtype=bool)
            ext[ext_sorted[pos + 1:]] = True
            s = estimate_size(sample_masks, prefix, ext)
            s += int(member_self(sample_masks, prefix))
            work.append(PBEC(prefix, ext, s, seq=c.seq + (int(b),)))
    return classes


def verify_disjoint_cover(
    classes: Sequence[PBEC], n_items: int, universe_masks: np.ndarray
) -> Tuple[bool, bool]:
    """Property check of a class table against ``universe_masks`` (bool
    [N, I], non-empty itemsets): ``(disjoint, covered)``.

    Disjoint: no itemset lies in two classes.  Covered: each lies in exactly
    one class, or is a prefix on some class' DFS path (those are counted by
    Phase 4's prefix side channel, Alg. 19 line 2, not by a class).
    """
    counts = np.zeros(len(universe_masks), dtype=np.int64)
    for c in classes:
        counts += member_mask(universe_masks, c.prefix, c.ext).astype(np.int64)
    closure = _prefix_closure([c.seq for c in classes])
    is_prefix = np.array(
        [frozenset(np.nonzero(m)[0].tolist()) in closure for m in universe_masks],
        dtype=bool,
    )
    disjoint = bool((counts <= 1).all())
    covered = bool(((counts == 1) | is_prefix).all())
    return disjoint, covered


def _prefix_closure(seqs):
    """All ancestors along each class' DFS path, as frozensets of items."""
    out = set()
    for seq in seqs:
        for k in range(1, len(seq) + 1):
            out.add(frozenset(seq[:k]))
    return out


def ancestor_closure(
    classes: Sequence[PBEC], n_items: int
) -> Tuple[np.ndarray, List[frozenset]]:
    """The prefix side-channel itemsets of a class table (Alg. 19 line 2).

    Every DFS-path prefix of every class, dedup'd and ordered by (size,
    lexicographic).  Returns ``(masks bool [A, I], list of frozensets)``
    with A ≥ 1 (a zero row pads the empty case).
    """
    anc_list = sorted(
        _prefix_closure([c.seq for c in classes]),
        key=lambda s: (len(s), tuple(sorted(s))),
    )
    A = max(len(anc_list), 1)
    masks = np.zeros((A, n_items), dtype=bool)
    for i, s in enumerate(anc_list):
        masks[i, sorted(s)] = True
    return masks, anc_list


def classes_to_packed(classes: Sequence[PBEC]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack class masks into packed int32 tensors [C, IW] (on the CPU)."""
    prefixes = torch.from_numpy(np.stack([c.prefix for c in classes]))
    exts = torch.from_numpy(np.stack([c.ext for c in classes]))
    return bm.pack_bool(prefixes), bm.pack_bool(exts)
