"""Apriori (§B.1) and the Count-Distribution parallel baseline (Alg. 2, §5.2.1).

The thesis compares its method against Apriori-family parallel algorithms.
Level-wise BFS: candidate generation and pruning are host control plane
(each level is a barrier, as in the original); support counting runs on the
device over packed bitmaps, chunked to bound memory.  Level 1 is one
single-prefix sweep (kernel B3 on the card).

Count Distribution (Alg. 2): every miner counts all candidates on its own
shard and the counts are all-reduced, here through ``LocalCollectives.psum``
over the P stacked miners.  Phase 4 uses :func:`count_supports` for the
ancestor side channel too.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Tuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm


def count_supports(
    item_bits: torch.Tensor,   # int32[I, W]
    cand_masks: torch.Tensor,  # bool [N, I]
    valid_tid: torch.Tensor,   # int32[W]
    chunk: int = 64,
) -> torch.Tensor:
    """Supports of N candidate itemsets (int32[N]), chunked over candidates.

    ``tid(U) = AND_{i∈U} bits_i`` masked to the valid transactions; a chunk
    keeps the working set at ``[chunk, I, W]`` words.
    """
    out = []
    for c in cand_masks.split(chunk):
        rows = torch.where(c[:, :, None], item_bits[None, :, :], bm.ALL_ONES)
        tid = bm.and_reduce(rows, 1) & valid_tid[None, :]
        out.append(bm.popcount(tid).sum(dim=-1, dtype=torch.int32))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=item_bits.device)
    return torch.cat(out)


def generate_candidates(frequent: List[FrozenSet[int]]) -> List[FrozenSet[int]]:
    """Generate-Candidates (Alg. 24): join F_{k-1} pairs sharing a
    (k-2)-prefix, prune candidates with an infrequent (k-1)-subset."""
    fset = set(frequent)
    if not frequent:
        return []
    k = len(next(iter(frequent)))
    by_prefix: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
    for f in frequent:
        t = tuple(sorted(f))
        by_prefix.setdefault(t[:-1], []).append(t)
    cands = set()
    for group in by_prefix.values():
        group = sorted(group)
        for a in range(len(group)):
            for b in range(a + 1, len(group)):
                u = frozenset(group[a]) | frozenset(group[b])
                if len(u) != k + 1:
                    continue
                if all(u - {x} in fset for x in u):
                    cands.add(u)
    return sorted(cands, key=lambda s: tuple(sorted(s)))


def apriori(db: bm.BitmapDB, min_support: int) -> Dict[FrozenSet[int], int]:
    """Sequential Apriori (Alg. 25) over a BitmapDB: a host loop over levels."""
    I = db.n_items
    valid = db.all_tids()
    out: Dict[FrozenSet[int], int] = {}
    supp1 = bm.extension_supports(db.item_bits, valid).cpu().numpy()   # kernel B3
    frequent = [frozenset([i]) for i in range(I) if supp1[i] >= min_support]
    for f in frequent:
        out[f] = int(supp1[next(iter(f))])
    while frequent:
        cands = generate_candidates(frequent)
        if not cands:
            break
        masks = np.zeros((len(cands), I), dtype=bool)
        for r, c in enumerate(cands):
            masks[r, list(c)] = True
        supports = count_supports(
            db.item_bits, torch.from_numpy(masks).to(db.item_bits.device), valid
        ).cpu().numpy()
        frequent = []
        for c, s in zip(cands, supports):
            if s >= min_support:
                out[c] = int(s)
                frequent.append(c)
    return out


def count_distribution_supports(
    local_item_bits: torch.Tensor,   # int32[P, I, W] — each miner's D_p, vertical
    cand_masks: torch.Tensor,        # bool [N, I]
    local_valid_tid: torch.Tensor,   # int32[P, W]
    *,
    coll,
) -> torch.Tensor:
    """One Count-Distribution level: each miner counts the candidates on its
    own shard, then the all-reduce (Alg. 2 line 10) through ``coll.psum``.
    Returns the global supports ``int32[N]``."""
    local = torch.stack([
        count_supports(local_item_bits[p], cand_masks, local_valid_tid[p])
        for p in range(local_item_bits.shape[0])
    ])
    return coll.psum(local).to(torch.int32)
