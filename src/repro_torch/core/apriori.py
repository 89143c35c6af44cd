"""Candidate support counting (the Apriori counting step, §B.1).

Only ``count_supports`` is ported: Phase 4 uses it for the ancestor side
channel (supports of every class prefix on each miner's own partition).
"""
from __future__ import annotations

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
