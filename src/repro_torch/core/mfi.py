"""DFS mining of candidates on maximal frequent itemsets (thesis Ch. 7), in
PyTorch.

The DFS-MFI-Schema (Alg. 10) on packed bitmaps: a frequent itemset is a
*candidate on an MFI* (Def. 7.1) iff none of its extensions is frequent.  Run
over a subset of the 1-prefix PBECs it gives a miner's set ``M_i``; the union
M satisfies ``M̃ ⊆ M ⊆ F̃`` with ``|M| ≤ min(P, |W|)·|M̃|`` (Thm. 7.5), the
Parallel-FIMI-Par Phase-1 object.  :func:`filter_maximal` recovers the exact
MFI set M̃ from a global candidate set (Parallel-FIMI-Seq Phase 1).

The JAX package's ``lax.while_loop`` becomes a host loop over a stack kept on
the device, one node a trip, as in :mod:`repro_torch.core.eclat`.  Each trip
follows ``repro/core/mfi.py`` step for step, so the candidate buffer is the
reference's trip for trip: pop the top node, count its extensions
(:func:`repro_torch.core.bitmap.extension_supports`, kernel B3 on the card), emit the node if it is
nonempty, frequent and has no frequent extension, and push every frequent
child (leaves too) in item-id order, each child's extensions being the
frequent extensions ranked after it by support (a stable sort).  The trip
makes one host read: the frequent extensions' ids, whose count moves the
stack pointer.  Stack and output capacities are fixed; both kinds of drop
are counted in ``overflow``, never silently lost.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import bitmap as bm

INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class MFIConfig:
    max_out: int = 2048
    max_stack: int = 1024
    max_iters: int = 1 << 20


class MFIResult(NamedTuple):
    items: torch.Tensor     # int32[max_out, IW] candidate itemset masks
    supports: torch.Tensor  # int32[max_out]
    n_out: int
    overflow: int           # stack + output drops; 0 ⇒ complete
    n_iters: int


def mine_candidates_seeded(
    item_bits: torch.Tensor,     # int32[I, W]
    seed_prefix: torch.Tensor,   # bool [K, I]
    seed_ext: torch.Tensor,      # bool [K, I]
    seed_tid: torch.Tensor,      # int32[K, W]
    seed_support: torch.Tensor,  # int[K]
    seed_valid: torch.Tensor,    # bool [K]
    min_support: int,
    *,
    config: MFIConfig,
    n_items: int,
) -> MFIResult:
    """All candidates on MFIs inside the union of K PBECs ``[prefix_k|ext_k]``.

    ``seed_support`` is Supp(prefix_k), emitted when the prefix itself is a
    leaf; an empty or infrequent prefix never emits.
    """
    dev = item_bits.device
    I = n_items
    IW = bm.n_words(I)
    W = item_bits.shape[-1]
    S, O = config.max_stack, config.max_out
    if seed_prefix.shape[0] > S:
        raise ValueError("seed count exceeds stack capacity")
    min_support = int(min_support)

    # Valid seeds, in order, at the bottom of the stack.
    valid_idx = torch.nonzero(seed_valid.to(dev)).flatten()
    sp = int(valid_idx.numel())
    stk_items = torch.zeros((S, IW), dtype=torch.int32, device=dev)
    stk_ext = torch.zeros((S, I), dtype=torch.bool, device=dev)
    stk_tid = torch.zeros((S, W), dtype=torch.int32, device=dev)
    stk_supp = torch.zeros((S,), dtype=torch.int32, device=dev)
    stk_items[:sp] = bm.pack_bool(seed_prefix.to(dev)[valid_idx])
    stk_ext[:sp] = seed_ext.to(dev, torch.bool)[valid_idx]
    stk_tid[:sp] = seed_tid.to(dev)[valid_idx]
    stk_supp[:sp] = seed_support.to(dev, torch.int32)[valid_idx]
    # Whether the node in a slot may be a candidate (nonempty and frequent),
    # kept on the host: read once for the seeds; every child is both.
    eligible = [False] * S
    eligible[:sp] = ((stk_items[:sp] != 0).any(dim=-1)
                     & (stk_supp[:sp] >= min_support)).tolist()

    out_items = torch.zeros((O, IW), dtype=torch.int32, device=dev)
    out_supp = torch.zeros((O,), dtype=torch.int32, device=dev)
    e_packed = bm.pack_bool(torch.eye(I, dtype=torch.bool, device=dev))  # [I, IW]
    n_out = overflow = it = 0

    while sp > 0 and it < config.max_iters:
        top = sp - 1
        node_tid = stk_tid[top]
        supports = bm.extension_supports(item_bits, node_tid)  # kernel B3 on the card
        freq = stk_ext[top] & (supports >= min_support)
        kids = torch.nonzero(freq).flatten()                   # the trip's host read
        nf = int(kids.numel())

        if nf == 0 and eligible[top]:
            if n_out < O:
                out_items[n_out] = stk_items[top]
                out_supp[n_out] = stk_supp[top]
                n_out += 1
            else:
                overflow += 1

        if nf:
            # Child e keeps the frequent extensions ranked after e by support
            # (Prop. 2.23); the children are pushed in item-id order, leaves
            # included.  All are built before the first overwrites slot top.
            order = torch.argsort(torch.where(freq, supports, INT32_MAX), stable=True)
            rank = torch.argsort(order, stable=True)
            child_items = stk_items[top] | e_packed[kids]
            child_ext = (rank[None, :] > rank[kids][:, None]) & freq[None, :]
            child_tid = item_bits[kids] & node_tid
            child_supp = supports[kids]
            n_keep = min(nf, S - top)
            overflow += nf - n_keep
            top_slots = slice(top, top + n_keep)
            stk_items[top_slots] = child_items[:n_keep]
            stk_ext[top_slots] = child_ext[:n_keep]
            stk_tid[top_slots] = child_tid[:n_keep]
            stk_supp[top_slots] = child_supp[:n_keep]
            eligible[top_slots] = [True] * n_keep
            sp = top + n_keep
        else:
            sp = top
        it += 1

    return MFIResult(out_items, out_supp, n_out, overflow, it)


def mine_candidates(
    item_bits: torch.Tensor,
    prefix_mask: torch.Tensor,   # bool [I]
    ext_mask: torch.Tensor,      # bool [I]
    prefix_tid: torch.Tensor,    # int32[W]
    prefix_support: int,
    min_support: int,
    *,
    config: MFIConfig,
    n_items: int,
) -> MFIResult:
    """Single-PBEC wrapper over :func:`mine_candidates_seeded`."""
    dev = item_bits.device
    return mine_candidates_seeded(
        item_bits,
        prefix_mask[None, :],
        ext_mask[None, :],
        prefix_tid[None, :],
        torch.tensor([int(prefix_support)], dtype=torch.int32, device=dev),
        torch.ones((1,), dtype=torch.bool, device=dev),
        min_support,
        config=config,
        n_items=n_items,
    )


def mine_all_candidates(
    db: bm.BitmapDB, min_support: int, *, config: MFIConfig = MFIConfig(),
) -> MFIResult:
    """Candidates on MFIs over the whole lattice (the root PBEC [∅ | B])."""
    I = db.n_items
    dev = db.item_bits.device
    return mine_candidates(
        db.item_bits,
        torch.zeros((I,), dtype=torch.bool, device=dev),
        torch.ones((I,), dtype=torch.bool, device=dev),
        db.all_tids(),
        0,
        min_support,
        config=config,
        n_items=I,
    )


def filter_maximal(items: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """bool ``[N]``: valid and not strictly contained in another valid itemset.

    ``items`` are packed masks ``int32[N, IW]``.  Applied to the global
    candidate set this gives exactly M̃ (DFS-MFI-Schema line 5 as a
    post-pass).
    """
    valid = valid.to(items.device, torch.bool)
    sub = bm.is_subset_packed(items[:, None, :], items[None, :, :])   # row ⊆ other
    proper = sub & ~bm.is_subset_packed(items[None, :, :], items[:, None, :])
    return valid & ~(proper & valid[None, :]).any(dim=1)


def powerset_log2_sizes(items: torch.Tensor, n_items: int) -> torch.Tensor:
    """|m| per packed mask: log2 |P(m)|, the coverage algorithm's weights."""
    return bm.popcount(items).sum(dim=-1)
