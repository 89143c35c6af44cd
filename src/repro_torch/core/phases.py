"""Phases 1, 3 and 4 of Parallel-FIMI over P miners stacked on one device.

The JAX package writes each phase once as an SPMD program over a named axis
and maps it with ``vmap`` (or ``shard_map``).  Here the miners are the
leading dimension of stacked ``[P, …]`` tensors, and :class:`LocalCollectives`
does what the collectives did across that axis.  Each miner's Eclat runs on
its own, one after the other, since every miner keeps its own stack.

Layout: the database is ``tx_shards int32[P, T, IW]`` — shard p is D_p,
|D|/P transactions in horizontal packed form.  A slab is the horizontal
sub-database a miner holds after the Phase-3 exchange.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, mfi
from repro_torch.core.apriori import count_supports

INT32_MAX = torch.iinfo(torch.int32).max


class LocalCollectives:
    """Collectives across P miners whose data is stacked on dim 0."""

    def __init__(self, P: int):
        self.P = P

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[P, n, …]`` → ``[P·n, …]``, the gathered block every miner sees."""
        return x.reshape((self.P * x.shape[1],) + tuple(x.shape[2:]))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[P_src, P_dst, …]`` → ``[P_dst, P_src, …]``."""
        return x.transpose(0, 1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the miners: ``[P, …]`` → ``[…]``."""
        return x.sum(dim=0)


def vertical_from_slab(slab: torch.Tensor, valid: torch.Tensor, n_items: int):
    """Horizontal packed slab ``int32[T, IW]`` (+ row-valid mask) → vertical
    ``item_bits int32[I, n_words(T)]`` and the valid-tid bitmap."""
    dense = bm.unpack_bool(slab, n_items) & valid[:, None]   # [T, I]
    return bm.pack_bool(dense.T), bm.pack_bool(valid)


def seed_tidlists(
    item_bits: torch.Tensor, seed_prefix: torch.Tensor, valid_tid: torch.Tensor
) -> torch.Tensor:
    """T(U_k) for K seed prefixes (bool [K, I]): one batched AND-reduce
    (`Prepare-Tidlists`, Alg. 20)."""
    rows = torch.where(seed_prefix[:, :, None], item_bits[None, :, :], bm.ALL_ONES)
    return bm.and_reduce(rows, 1) & valid_tid[None, :]


# ---------------------------------------------------------------------------
# Phase 1 — sampling
# ---------------------------------------------------------------------------


class Phase1Out(NamedTuple):
    sample_db: torch.Tensor           # int32[n_sample, IW] — D̃, replicated
    reservoir: torch.Tensor           # int32[P, R, IW] — local reservoirs (Res.)
    reservoir_supports: torch.Tensor  # int32[P, R]
    fi_count: np.ndarray              # int[P] — f_i, FIs streamed locally
    mfi_items: torch.Tensor           # int32[P, Mmax, IW] — M_p (Par variant)
    mfi_supports: torch.Tensor        # int32[P, Mmax]
    mfi_count: np.ndarray             # int[P]
    overflow: np.ndarray              # int[P] — stack (and MFI output) overflow
    n_iters: np.ndarray               # int[P] — DFS trips


def _assigned_item_seeds(order: torch.Tensor, n_items: int, p: int, P: int):
    """Alg. 11 line 3: miner p takes the items at positions j ≡ p (mod P) of
    the support-ascending ``order``.  Returns bool [K, I] prefix and ext
    masks and valid [K], K = ceil(I/P)."""
    I = n_items
    K = (I + P - 1) // P
    dev = order.device
    slots = p + P * torch.arange(K, device=dev)
    valid = slots < I
    slots_c = slots.clamp(max=I - 1)
    items = order[slots_c]
    prefix = torch.nn.functional.one_hot(items, I).to(torch.bool) & valid[:, None]
    positions = torch.arange(I, device=dev)
    ext = positions[None, :] > slots_c[:, None]            # positions in order
    ext_items = torch.zeros((K, I), dtype=torch.bool, device=dev)
    ext_items[:, order] = ext                              # back to item ids
    return prefix, ext_items & valid[:, None], valid


def phase1_device(
    tx_shards: torch.Tensor,      # int32[P, T, IW]
    min_support_rel: float,
    *,
    coll: LocalCollectives,
    n_items: int,
    n_sample_per_proc: int,
    reservoir_size: int,
    eclat_cfg: eclat.EclatConfig,
    mfi_cfg: mfi.MFIConfig = mfi.MFIConfig(),
    variant: str = "reservoir",   # "reservoir" | "par" | "sample"
    generators: List[torch.Generator],
    sample_idx: Optional[torch.Tensor] = None,       # int[P, n_sample_per_proc]
    reservoir_draws: Optional[List[torch.Tensor]] = None,  # per miner
) -> Phase1Out:
    """Device part of Phase 1 (Algs. 12/13/14 lines 1–9).

    1. each miner samples ``n_sample_per_proc`` rows of D_p i.i.d.;
    2. all-gather → D̃, the same on every miner;
    3. each miner mines D̃ restricted to its 1-prefix classes, streaming the
       FIs through its own reservoir (``reservoir``) or collecting its MFI
       candidates M_p (``par``).  ``sample`` (the Seq variant) stops after
       step 2: miner 1 mines D̃'s MFIs afterwards.

    D̃ is the same on every miner, so its vertical form and root supports
    are computed once.
    """
    P, T, _ = tx_shards.shape
    rows = torch.stack([
        bm.sample_transactions(
            tx_shards[p], n_sample_per_proc, generator=generators[p],
            idx=None if sample_idx is None else sample_idx[p],
        )
        for p in range(P)
    ])
    sample_db = coll.all_gather(rows)
    n_samp = sample_db.shape[0]
    min_support = int(np.ceil(np.float32(min_support_rel) * np.float32(n_samp)))

    dev = tx_shards.device
    if variant not in ("reservoir", "par", "sample"):
        raise ValueError(f"unknown phase-1 variant {variant!r}")
    IW = bm.n_words(n_items)
    R = max(reservoir_size, 1)
    zeros = np.zeros(P, dtype=np.int64)
    no_reservoir = dict(
        reservoir=torch.zeros((P, R, IW), dtype=torch.int32, device=dev),
        reservoir_supports=torch.zeros((P, R), dtype=torch.int32, device=dev),
        fi_count=zeros,
    )
    no_mfi = dict(
        mfi_items=torch.zeros((P, mfi_cfg.max_out, IW), dtype=torch.int32, device=dev),
        mfi_supports=torch.zeros((P, mfi_cfg.max_out), dtype=torch.int32, device=dev),
        mfi_count=zeros,
    )
    if variant == "sample":
        return Phase1Out(sample_db=sample_db, **no_reservoir, **no_mfi,
                         overflow=zeros, n_iters=zeros)

    item_bits, valid_tid = vertical_from_slab(
        sample_db, torch.ones((n_samp,), dtype=torch.bool, device=dev), n_items
    )
    root_supp = bm.extension_supports(item_bits, valid_tid)   # kernel B3
    frequent_item = root_supp >= min_support
    order = torch.argsort(
        torch.where(frequent_item, root_supp, INT32_MAX), stable=True
    )
    cfg = dataclasses.replace(eclat_cfg, reservoir_size=reservoir_size, count_only=True)

    results = []
    for p in range(P):
        prefix, ext, valid = _assigned_item_seeds(order, n_items, p, P)
        valid = valid & (prefix & frequent_item[None, :]).any(dim=-1)
        tid = seed_tidlists(item_bits, prefix, valid_tid)
        if variant == "par":
            supp = torch.where(prefix, root_supp[None, :], 0).sum(dim=-1)
            results.append(mfi.mine_candidates_seeded(
                item_bits, prefix, ext, tid, supp, valid, min_support,
                config=mfi_cfg, n_items=n_items,
            ))
        else:
            results.append(eclat.mine_seeded(
                item_bits, prefix, ext, tid, valid, min_support,
                config=cfg, n_items=n_items, generator=generators[p],
                reservoir_draws=None if reservoir_draws is None else reservoir_draws[p],
            ))
    if variant == "par":
        return Phase1Out(
            sample_db=sample_db, **no_reservoir,
            mfi_items=torch.stack([r.items for r in results]),
            mfi_supports=torch.stack([r.supports for r in results]),
            mfi_count=np.array([r.n_out for r in results]),
            overflow=np.array([r.overflow for r in results]),
            n_iters=np.array([r.n_iters for r in results]),
        )
    # The stream holds every FI of D̃ with |W| ≥ 2; the singletons are the
    # class prefixes, which Phase 4's side channel handles.
    return Phase1Out(
        sample_db=sample_db,
        reservoir=torch.stack([r.reservoir_items for r in results]),
        reservoir_supports=torch.stack([r.reservoir_supports for r in results]),
        fi_count=np.array([r.n_total for r in results]),
        **no_mfi,
        overflow=np.array([r.stack_overflow for r in results]),
        n_iters=np.array([r.n_iters for r in results]),
    )


# ---------------------------------------------------------------------------
# Phase 3 — database partition exchange (Alg. 18 → all_to_all)
# ---------------------------------------------------------------------------


class Phase3Out(NamedTuple):
    slab: torch.Tensor          # int32[P, P*cap, IW] — D'_p rows (incl. padding)
    slab_valid: torch.Tensor    # bool [P, P*cap]
    recv_counts: torch.Tensor   # int[P, P] — rows miner p got from each source
    overflow: int               # rows that did not fit cap
    replication: float          # Σ|D'_p| / |D| (thesis Ch. 10), float32


def phase3_exchange(
    tx_shards: torch.Tensor,           # int32[P, T, IW]
    local_valid: torch.Tensor,         # bool [P, T]
    class_prefix_packed: torch.Tensor,  # int32[C, IW] — U_k
    class_assign: np.ndarray,          # int[C] — miner per class
    *,
    coll: LocalCollectives,
    capacity: int,
) -> Phase3Out:
    """Each miner sends to miner q the transactions that contain any U_k with
    assign(k) = q, through a fixed-capacity ``all_to_all``.  Overflow is
    counted, never silently dropped."""
    P, T, IW = tx_shards.shape
    dev = tx_shards.device
    prefixes = class_prefix_packed.to(dev)
    cols = [
        torch.as_tensor(np.flatnonzero(class_assign == q), device=dev)
        for q in range(P)
    ]
    send = torch.zeros((P, P, capacity + 1, IW), dtype=torch.int32, device=dev)
    send_valid = torch.zeros((P, P, capacity + 1), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(P):
        tx = tx_shards[p]
        contains = bm.is_subset_packed(prefixes[None, :, :], tx[:, None, :])  # [T, C]
        contains &= local_valid[p][:, None]
        need = torch.stack([contains[:, c].any(dim=1) for c in cols], dim=1)  # [T, P]
        rank = torch.cumsum(need, dim=0) - 1
        sent = need & (rank < capacity)
        overflow += (need & ~sent).sum()
        pos = torch.where(sent, rank, capacity)          # row `capacity` drops
        for q in range(P):
            send[p, q, pos[:, q]] = tx
            send_valid[p, q, pos[:, q]] = sent[:, q]
    recv = coll.all_to_all(send[:, :, :capacity])        # [P_dst, P_src, cap, IW]
    recv_valid = coll.all_to_all(send_valid[:, :, :capacity])
    recv_counts = recv_valid.sum(dim=2)
    total_tx = coll.psum(local_valid.sum(dim=1))
    replication = recv_counts.sum().to(torch.float32) / total_tx.clamp(min=1).to(torch.float32)
    return Phase3Out(
        slab=recv.reshape(P, P * capacity, IW),
        slab_valid=recv_valid.reshape(P, P * capacity),
        recv_counts=recv_counts,
        overflow=int(overflow),
        replication=float(replication),
    )


# ---------------------------------------------------------------------------
# Phase 4 — parallel FI computation (Alg. 19 / 22)
# ---------------------------------------------------------------------------


class Phase4Out(NamedTuple):
    results: List[eclat.EclatResult]   # per miner
    prefix_supports: torch.Tensor      # int[A] — global Supp(W) of the ancestors


def phase4_mine(
    slab: torch.Tensor,            # int32[P, T', IW] — D'_p from Phase 3
    slab_valid: torch.Tensor,      # bool [P, T']
    tx_shards: torch.Tensor,       # int32[P, T, IW] — original D_p (side channel)
    local_valid: torch.Tensor,     # bool [P, T]
    seed_prefix: torch.Tensor,     # bool [P, Cmax, I] — assigned classes (padded)
    seed_ext: torch.Tensor,        # bool [P, Cmax, I]
    seed_valid: torch.Tensor,      # bool [P, Cmax]
    ancestor_masks: torch.Tensor,  # bool [A, I] — prefix side-channel itemsets
    min_support: int,
    *,
    coll: LocalCollectives,
    n_items: int,
    eclat_cfg: eclat.EclatConfig,
    multi_support_fn: Optional[eclat.MultiSupportFn] = None,
) -> Phase4Out:
    """Alg. 19 (Phase-4-Compute-FI) with Eclat (Alg. 22):

    * lines 2–5: each miner counts the ancestor prefixes on its own D_p, and
      the psum makes them global;
    * line 6: Exec-Eclat over each miner's classes on its slab D'_p, its
      sweeps through ``multi_support_fn`` (default: kernel B1 on the card).
    """
    P = tx_shards.shape[0]
    local_anc = []
    for p in range(P):
        bits, valid_tid = vertical_from_slab(tx_shards[p], local_valid[p], n_items)
        local_anc.append(count_supports(bits, ancestor_masks, valid_tid))
    prefix_supports = coll.psum(torch.stack(local_anc))

    results = []
    for p in range(P):
        item_bits, valid_tid = vertical_from_slab(slab[p], slab_valid[p], n_items)
        tid = seed_tidlists(item_bits, seed_prefix[p], valid_tid)
        results.append(eclat.mine_seeded(
            item_bits, seed_prefix[p], seed_ext[p], tid, seed_valid[p],
            min_support, config=eclat_cfg, n_items=n_items,
            multi_support_fn=multi_support_fn,
        ))
    return Phase4Out(results=results, prefix_supports=prefix_supports)
