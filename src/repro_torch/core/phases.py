"""Phases 1, 3 and 4 of Parallel-FIMI over P miners.

The JAX package writes each phase once as an SPMD program over a named axis
and maps it with ``vmap`` (P miners on one device) or ``shard_map`` (one
miner a device).  Here each phase loops over the miners this process holds,
and a collectives object does what the collectives did across that axis:

  * :class:`LocalCollectives` holds all P miners, stacked on dim 0 of
    ``[P, …]`` tensors on one device (the ``vmap`` counterpart);
  * :class:`DistCollectives` holds one miner a rank of a
    ``torch.distributed`` process group, its tensors ``[1, …]`` on the
    rank's device: ``all_gather`` (the Phase-1 sample), ``all_to_all_single``
    (the Phase-3 slabs) and ``all_reduce`` (ancestor supports, row totals,
    overflow), NCCL for CUDA tensors and gloo for CPU tensors
    (``launch/ranks.py`` sets the group up).

Each miner's Eclat runs on its own, one after the other, since every miner
keeps its own stack; its random streams are drawn by its global miner id, so
a miner draws the same numbers under either backend.  Each phase ends with
the per-miner results of all P miners gathered on every rank, so what comes
out reads the same under both.

Layout: the database is ``tx_shards int32[L, T, IW]`` — the L = len(miners)
shards this process holds, shard p being D_p, |D|/P transactions in
horizontal packed form.  A slab is the horizontal sub-database a miner holds
after the Phase-3 exchange.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, mfi
from repro_torch.core.apriori import count_supports

INT32_MAX = torch.iinfo(torch.int32).max


class LocalCollectives:
    """Collectives across P miners whose data is stacked on dim 0, all held
    by this process."""

    backend = "local"
    rank = 0

    def __init__(self, P: int):
        self.P = P
        self.miners = list(range(P))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of a ``[P, …]`` stack that this process holds (all)."""
        if x.shape[0] != self.P:
            raise ValueError(f"expected {self.P} miner rows, got {x.shape[0]}")
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[P, n, …]`` → ``[P·n, …]``, the gathered block every miner sees."""
        return x.reshape((self.P * x.shape[1],) + tuple(x.shape[2:]))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[P_src, P_dst, …]`` → ``[P_dst, P_src, …]``."""
        return x.transpose(0, 1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the miners: ``[P, …]`` → ``[…]``."""
        return x.sum(dim=0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The per-miner stack of all P miners (here already whole)."""
        return x

    def gather_counts(self, values: Sequence[int]) -> np.ndarray:
        """One integer a held miner → ``int[P]``, in miner order."""
        return np.array(values, dtype=np.int64)

    def gather_results(self, results: List[eclat.EclatResult]) -> List[eclat.EclatResult]:
        """The held miners' Eclat results → all P miners' (here already all)."""
        return list(results)

    def sum_counts(self, counts: Dict[str, int]) -> Dict[str, int]:
        """Counts of this process (say, kernel launches) → their sum over
        the processes (here the one)."""
        return dict(counts)


class DistCollectives:
    """Collectives across P ranks of the default ``torch.distributed`` group,
    one miner a rank (miner id = rank), its tensors ``[1, …]`` on ``device``.

    Bool tensors travel as uint8 (NCCL and gloo agree on bytes); results
    come back on the caller's device and dtype.
    """

    def __init__(self, P: int, device: torch.device):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistCollectives needs an initialised process group")
        if dist.get_world_size() != P:
            raise ValueError(f"{dist.get_world_size()} ranks for {P} miners: one miner a rank")
        self._dist = dist
        self.P = P
        self.rank = dist.get_rank()
        self.miners = [self.rank]
        self.device = torch.device(device)
        self.backend = dist.get_backend()

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's row of a ``[P, …]`` stack (or the ``[1, …]`` row itself)."""
        if x.shape[0] == self.P:
            return x[self.rank: self.rank + 1]
        if x.shape[0] != 1:
            raise ValueError(f"expected {self.P} or 1 miner rows, got {x.shape[0]}")
        return x

    @staticmethod
    def _wire(x: torch.Tensor) -> torch.Tensor:
        return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()

    def _gather0(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, …]`` on every rank → ``[P·n, …]`` in rank order."""
        wire = self._wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.P)]
        self._dist.all_gather(parts, wire)
        return torch.cat(parts).to(x.dtype)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, n, …]`` → ``[P·n, …]``, the gathered block every miner sees."""
        return self._gather0(x[0])

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, P_dst, …]`` → ``[1, P_src, …]``: row q goes to rank q."""
        wire = self._wire(x[0])
        out = torch.empty_like(wire)
        self._dist.all_to_all_single(out, wire)
        return out.to(x.dtype)[None]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks: ``[1, …]`` → ``[…]``."""
        out = self._wire(x.sum(dim=0))
        self._dist.all_reduce(out)
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[1, …]`` → the per-miner stack ``[P, …]`` of all ranks."""
        return self._gather0(x)

    def gather_counts(self, values: Sequence[int]) -> np.ndarray:
        t = torch.tensor(list(values), dtype=torch.int64, device=self.device)
        return self._gather0(t).cpu().numpy()

    def gather_results(self, results: List[eclat.EclatResult]) -> List[eclat.EclatResult]:
        """The rank's Eclat result → all P ranks', their written FIs on the host."""
        out: List = [None] * self.P
        self._dist.all_gather_object(out, [_to_host(r) for r in results])
        return [r for per_rank in out for r in per_rank]

    def sum_counts(self, counts: Dict[str, int]) -> Dict[str, int]:
        total = self.psum(torch.tensor([list(counts.values())], dtype=torch.int64,
                                       device=self.device))
        return dict(zip(counts, (int(n) for n in total.cpu())))


Collectives = LocalCollectives | DistCollectives


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
    tx_shards: torch.Tensor,      # int32[L, T, IW] — the held miners' shards
    min_support_rel: float,
    *,
    coll: Collectives,
    n_items: int,
    n_sample_per_proc: int,
    reservoir_size: int,
    eclat_cfg: eclat.EclatConfig,
    mfi_cfg: mfi.MFIConfig = mfi.MFIConfig(),
    variant: str = "reservoir",   # "reservoir" | "par" | "sample"
    generators: List[torch.Generator],               # per held miner
    sample_idx: Optional[torch.Tensor] = None,       # int[P, n_sample_per_proc]
    reservoir_draws: Optional[List[torch.Tensor]] = None,  # per global miner
) -> Phase1Out:
    """Device part of Phase 1 (Algs. 12/13/14 lines 1–9).

    1. each miner samples ``n_sample_per_proc`` rows of D_p i.i.d.;
    2. all-gather → D̃, the same on every miner;
    3. each miner mines D̃ restricted to its 1-prefix classes, streaming the
       FIs through its own reservoir (``reservoir``) or collecting its MFI
       candidates M_p (``par``).  ``sample`` (the Seq variant) stops after
       step 2: miner 1 mines D̃'s MFIs afterwards.

    D̃ is the same on every miner, so its vertical form and root supports
    are computed once a process.  The per-miner outputs are gathered: every
    process gets all P miners' reservoirs (or candidates) and counters.
    """
    P = coll.P
    rows = torch.stack([
        bm.sample_transactions(
            tx_shards[j], n_sample_per_proc, generator=generators[j],
            idx=None if sample_idx is None else sample_idx[p],
        )
        for j, p in enumerate(coll.miners)
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
    for j, p in enumerate(coll.miners):
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
                config=cfg, n_items=n_items, generator=generators[j],
                reservoir_draws=None if reservoir_draws is None else reservoir_draws[p],
            ))
    if variant == "par":
        return Phase1Out(
            sample_db=sample_db, **no_reservoir,
            mfi_items=coll.gather(torch.stack([r.items for r in results])),
            mfi_supports=coll.gather(torch.stack([r.supports for r in results])),
            mfi_count=coll.gather_counts([r.n_out for r in results]),
            overflow=coll.gather_counts([r.overflow for r in results]),
            n_iters=coll.gather_counts([r.n_iters for r in results]),
        )
    # The stream holds every FI of D̃ with |W| ≥ 2; the singletons are the
    # class prefixes, which Phase 4's side channel handles.
    return Phase1Out(
        sample_db=sample_db,
        reservoir=coll.gather(torch.stack([r.reservoir_items for r in results])),
        reservoir_supports=coll.gather(torch.stack([r.reservoir_supports for r in results])),
        fi_count=coll.gather_counts([r.n_total for r in results]),
        **no_mfi,
        overflow=coll.gather_counts([r.stack_overflow for r in results]),
        n_iters=coll.gather_counts([r.n_iters for r in results]),
    )


# ---------------------------------------------------------------------------
# Phase 3 — database partition exchange (Alg. 18 → all_to_all)
# ---------------------------------------------------------------------------


class Phase3Out(NamedTuple):
    slab: torch.Tensor          # int32[L, P*cap, IW] — D'_p rows (incl. padding)
    slab_valid: torch.Tensor    # bool [L, P*cap]
    recv_counts: torch.Tensor   # int[L, P] — rows each held miner got from each source
    overflow: int               # rows that did not fit cap, over all miners
    replication: float          # Σ|D'_p| / |D| (thesis Ch. 10), float32


def phase3_exchange(
    tx_shards: torch.Tensor,           # int32[L, T, IW]
    local_valid: torch.Tensor,         # bool [L, T]
    class_prefix_packed: torch.Tensor,  # int32[C, IW] — U_k
    class_assign: np.ndarray,          # int[C] — miner per class
    *,
    coll: Collectives,
    capacity: int,
) -> Phase3Out:
    """Each miner sends to miner q the transactions that contain any U_k with
    assign(k) = q, through a fixed-capacity ``all_to_all``.  Overflow is
    counted, never silently dropped."""
    L, T, IW = tx_shards.shape
    P = coll.P
    dev = tx_shards.device
    prefixes = class_prefix_packed.to(dev)
    cols = [
        torch.as_tensor(np.flatnonzero(class_assign == q), device=dev)
        for q in range(P)
    ]
    send = torch.zeros((L, P, capacity + 1, IW), dtype=torch.int32, device=dev)
    send_valid = torch.zeros((L, P, capacity + 1), dtype=torch.bool, device=dev)
    overflow = torch.zeros((L,), dtype=torch.int64, device=dev)
    for j in range(L):
        tx = tx_shards[j]
        contains = bm.is_subset_packed(prefixes[None, :, :], tx[:, None, :])  # [T, C]
        contains &= local_valid[j][:, None]
        need = torch.stack([contains[:, c].any(dim=1) for c in cols], dim=1)  # [T, P]
        rank = torch.cumsum(need, dim=0) - 1
        sent = need & (rank < capacity)
        overflow[j] = (need & ~sent).sum()
        pos = torch.where(sent, rank, capacity)          # row `capacity` drops
        for q in range(P):
            send[j, q, pos[:, q]] = tx
            send_valid[j, q, pos[:, q]] = sent[:, q]
    recv = coll.all_to_all(send[:, :, :capacity])        # [L_dst, P_src, cap, IW]
    recv_valid = coll.all_to_all(send_valid[:, :, :capacity])
    recv_counts = recv_valid.sum(dim=2)
    total_tx = coll.psum(local_valid.sum(dim=1))
    received = coll.psum(recv_counts.sum(dim=1))
    replication = received.to(torch.float32) / total_tx.clamp(min=1).to(torch.float32)
    return Phase3Out(
        slab=recv.reshape(L, P * capacity, IW),
        slab_valid=recv_valid.reshape(L, P * capacity),
        recv_counts=recv_counts,
        overflow=int(coll.psum(overflow)),
        replication=float(replication),
    )


# ---------------------------------------------------------------------------
# Phase 4 — parallel FI computation (Alg. 19 / 22)
# ---------------------------------------------------------------------------


class Phase4Out(NamedTuple):
    results: List[eclat.EclatResult]   # all P miners', in miner order
    prefix_supports: torch.Tensor      # int[A] — global Supp(W) of the ancestors


def _to_host(r: eclat.EclatResult) -> eclat.EclatResult:
    """A miner's result with its written FIs on the host, to cross ranks."""
    return r._replace(items=r.items[: r.n_out].cpu(), supports=r.supports[: r.n_out].cpu(),
                      reservoir_items=r.reservoir_items.cpu(),
                      reservoir_supports=r.reservoir_supports.cpu())


def phase4_mine(
    slab: torch.Tensor,            # int32[L, T', IW] — D'_p from Phase 3
    slab_valid: torch.Tensor,      # bool [L, T']
    tx_shards: torch.Tensor,       # int32[L, T, IW] — original D_p (side channel)
    local_valid: torch.Tensor,     # bool [L, T]
    seed_prefix: torch.Tensor,     # bool [L, Cmax, I] — assigned classes (padded)
    seed_ext: torch.Tensor,        # bool [L, Cmax, I]
    seed_valid: torch.Tensor,      # bool [L, Cmax]
    ancestor_masks: torch.Tensor,  # bool [A, I] — prefix side-channel itemsets
    min_support: int,
    *,
    coll: Collectives,
    n_items: int,
    eclat_cfg: eclat.EclatConfig,
    multi_support_fn: Optional[eclat.MultiSupportFn] = None,
) -> Phase4Out:
    """Alg. 19 (Phase-4-Compute-FI) with Eclat (Alg. 22):

    * lines 2–5: each miner counts the ancestor prefixes on its own D_p, and
      the psum makes them global;
    * line 6: Exec-Eclat over each miner's classes on its slab D'_p, its
      sweeps through ``multi_support_fn`` (default: kernel B1 on the card).

    The held miners' results are gathered, so every process returns all P
    (across ranks with their written FIs on the host).
    """
    L = tx_shards.shape[0]
    local_anc = []
    for j in range(L):
        bits, valid_tid = vertical_from_slab(tx_shards[j], local_valid[j], n_items)
        local_anc.append(count_supports(bits, ancestor_masks, valid_tid))
    prefix_supports = coll.psum(torch.stack(local_anc))

    results = []
    for j in range(L):
        item_bits, valid_tid = vertical_from_slab(slab[j], slab_valid[j], n_items)
        tid = seed_tidlists(item_bits, seed_prefix[j], valid_tid)
        results.append(eclat.mine_seeded(
            item_bits, seed_prefix[j], seed_ext[j], tid, seed_valid[j],
            min_support, config=eclat_cfg, n_items=n_items,
            multi_support_fn=multi_support_fn,
        ))
    return Phase4Out(results=coll.gather_results(results), prefix_supports=prefix_supports)
