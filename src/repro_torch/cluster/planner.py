"""Phase-1/2 control plane of the distributed mining executor.

Estimate the size of every candidate equivalence class from a database
sample (Thm 6.1 sizes the sample, a reservoir over the sample's FI stream
sizes the itemset sample), then assign classes to miners before any
distributed work starts.  The plan is host-side control plane; its output,
a :class:`MiningPlan`, is what every miner executes.

Pipeline (the port's ``core.sampling`` / ``core.pbec`` / ``core.schedule``)::

    D ── i.i.d. sample (Thm 6.1) ──► D̃ ── Eclat + in-loop reservoir ──► F̃s
      ── Partition (Alg. 15/17) ──► PBECs ── est. sizes ──► LPT ⊕ DB-Repl-Min
      ── volume comparison ──► assignment + per-miner queues

``scheduler="auto"`` computes both the LPT and the DB-Repl-Min assignment,
prices each by its exact replicated transaction volume on the sample, and
keeps the replication-aware one only when it moves strictly fewer
transactions without stretching the makespan past ``makespan_slack``.

The sample rows and the reservoir draws come from ``torch.Generator``s, or
from tensors the caller hands in: torch cannot draw JAX's threefry numbers,
so a test hands in the reference's draws to reproduce its plan.

Every process draws the same sample indices, each held shard contributes
the rows it owns, and the sum over the miners gathers D̃ (an all-reduce
across ranks, under a :class:`~repro_torch.core.phases.DistCollectives`);
the rest of the plan is host work that every rank does alike, so every rank
holds the same plan.

``plan`` also takes an on-disk :class:`~repro_torch.store.store.TxStore`
(``P`` required then): the Thm 6.1 sample is gathered off disk at the same
row indices (``store.reader.sample_rows``), so the plan equals the in-RAM
path's without the database ever being resident.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, pbec, phases, sampling, schedule
from repro_torch.store import reader as store_reader
from repro_torch.store.store import TxStore


@dataclasses.dataclass(frozen=True)
class PlannerParams:
    """Knobs of the sample-based planning stage (thesis Ch. 6 + Ch. 8)."""

    min_support_rel: float = 0.1
    eps_db: float = 0.05                # ε of the Thm 6.1 database sample
    delta_db: float = 0.1
    eps_fs: float = 0.05                # ε of the Thm 6.3 reservoir sample
    delta_fs: float = 0.1
    rho: float = 0.01
    alpha: float = 0.5                  # Phase-2 split granularity
    n_db_sample: Optional[int] = None   # override |D̃|
    n_fi_sample: Optional[int] = None   # override |F̃s|
    scheduler: str = "auto"             # "lpt" | "repl_min" | "auto"
    makespan_slack: float = 1.5         # auto: repl_min may cost ≤ slack × LPT
    max_classes: int = 512
    sample_eclat: eclat.EclatConfig = eclat.EclatConfig(
        max_out=1, max_stack=4096, frontier_size=16, count_only=True
    )


@dataclasses.dataclass
class MiningPlan:
    """Everything the executor needs, plus what the planner learned."""

    n_items: int
    n_tx: int
    P: int
    abs_minsup: int
    classes: List[pbec.PBEC]
    est_sizes: np.ndarray           # float [C] — sample counts per class
    assignment: np.ndarray          # int [C] — class → miner
    est_loads: np.ndarray           # float [P]
    scheduler_used: str             # "lpt" | "repl_min"
    lpt_volume: float               # replicated tx volume of the LPT schedule
    repl_volume: float              # … and of the DB-Repl-Min schedule
    sample_masks: np.ndarray        # bool [N, I] — F̃s (|W| ≥ 2)
    ancestor_masks: np.ndarray      # bool [A, I] — prefix side channel
    n_ancestors: int                # valid rows of ancestor_masks
    n_db_sample: int                # |D̃| actually drawn
    n_fi_sample: int                # reservoir capacity
    sample_item_rel: np.ndarray     # float [I] — item supports on D̃ (relative)
    eps_db_effective: float         # Thm 6.1 ε implied by |D̃| at delta_db

    def shard_queues(self) -> List[List[int]]:
        """Per-miner class queues, heaviest estimated class first.

        The executor drains these front to front each round; the rebalancer
        moves tail entries between them.
        """
        queues: List[List[int]] = [[] for _ in range(self.P)]
        order = np.argsort(-self.est_sizes, kind="stable")
        for cid in order:
            queues[int(self.assignment[cid])].append(int(cid))
        return queues


_PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(MiningPlan))


def plan_from_reference(ref) -> MiningPlan:
    """The port's :class:`MiningPlan` for a plan of the JAX package.

    ``ref`` is the reference's ``MiningPlan`` (read by its attributes, so
    nothing of that package is imported): its numpy fields are copied and
    each class becomes the port's :class:`~repro_torch.core.pbec.PBEC`
    (prefix, ext, est_count, seq).  Handed one plan, both executors mine the
    same classes in the same rounds.
    """
    fields = {name: getattr(ref, name) for name in _PLAN_FIELDS}
    fields["classes"] = [
        pbec.PBEC(np.array(c.prefix, dtype=bool), np.array(c.ext, dtype=bool),
                  c.est_count, tuple(int(i) for i in c.seq))
        for c in ref.classes
    ]
    for name in ("est_sizes", "assignment", "est_loads", "sample_masks",
                 "ancestor_masks", "sample_item_rel"):
        fields[name] = np.array(fields[name])
    return MiningPlan(**fields)


def plan(
    tx_shards: torch.Tensor | TxStore,  # int32[P, T, IW] shards, or a store
    n_items: Optional[int],
    params: PlannerParams,
    *,
    seed: int = 0,
    device: str | torch.device | None = None,
    sample_idx: Optional[torch.Tensor] = None,       # int[n_db] rows of D
    reservoir_draws: Optional[torch.Tensor] = None,  # int[≥ FIs streamed]
    P: Optional[int] = None,
    coll: Optional[phases.Collectives] = None,
) -> MiningPlan:
    """Build the mining plan from a database sample (Phases 1–2).

    The sample rows are drawn from a generator seeded from ``seed``, or taken
    from ``sample_idx`` (indices into the ``P·T`` rows of ``tx_shards`` in
    shard order); the j of Algorithm R for the t-th FI of the sample's stream
    from another, or from ``reservoir_draws[t - 1]``.  ``device`` defaults
    to CUDA.  With a :class:`TxStore`, ``P`` is required, ``n_items`` may be
    None, and the sample rows are gathered off disk at the same indices,
    each rank reading those of its own shard.  ``coll`` holds the miners
    (default: all of them here); under a ``DistCollectives`` ``tx_shards``
    is the whole database, the rank's shard, or the store.
    """
    dev = device_mod.resolve(device)
    store = None
    if isinstance(tx_shards, TxStore):   # plan off disk
        store = tx_shards
        if P is None:
            raise ValueError("P (shard count) is required when planning a TxStore")
        if n_items is None:
            n_items = store.n_items
        T, IW = store.n_tx // P, store.n_words
        coll = coll if coll is not None else phases.LocalCollectives(P)
        if coll.P != P:
            raise ValueError(f"P={P} miners, but the collectives hold {coll.P}")
    else:
        tx_shards = tx_shards.to(dev)
        coll = coll if coll is not None else phases.LocalCollectives(tx_shards.shape[0])
        tx_shards = coll.local(tx_shards)
        _, T, IW = tx_shards.shape
        P = coll.P
    n_tx = P * T
    abs_minsup = int(np.ceil(params.min_support_rel * n_tx))

    # ---- Phase 1a: database sample (Thm 6.1) -------------------------------
    n_db = params.n_db_sample or sampling.db_sample_size(params.eps_db, params.delta_db)
    n_db = min(n_db, n_tx)
    g_samp, g_mine = (device_mod.generator(dev, seed, stream) for stream in (0, 1))
    sample_idx = bm.sample_indices(n_tx, n_db, generator=g_samp, idx=sample_idx,
                                   device=dev).to(dev)
    # the same indices on every rank, each row from the miner holding it (off
    # disk: from the blocks of its shard)
    if store is not None:
        rows = _gather_store_rows(coll, store, T, sample_idx)
    else:
        rows = _gather_rows(coll, tx_shards, sample_idx)
    sample_bitdb = bm.rebuild_vertical(rows, n_items, n_db)
    sample_minsup = int(np.ceil(params.min_support_rel * n_db))
    eps_eff = math.sqrt(math.log(2.0 / params.delta_db) / (2.0 * n_db))

    # ---- Phase 1b: FI sample — Eclat over D̃ with the in-loop reservoir ----
    n_fs = params.n_fi_sample or sampling.reservoir_sample_size(
        params.eps_fs, params.delta_fs, params.rho
    )
    res = eclat.mine_all(
        sample_bitdb, sample_minsup,
        config=dataclasses.replace(params.sample_eclat, reservoir_size=n_fs,
                                   count_only=True),
        generator=g_mine, reservoir_draws=reservoir_draws,
    )
    res_rows = res.reservoir_items[: min(res.n_total, n_fs)]
    sample_masks = bm.unpack_bool(res_rows, n_items).cpu().numpy().reshape(-1, n_items)
    # the partitioner's sample space is F̃_{≥2}: singletons are exactly the
    # 1-prefixes, handled by the prefix side channel
    sample_masks = sample_masks[sample_masks.sum(axis=1) >= 2]

    # ---- Phase 2: Partition + schedule -------------------------------------
    def ext_supports(prefix: np.ndarray) -> np.ndarray:
        tid = bm.tidlist_of_itemset(sample_bitdb, torch.from_numpy(prefix).to(dev))
        return bm.extension_supports(sample_bitdb.item_bits, tid).cpu().numpy()  # B3

    classes = pbec.partition(
        sample_masks, P, params.alpha, ext_supports, n_items,
        max_classes=params.max_classes,
    )
    est_sizes = np.array([c.est_count for c in classes], dtype=np.float64)

    tids_t = phases.seed_tidlists(
        sample_bitdb.item_bits,
        torch.from_numpy(np.stack([c.prefix for c in classes])).to(dev),
        sample_bitdb.all_tids(),
    )
    tids = bm.to_reference(tids_t)
    if params.scheduler not in ("lpt", "repl_min", "auto"):
        raise ValueError(f"unknown scheduler {params.scheduler!r}")
    lpt_assign = schedule.lpt_schedule(est_sizes, P)
    lpt_volume = schedule.replicated_volume(tids, lpt_assign, P)
    if params.scheduler == "lpt":
        # skip the O(C²) profit matrix and greedy QKP the choice would discard
        repl_volume = float("nan")
        assignment, used = lpt_assign, "lpt"
    else:
        profit = schedule.pairwise_shared_transactions(tids_t)
        repl = schedule.db_repl_min(est_sizes, profit, P, tidlists=tids)
        repl_volume = repl.volume
        if params.scheduler == "repl_min":
            assignment, used = repl.assignment, "repl_min"
        else:  # "auto": replication-aware only if it moves strictly less data
            mk_lpt = schedule.makespan_of(est_sizes, lpt_assign, P)
            mk_rep = schedule.makespan_of(est_sizes, repl.assignment, P)
            take_repl = repl.volume < lpt_volume and (
                mk_rep <= params.makespan_slack * max(mk_lpt, 1.0)
            )
            assignment, used = (
                (repl.assignment, "repl_min") if take_repl else (lpt_assign, "lpt")
            )
    est_loads = schedule.loads_of(est_sizes, assignment, P)

    ancestor_masks, anc_list = pbec.ancestor_closure(classes, n_items)
    item_rel = (
        bm.extension_supports(sample_bitdb.item_bits, sample_bitdb.all_tids())
        .cpu().numpy().astype(np.float64) / n_db
    )
    return MiningPlan(
        n_items=n_items,
        n_tx=n_tx,
        P=P,
        abs_minsup=abs_minsup,
        classes=classes,
        est_sizes=est_sizes,
        assignment=np.asarray(assignment),
        est_loads=est_loads,
        scheduler_used=used,
        lpt_volume=lpt_volume,
        repl_volume=repl_volume,
        sample_masks=sample_masks,
        ancestor_masks=ancestor_masks,
        n_ancestors=len(anc_list),
        n_db_sample=n_db,
        n_fi_sample=n_fs,
        sample_item_rel=item_rel,
        eps_db_effective=eps_eff,
    )


def _gather_rows(coll: phases.Collectives, tx_shards: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global, shard order) of the database whose held shards
    are ``tx_shards``: each held shard fills the rows it owns, the rest are
    0, and the sum over the miners leaves every row exactly once."""
    _, T, IW = tx_shards.shape
    owner, row = idx // T, idx % T
    part = torch.zeros((len(coll.miners), idx.shape[0], IW), dtype=tx_shards.dtype,
                       device=tx_shards.device)
    for j, p in enumerate(coll.miners):
        mine = owner == p
        part[j, mine] = tx_shards[j][row[mine]]
    return coll.psum(part).to(tx_shards.dtype)


def _gather_store_rows(coll: phases.Collectives, store: TxStore, T: int,
                       idx: torch.Tensor) -> torch.Tensor:
    """:func:`_gather_rows` off disk: each held miner reads the rows ``idx``
    that fall in its shard (``[p·T, (p+1)·T)`` of the store) from the
    blocks holding them, and the sum over the miners leaves every row once."""
    owner = idx // T
    part = torch.zeros((len(coll.miners), idx.shape[0], store.n_words), dtype=torch.int32,
                       device=idx.device)
    for j, p in enumerate(coll.miners):
        mine = owner == p
        if bool(mine.any()):
            part[j, mine] = store_reader.sample_rows(store, idx[mine], device=idx.device)
    return coll.psum(part).to(torch.int32)


def pack_seeds(
    classes: List[pbec.PBEC],
    ids_per_shard: List[List[int]],
    n_items: int,
    width: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad per-miner class lists into ``[P, width, I]`` seed arrays.

    Returns ``(seed_prefix, seed_ext, seed_valid)``, the Phase-4 inputs.
    """
    P = len(ids_per_shard)
    seed_prefix = np.zeros((P, width, n_items), dtype=bool)
    seed_ext = np.zeros((P, width, n_items), dtype=bool)
    seed_valid = np.zeros((P, width), dtype=bool)
    for p, ids in enumerate(ids_per_shard):
        if len(ids) > width:
            raise ValueError(f"{len(ids)} classes exceed the seed width {width}")
        for j, cid in enumerate(ids):
            seed_prefix[p, j] = classes[cid].prefix
            seed_ext[p, j] = classes[cid].ext
            seed_valid[p, j] = True
    return seed_prefix, seed_ext, seed_valid
