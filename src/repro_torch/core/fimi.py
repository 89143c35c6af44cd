"""Parallel-FIMI entry point: Methods 1–3 of the thesis (§8.5).

``run`` executes the four phases over P miners, all stacked on one device
(:class:`~repro_torch.core.phases.LocalCollectives`, the default) or one a
rank of a ``torch.distributed`` group
(:class:`~repro_torch.core.phases.DistCollectives`, set up by
``launch/ranks.py``):

  1. all-gathered DB sample D̃, then the FI sample F̃s by one of three
     Phase-1 methods (``FimiParams.variant``):
       * ``seq`` (Method 1, Parallel-FIMI-Seq, Alg. 12): one miner mines the
         candidates on MFIs of D̃, keeps the maximal ones (M̃) and
         coverage-samples them;
       * ``par`` (Method 2, Parallel-FIMI-Par, Alg. 13): each miner mines the
         MFI candidates of its 1-prefix classes, and their union M is
         coverage-sampled;
       * ``reservoir`` (Method 3, Alg. 14, the default): each miner runs
         Eclat over its classes with an in-loop reservoir, and the P
         reservoirs are merged hypergeometrically;
  2. PBEC partition and LPT (or DB-Repl-Min) schedule, on the host;
  3. ``all_to_all`` exchange of the transactions each miner's classes need;
  4. frontier-batched Eclat over each miner's slab, plus the ancestor side
     channel.

The sample only steers the partition: Phase 4 always mines the whole
database, so the FITable is exact for any sample and any seed.

``run`` also mines a :class:`~repro_torch.store.store.TxStore` out of core:
the shards are assembled on the card block by block through the
double-buffered :class:`~repro_torch.store.reader.BlockReader` (span
``fimi/assemble_store``, ``phase_s["assemble_store"]``), and then exactly
the dense path runs.

Observability as in the reference: a span per phase (``fimi/phase1_sample``,
``fimi/phase2_partition``, ``fimi/phase3_exchange``, ``fimi/phase4_mine``)
that covers the device's time while tracing, a progress estimate around
Phase 4 (``FimiResult.progress``), and the ``fimi/*`` run metrics.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, mfi, pbec, phases, sampling, schedule
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import progress as obs_progress
from repro_torch.obs import trace as obs_trace
from repro_torch.store import reader as store_reader
from repro_torch.store.store import TxStore


@dataclasses.dataclass(frozen=True)
class FimiParams:
    """User-facing knobs (thesis Ch. 8 inputs)."""

    variant: str = "reservoir"          # "seq" | "par" | "reservoir"
    min_support_rel: float = 0.1        # min_support*
    eps_db: float = 0.05                # ε_D̃   (Thm 6.1)
    delta_db: float = 0.1               # δ_D̃
    eps_fs: float = 0.05                # ε_F̃s  (Thm 6.2/6.3)
    delta_fs: float = 0.1               # δ_F̃s
    rho: float = 0.01                   # smallest-PBEC relative size
    alpha: float = 0.5                  # Phase-2 granularity
    n_db_sample: Optional[int] = None   # override |D̃| (else from ε,δ)
    n_fi_sample: Optional[int] = None   # override |F̃s|
    scheduler: str = "lpt"              # "lpt" | "repl_min"
    exchange_capacity: Optional[int] = None  # Phase-3 per-(src,dst) row cap
    max_classes: int = 512
    eclat: eclat.EclatConfig = eclat.EclatConfig(max_out=8192, max_stack=2048)
    mfi: mfi.MFIConfig = mfi.MFIConfig(max_out=2048, max_stack=2048)


# The torch generator stream of the coverage draws (the miners' Phase-1
# streams are 0..P-1)
COVERAGE_STREAM = 1 << 16


@dataclasses.dataclass
class FimiResult:
    sample_masks: np.ndarray            # bool [N, I] — F̃s
    classes: List[pbec.PBEC]
    assignment: np.ndarray              # int [C]
    est_loads: np.ndarray               # float [P] — estimated work shares
    replication: float                  # Phase-3 replication factor
    exchange_overflow: int
    phase4: List[eclat.EclatResult]     # per miner
    ancestor_masks: np.ndarray          # bool [A, I]
    ancestor_supports: np.ndarray       # int [A] — global supports
    n_fis: int                          # |F| (classes ∪ frequent ancestors)
    work_iters: np.ndarray              # int [P] — Phase-4 DFS trips per miner
    nodes_popped: np.ndarray            # int [P] — Phase-4 DFS nodes mined
    variant: str                        # the Phase-1 method
    phase1_iters: np.ndarray            # int [P] — Phase-1 DFS trips per miner
    phase1_overflow: np.ndarray         # int [P] — stack (and MFI output) drops
    mfi_count: np.ndarray               # int [P] — MFI candidates kept per miner
    n_mfi: int                          # |M| coverage-sampled (seq: |M̃|)
    phase4_overflow: np.ndarray         # int [P]
    phase_s: Dict[str, float]           # seconds per phase, device-synchronised
    launches: Dict[str, int]            # kernel launches of this run, by kernel
    fi_dict: Optional[Dict] = None      # materialized {frozenset: supp}
    progress: Optional[obs_progress.ProgressSnapshot] = None  # final snapshot
    backend: str = "local"              # "local" | "gloo" | "nccl" (ranks)


def run(
    tx_shards: torch.Tensor | TxStore,      # int32[P, T, IW], or a store
    n_items: Optional[int],
    params: FimiParams,
    *,
    seed: int = 0,
    device: str | torch.device | None = None,
    materialize: bool = False,
    sample_idx: Optional[torch.Tensor] = None,
    reservoir_draws: Optional[List[torch.Tensor]] = None,
    coverage_picks: Optional[torch.Tensor] = None,
    coverage_bits: Optional[torch.Tensor] = None,
    P: Optional[int] = None,
    host_budget_blocks: int = 2,
    reader: Optional[store_reader.BlockReader] = None,
    coll: Optional[phases.Collectives] = None,
) -> FimiResult:
    """Mine ``tx_shards`` through the four phases; ``device`` defaults to CUDA.

    ``coll`` is the miners' collectives, the counterpart of the reference's
    ``spmd=``/``mesh=``: ``LocalCollectives(P)`` (the default, P from
    ``tx_shards``) or a ``DistCollectives`` of one miner a rank, to which
    ``tx_shards`` may be the whole ``[P, T, IW]`` database (each rank keeps
    its own shard) or the rank's ``[1, T, IW]`` shard.  Phase 2 runs on the
    host of every rank alike, and every rank returns the same result.

    ``tx_shards`` may be a :class:`TxStore`: then ``P`` is required
    (``ValueError`` without it), ``n_items`` may be None, and the shards are
    assembled on the device through ``reader`` (a caller-owned
    :class:`~repro_torch.store.reader.BlockReader` on this store, whose
    ``peak_host_bytes`` the caller reads) or a new reader with
    ``host_budget_blocks``: bit-exact with ``shard_db(store.to_dense(), P)``,
    so everything after is the in-RAM path's.  Under a ``DistCollectives``
    each rank assembles its own shard alone, reading only the blocks that
    hold its rows.

    ``seed`` drives the torch generators of Phase 1 and of the coverage
    sampler, and seeds the numpy generator of the reservoir merge with
    ``seed & 0x7FFFFFFF``, which is what the reference derives from
    ``jax.random.PRNGKey(seed)``.  ``sample_idx`` (int[P, n_per_miner]),
    ``reservoir_draws`` (one int tensor per miner, the j of Algorithm R for
    the t-th FI at index t-1), ``coverage_picks`` (int[N]: the MFI each
    coverage draw takes) and ``coverage_bits`` (int32[N, IW]: its random
    words), with N = ``int(1.3·|F̃s|) + 8``, replace the Phase-1 draws, so a
    test can replay the reference's plan.
    """
    if params.variant not in ("seq", "par", "reservoir"):
        raise ValueError(f"unknown variant {params.variant!r}")
    dev = device_mod.resolve(device)
    tr = obs_trace.TRACER
    launched_before = ops.kernel_launches()
    phase_s: Dict[str, float] = {}
    if isinstance(tx_shards, TxStore):   # mine out of core
        if P is None:
            raise ValueError("P (miner count) is required when mining a TxStore")
        if n_items is None:
            n_items = tx_shards.n_items
        t0 = time.perf_counter()
        with tr.span("fimi/assemble_store", P=P):
            tx_shards = tr.sync(store_reader.to_device_shards(
                tx_shards, P, miners=coll.miners if coll is not None else None,
                host_budget_blocks=host_budget_blocks, reader=reader, device=dev,
            ))
        device_mod.synchronize(dev)
        phase_s["assemble_store"] = time.perf_counter() - t0
    tx_shards = tx_shards.to(dev)
    coll = coll if coll is not None else phases.LocalCollectives(tx_shards.shape[0])
    tx_shards = coll.local(tx_shards)
    _, T, IW = tx_shards.shape
    P = coll.P
    n_tx = P * T
    abs_minsup = int(np.ceil(params.min_support_rel * n_tx))

    n_db = params.n_db_sample or sampling.db_sample_size(params.eps_db, params.delta_db)
    n_db = min(n_db, n_tx)
    per_proc = max(1, n_db // P)
    n_fs = params.n_fi_sample or sampling.reservoir_sample_size(
        params.eps_fs, params.delta_fs, params.rho
    )

    def lap(name: str, t0: float) -> float:
        device_mod.synchronize(dev)
        t1 = time.perf_counter()
        phase_s[name] = t1 - t0
        return t1

    t0 = time.perf_counter()
    # ---------------- Phase 1 ------------------------------------------------
    variant_dev = {"seq": "sample", "par": "par", "reservoir": "reservoir"}[params.variant]
    with tr.span("fimi/phase1_sample", P=P, variant=params.variant):
        out1 = tr.sync(phases.phase1_device(
            tx_shards, params.min_support_rel, coll=coll, n_items=n_items,
            n_sample_per_proc=per_proc,
            reservoir_size=n_fs if params.variant == "reservoir" else 1,
            eclat_cfg=params.eclat, mfi_cfg=params.mfi, variant=variant_dev,
            generators=[device_mod.generator(dev, seed, p) for p in coll.miners],
            sample_idx=sample_idx, reservoir_draws=reservoir_draws,
        ))
    n_samp = out1.sample_db.shape[0]
    sample_bitdb = bm.rebuild_vertical(out1.sample_db, n_items, n_samp)
    phase1_iters, phase1_overflow = out1.n_iters.copy(), out1.overflow.copy()
    mfi_count = out1.mfi_count.copy()
    IW = bm.n_words(n_items)
    n_mfi = 0

    if params.variant == "reservoir":
        rng = np.random.default_rng(seed & 0x7FFFFFFF)
        f_counts = out1.fi_count
        X = sampling.merge_reservoirs(rng, f_counts, n_fs)
        res_items = out1.reservoir.cpu()
        picked = []
        for i in range(P):
            avail = int(min(f_counts[i], n_fs))
            if X[i] == 0 or avail == 0:
                continue
            sel = rng.choice(avail, size=int(min(X[i], avail)), replace=False)
            picked.append(res_items[i][torch.from_numpy(sel)])
        fs_packed = (torch.cat(picked) if picked
                     else torch.zeros((0, IW), dtype=torch.int32))
    else:
        if params.variant == "par":
            M = torch.cat([out1.mfi_items[p, : int(mfi_count[p])] for p in range(P)])
        else:  # "seq": miner 1 mines the MFIs of D̃ (Alg. 12)
            sample_minsup = int(np.ceil(params.min_support_rel * n_samp))
            r = mfi.mine_all_candidates(sample_bitdb, sample_minsup, config=params.mfi)
            valid = torch.arange(r.items.shape[0], device=dev) < r.n_out
            M = r.items[mfi.filter_maximal(r.items, valid)]
            phase1_iters[0], phase1_overflow[0], mfi_count[0] = r.n_iters, r.overflow, r.n_out
        n_mfi = int(M.shape[0])
        # a global pick m ∝ 2^|m|, the thesis' per-processor s_i/s split
        # (Alg. 13); oversampled, since ∅ and singletons are dropped below
        fs_packed = _coverage_sample_host(
            M, n_fs, n_items, device_mod.generator(dev, seed, COVERAGE_STREAM),
            coverage_picks, coverage_bits,
        ).cpu()
    sample_masks = bm.unpack_bool(fs_packed, n_items).numpy().reshape(-1, n_items)
    # the partitioner needs |W| ≥ 2, as the reservoir stream gives: the
    # singletons are the class prefixes, which Phase 4's side channel counts
    sample_masks = sample_masks[sample_masks.sum(axis=1) >= 2]
    t0 = lap("phase1", t0)

    # ---------------- Phase 2 ------------------------------------------------
    def ext_supports(prefix: np.ndarray) -> np.ndarray:
        tid = bm.tidlist_of_itemset(sample_bitdb, torch.from_numpy(prefix).to(dev))
        return bm.extension_supports(sample_bitdb.item_bits, tid).cpu().numpy()  # kernel B3

    with tr.span("fimi/phase2_partition", scheduler=params.scheduler):
        classes = pbec.partition(
            sample_masks, P, params.alpha, ext_supports, n_items,
            max_classes=params.max_classes,
        )
        sizes = np.array([c.est_count for c in classes], dtype=np.float64)
        if params.scheduler == "repl_min":
            tids = phases.seed_tidlists(
                sample_bitdb.item_bits,
                torch.from_numpy(np.stack([c.prefix for c in classes])).to(dev),
                sample_bitdb.all_tids(),
            )
            profit = schedule.pairwise_shared_transactions(tids)  # kernel B6
            assignment = schedule.db_repl_min(sizes, profit, P).assignment
        elif params.scheduler == "lpt":
            assignment = schedule.lpt_schedule(sizes, P)
        else:
            raise ValueError(f"unknown scheduler {params.scheduler!r}")
        est_loads = schedule.loads_of(sizes, assignment, P)
    t0 = lap("phase2", t0)

    # ---------------- Phase 3 ------------------------------------------------
    pref_packed, _ = pbec.classes_to_packed(classes)
    local_valid = torch.ones((len(coll.miners), T), dtype=torch.bool, device=dev)
    with tr.span("fimi/phase3_exchange", C=len(classes)):
        out3 = tr.sync(phases.phase3_exchange(
            tx_shards, local_valid, pref_packed, assignment, coll=coll,
            capacity=params.exchange_capacity or T,
        ))
    t0 = lap("phase3", t0)

    # ---------------- Phase 4 ------------------------------------------------
    Cmax = max(max(int((assignment == p).sum()) for p in range(P)), 1)
    seed_prefix = np.zeros((P, Cmax, n_items), dtype=bool)
    seed_ext = np.zeros((P, Cmax, n_items), dtype=bool)
    seed_valid = np.zeros((P, Cmax), dtype=bool)
    for p in range(P):
        for j, cid in enumerate(np.nonzero(assignment == p)[0]):
            seed_prefix[p, j] = classes[cid].prefix
            seed_ext[p, j] = classes[cid].ext
            seed_valid[p, j] = True
    held = coll.miners
    ancestor_masks, anc_list = pbec.ancestor_closure(classes, n_items)

    progress = obs_progress.ProgressEstimator(est_loads)
    progress.start()
    with tr.span("fimi/phase4_mine", Cmax=Cmax, A=ancestor_masks.shape[0]):
        out4 = tr.sync(phases.phase4_mine(
            out3.slab, out3.slab_valid, tx_shards, local_valid,
            torch.from_numpy(seed_prefix[held]).to(dev),
            torch.from_numpy(seed_ext[held]).to(dev),
            torch.from_numpy(seed_valid[held]).to(dev),
            torch.from_numpy(ancestor_masks).to(dev),
            abs_minsup, coll=coll, n_items=n_items, eclat_cfg=params.eclat,
        ))
    work_iters = np.array([r.n_iters for r in out4.results])
    # One-shot pipeline: the single update closes the progress record with
    # the trip-grounded straggler scores (Thm 6.1 estimate vs observation).
    final_progress = progress.update(est_loads, work_iters.astype(np.float64))
    progress.finish()
    anc_supports = out4.prefix_supports.cpu().numpy()
    anc_frequent = int((anc_supports[: len(anc_list)] >= abs_minsup).sum())
    n_fis = sum(r.n_total for r in out4.results) + anc_frequent
    lap("phase4", t0)

    result = FimiResult(
        sample_masks=sample_masks,
        classes=classes,
        assignment=assignment,
        est_loads=est_loads,
        replication=out3.replication,
        exchange_overflow=out3.overflow,
        phase4=out4.results,
        ancestor_masks=ancestor_masks[: len(anc_list)],
        ancestor_supports=anc_supports[: len(anc_list)],
        n_fis=n_fis,
        work_iters=work_iters,
        nodes_popped=np.array([r.n_popped for r in out4.results]),
        variant=params.variant,
        phase1_iters=phase1_iters,
        phase1_overflow=phase1_overflow,
        mfi_count=mfi_count,
        n_mfi=n_mfi,
        phase4_overflow=np.array([r.stack_overflow for r in out4.results]),
        phase_s=phase_s,
        launches=coll.sum_counts(
            {k: n - launched_before[k] for k, n in ops.kernel_launches().items()}),
        progress=final_progress,
        backend=coll.backend,
    )
    _emit_run_metrics(result, params, P)
    if materialize:
        result.fi_dict = materialize_fis(result, n_items, abs_minsup)
    return result


def _emit_run_metrics(result: FimiResult, params: FimiParams, P: int) -> None:
    """Publish one pipeline pass into the process-global metrics registry,
    with the reference's names and values: per-shard estimated load beside
    the observed Phase-4 DFS trips, their largest share gap, and the frontier
    occupancy (nodes popped per trip slot) as a histogram."""
    reg = obs_metrics.registry()
    trips = result.work_iters.astype(np.float64).reshape(-1)
    est = result.est_loads.astype(np.float64).reshape(-1)
    reg.counter("fimi/runs").inc()
    reg.counter("fimi/trips").inc(int(trips.sum()))
    reg.counter("fimi/exchange_overflow").inc(result.exchange_overflow)
    reg.gauge("fimi/n_fis").set(float(result.n_fis))
    reg.gauge("fimi/n_classes").set(float(len(result.classes)))
    reg.gauge("fimi/replication").set(float(result.replication))
    est_share = est / est.sum() if est.sum() > 0 else np.full(P, 1.0 / P)
    obs_share = trips / trips.sum() if trips.sum() > 0 else np.full(P, 1.0 / P)
    reg.gauge("fimi/load/estimation_error").set(
        float(np.abs(est_share - obs_share).max())
    )
    occ = reg.histogram("fimi/frontier_occupancy")
    K = max(1, int(params.eclat.frontier_size))
    popped = result.nodes_popped.astype(np.float64).reshape(-1)
    for p in range(P):
        reg.gauge(f"fimi/shard{p}/est_load").set(float(est[p]))
        reg.gauge(f"fimi/shard{p}/obs_trips").set(float(trips[p]))
        if trips[p] > 0:
            occ.record(float(popped[p]) / (trips[p] * K))


def _coverage_sample_host(
    M: torch.Tensor, n_fs: int, n_items: int, generator: torch.Generator,
    picks: Optional[torch.Tensor] = None, bits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``int(1.3·n_fs) + 8`` coverage draws from the MFI masks ``M``
    (int32[|M|, IW]), or none when M is empty."""
    if len(M) == 0:
        return torch.zeros((0, bm.n_words(n_items)), dtype=torch.int32, device=M.device)
    valid = torch.ones((len(M),), dtype=torch.bool, device=M.device)
    return sampling.modified_coverage_sample(
        M, valid, int(n_fs * 1.3) + 8, n_items,
        generator=generator, picks=picks, bits=bits,
    )


def materialize_fis(result: FimiResult, n_items: int, abs_minsup: int) -> Dict:
    """Collect the distributed result into ``{frozenset: support}``."""
    out: Dict = {}
    for r in result.phase4:
        out.update(eclat.result_fis(r, n_items))
    for mask, s in zip(result.ancestor_masks, result.ancestor_supports):
        if s >= abs_minsup:
            out[frozenset(np.nonzero(mask)[0].tolist())] = int(s)
    return out


def fitable_digest(fis: Dict[frozenset, int]) -> str:
    """SHA-256 of a FITable ``{frozenset: support}``, one line an itemset
    (its items ascending, then its support) in sorted order: equal tables,
    equal digests, whichever process or backend mined them."""
    lines = sorted(",".join(map(str, sorted(s))) + f":{v}" for s, v in fis.items())
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def shard_db(db_dense: np.ndarray, P: int, device: str | torch.device | None = None,
             miners: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Split a dense bool DB row-wise into P packed shards ``int32[P, T, IW]``
    on ``device`` (CUDA unless the caller names another); the last
    ``n_tx mod P`` rows are dropped, as in the reference.  With ``miners``
    only those shards go to the device, ``int32[len(miners), T, IW]``: a
    rank passes its collectives' ``miners`` and holds its own shard alone."""
    dev = device_mod.resolve(device)
    n_tx, n_items = db_dense.shape
    T = n_tx // P
    rows = db_dense[: T * P].reshape(P, T, n_items)
    if miners is not None:
        rows = rows[list(miners)]
    return bm.pack_bool(torch.from_numpy(np.ascontiguousarray(rows)).to(dev))
