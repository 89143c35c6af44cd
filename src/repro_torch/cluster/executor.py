"""Distributed mining executor: Phase-3 exchange + Phase-4 mining in rounds.

Takes a packed transaction DB sharded over P miners and runs the paper's
pipeline end to end::

    plan (host, sample-based)                                  planner.py
      └─► per-miner class queues
    round r = 0, 1, …                                          this module
      ├─ Phase 3: all_to_all exchange of the transactions the
      │           round's classes need (fixed-capacity slabs)  core/phases.py
      ├─ Phase 4: frontier-batched Eclat per miner, its sweeps
      │           through kernel B1, or B2 with use_mxu        core/eclat.py
      └─ rebalance: telemetry-driven donation of queued PBEC
                    subtrees between miner queues              rebalance.py
    merge: all miners' FI buffers + frequent ancestors ──► one FITable

The P miners run through :class:`~repro_torch.core.phases.LocalCollectives`
on one device (backend ``local``, the counterpart of the JAX package's
``vmap``) or through :class:`~repro_torch.core.phases.DistCollectives`, one
miner a rank of a ``torch.distributed`` group (backend ``gloo`` or ``nccl``,
the counterpart of ``shard_map``; ``launch/ranks.py`` sets it up).  Under
ranks every rank plans alike, exchanges and mines its own miner, and gathers
each round's trips and FIs, so the queues, the rebalancing and the result are
the same on every rank.  The JAX package pads each round's class table to
``P·chunk`` rows so that its phases compile once; PyTorch compiles nothing,
so a round passes its real classes, and the exchange, the replication, the
trips and the FITable are the same.  Donating a class re-runs the Phase-3
exchange for the round that mines it, so the result stays exact however
many donations are made.

:func:`cluster_mine_fn` makes the executor the streaming miner's re-miner.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.cluster import checkpoint as checkpoint_mod
from repro_torch.cluster import planner as planner_mod
from repro_torch.cluster import rebalance as rebalance_mod
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, phases
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import progress as obs_progress
from repro_torch.obs import speedup as speedup_mod
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    """Executor knobs on top of the planner's."""

    planner: planner_mod.PlannerParams = planner_mod.PlannerParams()
    eclat: eclat.EclatConfig = eclat.EclatConfig(
        max_out=1 << 14, max_stack=4096, frontier_size=16
    )
    exchange_capacity: Optional[int] = None  # Phase-3 per-(src,dst) row cap
    chunk: Optional[int] = None     # classes per miner per round (None: auto)
    rebalance: bool = True          # telemetry-driven queue donation
    skew_threshold: float = 1.25    # rebalance when max/mean exceeds this
    max_donations: int = 8          # bounded moves per inter-round pass
    max_rounds: int = 128           # hard bound on mining rounds
    target_rounds: int = 4          # auto-chunk aims for this many rounds
    use_mxu: bool = False           # Phase 4 on the tensor-core kernel B2
    strict: bool = True             # raise on any overflow (exactness guard)


@dataclasses.dataclass(frozen=True)
class FITable:
    """The merged global mining result: one table, every miner's FIs.

    Supports are exact full-database counts: Phase 4 mines each class on the
    slab of all transactions containing its prefix (thesis Prop. 8.1).
    """

    masks: np.ndarray       # uint32 [F, IW] packed itemset masks
    supports: np.ndarray    # int64 [F]
    n_items: int
    n_tx: int

    @property
    def n_fis(self) -> int:
        return int(self.masks.shape[0])

    def to_dict(self) -> Dict[frozenset, int]:
        """Materialize as ``{frozenset(items): support}``."""
        bits = np.unpackbits(
            np.ascontiguousarray(self.masks, dtype=np.uint32).view(np.uint8),
            axis=1, bitorder="little",
        )[:, : self.n_items].astype(bool)
        out = {frozenset(np.flatnonzero(row).tolist()): int(s)
               for row, s in zip(bits, self.supports)}
        if len(out) != self.n_fis:
            raise ValueError("duplicate itemsets in the merged FITable")
        return out


@dataclasses.dataclass
class RoundStats:
    """Telemetry of one mining round."""

    round_index: int
    classes_mined: List[int]        # per miner
    work_iters: np.ndarray          # int [P] — DFS trips (the load metric)
    est_mined: np.ndarray           # float [P] — planner units mined
    replication: float              # Phase-3 Σ|D'_i| / |D| for this round
    donations: List[rebalance_mod.Donation]
    mine_ms: float = 0.0            # this round's mine-phase wall (host)


@dataclasses.dataclass
class ClusterReport:
    """What the executor observed, for the launcher to print."""

    P: int
    backend: str                    # "local" (one device) | "gloo" | "nccl" (ranks)
    rounds: List[RoundStats]
    phase_ms: Dict[str, float]      # plan / exchange / mine / merge
    est_loads: np.ndarray           # float [P] — planner prediction
    observed_loads: np.ndarray      # float [P] — cumulative DFS trips
    donations: List[rebalance_mod.Donation]
    exchange_overflow: int
    mine_overflow: int

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def imbalance(self) -> float:
        """max/mean of observed per-miner load (1.0 = perfect)."""
        mean = float(self.observed_loads.mean())
        return float(self.observed_loads.max()) / mean if mean > 0 else 1.0

    @property
    def makespan_trips(self) -> float:
        """Modeled makespan: Σ_r max_p trips(r, p) — rounds are barriers."""
        return float(sum(float(np.max(r.work_iters)) for r in self.rounds))

    def estimation_error(self) -> float:
        """``max_p |est_share_p − obs_share_p|``: the planner is judged on the
        distribution it balanced (estimates are in sample-FI units,
        observations in DFS trips)."""
        est, obs = self.est_loads.astype(float), self.observed_loads.astype(float)
        if est.sum() <= 0 or obs.sum() <= 0:
            return 0.0
        return float(np.abs(est / est.sum() - obs / obs.sum()).max())

    def snapshot(self) -> Dict[str, dict]:
        """The report as ``{"counters": …, "gauges": …, "histograms": …}``
        under the JAX package's ``cluster/*`` names, with the speedup
        waterfall's ``speedup/*`` gauges (:mod:`repro_torch.obs.speedup`)."""
        counters = {
            "cluster/donations": len(self.donations),
            "cluster/exchange_overflow": int(self.exchange_overflow),
            "cluster/mine_overflow": int(self.mine_overflow),
            "cluster/rounds": self.n_rounds,
        }
        gauges = {
            "cluster/imbalance": self.imbalance,
            "cluster/makespan_trips": self.makespan_trips,
            "cluster/load/estimation_error": self.estimation_error(),
        }
        for phase, ms in self.phase_ms.items():
            gauges[f"cluster/phase_ms/{phase}"] = float(ms)
        for p in range(self.P):
            gauges[f"cluster/shard{p}/est_load"] = float(self.est_loads[p])
            gauges[f"cluster/shard{p}/obs_load"] = float(self.observed_loads[p])
        for r in self.rounds:
            # per-round detail the speedup waterfall's compile term needs
            gauges[f"cluster/round{r.round_index}/mine_ms"] = float(r.mine_ms)
            gauges[f"cluster/round{r.round_index}/max_trips"] = _max_trips(r)
        hist = obs_metrics.Histogram("cluster/round_makespan_trips")
        for r in self.rounds:
            hist.record(_max_trips(r))
        # every record with cluster gauges also carries its own waterfall
        wf = speedup_mod.from_snapshot({"counters": counters, "gauges": gauges,
                                        "histograms": {}})
        if wf is not None:
            gauges.update(wf.gauges())
        return {"counters": counters, "gauges": gauges,
                "histograms": {hist.name: hist.summary()}}

    def emit(self, reg: Optional[obs_metrics.MetricsRegistry] = None) -> None:
        """Publish this report into the (default: global) metrics registry."""
        reg = reg if reg is not None else obs_metrics.registry()
        snap = self.snapshot()
        for name, v in snap["counters"].items():
            reg.counter(name).inc(int(v))
        for name, v in snap["gauges"].items():
            reg.gauge(name).set(float(v))
        h = reg.histogram("cluster/round_makespan_trips")
        for r in self.rounds:
            h.record(_max_trips(r))

    def republish_gauges(self, reg: Optional[obs_metrics.MetricsRegistry] = None) -> None:
        """Re-set the gauges alone (counters and the histogram would count
        twice).  A launcher calls this after back-patching ``phase_ms`` with
        work done outside :func:`execute` (off-disk planning, block-streamed
        assembly), so the waterfall charges it to ``host_tail``, not to the
        unexplained ``driver`` residual."""
        reg = reg if reg is not None else obs_metrics.registry()
        for name, v in self.snapshot()["gauges"].items():
            reg.gauge(name).set(float(v))


def _max_trips(r: RoundStats) -> float:
    return float(np.max(r.work_iters)) if len(r.work_iters) else 0.0


@dataclasses.dataclass
class ClusterResult:
    table: FITable
    plan: planner_mod.MiningPlan
    report: ClusterReport
    launches: Dict[str, int]        # kernel launches of this run, by kernel


def _chunk_width(params: ClusterParams, queues: List[List[int]]) -> int:
    """Classes per miner per round: a pure function of the plan."""
    maxlen = max((len(q) for q in queues), default=0)
    if params.chunk is not None:
        chunk = max(1, params.chunk)
    elif params.rebalance and maxlen > 1:
        chunk = max(1, -(-maxlen // max(params.target_rounds, 1)))
    else:
        chunk = max(1, maxlen)
    if chunk > params.eclat.max_stack:
        raise ValueError(f"chunk {chunk} exceeds the miner stack ({params.eclat.max_stack})")
    return chunk


def execute(
    tx_shards: torch.Tensor,   # int32[P, T, IW] — horizontal packed D_i shards
    n_items: int,
    params: ClusterParams,
    *,
    seed: int = 0,
    device: str | torch.device | None = None,
    plan: Optional[planner_mod.MiningPlan] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    round_hook: Optional[Callable[[int], None]] = None,
    sample_idx: Optional[torch.Tensor] = None,
    reservoir_draws: Optional[torch.Tensor] = None,
    progress_cb: Optional[Callable[[obs_progress.ProgressSnapshot], None]] = None,
    coll: Optional[phases.Collectives] = None,
) -> ClusterResult:
    """Run the distributed pipeline; returns table + plan + telemetry.

    ``device`` defaults to CUDA.  Without ``plan`` the planner runs first,
    from ``seed`` or from the injected ``sample_idx`` / ``reservoir_draws``
    (see :func:`planner.plan`).

    With ``checkpoint_dir`` set, the inter-round state is persisted
    atomically after every round; ``resume=True`` restores the latest
    checkpoint (plan-fingerprint guarded) and replays only the remaining
    rounds, bit-exact with an unbroken run: the chunk width comes from the
    plan and the donations from the restored ledger.  ``round_hook(r)`` is
    called after round ``r`` is checkpointed; a fault harness raises from it
    to simulate a death mid-run.

    ``progress_cb`` receives a live :class:`ProgressSnapshot` after every
    round, fed from the plan's estimated loads and each round's trips.
    ``coll`` is the miners' collectives (default ``LocalCollectives(P)``);
    under a ``DistCollectives`` ``tx_shards`` is the whole ``[P, T, IW]``
    database or the rank's shard, only rank 0 writes checkpoints, and every
    rank returns the same result.  The run ends by publishing its report
    into the metrics registry (:meth:`ClusterReport.emit`).
    """
    dev = device_mod.resolve(device)
    launched_before = ops.kernel_launches()
    tx_shards = tx_shards.to(dev)
    coll = coll if coll is not None else phases.LocalCollectives(tx_shards.shape[0])
    tx_shards = coll.local(tx_shards)
    _, T, IW = tx_shards.shape
    P, held = coll.P, coll.miners
    phase_ms = {"plan": 0.0, "exchange": 0.0, "mine": 0.0, "merge": 0.0}

    def since(t0: float) -> float:
        device_mod.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    tr = obs_trace.TRACER
    t0 = time.perf_counter()
    with tr.span("cluster/plan", P=P, backend=coll.backend):
        if plan is None:
            plan = planner_mod.plan(tx_shards, n_items, params.planner, seed=seed, device=dev,
                                    sample_idx=sample_idx, reservoir_draws=reservoir_draws,
                                    coll=coll)
        phase_ms["plan"] = since(t0)
    classes = plan.classes
    est_sizes = plan.est_sizes
    queues = plan.shard_queues()
    chunk = _chunk_width(params, queues)

    cap = params.exchange_capacity or T
    local_valid = torch.ones((len(held), T), dtype=torch.bool, device=dev)
    A = plan.ancestor_masks.shape[0]
    anc_masks = torch.from_numpy(np.asarray(plan.ancestor_masks, bool)).to(dev)
    multi_support_fn = partial(ops.multi_extension_supports, use_mxu=params.use_mxu)

    ledger = rebalance_mod.LoadLedger(P)
    rounds: List[RoundStats] = []
    donations: List[rebalance_mod.Donation] = []
    fi_masks: List[np.ndarray] = []
    fi_supports: List[np.ndarray] = []
    exchange_overflow = 0
    mine_overflow = 0
    anc_supports: Optional[np.ndarray] = None

    plan_hash = checkpoint_mod.plan_fingerprint(plan) if checkpoint_dir else ""
    r = 0
    if resume and checkpoint_dir:
        state = checkpoint_mod.load(checkpoint_dir, plan_hash=plan_hash)
        if state is not None:
            r = state.round_index
            queues = state.queues
            if state.fi_masks.shape[0]:
                fi_masks = [np.asarray(state.fi_masks, np.uint32)]
                fi_supports = [np.asarray(state.fi_supports, np.int64)]
            anc_supports = state.anc_supports
            ledger.observed[:] = state.observed
            ledger.est_mined[:] = state.est_mined
            exchange_overflow = state.exchange_overflow
            mine_overflow = state.mine_overflow
            rounds = list(state.rounds)
            donations = list(state.donations)

    progress = obs_progress.ProgressEstimator(plan.est_loads)
    progress.start()
    if r > 0:
        # resumed mid-run: credit the restored rounds as one bulk update
        progress.update(ledger.est_mined, ledger.observed)

    while any(queues) and r < params.max_rounds:
        take = [q[:chunk] for q in queues]
        queues = [q[chunk:] for q in queues]

        # ---- Phase 3: exchange the transactions of this round's classes ---
        round_ids = [cid for ids in take for cid in ids]
        class_assign = np.array([p for p, ids in enumerate(take) for _ in ids], np.int64)
        prefix_packed = bm.pack_bool(
            torch.from_numpy(np.stack([classes[c].prefix for c in round_ids]))
        )
        t0 = time.perf_counter()
        with tr.span("cluster/exchange", round=r, classes=len(round_ids)):
            out3 = phases.phase3_exchange(
                tx_shards, local_valid, prefix_packed, class_assign, coll=coll, capacity=cap,
            )
            phase_ms["exchange"] += since(t0)

        # ---- Phase 4: mine this round's classes on the received slabs -----
        seed_prefix, seed_ext, seed_valid = planner_mod.pack_seeds(
            classes, take, n_items, chunk
        )
        mine_t0 = time.perf_counter()
        with tr.span("cluster/mine", round=r, chunk=chunk):
            out4 = phases.phase4_mine(
                out3.slab, out3.slab_valid, tx_shards, local_valid,
                torch.from_numpy(seed_prefix[held]).to(dev),
                torch.from_numpy(seed_ext[held]).to(dev),
                torch.from_numpy(seed_valid[held]).to(dev),
                anc_masks, plan.abs_minsup, coll=coll, n_items=n_items,
                eclat_cfg=params.eclat, multi_support_fn=multi_support_fn,
            )
            for res in out4.results:
                if res.n_out:
                    fi_masks.append(bm.to_reference(res.items[: res.n_out]))
                    fi_supports.append(res.supports[: res.n_out].cpu().numpy().astype(np.int64))
            anc_supports = out4.prefix_supports.cpu().numpy().astype(np.int64)
            mine_ms = since(mine_t0)
        phase_ms["mine"] += mine_ms

        exchange_overflow += out3.overflow
        mine_overflow += sum(
            res.n_total - res.n_out + res.stack_overflow for res in out4.results
        )
        trips = np.array([res.n_iters for res in out4.results], dtype=np.float64)
        est_mined = np.array(
            [sum(max(float(est_sizes[c]), 1.0) for c in ids) for ids in take]
        )
        ledger.record_round(trips, est_mined)
        snap = progress.update(est_mined, trips)
        if progress_cb is not None:
            progress_cb(snap)
        if tr.enabled:
            # modeled per-miner lanes: the miners run a round between two
            # barriers, so miner p's lane is its trip share of the slowest
            # miner's; the gaps between the lanes are the round's imbalance
            t_max = max(float(trips.max()), 1.0)
            for p in range(P):
                tr.add_span("cluster/mine", mine_t0, mine_ms / 1e3 * float(trips[p]) / t_max,
                            track=f"shard{p}",
                            args={"round": r, "trips": int(trips[p]),
                                  "classes": len(take[p]), "est_mined": float(est_mined[p])})

        moved: List[rebalance_mod.Donation] = []
        if params.rebalance and any(queues):
            moved = rebalance_mod.rebalance(
                queues, est_sizes, ledger, round_index=r,
                skew_threshold=params.skew_threshold,
                max_donations=params.max_donations,
            )
            donations.extend(moved)
            for d in moved:
                tr.instant("cluster/donate", round=d.round_index, class_id=d.class_id,
                           src=d.src, dst=d.dst)
        rounds.append(RoundStats(
            round_index=r,
            classes_mined=[len(ids) for ids in take],
            work_iters=trips.astype(np.int64),
            est_mined=est_mined,
            replication=out3.replication,
            donations=moved,
            mine_ms=mine_ms,
        ))
        r += 1
        if checkpoint_dir and coll.rank == 0:
            checkpoint_mod.save(
                checkpoint_dir,
                checkpoint_mod.RoundState(
                    round_index=r,
                    queues=queues,
                    fi_masks=_concat(fi_masks, np.zeros((0, IW), np.uint32)),
                    fi_supports=_concat(fi_supports, np.zeros((0,), np.int64)),
                    anc_supports=anc_supports,
                    observed=ledger.observed,
                    est_mined=ledger.est_mined,
                    exchange_overflow=exchange_overflow,
                    mine_overflow=mine_overflow,
                    rounds=rounds,
                    donations=donations,
                ),
                plan_hash,
            )
        if round_hook is not None:
            round_hook(r - 1)
    if any(queues):
        raise RuntimeError(f"max_rounds={params.max_rounds} exhausted with classes still queued")
    progress.finish()

    if params.strict and (exchange_overflow or mine_overflow):
        raise RuntimeError(
            f"cluster executor overflow (exchange={exchange_overflow}, "
            f"mine={mine_overflow}): raise exchange_capacity / eclat.max_out "
            f"/ eclat.max_stack — the result would not be exact"
        )

    # ---- merge: one global table = all miners' FIs + frequent ancestors ---
    t0 = time.perf_counter()
    if anc_supports is None:  # no classes at all: no ancestor is counted
        anc_supports = np.zeros((A,), np.int64)
    anc_keep = np.zeros((A,), bool)
    anc_keep[: plan.n_ancestors] = anc_supports[: plan.n_ancestors] >= plan.abs_minsup
    if anc_keep.any():
        fi_masks.append(bm.to_reference(bm.pack_bool(torch.from_numpy(
            np.asarray(plan.ancestor_masks, bool)[anc_keep]))))
        fi_supports.append(anc_supports[anc_keep])
    table = FITable(
        masks=_concat(fi_masks, np.zeros((0, bm.n_words(n_items)), np.uint32)),
        supports=_concat(fi_supports, np.zeros((0,), np.int64)),
        n_items=n_items,
        n_tx=plan.n_tx,
    )
    phase_ms["merge"] = (time.perf_counter() - t0) * 1e3

    report = ClusterReport(
        P=P,
        backend=coll.backend,
        rounds=rounds,
        phase_ms=phase_ms,
        est_loads=plan.est_loads,
        observed_loads=ledger.observed.copy(),
        donations=donations,
        exchange_overflow=exchange_overflow,
        mine_overflow=mine_overflow,
    )
    report.emit()
    return ClusterResult(table=table, plan=plan, report=report,
                         launches=coll.sum_counts({k: n - launched_before[k]
                                                   for k, n in ops.kernel_launches().items()}))


def _concat(parts: List[np.ndarray], empty: np.ndarray) -> np.ndarray:
    return np.concatenate(parts, axis=0).astype(empty.dtype) if parts else empty


# ---------------------------------------------------------------------------
# StreamingMiner integration — the distributed re-miner
# ---------------------------------------------------------------------------


def cluster_mine_fn(
    P: int = 4,
    cluster_params: Optional[ClusterParams] = None,
    seed: int = 0,
) -> Callable:
    """A ``StreamingMiner.mine_fn`` that re-mines the window distributed.

    Shards the window's rows over the P miners on the window's device and
    runs the full planner → exchange → shard-mine → rebalance pipeline.
    ``cluster_params`` overrides everything except ``min_support_rel``,
    which is always derived from the trigger's absolute minsup.
    """

    def mine(window, abs_minsup: int) -> Dict[frozenset, int]:
        n_tx = window.n_tx
        if n_tx % P:
            raise ValueError(f"window size {n_tx} not divisible by P={P}")
        shards = window.rows().reshape(P, n_tx // P, window.n_words)
        base = cluster_params or ClusterParams(
            planner=planner_mod.PlannerParams(
                n_db_sample=min(1024, n_tx), n_fi_sample=512
            )
        )
        # (abs−0.5)/n_tx survives the float round-trip: the planner's
        # ceil(rel·n_tx) lands exactly on abs_minsup, whereas abs/n_tx can
        # ceil to abs+1 and silently drop itemsets at exactly abs_minsup
        params = dataclasses.replace(
            base,
            planner=dataclasses.replace(
                base.planner, min_support_rel=(abs_minsup - 0.5) / n_tx
            ),
        )
        res = execute(shards, window.n_items, params, seed=seed,
                      device=window.device)
        return res.table.to_dict()

    return mine
