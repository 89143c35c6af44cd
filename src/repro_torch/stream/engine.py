"""StreamingMiner — keep the serving layer fresh against a live stream.

The port of the JAX package's ``stream/engine.py``.  It runs the loop the
subsystem exists for::

    admit block ─→ delta-support update (kernel B5) ─→ drift check ─→ (on
        trigger) full re-mine of the window ─→ build standby indexes ─→
        atomic hot-swap inside the QueryEngine (generation bump + cache clear)

Between re-mines the serving indexes are immutable, while a host-side
support vector tracks the *exact* current window supports of every indexed
itemset through the ``[2, F]`` arrive/expire sweep (``ops.delta_supports``).
That vector feeds the monitor's border signal and the staleness report.
With ``StreamParams.spill_dir`` set, every evicted block is appended to a
store there (:class:`~repro_torch.stream.window.WindowSpill`), the stream's
history.  The loop's spans are the reference's: ``stream/drift`` (an
instant when a drift check fires), ``stream/remine`` and ``stream/swap``.

Re-mining is pluggable: ``mine_fn(window, abs_minsup) -> {frozenset: supp}``
defaults to the port's Parallel-FIMI pipeline over the window
(:func:`fimi_mine_fn`); tests inject the brute-force oracle.  The events,
the drift verdicts and the generations equal the reference's on one stream:
the monitor draws its sample with numpy's generator, every FITable is exact,
and the window's ring order and the cooldown and check counters are the
reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, fimi
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.cache import QueryCache
from repro_torch.serve.engine import QueryEngine
from repro_torch.serve.index import build_indexes
from repro_torch.stream.monitor import DriftMonitor, DriftVerdict
from repro_torch.stream.window import SlidingWindow, WindowSpill

MineFn = Callable[[SlidingWindow, int], Dict[frozenset, int]]


@dataclasses.dataclass(frozen=True)
class StreamParams:
    """Knobs of the streaming subsystem (window ∪ monitor ∪ serving)."""

    n_blocks: int = 8               # ring length B (window = B·block_tx tx)
    block_tx: int = 256             # transactions per stream block
    min_support_rel: float = 0.1
    min_confidence: float = 0.6
    eps: float = 0.1                # staleness tolerance ε (monitor)
    delta: float = 0.05             # confidence 1−δ (Thm 6.1)
    border_margin: float = 0.0      # exact border tracking width (0 = off)
    border_hysteresis: float = 0.0  # crossing must clear minsup by this much
    check_every: int = 1            # drift-check cadence in blocks
    cooldown_blocks: int = 0        # suppress triggers this long after a mine
    batch: int = 256                # QueryEngine dispatch width
    top_k: int = 5
    cache_capacity: int = 2048
    spill_dir: Optional[str] = None  # persist expired blocks to a TxStore
    seed: int = 0


@dataclasses.dataclass
class AdmitEvent:
    """What one :meth:`StreamingMiner.admit` did (observable by the launcher)."""

    block_index: int
    expired: bool                   # an old block left the window
    delta_applied: bool             # supports updated in place
    verdict: Optional[DriftVerdict]
    remined: bool
    remine_reason: Optional[str]    # "initial" | "error" | "border" | "recovery"
    mine_ms: float = 0.0            # re-mine + standby index build
    swap_ms: float = 0.0            # the atomic publish itself
    generation: int = 0


@dataclasses.dataclass
class StreamStats:
    blocks_in: int = 0
    tx_in: int = 0
    remines: int = 0
    drift_checks: int = 0
    fired_error: int = 0
    fired_border: int = 0
    fired_recovery: int = 0   # re-mines forced by an empty mined table
    mine_ms: List[float] = dataclasses.field(default_factory=list)
    swap_ms: List[float] = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "blocks_in": self.blocks_in,
            "tx_in": self.tx_in,
            "remines": self.remines,
            "drift_checks": self.drift_checks,
            "fired_error": self.fired_error,
            "fired_border": self.fired_border,
            "fired_recovery": self.fired_recovery,
            "mine_ms_mean": float(np.mean(self.mine_ms)) if self.mine_ms else 0.0,
            "swap_ms_max": float(np.max(self.swap_ms)) if self.swap_ms else 0.0,
        }


def fimi_mine_fn(P: int = 4, fimi_params=None, seed: int = 0) -> MineFn:
    """Default re-miner: the port's Parallel-FIMI pipeline over the window.

    Shards the window's rows over ``P`` miners on the window's device and
    runs ``core.fimi.run`` with ``materialize=True``.  ``fimi_params``
    overrides everything except ``min_support_rel``, which is always derived
    from the trigger's absolute minsup.
    """
    def mine(window: SlidingWindow, abs_minsup: int) -> Dict[frozenset, int]:
        n_tx = window.n_tx
        if n_tx % P:
            raise ValueError(f"window size {n_tx} not divisible by P={P}")
        shards = window.rows().reshape(P, n_tx // P, window.n_words)
        base = fimi_params or fimi.FimiParams(
            n_db_sample=min(1024, n_tx),
            n_fi_sample=512,
            eclat=eclat.EclatConfig(max_out=1 << 14, max_stack=4096, frontier_size=16),
        )
        # (abs−0.5)/n_tx survives the float round-trip: fimi.run's
        # ceil(rel·n_tx) lands exactly on abs_minsup, whereas abs/n_tx can
        # ceil to abs+1 and silently drop itemsets at exactly abs_minsup
        params = dataclasses.replace(base, min_support_rel=(abs_minsup - 0.5) / n_tx)
        res = fimi.run(shards, window.n_items, params, seed=seed, device=window.device,
                       materialize=True)
        return res.fi_dict

    return mine


class StreamingMiner:
    """The streaming control loop: window + monitor + serving engine.

    Life cycle: admit blocks; once the window first fills, mine it and bring
    the :class:`~repro_torch.serve.engine.QueryEngine` up (generation 0).
    Every later admit evicts the oldest block, applies the arrive/expire
    support delta, and (on the configured cadence) runs the drift check; a
    trigger re-mines the *current* window into standby indexes and hot-swaps
    them in.  ``engine`` is None until the first mine completes.  Everything
    lives on ``device`` (CUDA unless the caller names another).
    """

    def __init__(
        self,
        params: StreamParams,
        n_items: int,
        *,
        mine_fn: Optional[MineFn] = None,
        device=None,
    ):
        self.params = params
        self.n_items = n_items
        self.device = device_mod.resolve(device)
        self.window = SlidingWindow.empty(params.n_blocks, params.block_tx, n_items,
                                          self.device)
        self.monitor = DriftMonitor(
            params.n_blocks,
            params.block_tx,
            eps=params.eps,
            delta=params.delta,
            border_margin=params.border_margin,
            border_hysteresis=params.border_hysteresis,
            seed=params.seed,
        )
        self.mine_fn = mine_fn or fimi_mine_fn(seed=params.seed)
        # store-backed spill: evicted blocks persist as the stream's history
        self.spill: Optional[WindowSpill] = (
            WindowSpill(params.spill_dir, params.block_tx, n_items)
            if params.spill_dir
            else None
        )
        self.cache = QueryCache(capacity=params.cache_capacity)
        self.engine: Optional[QueryEngine] = None
        self.current_supports: Optional[np.ndarray] = None  # int64[F], exact
        self.stats = StreamStats()
        self._since_check = 0
        self._since_remine = 0

    # -- views ----------------------------------------------------------------
    @property
    def abs_minsup(self) -> int:
        return int(np.ceil(self.params.min_support_rel * self.window.n_tx))

    def _index_masks(self) -> torch.Tensor:
        """Valid rows of the serving FI mask slab (drops shape padding)."""
        idx = self.engine.index
        return idx.masks[: idx.n_fis]

    def served_rel_supports(self) -> np.ndarray:
        """float64[F] — what the serving index claims (mine-time snapshot)."""
        idx = self.engine.index
        return idx.supports[: idx.n_fis].cpu().numpy().astype(np.float64) / idx.n_tx

    def current_rel_supports(self) -> np.ndarray:
        """float64[F] — exact delta-maintained window supports, relative."""
        return self.current_supports.astype(np.float64) / self.window.n_tx

    def exact_window_supports(self) -> np.ndarray:
        """int64[F] — offline oracle: full recompute over the whole window.

        O(window) work — the per-block cost the delta sweep avoids; used for
        staleness reporting and invariants.
        """
        counts = ops.block_itemset_supports(self.window.stacked(), self._index_masks())
        return counts.sum(dim=0, dtype=torch.int64).cpu().numpy()

    def staleness(self, exact: Optional[np.ndarray] = None) -> float:
        """max |served_rel − true current rel support| over indexed FIs.

        ``exact`` is :meth:`exact_window_supports` if the caller has it.
        """
        if self.engine is None or self.engine.index.n_fis == 0:
            return 0.0
        if exact is None:
            exact = self.exact_window_supports()
        true_rel = exact.astype(np.float64) / self.window.n_tx
        return float(np.abs(self.served_rel_supports() - true_rel).max())

    # -- the control loop ------------------------------------------------------
    def _packed(self, block) -> torch.Tensor:
        """A block as int32 words ``[T, IW]`` on the device: packed words
        (uint32 numpy, or an int32 tensor) keep their bits, a dense bool
        block is packed."""
        if isinstance(block, torch.Tensor) and block.dtype == torch.int32:
            return block.to(self.device)
        block = np.asarray(block)
        if block.dtype == np.uint32:
            return bm.from_reference(block).to(self.device)
        return bm.pack_bool(torch.from_numpy(block.astype(bool)).to(self.device))

    def admit(self, block) -> AdmitEvent:
        """Ingest one stream block (dense bool [T, I] or packed words [T, IW])."""
        arrive = self._packed(block)
        expired = self.window.admit(arrive)
        if expired is not None and self.spill is not None:
            self.spill.append(expired)
        self.monitor.admit(arrive)
        self.stats.blocks_in += 1
        self.stats.tx_in += self.window.block_tx
        reg = obs_metrics.registry()
        reg.counter("stream/blocks_in").inc()
        reg.counter("stream/tx_in").inc(self.window.block_tx)
        ev = AdmitEvent(
            block_index=self.stats.blocks_in - 1,
            expired=expired is not None,
            delta_applied=False,
            verdict=None,
            remined=False,
            remine_reason=None,
        )

        if self.engine is None:
            if self.window.full:
                self._remine("initial", ev)
            return self._stamp(ev)

        # steady state: engine exists ⇒ the window was full ⇒ every admit evicts
        F = self.engine.index.n_fis
        if F:
            counts = ops.delta_supports(arrive, expired, self._index_masks())
            counts = counts.cpu().numpy().astype(np.int64)
            self.current_supports += counts[0] - counts[1]
            ev.delta_applied = True
            reg.counter("stream/delta_updates").inc()

        # drift-triggered re-mining is rate-limited: during a drift washout
        # the window keeps changing for B blocks, and re-mining every one of
        # them buys little freshness for full mining cost.
        self._since_remine += 1
        if self._since_remine <= self.params.cooldown_blocks:
            return self._stamp(ev)

        self._since_check += 1
        if self._since_check >= self.params.check_every:
            self._since_check = 0
            if F == 0:
                # an empty mined table has nothing to monitor but must not
                # wedge the loop: re-mine until the stream yields FIs again
                self.stats.fired_recovery += 1
                self._remine("recovery", ev)
                return self._stamp(ev)
            self.stats.drift_checks += 1
            reg.counter("stream/drift_checks").inc()
            ev.verdict = self.monitor.check(
                self._index_masks(), current_rel=self.current_rel_supports()
            )
            if ev.verdict.fired:
                if ev.verdict.reason == "border":
                    self.stats.fired_border += 1
                else:
                    self.stats.fired_error += 1
                reg.counter(f"stream/fired_{ev.verdict.reason}").inc()
                obs_trace.TRACER.instant(
                    "stream/drift",
                    reason=ev.verdict.reason,
                    block=ev.block_index,
                )
                self._remine(ev.verdict.reason, ev)
        return self._stamp(ev)

    def _stamp(self, ev: AdmitEvent) -> AdmitEvent:
        ev.generation = self.engine.generation if self.engine else -1
        return ev

    def _remine(self, reason: str, ev: AdmitEvent) -> None:
        """Mine the current window, build standby indexes, hot-swap."""
        t0 = time.perf_counter()
        with obs_trace.TRACER.span("stream/remine", reason=reason,
                                   block=ev.block_index):
            fis = self.mine_fn(self.window, self.abs_minsup)
            fi_idx, rule_idx = build_indexes(
                fis, self.n_items, self.window.n_tx,
                min_confidence=self.params.min_confidence, device=self.device,
            )
            # the standby pair is complete on the device before it is live
            device_mod.synchronize(self.device)
        ev.mine_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        with obs_trace.TRACER.span("stream/swap", reason=reason):
            if self.engine is None:
                self.engine = QueryEngine(
                    fi_idx, rule_idx, batch=self.params.batch,
                    top_k=self.params.top_k, cache=self.cache,
                )
            else:
                self.engine.swap_indexes(fi_idx, rule_idx)
        ev.swap_ms = (time.perf_counter() - t0) * 1e3
        reg = obs_metrics.registry()
        reg.counter("stream/remines").inc()
        reg.histogram("stream/mine_ms").record(ev.mine_ms)
        reg.histogram("stream/swap_ms").record(ev.swap_ms)

        F = fi_idx.n_fis
        self.current_supports = fi_idx.supports[:F].cpu().numpy().astype(np.int64)
        self.monitor.rearm(self.served_rel_supports(), self.params.min_support_rel)
        self.stats.remines += 1
        self.stats.mine_ms.append(ev.mine_ms)
        self.stats.swap_ms.append(ev.swap_ms)
        ev.remined = True
        ev.remine_reason = reason
        self._since_check = 0
        self._since_remine = 0
