"""Live mining progress/ETA from the paper's sample-based load estimates.

The port's copy of the JAX package's ``obs/progress.py``, with the same
behaviour.  Thm 6.1 of the source paper bounds how well a database sample
predicts each processor's mining load.  A :class:`ProgressEstimator` is
seeded with the planner's per-shard estimated loads and fed observed
completions as mining proceeds; it answers how far along the run is, when it
will finish, and which shard drags the barrier.

ETA math (barrier-aware): per shard ``p`` with estimated total ``E_p``,
completed ``D_p`` and observed rate ``r_p`` (units/s),

    eta = max_p (E_p − D_p) / r_p

the projected finish of the slowest remaining shard.  Once a second update
exists, the first inter-update interval (which holds the warm-up) is dropped
from every shard's rate window: ``r_p = (D_p − D_p¹) / (t − t¹)``.

Straggler score ``s_p``: shard ``p``'s observed cost per estimated unit
(trips per unit when trip telemetry is supplied, seconds per unit
otherwise), normalized by the fleet mean; ``s_p > 1`` flags a shard slower
than the sample predicted.

Outputs: gauges (``progress/{frac, eta_s, elapsed_s, round}``,
``progress/shard<p>/straggler``), a Perfetto counter track
(``Tracer.counter``), a one-line live string for the launchers, and a
post-run midpoint ETA error (``progress/eta_rel_err_mid``).

Stdlib-only and clock-injectable (the ETA tests run on a fake clock).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class ProgressSnapshot:
    """One observation of run progress."""

    frac: float                     # completed fraction of estimated work
    elapsed_s: float                # since start()
    eta_s: Optional[float]          # None until a rate exists
    rate: float                     # fleet units/s over the rate window
    round: int                      # updates observed so far
    stragglers: List[float]         # per-shard score (1.0 = as modeled)

    def line(self) -> str:
        """The launchers' live status line."""
        eta = f"{self.eta_s:6.1f}s" if self.eta_s is not None else "   ?  "
        worst = max(self.stragglers) if self.stragglers else 1.0
        return (
            f"progress {100.0 * self.frac:5.1f}%  eta {eta}  "
            f"elapsed {self.elapsed_s:6.1f}s  round {self.round}  "
            f"worst-straggler {worst:.2f}x"
        )


class ProgressEstimator:
    """Turn per-shard load estimates + observed completions into ETA."""

    def __init__(
        self,
        est_loads: Sequence[float],
        *,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        tracer: Optional[obs_trace.Tracer] = None,
        publish: bool = True,
    ):
        self._est = [max(float(e), 1.0) for e in est_loads]
        self._P = len(self._est)
        self._done = [0.0] * self._P
        self._trips = [0.0] * self._P
        self._clock = clock
        self._reg = registry
        self._tracer = tracer
        self._publish = publish
        self._t0: Optional[float] = None
        # rate window anchor: state as of the FIRST update (warm-up discount)
        self._t1: Optional[float] = None
        self._done1: Optional[List[float]] = None
        self._round = 0
        self._history: List[ProgressSnapshot] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._t0 = self._clock()

    @property
    def total_est(self) -> float:
        return sum(self._est)

    # -- feeding -------------------------------------------------------------
    def update(
        self,
        done_delta: Sequence[float],
        trips_delta: Optional[Sequence[float]] = None,
    ) -> ProgressSnapshot:
        """Account per-shard work completed since the previous update.

        ``done_delta`` is in the planner's estimated-load units
        (``fimi.run`` feeds the estimated loads once, at the end);
        ``trips_delta`` is the matching observed DFS trip counts when
        available — it sharpens the straggler score from time-based to
        work-based.
        """
        if self._t0 is None:
            self.start()
        now = self._clock()
        for p in range(self._P):
            self._done[p] += float(done_delta[p])
            if trips_delta is not None:
                self._trips[p] += float(trips_delta[p])
        self._round += 1
        if self._round == 1:
            self._t1 = now
            self._done1 = list(self._done)
        snap = self._snapshot(now)
        self._history.append(snap)
        if self._publish:
            self._export(snap)
        return snap

    # -- math ----------------------------------------------------------------
    def _rates(self, now: float) -> List[float]:
        """Per-shard units/s over the warm-up-discounted window."""
        rates = []
        for p in range(self._P):
            if (
                self._round >= 2
                and self._t1 is not None
                and now > self._t1 + 1e-9
            ):
                r = (self._done[p] - self._done1[p]) / (now - self._t1)
            elif self._t0 is not None and now > self._t0 + 1e-9:
                r = self._done[p] / (now - self._t0)
            else:
                r = 0.0
            rates.append(r)
        return rates

    def _snapshot(self, now: float) -> ProgressSnapshot:
        elapsed = now - (self._t0 if self._t0 is not None else now)
        total = self.total_est
        frac = min(sum(self._done) / total, 1.0) if total > 0 else 0.0
        rates = self._rates(now)
        etas = []
        for p in range(self._P):
            remaining = max(self._est[p] - self._done[p], 0.0)
            if remaining <= 0.0:
                etas.append(0.0)
            elif rates[p] > 0.0:
                etas.append(remaining / rates[p])
        eta = max(etas) if etas else None

        # straggler: observed cost per estimated unit vs fleet mean
        if any(t > 0 for t in self._trips):
            cost = [
                self._trips[p] / max(self._done[p], 1.0)
                for p in range(self._P)
            ]
        else:
            mean_rate = sum(rates) / self._P if self._P else 0.0
            cost = [
                (mean_rate / rates[p]) if rates[p] > 0 else 1.0
                for p in range(self._P)
            ]
        mean_cost = sum(cost) / len(cost) if cost else 1.0
        stragglers = [
            c / mean_cost if mean_cost > 0 else 1.0 for c in cost
        ]
        return ProgressSnapshot(
            frac=frac,
            elapsed_s=elapsed,
            eta_s=eta,
            rate=sum(rates),
            round=self._round,
            stragglers=stragglers,
        )

    def snapshot(self) -> ProgressSnapshot:
        return self._snapshot(self._clock())

    # -- export --------------------------------------------------------------
    def _export(self, snap: ProgressSnapshot) -> None:
        reg = self._reg or obs_metrics.registry()
        reg.gauge("progress/frac").set(snap.frac)
        reg.gauge("progress/elapsed_s").set(snap.elapsed_s)
        reg.gauge("progress/round").set(float(snap.round))
        if snap.eta_s is not None:
            reg.gauge("progress/eta_s").set(snap.eta_s)
        for p, s in enumerate(snap.stragglers):
            reg.gauge(f"progress/shard{p}/straggler").set(s)
        tr = self._tracer or obs_trace.tracer()
        tr.counter(
            "mining progress",
            percent=100.0 * snap.frac,
            eta_s=snap.eta_s if snap.eta_s is not None else 0.0,
        )

    def finish(self) -> Optional[float]:
        """Seal the run: midpoint-ETA relative error vs what really remained.

        Finds the first update at ≥ 50 % completed work, compares the ETA
        it printed against the actual time from that update to now, and
        publishes ``progress/eta_rel_err_mid``.
        Returns the error, or None when the run never crossed the midpoint
        with a usable ETA (single-round runs).
        """
        now = self._clock()
        mid = next(
            (
                s for s in self._history
                if s.frac >= 0.5 and s.eta_s is not None and s.frac < 1.0
            ),
            None,
        )
        err: Optional[float] = None
        if mid is not None and self._t0 is not None:
            actual_remaining = (now - self._t0) - mid.elapsed_s
            if actual_remaining > 1e-9:
                err = abs(mid.eta_s - actual_remaining) / actual_remaining
        if self._publish and err is not None:
            reg = self._reg or obs_metrics.registry()
            reg.gauge("progress/eta_rel_err_mid").set(err)
        return err
