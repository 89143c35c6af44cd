"""Sliding-window telemetry + SLO policy engine for the serving tier.

The port's own copy of the JAX package's ``obs/slo.py``, with the same
behaviour.  :mod:`repro_torch.obs.metrics` answers "what happened over the
whole process lifetime"; the serving front end
(:mod:`repro_torch.serve.service`) needs the *live* half: p99 latency, QPS
and the shed rate over the last W seconds.  This module is that view, plus
the policy that acts on it:

  * :class:`WindowedHistogram` — a ring of ``slots`` log-bucketed
    :class:`~repro_torch.obs.metrics.Histogram`\\ s, one per rotation
    interval of ``window_s / slots`` seconds.  Recording lands in the
    current slot; reading merges the ring into one histogram, so
    p50/p95/p99 reflect exactly the samples of the trailing window (a
    sample expires between ``window_s - rotate_s`` and ``window_s`` seconds
    after it arrived).  Merging is exact: the slots share bucket
    boundaries.
  * :class:`WindowedCounter` — the same ring over plain counts;
    ``rate()`` is events per second over the trailing window (QPS, shed
    rate, error rate).
  * :class:`SLOPolicy` / :class:`SLOTracker` — the objectives (windowed
    p99 latency bound + availability target) and the alerting state
    machine.  Availability alerts are **error-budget burn-rate** alerts:
    with budget ``1 - availability``, the burn rate is
    ``bad_fraction / budget``.  Both alert kinds have hysteresis (fire
    at/above ``burn_hi`` / the latency objective, clear only below
    ``burn_lo`` / ``latency_clear`` × objective).

Everything here is stdlib-only, thread-safe (the service's dispatcher
thread records while the dashboard thread reads), and takes an injectable
``clock`` so the window and alert math is testable on a fake clock.

Alert *transitions* come back from :meth:`SLOTracker.evaluate` as event
dicts and are also pushed to ``on_alert`` callbacks — the load harness
(``launch/serve_load.py``) wires those to trace instants, run-record
events, and its non-zero gate exit.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import Histogram


class _Ring:
    """Shared rotation bookkeeping: absolute slot index from the clock.

    Slot ``k = floor((now - epoch) / rotate_s)``; the ring cell is
    ``k % slots``.  Advancing from the last seen ``k`` clears every cell
    that a skipped interval invalidated, so an idle stretch longer than
    the window leaves the ring empty — time moves the window forward even
    when no samples arrive.
    """

    def __init__(self, window_s: float, slots: int, clock):
        assert window_s > 0 and slots >= 2, (window_s, slots)
        self.window_s = float(window_s)
        self.slots = slots
        self.rotate_s = self.window_s / slots
        self.clock = clock
        self.epoch = clock()
        self.cur_k = 0

    def advance(self, clear_cell) -> int:
        """Rotate to the clock's slot, clearing expired cells; returns the
        current ring cell index."""
        k = int((self.clock() - self.epoch) / self.rotate_s)
        if k > self.cur_k:
            step = min(k - self.cur_k, self.slots)
            for j in range(1, step + 1):
                clear_cell((self.cur_k + j) % self.slots)
            self.cur_k = k
        return self.cur_k % self.slots

    def coverage_s(self) -> float:
        """Seconds of traffic the ring currently represents (ramps from 0
        to ``window_s`` after start/idle — keeps early rates honest)."""
        return min(self.window_s, max(self.clock() - self.epoch, 1e-6))


class WindowedHistogram:
    """Trailing-window latency distribution: a ring of log-bucket slots."""

    def __init__(self, name: str, window_s: float = 30.0, slots: int = 6,
                 growth: float = 1.08, clock=time.monotonic):
        self.name = name
        self.growth = growth
        self._ring = _Ring(window_s, slots, clock)
        self._slots = [Histogram(f"{name}[{i}]", growth)
                       for i in range(slots)]
        self._lock = threading.Lock()

    @property
    def window_s(self) -> float:
        return self._ring.window_s

    def record(self, v: float) -> None:
        with self._lock:
            cell = self._ring.advance(lambda i: self._slots[i].clear())
            self._slots[cell].record(v)

    def merged(self) -> Histogram:
        """One histogram holding exactly the live window's samples."""
        acc = Histogram(self.name, self.growth)
        with self._lock:
            self._ring.advance(lambda i: self._slots[i].clear())
            for h in self._slots:
                acc.merge_from(h)
        return acc

    def percentile(self, q: float) -> Optional[float]:
        return self.merged().percentile(q)

    @property
    def count(self) -> int:
        return self.merged().count

    def summary(self) -> Dict[str, Optional[float]]:
        return self.merged().summary()


class WindowedCounter:
    """Trailing-window event count; ``rate()`` = events/s over the window."""

    def __init__(self, name: str, window_s: float = 30.0, slots: int = 6,
                 clock=time.monotonic):
        self.name = name
        self._ring = _Ring(window_s, slots, clock)
        self._cells = [0] * slots
        self._lock = threading.Lock()

    def _clear(self, i: int) -> None:
        self._cells[i] = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            cell = self._ring.advance(self._clear)
            self._cells[cell] += n

    @property
    def value(self) -> int:
        """Events inside the trailing window."""
        with self._lock:
            self._ring.advance(self._clear)
            return sum(self._cells)

    def rate(self) -> float:
        """Events per second over the (possibly still ramping) window."""
        with self._lock:
            self._ring.advance(self._clear)
            return sum(self._cells) / self._ring.coverage_s()


# ---------------------------------------------------------------------------
# SLO policy + alerting state machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """The objectives a serving window is held to.

    ``availability`` is the fraction of requests that must be *served*
    (not shed, not errored); its complement is the error budget the burn
    rate is measured against.  ``p99_ms`` bounds the windowed p99 latency
    of served requests.  ``min_requests`` keeps a near-empty window from
    alerting on noise (one shed request out of three is not an outage).
    """

    p99_ms: float = 50.0
    availability: float = 0.999
    window_s: float = 30.0
    slots: int = 6
    burn_hi: float = 2.0          # fire availability alert at/above this burn
    burn_lo: float = 1.0          # clear only below this burn (hysteresis)
    latency_clear: float = 0.8    # clear latency alert below this × p99_ms
    min_requests: int = 20

    @property
    def budget(self) -> float:
        """Allowed bad fraction per window (the error budget)."""
        return max(1.0 - self.availability, 1e-9)


@dataclasses.dataclass
class SLOStatus:
    """One evaluation of the live window against the policy."""

    t: float
    window_s: float
    total: int                    # requests that entered the window
    served: int
    shed: int
    errors: int
    qps: float                    # served per second (trailing window)
    offered_qps: float            # served + shed + errors per second
    shed_rate: float              # (shed + errors) / total
    burn_rate: float              # shed_rate / error budget
    p50_ms: Optional[float]
    p95_ms: Optional[float]
    p99_ms: Optional[float]
    latency_ok: bool
    availability_ok: bool
    alert_active: bool
    events: List[dict]            # alert transitions THIS evaluation


class SLOTracker:
    """Records request outcomes; evaluates the window against the policy.

    The recording side (:meth:`record_ok` / :meth:`record_shed` /
    :meth:`record_error`) is called by the service on its dispatcher
    thread; :meth:`evaluate` is called by whoever acts on the state — the
    harness dashboard tick, a router.  Alert state transitions are edge
    events: each fire/clear is reported exactly once, both in the returned
    :class:`SLOStatus` and to every ``on_alert`` callback.
    """

    def __init__(self, policy: SLOPolicy, clock=time.monotonic,
                 name: str = "service"):
        self.policy = policy
        self.name = name
        self._clock = clock
        p = policy
        self.latency = WindowedHistogram(
            f"{name}/window/latency_ms", p.window_s, p.slots, clock=clock)
        self._served = WindowedCounter(
            f"{name}/window/served", p.window_s, p.slots, clock=clock)
        self._shed = WindowedCounter(
            f"{name}/window/shed", p.window_s, p.slots, clock=clock)
        self._errors = WindowedCounter(
            f"{name}/window/errors", p.window_s, p.slots, clock=clock)
        self._lock = threading.Lock()
        self._burn_active = False
        self._latency_active = False
        self.alerts: List[dict] = []      # every transition, timestamped
        self._callbacks: List[Callable[[dict], None]] = []

    # -- recording (dispatcher thread) ---------------------------------------
    def record_ok(self, latency_ms: float) -> None:
        self.latency.record(latency_ms)
        self._served.inc()

    def record_shed(self) -> None:
        self._shed.inc()

    def record_error(self) -> None:
        self._errors.inc()

    def on_alert(self, cb: Callable[[dict], None]) -> None:
        self._callbacks.append(cb)

    # -- evaluation -----------------------------------------------------------
    def _transition(self, events: List[dict], kind: str, objective: str,
                    **fields) -> None:
        ev = {"kind": kind, "objective": objective, "slo": self.name,
              "t": self._clock(), **fields}
        events.append(ev)
        self.alerts.append(ev)
        for cb in self._callbacks:
            cb(ev)

    def evaluate(self) -> SLOStatus:
        p = self.policy
        with self._lock:
            served = self._served.value
            shed = self._shed.value
            errors = self._errors.value
            total = served + shed + errors
            summ = self.latency.summary()
            bad = shed + errors
            shed_rate = bad / total if total else 0.0
            burn = shed_rate / p.budget
            p99 = summ["p99"]
            enough = total >= p.min_requests
            latency_breached = (
                enough and p99 is not None and p99 > p.p99_ms
            )
            availability_ok = not (enough and burn >= p.burn_hi)
            events: List[dict] = []
            # burn-rate alert: fire >= burn_hi, clear < burn_lo
            if not self._burn_active and enough and burn >= p.burn_hi:
                self._burn_active = True
                self._transition(events, "slo_alert", "availability",
                                 burn_rate=burn, shed_rate=shed_rate,
                                 budget=p.budget)
            elif self._burn_active and burn < p.burn_lo:
                self._burn_active = False
                self._transition(events, "slo_clear", "availability",
                                 burn_rate=burn)
            # latency alert: fire > p99_ms, clear < latency_clear * p99_ms
            if not self._latency_active and latency_breached:
                self._latency_active = True
                self._transition(events, "slo_alert", "latency",
                                 p99_ms=p99, objective_ms=p.p99_ms)
            elif self._latency_active and (
                p99 is None or p99 < p.latency_clear * p.p99_ms
            ):
                self._latency_active = False
                self._transition(events, "slo_clear", "latency", p99_ms=p99)
            return SLOStatus(
                t=self._clock(),
                window_s=p.window_s,
                total=total,
                served=served,
                shed=shed,
                errors=errors,
                qps=self._served.rate(),
                offered_qps=(self._served.rate() + self._shed.rate()
                             + self._errors.rate()),
                shed_rate=shed_rate,
                burn_rate=burn,
                p50_ms=summ["p50"],
                p95_ms=summ["p95"],
                p99_ms=p99,
                latency_ok=not latency_breached,
                availability_ok=availability_ok,
                alert_active=self._burn_active or self._latency_active,
                events=events,
            )

    def alerts_since(self, t: float) -> List[dict]:
        """Alert *fire* transitions at or after ``t`` (the harness gates on
        alerts inside the measured phase, ignoring the ramp)."""
        return [ev for ev in self.alerts
                if ev["kind"] == "slo_alert" and ev["t"] >= t]
