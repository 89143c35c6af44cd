"""Production serving front end: micro-batching, admission control, replicas.

The port of the JAX package's ``serve/service.py``, with the same behaviour.
The :class:`QueryEngine` answers a *caller-assembled* batch; a real service
faces an **arrival process** — requests trickle in one at a time and someone
must decide when to cut a batch.  :class:`MiningService` is that front end:

  * **dynamic micro-batching** — submissions enqueue; a dispatcher thread
    flushes when the batch is full (``max_batch``) or the oldest request
    has waited ``deadline_ms``, whichever first.  One subset/superset sweep
    (kernel B4 on the card) per kind per flush, so the deadline bounds the
    added latency at D while Poisson arrivals at rate λ fill batches to
    ≈ min(λ·D, K) rows.
  * **admission control** — a bounded queue: at ``max_queue`` depth a
    submission is *shed*, returning a typed :class:`Shed` result
    immediately (never a silent drop, never an unbounded queue).  Sheds
    feed the SLO tracker's availability budget.
  * **replicas** — N :class:`QueryEngine`\\ s behind a round-robin router
    (one flush per replica turn).  Hot-swap is **generation-consistent**
    across all of them: :meth:`swap_indexes` swaps every replica's
    single-reference state under one lock and asserts they converge to
    the same generation; each flush pins itself to one replica
    :class:`~repro_torch.serve.engine.EngineSnapshot`, so no flush ever
    mixes generations even mid-swap.
  * **per-request tracing** — every request id flows through the span
    chain ``service/enqueue`` (queue wait, a span per request) →
    ``service/assemble`` → ``service/sweep`` (device) →
    ``service/respond``, each batch span carrying the member ids in its
    args; a Perfetto timeline separates queueing from compute per flush.

On the card the flushes run on the ``service-dispatch`` thread, whose
current CUDA stream is not a swapping caller's: :meth:`swap_indexes` waits
for the caller's current stream before it publishes a pair, so a flush never
reads an index whose build is still queued.

Outcome types a ticket can resolve to: the query's value, :class:`Shed`
(admission control), or :class:`Failed` (a dispatch raised — the error is
named, counted, and never lost on the dispatcher thread; it is never retried
elsewhere).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.cache import QueryCache, query_key
from repro_torch.serve.engine import QueryEngine

#: query kinds the service routes (mirrors the engine's entry points)
KINDS = ("support", "rules", "superset")


@dataclass(frozen=True)
class Shed:
    """Typed admission-control rejection (the request was NOT served)."""

    reason: str
    queue_depth: int


@dataclass(frozen=True)
class Failed:
    """A dispatch error, surfaced to the submitter instead of swallowed."""

    error: str


class Ticket:
    """The submitter's handle: blocks on :meth:`result` until resolved."""

    __slots__ = ("id", "_ev", "_val")

    def __init__(self, req_id: int):
        self.id = req_id
        self._ev = threading.Event()
        self._val = None

    def _resolve(self, val) -> None:
        self._val = val
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        """The outcome: a query value, :class:`Shed`, or :class:`Failed`."""
        if not self._ev.wait(timeout):
            raise TimeoutError(f"request {self.id} not resolved "
                               f"within {timeout}s")
        return self._val


class _Request:
    __slots__ = ("id", "kind", "mask", "t_submit", "ticket")

    def __init__(self, req_id: int, kind: str, mask: np.ndarray,
                 t_submit: float):
        self.id = req_id
        self.kind = kind
        self.mask = mask
        self.t_submit = t_submit
        self.ticket = Ticket(req_id)


class MiningService:
    """Arrival-stream front end over N replica engines.

    Args:
      engines: one or more :class:`QueryEngine` replicas (equal batch
        widths and top_k; typically built over the same index pair).
      max_batch: flush width (default: the replicas' batch width).
      deadline_ms: max time the OLDEST queued request waits before its
        batch is cut — the micro-batching latency bound.
      max_queue: admission-control bound; submissions beyond this depth
        shed with a typed :class:`Shed` result.
      slo: optional :class:`repro_torch.obs.slo.SLOTracker` fed every outcome
        (served latency / shed / error) — the live windowed view.
      cache: optional :class:`QueryCache` consulted per flush; keys carry
        the flush snapshot's generation so hot-swaps can never serve
        stale hits.  Duplicate queries inside one flush dispatch once.
      auto_start: start the dispatcher thread immediately (tests pass
        False to stage deterministic queue states).
    """

    def __init__(
        self,
        engines: Sequence[QueryEngine],
        *,
        max_batch: Optional[int] = None,
        deadline_ms: float = 5.0,
        max_queue: int = 1024,
        slo=None,
        cache: Optional[QueryCache] = None,
        auto_start: bool = True,
    ):
        assert engines, "need at least one replica engine"
        self.engines: Tuple[QueryEngine, ...] = tuple(engines)
        widths = {e.batch for e in self.engines}
        assert len(widths) == 1, f"replica batch widths differ: {widths}"
        self.max_batch = max_batch or self.engines[0].batch
        assert self.max_batch <= self.engines[0].batch, (
            f"max_batch {self.max_batch} exceeds engine width "
            f"{self.engines[0].batch}")
        assert deadline_ms > 0 and max_queue > 0
        self.deadline_s = deadline_ms / 1e3
        self.max_queue = max_queue
        self.slo = slo
        self.cache = cache
        gens = {e.generation for e in self.engines}
        assert len(gens) == 1, f"replica generations diverged: {gens}"
        self._generation = gens.pop()
        self._q: "deque[_Request]" = deque()
        self._cond = threading.Condition()
        self._ids = itertools.count()
        self._rr = 0
        self._swap_lock = threading.Lock()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._reg = obs_metrics.registry()
        self._tracer = obs_trace.tracer()
        if auto_start:
            self.start()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "MiningService":
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="service-dispatch", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatcher; ``drain`` flushes queued requests first
        (False sheds them — still typed, never silent)."""
        with self._cond:
            self._stop = True
            if not drain:
                while self._q:
                    r = self._q.popleft()
                    self._shed_locked(r, "shutdown")
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self) -> "MiningService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission (any thread) ----------------------------------------------
    def submit(self, kind: str, mask: np.ndarray) -> Ticket:
        """Enqueue one query; returns immediately with a :class:`Ticket`.

        A full queue resolves the ticket to :class:`Shed` on the spot —
        admission control pushes back instead of letting latency grow
        without bound.
        """
        assert kind in KINDS, f"unknown query kind {kind!r}"
        now = time.monotonic()
        req = _Request(next(self._ids), kind, np.asarray(mask, np.uint32),
                       now)
        with self._cond:
            if self._stop:
                raise RuntimeError("service is stopped")
            if len(self._q) >= self.max_queue:
                self._shed_locked(req, "queue_full")
                return req.ticket
            self._q.append(req)
            self._reg.gauge("service/queue_depth").update_max(len(self._q))
            self._tracer.counter("queue depth", depth=len(self._q))
            self._cond.notify()
        return req.ticket

    def _shed_locked(self, req: _Request, reason: str) -> None:
        depth = len(self._q)
        req.ticket._resolve(Shed(reason=reason, queue_depth=depth))
        self._reg.counter("service/shed").inc()
        if self.slo is not None:
            self.slo.record_shed()
        self._tracer.instant("service/shed", req=req.id, reason=reason,
                             queue_depth=depth)

    # -- hot swap (any thread) -------------------------------------------------
    @property
    def generation(self) -> int:
        """Service-wide swap generation (all replicas agree by invariant)."""
        return self._generation

    def swap_indexes(self, index, rules=None) -> int:
        """Publish a standby index pair on EVERY replica, consistently.

        Extends the engine's single-reference swap across the fleet: each
        replica's swap is individually atomic, the service lock serializes
        swaps so replicas step through generations in lockstep, and the
        post-condition asserts one common generation.  Flushes pin a
        snapshot first, so a flush concurrent with the swap serves
        entirely old or entirely new — never a mix.  On the card the pair
        is published only once the caller's current stream, on which it
        was built, has completed.
        """
        if index.device.type == "cuda":
            torch.cuda.current_stream(index.device).synchronize()
        with self._swap_lock:
            gens = [e.swap_indexes(index, rules) for e in self.engines]
            assert len(set(gens)) == 1, f"replica swap diverged: {gens}"
            self._generation = gens[0]
            if self.cache is not None:
                self.cache.clear()
            self._reg.counter("service/swaps").inc()
            self._tracer.instant("service/swap", generation=self._generation)
            return self._generation

    # -- dispatcher ------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait(0.05)
                if not self._q:
                    if self._stop:
                        return
                    continue
                if not self._stop:
                    # cut the batch at width K or the oldest's deadline
                    deadline = self._q[0].t_submit + self.deadline_s
                    while (len(self._q) < self.max_batch
                           and not self._stop):
                        remain = deadline - time.monotonic()
                        if remain <= 0:
                            break
                        self._cond.wait(remain)
                n = min(len(self._q), self.max_batch)
                batch = [self._q.popleft() for _ in range(n)]
                self._tracer.counter("queue depth", depth=len(self._q))
            self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        replica = self._rr
        self._rr = (self._rr + 1) % len(self.engines)
        snap = self.engines[replica].snapshot()
        t_flush = time.monotonic()
        ids = [r.id for r in batch]
        tracing = self._tracer.enabled
        if tracing:
            # queue-wait span per request: enqueue -> batch cut, id in args
            for r in batch:
                self._tracer.add_span(
                    "service/enqueue", r.t_submit, t_flush - r.t_submit,
                    track=f"service/replica{replica}/queue",
                    cat="service", args={"req": r.id},
                )
        with self._tracer.span("service/flush", replica=replica,
                               generation=snap.generation, n=len(batch),
                               reqs=ids):
            values: Dict[int, object] = {}
            error: Optional[str] = None
            for kind in KINDS:
                rows = [r for r in batch if r.kind == kind]
                if not rows:
                    continue
                kind_ids = [r.id for r in rows]
                try:
                    with self._tracer.span("service/assemble", kind=kind,
                                           reqs=kind_ids):
                        masks = np.stack([r.mask for r in rows])
                        keys = None
                        if self.cache is not None:
                            keys = [query_key(kind, r.mask, snap.top_k,
                                              snap.generation)
                                    for r in rows]
                            results, miss = self.cache.split_batch(keys)
                        else:
                            results = [None] * len(rows)
                            miss = list(range(len(rows)))
                    if miss:
                        with self._tracer.span(
                            "service/sweep", kind=kind, replica=replica,
                            n=len(miss), reqs=[rows[j].id for j in miss],
                        ):
                            vals = self._dispatch(
                                snap, kind, masks[miss]
                                if len(miss) < len(rows) else masks)
                        if self.cache is not None:
                            results = self.cache.fill_batch(
                                keys, results, miss, vals)
                        else:
                            for j, v in zip(miss, vals):
                                results[j] = v
                    for r, v in zip(rows, results):
                        values[r.id] = v
                except Exception as e:   # dispatcher must never die silently
                    error = f"{type(e).__name__}: {e}"
                    self._reg.counter("service/errors").inc(len(rows))
                    for r in rows:
                        values[r.id] = Failed(error=error)
                        if self.slo is not None:
                            self.slo.record_error()
            with self._tracer.span("service/respond", reqs=ids):
                t_done = time.monotonic()
                lat_hist = self._reg.histogram("service/latency_ms")
                for r in batch:
                    v = values.get(r.id)
                    r.ticket._resolve(v)
                    if isinstance(v, Failed):
                        continue
                    ms = (t_done - r.t_submit) * 1e3
                    lat_hist.record(ms)
                    if self.slo is not None:
                        self.slo.record_ok(ms)
        self._reg.counter("service/flushes").inc()
        self._reg.counter(f"service/replica{replica}/flushes").inc()
        self._reg.counter(f"service/replica{replica}/requests").inc(
            len(batch))
        self._reg.histogram("service/batch_fill").record(len(batch))

    def _dispatch(self, snap, kind: str, masks: np.ndarray) -> List[object]:
        """One fused sweep for a per-kind group, rows back out as values."""
        if kind == "support":
            return list(snap.support(masks))
        if kind == "rules":
            rows, conf = snap.rules_for(masks)
            return [(rows[i], conf[i]) for i in range(rows.shape[0])]
        rows, supp = snap.supersets(masks)
        return [(rows[i], supp[i]) for i in range(rows.shape[0])]

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict:
        with self._cond:
            depth = len(self._q)
        reg = self._reg
        out = {
            "generation": self._generation,
            "replicas": len(self.engines),
            "queue_depth": depth,
            "max_queue": self.max_queue,
            "max_batch": self.max_batch,
            "deadline_ms": self.deadline_s * 1e3,
            "flushes": reg.counter("service/flushes").value,
            "shed": reg.counter("service/shed").value,
            "errors": reg.counter("service/errors").value,
            "per_replica_flushes": [
                reg.counter(f"service/replica{r}/flushes").value
                for r in range(len(self.engines))
            ],
            "per_replica_requests": [
                reg.counter(f"service/replica{r}/requests").value
                for r in range(len(self.engines))
            ],
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats.as_dict()
        return out
