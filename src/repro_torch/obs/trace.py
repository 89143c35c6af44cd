"""Host-side span tracing with Chrome trace-event export (Perfetto-loadable).

The port's copy of the JAX package's ``obs/trace.py``, with the same
behaviour and the same JSON.  A :class:`Tracer` records nested wall-clock
spans on any thread against one shared monotonic clock, and exports the
Chrome trace-event JSON that ``ui.perfetto.dev`` / ``chrome://tracing``
render as a per-thread timeline.  Four event flavors:

  * ``span(name, **args)`` — a context manager recording one complete
    ("ph": "X") event; nesting is by time containment per thread, exactly
    how the trace viewers stack them;
  * ``add_span(...)`` — a raw event on a *virtual* track (one track per
    modeled lane);
  * ``instant(name, **args)`` — a zero-duration marker ("ph": "i");
  * ``counter(name, **values)`` — a counter-track sample ("ph": "C") for
    live gauges (mining progress %) rendered beside the spans.

Device timing: CUDA launches are asynchronous, so a host span around one
measures the enqueue, not the execution.  ``sync(value, name)`` closes the
gap: **only when tracing is enabled** it waits, inside a span, for the CUDA
devices of the tensors in ``value``, so the enclosing phase span covers the
device's time; when disabled it returns the value untouched and nothing
waits.  ``torch_profiler(log_dir)`` is the opt-in way to the real profiler
(``torch.profiler``, CPU and CUDA activities) when op-level device detail is
needed.

The disabled fast path is a single attribute check returning a shared
no-op context manager: no allocation, no clock read, no lock.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional

#: Default event-buffer cap.  Long runs otherwise grow the buffer — and the
#: exported trace.json — without bound; at the cap the oldest events are
#: dropped (the *recent* timeline is the diagnostic one) and the drop is
#: accounted: a ``trace/dropped_events`` counter plus a ``truncated_events``
#: note in the exported JSON.
DEFAULT_MAX_EVENTS = 500_000


class _NullSpan:
    """Shared do-nothing context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._tracer._record(
            self._name, self._t0, time.monotonic() - self._t0, self._args
        )
        return False


class Tracer:
    """Thread-safe span recorder with Chrome trace-event JSON export."""

    def __init__(
        self, enabled: bool = False, max_events: int = DEFAULT_MAX_EVENTS
    ):
        self._enabled = enabled
        self._max_events = max(1, int(max_events))
        self._events: Deque[dict] = deque(maxlen=self._max_events)
        self._dropped = 0
        self._t_base = time.monotonic()
        self._track_names: Dict[int, str] = {}
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._track_names.clear()
            self._dropped = 0
        self._t_base = time.monotonic()

    def set_max_events(self, max_events: int) -> None:
        """Re-cap the buffer (keeping the newest events that still fit)."""
        with self._lock:
            self._max_events = max(1, int(max_events))
            old = self._events
            self._dropped += max(0, len(old) - self._max_events)
            self._events = deque(old, maxlen=self._max_events)

    @property
    def max_events(self) -> int:
        return self._max_events

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._dropped

    def _append_locked(self, ev: dict) -> None:
        # deque(maxlen) silently evicts the oldest; account for it first
        if len(self._events) == self._max_events:
            self._dropped += 1
            from repro_torch.obs import metrics as _metrics  # lazy: cold path only

            _metrics.registry().counter("trace/dropped_events").inc()
        self._events.append(ev)

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing one nested span on the calling thread."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def _tid(self) -> int:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._track_names:       # benign race: same value
            self._track_names[tid] = t.name
        return tid

    def _record(self, name, t0, dur_s, args, tid=None, cat="host"):
        ev = {
            "ph": "X",
            "name": name,
            "cat": cat,
            "pid": 0,
            "tid": self._tid() if tid is None else tid,
            "ts": (t0 - self._t_base) * 1e6,
            "dur": dur_s * 1e6,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._append_locked(ev)

    def add_span(
        self,
        name: str,
        t0: float,
        dur_s: float,
        *,
        track: str,
        cat: str = "modeled",
        args: Optional[dict] = None,
    ) -> None:
        """Record a span on a named virtual track (``t0`` from
        ``time.monotonic()``).  Used for modeled lanes — e.g. per-shard
        mining spans whose duration is apportioned from trip telemetry."""
        if not self._enabled:
            return
        tid = 1_000_000 + (hash(track) & 0xFFFF)
        if tid not in self._track_names:
            self._track_names[tid] = track
        self._record(name, t0, dur_s, args, tid=tid, cat=cat)

    def counter(self, name: str, **values) -> None:
        """A Chrome counter sample ("ph": "C") — renders as a counter track.

        Each call appends one sample of the named counter series; Perfetto
        draws the series as a stacked area/line track (one lane per key in
        ``values``).  Used for the live gauges worth seeing against the
        span timeline: mining progress %, serve queue depth, host-bytes
        high-water.  Values must be numeric."""
        if not self._enabled:
            return
        ev = {
            "ph": "C",
            "name": name,
            "cat": "counter",
            "pid": 0,
            "tid": self._tid(),
            "ts": (time.monotonic() - self._t_base) * 1e6,
            "args": {k: float(v) for k, v in values.items()},
        }
        with self._lock:
            self._append_locked(ev)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event (drift fired, checkpoint saved…)."""
        if not self._enabled:
            return
        ev = {
            "ph": "i",
            "s": "t",
            "name": name,
            "cat": "event",
            "pid": 0,
            "tid": self._tid(),
            "ts": (time.monotonic() - self._t_base) * 1e6,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._append_locked(ev)

    # -- device helper -------------------------------------------------------
    def sync(self, value, name: str = "device_sync"):
        """Wait for the CUDA devices of the tensors in ``value`` inside a span,
        ONLY when tracing.

        The disabled path returns ``value`` untouched (nothing waits): tracing
        must never change how the queued work executes when off.
        """
        if not self._enabled:
            return value
        import torch

        with self.span(name, cat="device"):
            for dev in _cuda_devices(value, set()):
                torch.cuda.synchronize(dev)
        return value

    # -- export --------------------------------------------------------------
    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._events)

    def export(self) -> dict:
        """The Chrome trace-event object (Perfetto/chrome://tracing)."""
        with self._lock:
            events = list(self._events)
            tracks = dict(self._track_names)
            dropped = self._dropped
        meta = [
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 0,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(tracks.items())
        ]
        out = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if dropped:
            out["truncated_events"] = dropped   # oldest `dropped` evicted
        return out

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.export(), f)
        return path


#: The process-global tracer every subsystem records into by default.
TRACER = Tracer()


def tracer() -> Tracer:
    return TRACER


def _cuda_devices(value, found: set) -> set:
    """The CUDA devices of the tensors in ``value`` (nested in tuples, lists
    and dicts)."""
    import torch

    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    return found


class torch_profiler:
    """Opt-in ``torch.profiler`` capture (CPU and CUDA activities) for the
    span of a ``with`` block, written as a Chrome trace into ``log_dir``::

        with obs_trace.torch_profiler(log_dir):
            ... mine ...
    """

    FILE = "torch_trace.json"

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.log_dir, self.FILE))
        return False
