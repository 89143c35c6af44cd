"""Process-global metrics registry: counters, gauges, latency histograms.

The port's own copy of the JAX package's ``obs/metrics.py``, with the same
behaviour: one :class:`MetricsRegistry` holds every number a subsystem
reports (the serving engine's query latencies and swaps, the query cache's
hit counters, the streaming miner's block and re-mine counts) and gives them
back in one snapshot shape::

    {"counters":   {name: int},
     "gauges":     {name: float},
     "histograms": {name: {count, sum, mean, min, max, p50, p95, p99}}}

Design constraints, in order:

  * **zero dependencies** — stdlib only;
  * **thread-safe** — a recorder may run beside the serving loop;
  * **no sample retention** — :class:`Histogram` is log-bucketed: geometric
    buckets of width ``growth`` (default 8 %) give p50/p95/p99 within
    ``sqrt(growth)`` relative error of the exact nearest-rank percentile at
    O(buckets) memory, any stream length;
  * **near-zero when idle** — recording is one lock + int add; nothing is
    formatted, allocated per-event, or written until :func:`snapshot`.

Naming scheme: ``subsystem/metric`` — flat strings, no label cardinality to
manage.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonic event count (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-written (or high-water) value of a quantity (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def update_max(self, v: float) -> None:
        """High-water semantics: keep the largest value ever seen."""
        with self._lock:
            if float(v) > self._value:
                self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed distribution of a non-negative quantity.

    Bucket ``i`` covers ``[growth**i, growth**(i+1))`` — relative, not
    absolute, resolution, so one histogram spans nanoseconds to hours in a
    few hundred ints.  ``percentile(q)`` walks the cumulative counts to the
    nearest-rank sample's bucket and returns its geometric midpoint, clamped
    to the exact observed ``[min, max]``: the estimate is within a
    ``sqrt(growth)`` factor (≈ 4 % at the default) of
    ``numpy.percentile(samples, q, method="nearest")``.  Exact ``count``,
    ``sum``, ``min`` and ``max`` are kept on the side; values below
    ``floor`` (and zeros) land in a dedicated underflow bucket.
    """

    __slots__ = ("name", "growth", "floor", "_log_g", "_buckets", "_zero",
                 "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, growth: float = 1.08, floor: float = 1e-9):
        assert growth > 1.0, "bucket growth must be > 1"
        self.name = name
        self.growth = growth
        self.floor = floor
        self._log_g = math.log(growth)
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        v = float(v)
        if v < 0.0 or v != v:          # negative or NaN: not a latency/size
            raise ValueError(f"histogram {self.name}: bad sample {v!r}")
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if v < self.floor:
                self._zero += 1
            else:
                i = int(math.floor(math.log(v) / self._log_g))
                self._buckets[i] = self._buckets.get(i, 0) + 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def clear(self) -> None:
        """Forget every sample (the sliding-window ring rotates on this)."""
        with self._lock:
            self._buckets.clear()
            self._zero = 0
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def merge_from(self, other: "Histogram") -> None:
        """Fold ``other``'s samples into this histogram.

        Exact for every summary field: bucket counts add, min/max take the
        extremes, and the percentile walk over the summed buckets is the
        walk over the union stream.  Requires equal ``growth`` (bucket
        boundaries must line up), so a ring of rotation slots merges into
        one last-W-seconds distribution.
        """
        assert other.growth == self.growth, "bucket geometries differ"
        with other._lock:
            buckets = dict(other._buckets)
            zero, count = other._zero, other._count
            total, lo, hi = other._sum, other._min, other._max
        if count == 0:
            return
        with self._lock:
            for i, n in buckets.items():
                self._buckets[i] = self._buckets.get(i, 0) + n
            self._zero += zero
            self._count += count
            self._sum += total
            if lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile estimate; None on an empty histogram."""
        with self._lock:
            if self._count == 0:
                return None
            if self._count == 1:
                return self._min
            # nearest-rank index over the (conceptually sorted) samples
            k = int(round((q / 100.0) * (self._count - 1)))
            seen = self._zero
            if k < seen:
                return self._min
            for i in sorted(self._buckets):
                seen += self._buckets[i]
                if k < seen:
                    mid = math.exp((i + 0.5) * self._log_g)
                    return min(max(mid, self._min), self._max)
            return self._max

    def summary(self) -> Dict[str, Optional[float]]:
        empty = self._count == 0
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": (self._sum / self._count) if not empty else None,
            "min": None if empty else self._min,
            "max": None if empty else self._max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named, typed, get-or-create metric store with one snapshot shape."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, growth: float = 1.08) -> Histogram:
        return self._get(name, Histogram, growth)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """The canonical dict shape every subsystem's stats reduce to."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: The process-global registry every subsystem records into by default.
REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    """Drop every process-global metric (launchers call this at run start so
    a run record contains exactly that run; tests call it for isolation)."""
    REGISTRY.reset()
