"""LRU query cache keyed on packed query masks.

The port's own copy of the JAX package's ``serve/cache.py``, with the same
behaviour and the same keys: a key holds the mask's uint32 bytes (an int32
row converts with its bits kept), so the port's int32 words and the
reference's uint32 words of one basket key alike.

Real basket traffic is heavily repetitive (popular carts, hot itemsets), so
the cheapest query is the one never dispatched.  The cache sits in front of
the batched engine on the host: keys are the raw bytes of a packed uint32
query mask plus the query kind and its static knobs — exact, collision-free
and already in wire format (no canonicalization step; two baskets hash
equal iff their bitmaps are equal).

``OrderedDict`` LRU with hit/miss/eviction counters, its entries under one
lock: the serving service's dispatcher reads it while a hot-swap clears it
from another thread (the JAX package's cache has no lock, and a clear
between a lookup's membership test and its ``move_to_end`` raises there;
the values and counters are the same either way).  The launcher
(`launch/serve_mine.py`) reports the hit rate next to QPS and latency.
``split_batch`` is the serving-loop helper: partition a query batch into
cached results and the de-duplicated miss set that still needs a dispatch
(duplicates inside one batch dispatch once).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import metrics as obs_metrics


def query_key(kind: str, packed_row: np.ndarray, *knobs: Hashable) -> Tuple:
    """Cache key for one query: (kind, knobs..., mask bytes).

    When the engine's indexes can be hot-swapped (``repro_torch.stream``), include
    ``engine.generation`` among the knobs: entries raced in around a swap
    then key to the dead generation and can never serve stale results, even
    before :meth:`QueryCache.clear` lands.
    """
    return (kind, *knobs, np.asarray(packed_row, np.uint32).tobytes())


class CacheStats:
    """Per-cache counters as thin views over a metrics registry.

    The counts live in a per-instance :class:`~repro_torch.obs.metrics.
    MetricsRegistry` — every cache keeps its own numbers, exactly as the old
    plain-int dataclass did — and each event is mirrored into the
    process-global registry under the same ``serve/cache/...`` names, so a
    run's snapshot sees cache behavior without any extra plumbing.
    ``hits`` / ``misses`` / ``evictions`` / ``invalidations`` read exactly as
    before; mutation goes through the ``hit()`` / ``miss()`` / … recorders.
    """

    def __init__(self, registry: Optional[obs_metrics.MetricsRegistry] = None):
        self._reg = (
            registry if registry is not None else obs_metrics.MetricsRegistry()
        )

    def _inc(self, field: str) -> None:
        self._reg.counter(f"serve/cache/{field}").inc()
        g = obs_metrics.registry()
        if g is not self._reg:   # mirror unless we ARE the global registry
            g.counter(f"serve/cache/{field}").inc()
        if field in ("hits", "misses"):
            # keep the hit-rate gauge current on the ACCESS path — a
            # windowed SLO snapshot taken between stats() calls must never
            # read a stale value
            hr = self.hit_rate
            self._reg.gauge("serve/cache/hit_rate").set(hr)
            if g is not self._reg:
                g.gauge("serve/cache/hit_rate").set(hr)

    def hit(self) -> None:
        self._inc("hits")

    def miss(self) -> None:
        self._inc("misses")

    def eviction(self) -> None:
        self._inc("evictions")

    def invalidation(self) -> None:   # whole-cache clears (index hot-swaps)
        self._inc("invalidations")

    @property
    def hits(self) -> int:
        return self._reg.counter("serve/cache/hits").value

    @property
    def misses(self) -> int:
        return self._reg.counter("serve/cache/misses").value

    @property
    def evictions(self) -> int:
        return self._reg.counter("serve/cache/evictions").value

    @property
    def invalidations(self) -> int:
        return self._reg.counter("serve/cache/invalidations").value

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "hit_rate": self.hit_rate,
        }

    def snapshot(self) -> Dict[str, dict]:
        """This cache's counts in the canonical metrics-snapshot shape."""
        return self._reg.snapshot()


class QueryCache:
    """Bounded LRU over query results.

    ``capacity <= 0`` disables caching (every lookup is a miss, nothing is
    stored) so the serving loop needs no branches.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.stats = CacheStats()
        self._data: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: Tuple) -> Optional[Any]:
        with self._lock:
            if self.capacity <= 0 or key not in self._data:
                self.stats.miss()
                return None
            self.stats.hit()
            self._data.move_to_end(key)
            return self._data[key]

    def clear(self) -> int:
        """Drop every entry (index hot-swap invalidation); returns the count
        dropped.  Hit/miss/eviction counters survive — only the data goes."""
        with self._lock:
            n = len(self._data)
            self._data.clear()
            self.stats.invalidation()
            return n

    def put(self, key: Tuple, value: Any) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.stats.eviction()

    # -- batch helper ---------------------------------------------------------
    def split_batch(
        self, keys: Sequence[Tuple]
    ) -> Tuple[List[Optional[Any]], List[int]]:
        """Partition a batch into cached results and the miss set.

        Returns ``(results, miss_positions)``: ``results[i]`` is the cached
        value or None; ``miss_positions`` lists the indices still needing a
        dispatch, **first occurrence only** (duplicate keys inside the batch
        resolve from the first's result via :meth:`fill_batch`).
        """
        results: List[Optional[Any]] = []
        miss: List[int] = []
        seen: Dict[Tuple, int] = {}
        for i, key in enumerate(keys):
            hit = self.get(key)
            if hit is not None:
                results.append(hit)
            else:
                results.append(None)
                if key not in seen:
                    seen[key] = i
                    miss.append(i)
        return results, miss

    def fill_batch(
        self,
        keys: Sequence[Tuple],
        results: List[Optional[Any]],
        miss_positions: Sequence[int],
        miss_values: Sequence[Any],
    ) -> List[Any]:
        """Insert dispatched values, then resolve every remaining None.

        Duplicates resolve from a per-batch map of the dispatched values, so
        the result is complete even with caching disabled or under eviction
        pressure.
        """
        batch_map: Dict[Tuple, Any] = {}
        for pos, val in zip(miss_positions, miss_values):
            self.put(keys[pos], val)
            batch_map[keys[pos]] = val
        for i, r in enumerate(results):
            if r is None:
                results[i] = batch_map[keys[i]]
        return results
