"""Dynamic work rebalancing between mining rounds.

The port's own copy of the JAX package's ``cluster/rebalance.py`` (numpy
only), with the same behaviour, so one load ledger drives the same
donations in both packages and a checkpoint of either resumes in the other.

The paper's estimator is *static*: class sizes come from one sample taken
before any mining starts, so a shard whose classes were under-estimated
stays overloaded for the whole of Phase 4 — exactly the skew that the
distributed-Apriori literature (Aouad et al.; Koundinya et al.) identifies
as the speedup killer.  The executor therefore mines in **rounds** and this
module closes the loop between them:

  * :class:`LoadLedger` ingests per-shard telemetry (observed DFS trips per
    round — ``Phase4Out.work_iters``, the load metric the miner already
    reports) and maintains a per-shard *rate*: observed trips per unit of
    estimated size actually mined there.  A rate > 1 means the sample
    under-estimated that shard's classes.
  * :func:`rebalance` compares the rate-corrected **remaining** load of every
    shard queue; while the skew (max/mean) exceeds a threshold it donates
    unexplored PBEC subtrees — whole classes, from the *tail* of the most
    loaded queue (its cheapest pending work, so the expensive head the
    estimates placed deliberately stays put) — to the least loaded shard.
    Donations per call are bounded, so a pathological estimate cannot turn
    the control plane into a thrash loop.

Donating a class is *exact* by construction: the executor re-runs the
Phase-3 exchange for each round's classes, so the recipient shard receives
precisely the transactions containing the donated prefix before it mines it
(no stale slab is ever reused across an ownership change).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np


class Donation(NamedTuple):
    """One class moved between shard queues (telemetry record)."""

    round_index: int
    class_id: int
    src: int
    dst: int


@dataclasses.dataclass
class LoadLedger:
    """Per-shard telemetry accumulator: estimated-vs-observed load.

    ``rates[p]`` converts the planner's size estimates into observed DFS
    trips for shard p; shards with no history fall back to the global rate,
    and the global rate starts at 1.0 (trust the estimates until told
    otherwise).
    """

    P: int
    observed: np.ndarray = dataclasses.field(default=None)   # trips per shard
    est_mined: np.ndarray = dataclasses.field(default=None)  # est units mined

    def __post_init__(self):
        if self.observed is None:
            self.observed = np.zeros(self.P, dtype=np.float64)
        if self.est_mined is None:
            self.est_mined = np.zeros(self.P, dtype=np.float64)

    def record_round(self, trips: np.ndarray, est_mined: np.ndarray) -> None:
        """Add one round of telemetry (both arrays are per-shard, length P)."""
        self.observed += np.asarray(trips, dtype=np.float64)
        self.est_mined += np.asarray(est_mined, dtype=np.float64)

    @property
    def global_rate(self) -> float:
        tot_est = float(self.est_mined.sum())
        if tot_est <= 0.0:
            return 1.0
        return float(self.observed.sum()) / tot_est

    def rates(self) -> np.ndarray:
        """float [P] — observed trips per estimated size unit, per shard."""
        g = self.global_rate
        out = np.full(self.P, g, dtype=np.float64)
        has = self.est_mined > 0.0
        out[has] = self.observed[has] / self.est_mined[has]
        return out

    def imbalance(self) -> float:
        """max/mean of cumulative observed load (1.0 = perfect balance)."""
        mean = float(self.observed.mean())
        if mean <= 0.0:
            return 1.0
        return float(self.observed.max()) / mean


def remaining_loads(
    queues: List[List[int]],
    est_sizes: np.ndarray,
    rates: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Rate-corrected estimated load still queued on every shard."""
    P = len(queues)
    rates = np.ones(P) if rates is None else np.asarray(rates, dtype=np.float64)
    # every queued class costs at least ~1 trip (the pop that prunes it), so
    # an all-zero estimate still exposes queue-length skew to the balancer
    return np.array(
        [
            rates[p] * float(sum(max(est_sizes[c], 1.0) for c in queues[p]))
            for p in range(P)
        ]
    )


def rebalance(
    queues: List[List[int]],
    est_sizes: np.ndarray,
    ledger: LoadLedger,
    *,
    round_index: int,
    skew_threshold: float = 1.25,
    max_donations: int = 8,
) -> List[Donation]:
    """Donate queued classes from overloaded to underloaded shards, in place.

    Runs at most ``max_donations`` single-class moves; stops early once the
    rate-corrected remaining skew (max/mean) drops under ``skew_threshold``
    or a move would overshoot (never makes the donor lighter than the
    recipient was — the classic list-scheduling stability rule).
    """
    rates = ledger.rates()
    donations: List[Donation] = []
    for _ in range(max_donations):
        loads = remaining_loads(queues, est_sizes, rates)
        mean = float(loads.mean())
        if mean <= 0.0 or float(loads.max()) <= skew_threshold * mean:
            break
        src = int(loads.argmax())
        dst = int(loads.argmin())
        if src == dst or not queues[src]:
            break
        cid = queues[src][-1]  # tail = lightest pending class of the donor
        cost_dst = rates[dst] * max(float(est_sizes[cid]), 1.0)
        # stability: donating must not just swap who is overloaded
        if loads[dst] + cost_dst >= loads[src]:
            break
        queues[src].pop()
        queues[dst].append(cid)
        donations.append(Donation(round_index, int(cid), src, dst))
    return donations
