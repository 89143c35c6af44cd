"""Schedulers: LPT (Alg. 16) and the replication-aware greedy QKP (Alg. 23).

Host-side control plane (numpy).  ``pairwise_shared_transactions`` counts on
the port's packed tidlists: on the card with kernel B6.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.kernels import ops


def lpt_schedule(sizes: Sequence[float], n_processors: int) -> np.ndarray:
    """Assign each task to the least-loaded processor, largest tasks first.

    Ties go to the lowest processor index, so every host computes the same
    schedule from the same sample.
    """
    sizes = np.asarray(sizes, dtype=np.float64)
    order = np.argsort(-sizes, kind="stable")
    loads = np.zeros(n_processors, dtype=np.float64)
    assignment = np.zeros(len(sizes), dtype=np.int64)
    for t in order:
        p = int(np.argmin(loads))
        assignment[t] = p
        loads[p] += sizes[t]
    return assignment


def loads_of(sizes: Sequence[float], assignment: np.ndarray, P: int) -> np.ndarray:
    loads = np.zeros(P, dtype=np.float64)
    np.add.at(loads, assignment, np.asarray(sizes, dtype=np.float64))
    return loads


def lpt_makespan_bound_ok(sizes: Sequence[float], assignment: np.ndarray, P: int) -> bool:
    """Soundly checkable Graham guarantee: ``makespan ≤ Σ/P + (1 − 1/P)·max``.

    The classic 4/3·OPT bound needs the true OPT; against the computable
    lower bound max(mean, max) this list-scheduling guarantee is the sound
    one (it implies ≤ 2·OPT, and LPT is 4/3-optimal per Lemma 8.2)."""
    sizes = np.asarray(sizes, dtype=np.float64)
    if len(sizes) == 0:
        return True
    loads = loads_of(sizes, assignment, P)
    bound = sizes.sum() / P + (1.0 - 1.0 / P) * sizes.max()
    return loads.max() <= bound + 1e-9


def makespan_of(sizes: Sequence[float], assignment: np.ndarray, P: int) -> float:
    """Max processor load under an assignment (the schedule's makespan)."""
    return float(loads_of(sizes, assignment, P).max())


def replicated_volume(
    tidlists: np.ndarray,     # uint32[C, W] packed class tidlists T(U_i)
    assignment: np.ndarray,   # int[C]
    n_processors: int,
) -> float:
    """Σ_p |D'_p| with ``|D'_p| = popcount(OR of T(U_i) over classes on p)``."""
    tidlists = np.asarray(tidlists, dtype=np.uint32)
    total = 0
    for p in range(n_processors):
        rows = tidlists[np.asarray(assignment) == p]
        if len(rows) == 0:
            continue
        union = np.bitwise_or.reduce(rows, axis=0)
        total += int(np.unpackbits(union.view(np.uint8)).sum())
    return float(total)


class ReplAssignment(NamedTuple):
    """DB-Repl-Min output: the assignment and its replicated volume (NaN
    without tidlists)."""

    assignment: np.ndarray
    volume: float


def db_repl_min(
    sizes: np.ndarray,        # est. class sizes w_i
    profit: np.ndarray,       # S_ij shared-transaction counts
    n_processors: int,
    tidlists: Optional[np.ndarray] = None,
) -> ReplAssignment:
    """Alg. 23 (DB-Repl-Min): for each processor in turn, greedily add the
    free class with the largest shared-transaction profit against the
    classes already there, up to the capacity Σw/P (5% slack); the last
    processor takes the rest."""
    n = len(sizes)
    sizes = np.asarray(sizes, dtype=np.float64)
    cap = sizes.sum() / n_processors
    assignment = np.full(n, -1, dtype=np.int64)
    for p in range(n_processors - 1):
        free = np.nonzero(assignment < 0)[0]
        if free.size == 0:
            break
        load = 0.0
        seed = free[np.argmax(sizes[free])]
        chosen = [seed]
        assignment[seed] = p
        load += sizes[seed]
        while True:
            free = np.nonzero(assignment < 0)[0]
            if free.size == 0:
                break
            gains = profit[np.ix_(free, chosen)].sum(axis=1)
            ordergain = np.argsort(-gains, kind="stable")
            placed = False
            for gi in ordergain:
                c = free[gi]
                if load + sizes[c] <= cap * 1.05:
                    assignment[c] = p
                    chosen.append(c)
                    load += sizes[c]
                    placed = True
                    break
            if not placed:
                break
    assignment[assignment < 0] = n_processors - 1

    volume = (
        replicated_volume(tidlists, assignment, n_processors)
        if tidlists is not None
        else float("nan")
    )
    return ReplAssignment(assignment=assignment, volume=volume)


def pairwise_shared_transactions(tidlists: torch.Tensor) -> np.ndarray:
    """S_ij = popcount(tid_i & tid_j) for packed int32 tidlists [C, W],
    with a zero diagonal: DB-Repl-Min's profit matrix, through
    ``ops.pair_supports`` with every word valid (kernel B6 on the card)."""
    all_words = torch.full((tidlists.shape[1],), bm.ALL_ONES, dtype=torch.int32,
                           device=tidlists.device)
    inter = ops.pair_supports(tidlists.contiguous(), all_words, use_mxu=False)
    out = inter.cpu().numpy().copy()
    np.fill_diagonal(out, 0)
    return out
