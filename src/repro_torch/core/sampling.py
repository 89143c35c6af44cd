"""Sample sizes and the reservoir merge of Phase 1 (thesis Ch. 6).

  * Thm 6.1 (Toivonen/Chernoff):    |D̃| ≥ 1/(2ε²)·ln(2/δ)
  * Thm 6.3 (reservoir, hypergeom.): |F̃s| ≥ −log(δ/2)/D(ρ+ε‖ρ)
  * Phase-1-Reservoir lines 10–14: hypergeometric re-weighting of P local
    reservoirs into one global uniform sample.

The reservoir itself runs inside the Eclat loop (:mod:`repro_torch.core.eclat`).
"""
from __future__ import annotations

import math

import numpy as np


def db_sample_size(eps: float, delta: float) -> int:
    """Thm 6.1 — database sample size for support error ≤ ε w.p. ≥ 1−δ."""
    return int(math.ceil(math.log(2.0 / delta) / (2.0 * eps * eps)))


def kl_bernoulli(p: float, q: float) -> float:
    """Kullback–Leibler divergence D(p‖q) of Bernoulli distributions."""
    p = min(max(p, 1e-12), 1 - 1e-12)
    q = min(max(q, 1e-12), 1 - 1e-12)
    return p * math.log(p / q) + (1 - p) * math.log((1 - p) / (1 - q))


def reservoir_sample_size(eps: float, delta: float, rho: float) -> int:
    """Thm 6.3 — hypergeometric (reservoir) FI-sample size."""
    return int(math.ceil(-math.log(delta / 2.0) / kl_bernoulli(rho + eps, rho)))


def merge_reservoirs(
    rng: np.random.Generator,
    counts: np.ndarray,  # f_i: total FIs seen by each processor [P]
    n_take: int,
) -> np.ndarray:
    """X ~ multivariate hypergeometric(f_i): processor i contributes X_i of
    its reservoir.  Returns ``int[P]`` with ΣX = min(n_take, Σf)."""
    counts = np.asarray(counts, dtype=np.int64)
    remaining = counts.copy()
    total = int(counts.sum())
    n_take = min(n_take, total)
    X = np.zeros(len(counts), dtype=np.int64)
    left = n_take
    pool = total
    for i in range(len(counts)):
        if left == 0 or pool == 0:
            break
        x = rng.hypergeometric(remaining[i], pool - remaining[i], left)
        X[i] = x
        left -= x
        pool -= remaining[i]
    return X
