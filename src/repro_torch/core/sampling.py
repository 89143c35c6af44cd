"""Sampling theory and the samplers of Phase 1 (thesis Ch. 6).

Sample sizes:
  * Thm 6.1 (Toivonen/Chernoff):    |D̃| ≥ 1/(2ε²)·ln(2/δ)
  * Thm 6.2 (coverage, i.i.d.):     |F̃s| ≥ 4/(ε²ρ)·ln(2/δ)
  * Thm 6.3 (reservoir, hypergeom.): |F̃s| ≥ −log(δ/2)/D(ρ+ε‖ρ)

Samplers:
  * :func:`modified_coverage_sample` — Alg. 8 on the device, vectorised over
    the N draws (the Seq and Par variants' fast, non-uniform heuristic);
  * :func:`coverage_sample_uniform` — Alg. 7 on the host (uniform; checks the
    heuristic);
  * the reservoir runs inside the Eclat loop (:mod:`repro_torch.core.eclat`);
    :func:`reservoir_sample_np` is its host oracle;
  * :func:`merge_reservoirs` — Phase-1-Reservoir lines 10–14: hypergeometric
    re-weighting of P local reservoirs into one global uniform sample;
  * :func:`sample_db` — the i.i.d. transaction sample as a BitmapDB.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import bitmap as bm


def db_sample_size(eps: float, delta: float) -> int:
    """Thm 6.1 — database sample size for support error ≤ ε w.p. ≥ 1−δ."""
    return int(math.ceil(math.log(2.0 / delta) / (2.0 * eps * eps)))


def coverage_sample_size(eps: float, delta: float, rho: float) -> int:
    """Thm 6.2 — i.i.d. FI-sample size for relative-size error ≤ ε·ρ."""
    return int(math.ceil(4.0 / (eps * eps * rho) * math.log(2.0 / delta)))


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


def modified_coverage_sample(
    mfi_items: torch.Tensor,   # int32[M, IW] packed MFI (candidate) masks
    mfi_valid: torch.Tensor,   # bool [M]
    n_samples: int,
    n_items: int,
    *,
    generator: torch.Generator | None = None,
    picks: torch.Tensor | None = None,   # int[N]
    bits: torch.Tensor | None = None,    # int32[N, IW]
) -> torch.Tensor:
    """Draw N itemsets (Alg. 8): pick m with weight |P(m)| = 2^|m|, then a
    uniform subset of m (a random word ANDed onto each mask word).

    The dedup loop of Alg. 7 is dropped, so the draws are independent but
    not uniform over F̃: the thesis calls this estimate a heuristic.  The
    picks and the random words come from ``generator``, or from ``picks`` and
    ``bits`` when given (so a test can replay the reference's draws).
    Returns packed masks ``int32[N, IW]`` on ``mfi_items``' device.
    """
    dev = mfi_items.device
    IW = mfi_items.shape[-1]
    if picks is None:
        valid = mfi_valid.to(dev, torch.bool)
        if not bool(valid.any()):
            raise ValueError("no valid MFI to draw from")
        sizes = bm.popcount(mfi_items).sum(dim=-1).to(torch.float64)
        sizes = torch.where(valid, sizes, float("-inf"))
        weights = torch.exp2(sizes - sizes.max())          # ∝ 2^|m|, 0 where invalid
        picks = torch.multinomial(weights, n_samples, replacement=True, generator=generator)
    elif picks.shape != (n_samples,):
        raise ValueError(f"picks has shape {tuple(picks.shape)}, want ({n_samples},)")
    if bits is None:
        bits = torch.randint(-(1 << 31), 1 << 31, (n_samples, IW), generator=generator,
                             dtype=torch.int32, device=dev)
    elif bits.shape != (n_samples, IW):
        raise ValueError(f"bits has shape {tuple(bits.shape)}, want ({n_samples}, {IW})")
    return mfi_items[picks.to(dev, torch.int64)] & bits.to(dev, torch.int32)


def coverage_sample_uniform(
    rng: np.random.Generator,
    mfi_masks: np.ndarray,  # bool [M, I]
    n_samples: int,
) -> np.ndarray:
    """Uniform i.i.d. sample of ∪ P(m_i) by the coverage rejection rule
    (Alg. 7, on the host).

    A draw (W, i) is kept iff i is the *smallest* index with W ⊆ m_i, which
    samples the set S' of §6.2.1 whose elements biject with F̃.
    """
    M, I = mfi_masks.shape
    sizes = mfi_masks.sum(axis=1)
    w = np.exp2(sizes - sizes.max())
    w = w / w.sum()
    out = np.zeros((n_samples, I), dtype=bool)
    k = 0
    while k < n_samples:
        i = rng.choice(M, p=w)
        subset = mfi_masks[i] & (rng.random(I) < 0.5)
        earlier = mfi_masks[:i]   # line 6: reject if inside an earlier MFI
        if earlier.size and (~(subset & ~earlier).any(axis=1)).any():
            continue
        out[k] = subset
        k += 1
    return out


def reservoir_sample_np(rng: np.random.Generator, stream: np.ndarray, n: int) -> np.ndarray:
    """Algorithm R over a host stream: the in-loop sampler's oracle."""
    R = stream[:n].copy()
    for t in range(n, len(stream)):
        j = rng.integers(0, t + 1)
        if j < n:
            R[j] = stream[t]
    return R


def sample_db(
    db: bm.BitmapDB,
    n_sample: int,
    *,
    generator: torch.Generator | None = None,
    idx: torch.Tensor | None = None,
) -> bm.BitmapDB:
    """i.i.d. with-replacement transaction sample as a new BitmapDB; the row
    indices come from ``generator``, or from ``idx`` when given."""
    rows = bm.sample_transactions(db.tx_bits, n_sample, generator=generator, idx=idx)
    return bm.rebuild_vertical(rows, db.n_items, n_sample)
