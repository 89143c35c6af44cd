"""IBM-Quest-style synthetic transaction database generator (numpy).

The port's own copy of the JAX package's generator: the same draws in the
same order, so ``generate_dense`` is bit-equal to it for every name and
seed.  Names follow the thesis (§11.2):
``T<tx/1000>I<items/1000>P<patterns>PL<pattern_len>TL<tx_len>``, e.g.
``T500I0.1P50PL10TL40`` = 500k transactions over 100 items.

The generator (Agrawal & Srikant '94): a pool of "potentially frequent"
patterns with Poisson lengths and exponentially distributed weights; each
transaction is a union of weighted-sampled patterns, each item kept with a
per-pattern corruption rate, until the target length is reached.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np


@dataclasses.dataclass(frozen=True)
class IBMParams:
    n_tx: int = 2000
    n_items: int = 100
    n_patterns: int = 50
    avg_pattern_len: float = 10.0
    avg_tx_len: float = 40.0
    corruption: float = 0.5
    seed: int = 0

    @property
    def name(self) -> str:
        """The thesis-style name of these params (the store's ``source``)."""
        return (
            f"T{self.n_tx / 1000:g}I{self.n_items / 1000:g}"
            f"P{self.n_patterns}PL{self.avg_pattern_len:g}TL{self.avg_tx_len:g}"
        )


_NAME_RE = re.compile(
    r"T(?P<t>[\d.]+)I(?P<i>[\d.]+)P(?P<p>\d+)PL(?P<pl>[\d.]+)TL(?P<tl>[\d.]+)"
)


def params_from_name(name: str, seed: int = 0) -> IBMParams:
    """Parse a thesis-style database name into generator params."""
    m = _NAME_RE.fullmatch(name)
    if not m:
        raise ValueError(f"not a T..I..P..PL..TL.. database name: {name!r}")
    return IBMParams(
        n_tx=int(float(m["t"]) * 1000),
        n_items=max(int(float(m["i"]) * 1000), 1),
        n_patterns=int(m["p"]),
        avg_pattern_len=float(m["pl"]),
        avg_tx_len=float(m["tl"]),
        seed=seed,
    )


@dataclasses.dataclass(frozen=True)
class PatternPool:
    """The generator's latent state: what counts as a "frequent pattern"."""

    patterns: list          # list[np.int64 array] — the potential FIs
    weights: np.ndarray     # float [P] — normalized pattern popularity
    corruption: np.ndarray  # float [P] — per-pattern item-drop rate


def _draw_pattern_pool(rng: np.random.Generator, params: IBMParams) -> PatternPool:
    I, P = params.n_items, params.n_patterns
    # Pattern lengths ~ Poisson(avg_pattern_len), at least 1, at most n_items.
    plens = np.clip(rng.poisson(params.avg_pattern_len, P), 1, I)
    patterns = []
    prev: np.ndarray | None = None
    for k in range(P):
        L = int(plens[k])
        # Successive patterns share items: take half from the previous one.
        take_prev = 0
        base: list[int] = []
        if prev is not None and len(prev) > 1:
            take_prev = min(L // 2, len(prev))
            base = list(rng.choice(prev, size=take_prev, replace=False))
        rest = rng.choice(I, size=I, replace=False, p=None)
        for it in rest:
            if len(base) >= L:
                break
            if it not in base:
                base.append(int(it))
        patterns.append(np.array(sorted(base[:L]), dtype=np.int64))
        prev = patterns[-1]

    pw = rng.exponential(1.0, P)
    pw /= pw.sum()
    corr = np.clip(rng.normal(params.corruption, 0.1, P), 0.0, 0.95)
    return PatternPool(patterns=patterns, weights=pw, corruption=corr)


def _emit_transactions(
    rng: np.random.Generator, params: IBMParams, pool: PatternPool, n_tx: int
) -> np.ndarray:
    """Emit ``n_tx`` transactions from a pattern pool: dense bool [n_tx, I]."""
    I, P = params.n_items, params.n_patterns
    tlens = np.clip(rng.poisson(params.avg_tx_len, n_tx), 1, I)
    dense = np.zeros((n_tx, I), dtype=bool)
    pat_choices = rng.choice(P, size=(n_tx, 8), p=pool.weights)
    for t in range(n_tx):
        target = int(tlens[t])
        got = 0
        for k in pat_choices[t]:
            if got >= target:
                break
            pat = pool.patterns[k]
            keep = rng.random(len(pat)) >= pool.corruption[k]
            dense[t, pat[keep]] = True
            got = int(dense[t].sum())
        if got == 0:  # guarantee non-empty transactions
            dense[t, rng.integers(0, I)] = True
    return dense


def generate_blocks(params: IBMParams, block_tx: int):
    """Yield the database as dense bool blocks ``[≤block_tx, n_items]``.

    Each block's draws (lengths, pattern picks, corruption) happen when the
    block is emitted, so the host holds one block at a time; the store spill
    (``repro_torch.store.write_ibm_store``) packs each block as it lands.
    The reference's draws in the reference's order, so the blocks are
    bit-equal to its ``generate_blocks``.  With ``block_tx >= n_tx`` the one
    block is :func:`generate_dense`'s matrix; smaller blocks draw per block,
    so a blocked database is a dataset of its own, not a re-chunking of the
    unblocked one.
    """
    if block_tx <= 0:
        raise ValueError(f"block_tx must be positive (got {block_tx})")
    rng = np.random.default_rng(params.seed)
    pool = _draw_pattern_pool(rng, params)
    done = 0
    while done < params.n_tx:
        b = min(block_tx, params.n_tx - done)
        yield _emit_transactions(rng, params, pool, b)
        done += b


def generate_dense(params: IBMParams) -> np.ndarray:
    """Generate a dense bool transaction matrix ``[n_tx, n_items]``."""
    if params.n_tx == 0:
        return np.zeros((0, params.n_items), dtype=bool)
    rng = np.random.default_rng(params.seed)
    pool = _draw_pattern_pool(rng, params)
    return _emit_transactions(rng, params, pool, params.n_tx)


def drifting_stream(
    params: IBMParams,
    *,
    n_blocks: int,
    block_tx: int,
    breaks: tuple = (),
):
    """Yield a concept-drifting transaction stream, block by block.

    Yields ``(dense_block [block_tx, n_items], segment_id)`` for
    ``n_blocks`` blocks.  At every block index listed in ``breaks`` the
    pattern pool is **re-drawn** (fresh patterns, weights, and corruption
    over the same item universe): an abrupt concept drift.  ``segment_id``
    counts the pool in force (0 = initial).

    One host generator drives pool draws and emission in sequence, as in
    the reference, so the same (params, n_blocks, block_tx, breaks) gives
    the reference's blocks, bit for bit.
    """
    rng = np.random.default_rng(params.seed)
    pool = _draw_pattern_pool(rng, params)
    bset = {int(b) for b in breaks}
    segment = 0
    for b in range(n_blocks):
        if b in bset:
            # a break at 0 re-draws over the initial pool, as documented —
            # segment ids then start at 1
            pool = _draw_pattern_pool(rng, params)
            segment += 1
        yield _emit_transactions(rng, params, pool, block_tx), segment
