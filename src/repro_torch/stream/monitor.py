"""Drift detection for the streaming miner — thesis Ch. 6 turned online.

The port of the JAX package's ``stream/monitor.py``.  Its sample is drawn
with numpy's generator from the same seed, row for row as the reference
draws it, and held on the device; the estimate runs kernel B5 on the card.

The thesis uses sampling to make mining *cheaper*; here the same machinery
decides *when a mined FI table has gone stale*.  The monitor maintains a
uniform sample of the **current window** and fires a re-mine trigger on
either of two signals:

* **Support-error signal** (Thm 6.1).  Estimate the relative support of
  every indexed itemset on the sample and compare against what the serving
  index claims.  The sample is sized by ``sampling.db_sample_size(ε/2, δ)``
  so the estimator itself errs ≤ ε/2 w.p. ≥ 1−δ; firing when the observed
  discrepancy exceeds ε/2 then gives the two-sided guarantee (per itemset,
  w.p. ≥ 1−δ): a fresh table (true error 0) does not fire, and a table whose
  true support error exceeds ε does.
* **Border signal** (exact).  Itemsets whose mine-time relative support was
  within ``border_margin`` of minsup are *tracked*; the streaming engine
  maintains their exact current window supports via the delta kernel, and
  the monitor fires as soon as a tracked itemset crosses minsup — the
  mined table's membership is then provably wrong, no estimation needed.
  ``border_hysteresis`` requires the crossing to clear minsup by that much
  before firing, so a support sitting exactly on the threshold doesn't
  flap a re-mine on every one-transaction fluctuation.

Window sampling is stratified by block: ``m = ⌈n/B⌉`` rows are drawn
uniformly without replacement from each admitted block and retired with it
(a deque aligned with the ring buffer).  Blocks have equal size, so the
union is a uniform (without-replacement) sample of the window — the
hypergeometric regime of Thm 6.3, for which the with-replacement Chernoff
bound of Thm 6.1 is conservative.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import sampling
from repro_torch.kernels import ops


def chernoff_eps(n: int, delta: float) -> float:
    """Invert Thm 6.1: support error of an n-row sample, w.p. ≥ 1−δ."""
    return math.sqrt(math.log(2.0 / delta) / (2.0 * n))


@dataclasses.dataclass(frozen=True)
class DriftVerdict:
    """Outcome of one drift check (all fields observable by the caller)."""

    fired: bool
    reason: Optional[str]        # "error" | "border" | None
    max_err: float               # max |p̂_sample − p_served| over indexed FIs
    threshold: float             # the ε/2 firing threshold
    eps_sample: float            # Thm 6.1 error of the sample actually held
    n_sample: int
    n_border_crossed: int = 0


class DriftMonitor:
    """Window sampler + staleness test for a served FI table.

    Args:
      eps:    staleness tolerance ε on relative support (fire at true
              error > ε; never fire at 0, each w.p. ≥ 1−δ).
      delta:  confidence parameter δ of Thm 6.1.
      n_blocks / block_tx: ring geometry (sets the per-block sample quota).
      border_margin: track itemsets with |supp_rel − minsup| ≤ margin for
              the exact border signal (0 disables).
      seed:   host RNG seed (sampling is deterministic given the stream).
    """

    def __init__(
        self,
        n_blocks: int,
        block_tx: int,
        *,
        eps: float = 0.1,
        delta: float = 0.05,
        border_margin: float = 0.0,
        border_hysteresis: float = 0.0,
        seed: int = 0,
    ):
        self.eps = float(eps)
        self.delta = float(delta)
        self.border_margin = float(border_margin)
        self.border_hysteresis = float(border_hysteresis)
        n_target = sampling.db_sample_size(eps / 2.0, delta)
        self.rows_per_block = min(block_tx, -(-n_target // n_blocks))
        if n_blocks * block_tx < n_target:
            # the whole window is smaller than the Thm 6.1 sample: the ε/2
            # firing threshold no longer carries the two-sided guarantee
            # (check() still reports the achievable eps_sample per verdict)
            warnings.warn(
                f"window of {n_blocks * block_tx} tx cannot hold the "
                f"{n_target}-row Thm 6.1 sample for eps={eps}, delta={delta}; "
                f"drift detection degrades to "
                f"eps≈{2 * chernoff_eps(n_blocks * block_tx, delta):.3f}",
                stacklevel=2,
            )
        self._samples: deque = deque(maxlen=n_blocks)
        self._rng = np.random.default_rng(seed)
        # armed state (set by rearm() after each (re-)mine)
        self._served_rel: Optional[np.ndarray] = None
        self._tracked: Optional[np.ndarray] = None
        self._minsup_rel: float = 0.0

    # -- window sample maintenance -------------------------------------------
    def admit(self, block_packed: torch.Tensor) -> None:
        """Subsample one admitted block ``int32[T, IW]`` (on its device); the
        deque retires the expired one."""
        pick = self._rng.choice(
            block_packed.shape[0], size=self.rows_per_block, replace=False
        )
        self._samples.append(block_packed[torch.from_numpy(pick).to(block_packed.device)])

    @property
    def n_sample(self) -> int:
        return sum(s.shape[0] for s in self._samples)

    def sample_rows(self) -> torch.Tensor:
        """int32[n_sample, IW] — the current window sample."""
        return torch.cat(list(self._samples), dim=0)

    # -- arming ----------------------------------------------------------------
    def rearm(self, served_rel: np.ndarray, minsup_rel: float) -> None:
        """Snapshot what the freshly swapped index serves; reset tracking."""
        self._served_rel = np.asarray(served_rel, np.float64)
        self._minsup_rel = float(minsup_rel)
        if self.border_margin > 0.0:
            self._tracked = (
                np.abs(self._served_rel - minsup_rel) <= self.border_margin
            )
        else:
            self._tracked = np.zeros(self._served_rel.shape, bool)

    # -- the drift test --------------------------------------------------------
    def estimate_rel_supports(self, fi_masks: torch.Tensor) -> np.ndarray:
        """float64[F] sample-estimated relative supports of the indexed FIs
        (kernel B5 at S=1 on the card)."""
        rows = self.sample_rows()
        counts = ops.block_itemset_supports(rows[None], fi_masks)
        return counts[0].cpu().numpy().astype(np.float64) / rows.shape[0]

    def check(
        self,
        fi_masks: torch.Tensor,
        *,
        current_rel: Optional[np.ndarray] = None,
    ) -> DriftVerdict:
        """Run both staleness signals against the armed serving snapshot.

        ``current_rel`` (optional) is the engine's exact delta-maintained
        relative supports — enables the border signal; the support-error
        signal needs only the sample.
        """
        if self._served_rel is None:
            raise RuntimeError("monitor not armed (call rearm)")
        n = self.n_sample
        est = self.estimate_rel_supports(fi_masks)
        err = np.abs(est - self._served_rel)
        max_err = float(err.max()) if err.size else 0.0
        threshold = self.eps / 2.0
        eps_n = chernoff_eps(n, self.delta) if n else float("inf")

        n_crossed = 0
        if current_rel is not None and self._tracked is not None:
            cur = np.asarray(current_rel)
            h = self.border_hysteresis
            served_freq = self._served_rel >= self._minsup_rel
            # crossing must clear minsup by the hysteresis band to count
            crossed = np.where(
                served_freq,
                cur < self._minsup_rel - h,
                cur >= self._minsup_rel + h,
            )
            n_crossed = int((self._tracked & crossed).sum())

        if n_crossed:
            reason: Optional[str] = "border"
        elif max_err > threshold:
            reason = "error"
        else:
            reason = None
        return DriftVerdict(
            fired=reason is not None,
            reason=reason,
            max_err=max_err,
            threshold=threshold,
            eps_sample=eps_n,
            n_sample=n,
            n_border_crossed=n_crossed,
        )
