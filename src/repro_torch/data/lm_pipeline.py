"""Deterministic, shardable, checkpointable LM token pipeline.

The port of the JAX package's ``data/lm_pipeline.py``, numpy on the host:
its batches are the reference's, bit for bit, for any ``(seed, step,
n_hosts, host_id)``.

  * **stateless addressing**: batch ``i`` of host ``h`` is a pure function
    of (seed, step, host), so a restart replays the exact stream;
  * **checkpointable state**: ``step`` and ``seed``, stored in the
    checkpoint manifest (``state_dict``/``load_state_dict``);
  * **LPT length-bucketing**: sampled document lengths are packed into the
    batch's rows with the LPT rule Phase 2 uses for PBECs (the port's own
    ``core/schedule.lpt_schedule``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.core.schedule import lpt_schedule


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int


class SyntheticLM:
    """Markov-ish synthetic token stream with document structure."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                 mean_doc_len: int = 256):
        if global_batch % n_hosts:
            raise ValueError(f"a global batch of {global_batch} does not split over "
                             f"{n_hosts} hosts")
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.host_id = host_id
        self.mean_doc_len = mean_doc_len
        self.state = PipelineState(seed=seed, step=0)

    # -- stateless batch addressing -------------------------------------------
    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * 631 + self.host_id
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng_for(step)
        B, S = self.local_batch, self.seq_len
        # documents: lengths ~ clipped exponential; LPT-pack into B rows
        n_docs = max(B * S // self.mean_doc_len, B)
        lens = np.clip(rng.exponential(self.mean_doc_len, n_docs).astype(int), 16, S)
        rows = lpt_schedule(lens, B)
        tokens = np.zeros((B, S), dtype=np.int32)
        mask = np.zeros((B, S), dtype=bool)
        fill = np.zeros(B, dtype=int)
        for d in np.argsort(-lens, kind="stable"):
            r = rows[d]
            L = int(min(lens[d], S - fill[r]))
            if L <= 0:
                continue
            # a document-level base plus a running sum of small steps
            base = rng.integers(0, self.vocab)
            seq = (base + np.cumsum(rng.integers(0, 17, L))) % self.vocab
            tokens[r, fill[r]: fill[r] + L] = seq
            mask[r, fill[r]: fill[r] + L] = True
            fill[r] += L
        return {"tokens": tokens, "loss_mask": mask[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    # -- checkpoint plumbing ----------------------------------------------------
    def state_dict(self) -> Dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: Dict):
        self.state = PipelineState(**d)
