"""Serving step builders: the full-sequence prefill and one cached decode step.

The port of the JAX package's ``make_prefill_step`` and ``make_serve_step``
(``models/steps.py``).  Nothing here is compiled: each call runs the model's
ops on the parameters' device.  Training (``make_train_step``) is not part
of the serving path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig, attn_chunk: Optional[int] = None):
    """Full-sequence forward returning last-position logits."""

    @torch.no_grad()
    def prefill(params, batch):
        return M.forward(cfg, params, batch, chunk=attn_chunk)[:, -1]

    return prefill


def make_serve_step(cfg: ModelConfig):
    """One incremental decode step: (params, cache, tokens[B,1], pos)."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache, tokens, pos)

    return serve_step
