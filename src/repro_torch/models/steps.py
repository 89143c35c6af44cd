"""The step functions: the train step, the full-sequence prefill and one cached
decode step.

The port of the JAX package's ``models/steps.py``.  Nothing here is
compiled: each call runs the model's ops on the parameters' device.  The
reference's ``batch_spec``/``act_spec`` (sharding constraints) are not
taken: the port's train step runs on one device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers import leaves, torch_dtype, tree_of
from repro_torch.optim import adamw


def value_and_grad(cfg: ModelConfig, params, batch, chunk: Optional[int] = None):
    """``(loss, grads)`` of ``loss_fn`` at ``params``: the gradients in the
    parameters' tree and dtype, zeros for a leaf the loss does not reach."""
    paths, flat = zip(*leaves(params))
    for p in flat:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss = M.loss_fn(cfg, params, batch, chunk)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), tree_of(zip(paths, grads))


def accumulated_grads(cfg: ModelConfig, params, batch, accum: int = 1,
                      chunk: Optional[int] = None,
                      accum_dtype: torch.dtype | str = torch.float32):
    """``(loss, grads)`` of the train step: with ``accum > 1`` the batch's
    leading dim is split into ``accum`` microbatches, whose gradients are
    summed in ``accum_dtype`` and divided by ``accum`` (the loss likewise,
    in f32); with ``accum == 1`` the gradients keep the parameters' dtype."""
    if accum == 1:
        return value_and_grad(cfg, params, batch, chunk)
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"a batch of {B} does not split into {accum} microbatches")
    dt = torch_dtype(accum_dtype)
    paths, flat = zip(*leaves(params))
    gsum = [torch.zeros(p.shape, dtype=dt, device=p.device) for p in flat]
    lsum = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
    for mb in zip(*(v.reshape((accum, B // accum) + v.shape[1:]) for v in batch.values())):
        loss, g = value_and_grad(cfg, params, dict(zip(batch, mb)), chunk)
        for a, (_, b) in zip(gsum, leaves(g)):
            a.copy_(a.float() + b)   # f32 sum, stored in accum_dtype
        lsum = lsum + loss
    return lsum / accum, tree_of(zip(paths, (g / accum for g in gsum)))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, accum: int = 1,
                    attn_chunk: Optional[int] = None,
                    accum_dtype: torch.dtype | str = torch.float32):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``; ``params`` and the moments are updated
    in place (``adamw.update``)."""

    def train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor]) -> Tuple[Any, adamw.AdamWState, Dict]:
        loss, grads = accumulated_grads(cfg, params, batch, accum, attn_chunk, accum_dtype)
        params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


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
