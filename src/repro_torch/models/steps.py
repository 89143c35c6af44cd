"""The step functions: the train step, the full-sequence prefill and one cached
decode step.

The port of the JAX package's ``models/steps.py``.  Nothing here is
compiled: each call runs the model's ops on the parameters' device.

Sharded steps: given DTensor parameters (``distributed.sharding``) the
steps run under DTensor's sharding propagation on their mesh
(``distributed.dtensor.sharded_context``).  The reference's sharding
constraints are taken: ``batch_spec`` (an entry of a ``PartitionSpec``: the
mesh axes of one microbatch's leading dim) redistributes each microbatch
after the reshape, ``act_spec`` (a ``PartitionSpec`` of [B, T, d])
redistributes the embedding's output and every block's.  The gradients
come back in each parameter's placements (a pending sum is reduced and
scattered), and the returned loss and metrics are plain tensors, the same
on every rank.  With plain tensors the specs are ignored and the step is
the one-device step, op for op.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.dtensor import (constrain, full, is_dtensor, sharded_context,
                                             split_dim)
from repro_torch.distributed.sharding import PartitionSpec
from repro_torch.models import model as M
from repro_torch.models.layers import leaves, torch_dtype, tree_of
from repro_torch.optim import adamw


def _zeros_like(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``p``'s shape in ``dtype``: a DTensor in ``p``'s placements
    where ``p`` is one."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _in_placements_of(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(cfg: ModelConfig, params, batch, chunk: Optional[int] = None,
                   act_spec=None):
    """``(loss, grads)`` of ``loss_fn`` at ``params``: the gradients in the
    parameters' tree, dtype and placements, zeros for a leaf the loss does
    not reach."""
    paths, flat = zip(*leaves(params))
    for p in flat:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad(), sharded_context(params):
        loss = M.loss_fn(cfg, params, batch, chunk, act_spec)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _in_placements_of(g, p)
                 for p, g in zip(flat, grads)]
    return loss.detach(), tree_of(zip(paths, grads))


def accumulated_grads(cfg: ModelConfig, params, batch, accum: int = 1,
                      chunk: Optional[int] = None,
                      accum_dtype: torch.dtype | str = torch.float32,
                      batch_spec=None, act_spec=None):
    """``(loss, grads)`` of the train step: with ``accum > 1`` the batch's
    leading dim is split into ``accum`` microbatches (each redistributed to
    ``batch_spec`` on its own leading dim; a batch whose shards do not
    divide ``accum`` is gathered first, ``dtensor.split_dim``), whose
    gradients are summed in ``accum_dtype`` and divided by ``accum`` (the
    loss likewise, in f32);
    with ``accum == 1`` the gradients keep the parameters' dtype."""
    if accum == 1:
        return value_and_grad(cfg, params, batch, chunk, act_spec)
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"a batch of {B} does not split into {accum} microbatches")
    dt = torch_dtype(accum_dtype)

    def resh(v):
        out = split_dim("microbatch.reshape", v, 0, accum)
        if batch_spec is None:
            return out
        return constrain(out, PartitionSpec(None, batch_spec, *([None] * (v.dim() - 1))))

    paths, flat = zip(*leaves(params))
    gsum = [_zeros_like(p, dt) for p in flat]
    lsum = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
    with sharded_context(params):
        for mb in zip(*(resh(v) for v in batch.values())):
            loss, g = value_and_grad(cfg, params, dict(zip(batch, mb)), chunk, act_spec)
            for a, (_, b) in zip(gsum, leaves(g)):
                a.copy_(a.float() + b)   # f32 sum, stored in accum_dtype
            lsum = lsum + loss
        for g in gsum:      # in place: the sums are the step's own buffers
            g.div_(accum)
        return lsum / accum, tree_of(zip(paths, gsum))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, accum: int = 1,
                    attn_chunk: Optional[int] = None, batch_spec=None, act_spec=None,
                    accum_dtype: torch.dtype | str = torch.float32):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``; ``params`` and the moments are updated
    in place (``adamw.update``), on each rank's own shards where they are
    DTensors."""

    def train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor]) -> Tuple[Any, adamw.AdamWState, Dict]:
        loss, grads = accumulated_grads(cfg, params, batch, accum, attn_chunk, accum_dtype,
                                        batch_spec, act_spec)
        params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": full(loss), **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, attn_chunk: Optional[int] = None, act_spec=None):
    """Full-sequence forward returning last-position logits."""

    @torch.no_grad()
    def prefill(params, batch):
        with sharded_context(params):
            return M.forward(cfg, params, batch, chunk=attn_chunk, act_spec=act_spec)[:, -1]

    return prefill


def make_serve_step(cfg: ModelConfig):
    """One incremental decode step: (params, cache, tokens[B,1], pos)."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        with sharded_context(params):
            return M.decode_step(cfg, params, cache, tokens, pos)

    return serve_step
