"""AdamW with dtype-configurable state.

The port of the JAX package's ``optim/adamw.py``: the same config, state
(``AdamWState(step, m, v)``), warmup-then-cosine schedule, global-norm
clipping and update, in the reference's order of operations in f32: the
clip scale, the bias corrections ``1 - b**step`` with ``step`` as f32,
``mh / (sqrt(vh) + eps) + wd·p``, the result cast back to the parameter's
dtype and the moments stored in ``state_dtype``.  The learning rate and the
bias corrections are f32 tensors on the parameters' device.

One difference in form, not in value: :func:`update` writes the new
parameters and moments into the tensors it is given (under ``no_grad``) and
returns them, where the reference returns new arrays.  Each leaf is updated
in slices of its leading dim of at most ``CHUNK`` elements, so the f32
temporaries of a stacked leaf (llama3.2-3b's ``[28, 3072, 8192]`` MLP
weights: 2.8 GB each in f32) stay the size of a slice.

DTensor leaves (a sharded step, ``distributed.sharding``): the moments are
made in their parameter's placements, the update runs on each rank's local
shards (every gradient must be in its parameter's placements, as the
sharded step returns them), and :func:`global_norm` sums each rank's shard
and reduces over the mesh dims that shard the leaf only, so an element
replicated over ``model`` counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.distributed.dtensor import is_dtensor
from repro_torch.models.layers import leaves, map_tree, torch_dtype

#: the most elements of one leaf updated at a time
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # "float32" | "bfloat16"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    m: Any
    v: Any


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``cfg.state_dtype`` beside each parameter; step 0."""
    dt = torch_dtype(cfg.state_dtype)

    def zeros(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=dt, requires_grad=False)
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = next(leaves(params))[1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=map_tree(zeros, params), v=map_tree(zeros, params))


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_frac·lr``, in f32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _chunks(a: torch.Tensor):
    """``a`` in slices of its leading dim of at most ``CHUNK`` elements."""
    if a.dim() == 0 or a.numel() <= CHUNK:
        return (a,)
    rows = max(1, CHUNK // max(a[0].numel(), 1))
    return a.split(rows)


def _square_sum(a: torch.Tensor) -> torch.Tensor:
    return sum(c.float().square().sum() for c in _chunks(a))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a plain tensor, the
    same on every rank, where the leaves are DTensors)."""
    total = None
    sharded: Dict[Any, torch.Tensor] = {}
    for _, leaf in leaves(tree):
        if is_dtensor(leaf):
            # the local shard's sum, pending a sum over the mesh dims that
            # shard the leaf (the others hold the same shard)
            key = (leaf.device_mesh, tuple(pl.is_shard() for pl in leaf.placements))
            s = _square_sum(leaf.to_local())
            sharded[key] = s if key not in sharded else sharded[key] + s
            continue
        s = _square_sum(leaf)
        total = s if total is None else total + s
    for (mesh, shards), s in sharded.items():
        s = _reduce_over(s, mesh, shards)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _reduce_over(s: torch.Tensor, mesh, shards) -> torch.Tensor:
    """The local value ``s`` summed over the mesh dims flagged in
    ``shards``, as a plain tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    pl = [Partial() if sh else Replicate() for sh in shards]
    return DTensor.from_local(s, mesh, pl, run_check=False).full_tensor()


@torch.no_grad()
def update(grads, state: AdamWState, params,
           cfg: AdamWConfig) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``, with
    ``params``, ``state.m`` and ``state.v`` updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        step_ = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_)
        m.copy_(m32)
        v.copy_(v32)

    grads_at = dict(leaves(grads))
    m_at, v_at = dict(leaves(state.m)), dict(leaves(state.v))
    for path, p in leaves(params):
        parts = (p, grads_at[path], m_at[path], v_at[path])
        if is_dtensor(p):
            for t in parts[1:]:
                if not is_dtensor(t) or tuple(t.placements) != tuple(p.placements):
                    raise ValueError(f"{path}: the gradient and moments must be DTensors in "
                                     f"the parameter's placements {p.placements}")
            parts = tuple(t.to_local() for t in parts)
        for chunk in zip(*(_chunks(t) for t in parts)):
            upd(*chunk)
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
