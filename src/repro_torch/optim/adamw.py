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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    total = None
    for _, leaf in leaves(tree):
        s = sum(c.float().square().sum() for c in _chunks(leaf))
        total = s if total is None else total + s
    return torch.sqrt(total)


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
        for chunk in zip(_chunks(p), _chunks(grads_at[path]), _chunks(m_at[path]),
                         _chunks(v_at[path])):
            upd(*chunk)
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}
