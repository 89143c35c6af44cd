"""Weights carried across from the JAX package: its parameter tree, as numpy
arrays, becomes the port's model, so that both compute the same function.

The tree layouts are the same (the port's ``specs`` mirror the reference's,
layer stacks ``[L, ...]`` included), so each leaf maps 1:1 by its path.
bf16 leaves arrive as numpy's ``bfloat16`` extension type and are carried
bit for bit.  Nothing of JAX is imported: the caller converts the arrays.
The tensors land on CUDA unless the caller names another device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers import leaves, map_tree


def to_tensor(a, device: str | torch.device | None = None) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device`` (CUDA
    unless the caller names another)."""
    device = device_mod.resolve(device)
    a = np.array(a)   # a writable copy: the caller's arrays may be read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_from_jax(tree: Dict[str, Any], device: str | torch.device | None = None):
    """A nested dict of numpy arrays → the same tree of tensors on ``device``."""
    device = device_mod.resolve(device)
    return map_tree(lambda a: to_tensor(a, device), tree)


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any],
                    device: str | torch.device | None = None) -> M.LM:
    """The port's model holding the reference's parameters ``tree`` (numpy
    arrays at the reference's paths); raises if a path or shape differs
    from the port's spec tree."""
    want = {path: spec.shape for path, spec in leaves(M.specs(cfg))}
    got = {path: tuple(np.shape(a)) for path, a in leaves(tree)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the parameter tree differs from the spec tree at {diff[:4]}")
    return M.LM(cfg, tree_from_jax(tree, device))
