"""``meta``-tensor stand-ins for every (arch × shape) dry-run cell.

The port of the JAX package's ``launch/input_specs.py``: where the
reference gives ``jax.ShapeDtypeStruct``s, these are tensors on the
``meta`` device, shapes and dtypes with nothing allocated.  Modality
frontends are stubs: ``vision_embeds`` / ``frames`` arrive as precomputed
embeddings with the model's d_model width.

Shape semantics (the reference's):
  * train/prefill: ``seq_len`` is the token positions budget.  VLM: 256 of the
    positions are patch embeddings, the rest text.  Enc-dec: seq_len applies to
    the *encoder frames* (audio length — the compute-dominant side) with a
    448-token decoder, Whisper's native split.
  * decode: one new token against a cache of ``seq_len``.  Enc-dec: cross
    context of seq_len encoder states, 448-deep decoder self-cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.layers import torch_dtype

WHISPER_DEC_LEN = 448


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def shape_adjusted_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Per-cell config tweaks (enc-dec cross-context follows the cell)."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, enc_context=shape.seq_len)
    return cfg


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The forward-pass batch for train/prefill cells."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.compute_dtype)
    if cfg.family == "vlm":
        nv = cfg.vision_tokens
        return {"tokens": _meta((B, S - nv), torch.int32),
                "vision_embeds": _meta((B, nv, cfg.d_model), dt)}
    if cfg.family == "encdec":
        return {"tokens": _meta((B, WHISPER_DEC_LEN), torch.int32),
                "frames": _meta((B, S, cfg.d_model), dt)}
    return {"tokens": _meta((B, S), torch.int32)}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """(cache, tokens, pos) abstract args for the serve step."""
    B, S = shape.global_batch, shape.seq_len
    cfg = shape_adjusted_config(cfg, shape)
    max_len = WHISPER_DEC_LEN if cfg.family == "encdec" else S
    cache = M.init_cache(cfg, B, max_len, torch_dtype(cfg.compute_dtype), "meta")
    return cache, _meta((B, 1), torch.int32), _meta((), torch.int32)
