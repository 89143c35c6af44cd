"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

The port of the JAX package's ``models/mla.py``.  The KV state is compressed
to a per-token latent ``c_kv ∈ R^{kv_lora}`` plus one shared RoPE key
``k_rope ∈ R^{rope}``: the decode cache holds ``kv_lora + rope`` values a
token.  Decode uses the absorbed form: scores are taken against the latent
through ``q·W_uk``-absorbed queries, and the attention output stays in
latent space until the final up-projection.  The cache is updated in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.distributed.dtensor import write_at
from repro_torch.models.attention import NEG_INF, chunked_causal_attention, check_pos
from repro_torch.models.layers import ParamSpec, apply_rope, einsum, rms_norm


def mla_specs(d: int, n_heads: int, m: MLAConfig) -> Dict[str, ParamSpec]:
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "q_down": ParamSpec((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": ParamSpec((m.q_lora_rank,), ("q_lora",), init="ones"),
        "q_up": ParamSpec((m.q_lora_rank, n_heads, qk), ("q_lora", "heads", None)),
        "kv_down": ParamSpec(
            (d, m.kv_lora_rank + m.qk_rope_dim), ("embed", "kv_lora")
        ),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("kv_lora",), init="ones"),
        "k_up": ParamSpec(
            (m.kv_lora_rank, n_heads, m.qk_nope_dim), ("kv_lora", "heads", None)
        ),
        "v_up": ParamSpec(
            (m.kv_lora_rank, n_heads, m.v_head_dim), ("kv_lora", "heads", None)
        ),
        "wo": ParamSpec((n_heads, m.v_head_dim, d), ("heads", None, "embed")),
    }


def _project(p, x, m: MLAConfig, positions):
    """Shared q/kv projections.  Returns (q_nope, q_rope, c_kv, k_rope)."""
    cq = rms_norm(einsum("btd,dr->btr", x, p["q_down"]), p["q_norm"])
    q = einsum("btr,rhk->bthk", cq, p["q_up"])
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, 10_000.0)

    ckv_full = einsum("btd,dr->btr", x, p["kv_down"])
    c_kv = rms_norm(ckv_full[..., : m.kv_lora_rank], p["kv_norm"])
    k_rope = ckv_full[..., m.kv_lora_rank:][:, :, None, :]        # [B,T,1,rope]
    k_rope = apply_rope(k_rope, positions, 10_000.0)[:, :, 0]      # [B,T,rope]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, m: MLAConfig,
                chunk=None) -> torch.Tensor:
    """Training/prefill path (materializes per-head K/V; causal).  With
    ``chunk`` the online-softmax path bounds memory at O(T·chunk)."""
    B, T, _ = x.shape
    pos = torch.arange(T, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _project(p, x, m, pos)
    k_nope = einsum("btr,rhk->bthk", c_kv, p["k_up"])
    v = einsum("btr,rhk->bthk", c_kv, p["v_up"])
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    if chunk is not None and T > chunk and T % chunk == 0:
        H = q_nope.shape[2]
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(B, T, H, m.qk_rope_dim)], dim=-1)
        ctx = chunked_causal_attention(q, k, v, chunk)
        return einsum("bthk,hkd->btd", ctx, p["wo"])
    s = (
        einsum("bthk,bshk->bhts", q_nope, k_nope)
        + einsum("bthk,bsk->bhts", q_rope, k_rope)
    )
    s = s.float() * scale
    mask = pos[None, :] <= pos[:, None]
    s = torch.where(mask[None, None], s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    ctx = einsum("bhts,bshk->bthk", pr, v)
    return einsum("bthk,hkd->btd", ctx, p["wo"])


def mla_init_cache(batch: int, max_len: int, m: MLAConfig, dtype, device):
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype, device=device),
    }


def mla_decode_step(
    p: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    x: torch.Tensor,            # [B, 1, d]
    pos: int,
    m: MLAConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form decode: attention runs entirely in latent space."""
    pos = check_pos(pos, cache["c_kv"].shape[1])
    at = torch.tensor([pos], device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _project(p, x, m, at)
    write_at(cache["c_kv"], {1: pos}, c_kv_new[:, 0])
    write_at(cache["k_rope"], {1: pos}, k_rope_new[:, 0])
    # absorb W_uk into the query:  q̃ = q_nope · W_uk  ∈ latent space
    q_lat = einsum("bthk,rhk->bthr", q_nope, p["k_up"])          # [B,1,H,r]
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    s = (
        einsum("bthr,bsr->bhts", q_lat, cache["c_kv"])
        + einsum("bthk,bsk->bhts", q_rope, cache["k_rope"])
    )
    s = s.float() * scale
    valid = torch.arange(cache["c_kv"].shape[1], device=x.device)[None, :] <= pos
    s = torch.where(valid[None, None], s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    ctx_lat = einsum("bhts,bsr->bthr", pr, cache["c_kv"])        # latent ctx
    ctx = einsum("bthr,rhk->bthk", ctx_lat, p["v_up"])
    return einsum("bthk,hkd->btd", ctx, p["wo"]), cache
