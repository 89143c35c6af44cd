"""GQA attention: training/prefill (dense or chunked online softmax) and
cached decode.

The port of the JAX package's ``models/attention.py``, with its math: scores
cast to f32 before the mask, ``NEG_INF = -1e30`` masks written out, f32
softmax statistics in the chunked path.  No fused library attention.

The decode cache is updated in place: :func:`gqa_decode_step` writes the
new token's K/V at ``pos`` into the cache it is given and returns that
cache.  Where ``lax.dynamic_update_slice`` clamps an out-of-range ``pos``,
the port raises ``IndexError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.dtensor import split_dim, write_at
from repro_torch.models.layers import ParamSpec, apply_rope, einsum

NEG_INF = -1e30


def attn_specs(d: int, n_heads: int, n_kv: int, hd: int) -> Dict[str, ParamSpec]:
    return {
        "wq": ParamSpec((d, n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, n_kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, n_kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, hd, d), ("heads", "head_dim", "embed")),
    }


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,T,H,hd] -> [B,T,KV,G,hd] with H = KV*G (on a DTensor whose head
    shards do not divide KV, the heads gathered first)."""
    return split_dim("attention.group_heads", q, 2, n_kv)


def check_pos(pos: int, max_len: int) -> int:
    """``pos`` as an int; ``IndexError`` outside ``[0, max_len)`` (the
    reference's ``dynamic_update_slice`` would clamp it)."""
    pos = int(pos)
    if not 0 <= pos < max_len:
        raise IndexError(f"decode position {pos} outside the cache's {max_len} slots")
    return pos


def sdpa_causal(
    q: torch.Tensor,            # [B, Tq, H, hd]
    k: torch.Tensor,            # [B, Tk, KV, hd]
    v: torch.Tensor,            # [B, Tk, KV, hd]
    q_positions: torch.Tensor,  # [Tq] absolute positions of queries
    k_valid_len: Optional[int] = None,  # #valid kv (decode)
) -> torch.Tensor:
    """Dense causal GQA attention (reference / decode / small-T path)."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    qg = _group(q, KV)                                  # [B,Tq,KV,G,hd]
    scale = hd ** -0.5
    scores = einsum("btkgh,bskh->bkgts", qg, k) * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, :] <= q_positions[:, None]        # [Tq, Tk]
    if k_valid_len is not None:
        mask = mask & (kpos[None, :] < k_valid_len)
    scores = torch.where(mask[None, None, None], scores.float(), NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = einsum("bkgts,bskh->btkgh", p, v)
    return ctx.reshape(B, Tq, H, hd)


def chunked_causal_attention(
    q: torch.Tensor,       # [B, T, H, hd_qk]
    k: torch.Tensor,       # [B, T, KV, hd_qk]
    v: torch.Tensor,       # [B, T, KV, hd_v]  (hd_v may differ — MLA)
    chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style online-softmax attention, O(T·chunk) memory.

    Queries are processed in blocks; for each query block a loop walks the
    causal KV blocks carrying (m, l, acc) running statistics in f32.  The
    reference also walks the blocks past the diagonal, fully masked: they
    add exactly 0 (``exp(NEG_INF − m)``) and leave the statistics as they
    are, so the port skips them.
    """
    B, T, H, hd = q.shape
    hdv = v.shape[-1]
    KV = k.shape[2]
    G = H // KV
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of the chunk {chunk}")
    n = T // chunk
    scale = hd ** -0.5
    ar = torch.arange(chunk, device=q.device)
    outs = []
    for qi in range(n):
        qg = _group(q[:, qi * chunk:(qi + 1) * chunk], KV)
        q_pos = qi * chunk + ar
        m = torch.full((B, KV, G, chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, chunk, hdv), dtype=torch.float32, device=q.device)
        for kj in range(qi + 1):
            k_blk = k[:, kj * chunk:(kj + 1) * chunk]
            v_blk = v[:, kj * chunk:(kj + 1) * chunk]
            s = einsum("btkgh,bskh->bkgts", qg, k_blk).float() * scale
            k_pos = kj * chunk + ar
            mask = k_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + einsum(
                "bkgts,bskh->bkgth", p.to(v_blk.dtype), v_blk).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, chunk, H, hdv))
    return torch.cat(outs, dim=1).to(q.dtype)


def gqa_forward(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,             # [B, T, d]
    rope_theta: float,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    B, T, _ = x.shape
    q = einsum("btd,dhk->bthk", x, p["wq"])
    k = einsum("btd,dhk->bthk", x, p["wk"])
    v = einsum("btd,dhk->bthk", x, p["wv"])
    pos = torch.arange(T, device=x.device)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    if chunk is not None and T > chunk and T % chunk == 0:
        ctx = chunked_causal_attention(q, k, v, chunk)
    else:
        ctx = sdpa_causal(q, k, v, pos)
    return einsum("bthk,hkd->btd", ctx, p["wo"])


def gqa_init_cache(batch: int, max_len: int, n_kv: int, hd: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, max_len, n_kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, n_kv, hd), dtype=dtype, device=device),
    }


def gqa_decode_step(
    p: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    x: torch.Tensor,             # [B, 1, d]
    pos: int,                    # index of the new token
    rope_theta: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    pos = check_pos(pos, cache["k"].shape[1])
    q = einsum("btd,dhk->bthk", x, p["wq"])
    k = einsum("btd,dhk->bthk", x, p["wk"])
    v = einsum("btd,dhk->bthk", x, p["wv"])
    at = torch.tensor([pos], device=x.device)
    q = apply_rope(q, at, rope_theta)
    k = apply_rope(k, at, rope_theta)
    write_at(cache["k"], {1: pos}, k[:, 0])
    write_at(cache["v"], {1: pos}, v[:, 0])
    ctx = sdpa_causal(q, cache["k"], cache["v"], at, k_valid_len=pos + 1)
    return einsum("bthk,hkd->btd", ctx, p["wo"]), cache


def chunked_bidir_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Online-softmax non-causal attention, O(T·chunk) memory (enc side)."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of the chunk {chunk}")
    n = T // chunk
    scale = hd ** -0.5
    outs = []
    for qi in range(n):
        qg = _group(q[:, qi * chunk:(qi + 1) * chunk], KV)
        m = torch.full((B, KV, G, chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, chunk, hd), dtype=torch.float32, device=q.device)
        for kj in range(n):
            k_blk = k[:, kj * chunk:(kj + 1) * chunk]
            v_blk = v[:, kj * chunk:(kj + 1) * chunk]
            s = einsum("btkgh,bskh->bkgts", qg, k_blk).float() * scale
            m_new = torch.maximum(m, s.amax(dim=-1))
            p_ = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(dim=-1)
            acc = acc * corr[..., None] + einsum(
                "bkgts,bskh->bkgth", p_.to(v_blk.dtype), v_blk).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, chunk, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked GQA attention: [B,Tq,H,hd] against [B,Tk,KV,hd] → [B,Tq,H,hd]."""
    B, Tq, H, hd = q.shape
    qg = _group(q, k.shape[2])
    s = einsum("btkgh,bskh->bkgts", qg, k).float() * (hd ** -0.5)
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    return einsum("bkgts,bskh->btkgh", pr, v).reshape(B, Tq, H, hd)


def bidir_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    rope_theta: float,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Non-causal self-attention (encoder side of enc-dec)."""
    B, T, _ = x.shape
    q = einsum("btd,dhk->bthk", x, p["wq"])
    k = einsum("btd,dhk->bthk", x, p["wk"])
    v = einsum("btd,dhk->bthk", x, p["wv"])
    pos = torch.arange(T, device=x.device)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    if chunk is not None and T > chunk and T % chunk == 0:
        ctx = chunked_bidir_attention(q, k, v, chunk)
    else:
        ctx = _full_attention(q, k, v)
    return einsum("bthk,hkd->btd", ctx, p["wo"])


def cross_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,             # [B, Tq, d] decoder states
    enc: torch.Tensor,           # [B, Te, d] encoder states
) -> torch.Tensor:
    q = einsum("btd,dhk->bthk", x, p["wq"])
    k = einsum("btd,dhk->bthk", enc, p["wk"])
    v = einsum("btd,dhk->bthk", enc, p["wv"])
    return einsum("bthk,hkd->btd", _full_attention(q, k, v), p["wo"])
