"""Mamba-2 block via SSD (state-space duality), chunked — arXiv:2405.21060.

The port of the JAX package's ``models/mamba2.py``.  The SSD form computes
``y = SSM(A, B, C)(x)`` as a block-diagonal part (intra-chunk, quadratic in
the chunk length) plus low-rank inter-chunk terms carried by a loop over the
chunk states.  Decode is the O(1)-a-token recurrence on the f32
``[B, H, P, N]`` state; the cache is updated in place.

Layout: d_inner = expand·d, H heads of dim P = head_dim, G state groups of
size N = d_state.  The in-projection gives (z, x, B, C, dt); a depthwise
causal conv of width w runs over (x, B, C); a gated RMSNorm comes before the
out-projection.  The SSD einsums run in f32, with the casts JAX's promotion
makes written out.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed.dtensor import along, gather_dim, pinned, split_dim, write_at
from repro_torch.models.layers import ParamSpec, einsum, rms_norm

F32 = torch.float32


def ssm_dims(d: int, s: SSMConfig):
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, H, conv_dim


def mamba2_specs(d: int, s: SSMConfig) -> Dict[str, ParamSpec]:
    """Projections split into (z, x, BC, dt), as the reference's."""
    d_inner, H, conv_dim = ssm_dims(d, s)
    gN = s.n_groups * s.d_state
    return {
        "z_proj": ParamSpec((d, d_inner), ("embed", "ffn")),
        "x_proj": ParamSpec((d, d_inner), ("embed", "ffn")),
        "bc_proj": ParamSpec((d, 2 * gN), ("embed", None)),
        "dt_proj": ParamSpec((d, H), ("embed", None)),
        "conv_x_w": ParamSpec((s.conv_width, d_inner), (None, "ffn"), scale=0.5),
        "conv_x_b": ParamSpec((d_inner,), ("ffn",), init="zeros"),
        "conv_bc_w": ParamSpec((s.conv_width, 2 * gN), (None, None), scale=0.5),
        "conv_bc_b": ParamSpec((2 * gN,), (None,), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),
        "D": ParamSpec((H,), (None,), init="ones"),
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "norm": ParamSpec((d_inner,), ("ffn",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("ffn", "embed")),
    }


def _project(p, xin, s: SSMConfig):
    gN = s.n_groups * s.d_state
    z = einsum("btd,dk->btk", xin, p["z_proj"])
    x = einsum("btd,dk->btk", xin, p["x_proj"])
    bc = einsum("btd,dk->btk", xin, p["bc_proj"])
    dt = einsum("btd,dk->btk", xin, p["dt_proj"])
    return z, x, bc[..., :gN], bc[..., gN:], dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: xbc [B, T, D], w [width, D]."""
    width = w.shape[0]
    # zeros concatenated in the input's own placements, not ``F.pad``: on a
    # DTensor the pad redistributes, and torch 2.11's planner raises on it
    # over a 2-D mesh
    pad = torch.cat([xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[2])), xbc], dim=1)
    T = xbc.shape[1]
    out = sum(pad[:, i: i + T, :] * w[i][None, None, :] for i in range(width))
    return F.silu(out + b)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = Σ_{j<k≤i} x[..., k]."""
    T = x.shape[-1]
    cs = along(lambda t: torch.cumsum(t, dim=-1), x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def _heads_grouped(t: torch.Tensor, dim: int, G: int) -> torch.Tensor:
    """The H heads at dim ``dim`` as ``(G, H // G)`` (on a DTensor whose
    head shards do not divide the G groups, the heads gathered first)."""
    return split_dim("mamba2.group_heads", t, dim, G)


def ssd_chunked(
    x: torch.Tensor,    # [B, T, H, P]
    dt: torch.Tensor,   # [B, T, H]   (post-softplus)
    A: torch.Tensor,    # [H]         (negative)
    B_: torch.Tensor,   # [B, T, G, N]
    C_: torch.Tensor,   # [B, T, G, N]
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # [B, H, P, N] initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,T,H,P], final state [B,H,P,N])."""
    Bb, T, H, P = x.shape
    G, N = B_.shape[-2:]
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of the SSD chunk {chunk}")
    nc = T // chunk

    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = B_.reshape(Bb, nc, chunk, G, N)
    Cc = C_.reshape(Bb, nc, chunk, G, N)
    dA = dtc * A[None, None, None, :]                        # [B,nc,Q,H]
    dA_cs = along(lambda t: torch.cumsum(t, dim=2), dA, 2)

    # intra-chunk (quadratic in Q), grouped: H = G×rep as two indices
    Lh = torch.exp(
        _segsum(_heads_grouped(dA, 3, G).permute(0, 1, 3, 4, 2))
    )                                                        # [B,nc,G,r,Q,Q]
    CB = einsum("bnqgs,bnkgs->bngqk", Cc, Bc)                 # [B,nc,G,Q,K]
    xdt = xc * dtc[..., None]                                # [B,nc,Q,H,P]
    xdt_g = _heads_grouped(xdt, 3, G)
    y_diag = einsum(
        "bngqk,bngrqk,bnkgrp->bnqgrp", CB.to(F32), Lh.to(F32), xdt_g.to(F32),
    ).reshape(Bb, nc, chunk, H, P)

    # chunk states (B broadcast from G groups to H heads by a grouped einsum)
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # [B,nc,Q,H]
    xdtd_g = _heads_grouped(xdt * decay_states[..., None], 3, G)
    states = einsum(
        "bnqgs,bnqgrp->bngrps", Bc.to(F32), xdtd_g.to(F32),
    ).reshape(Bb, nc, H, P, N)

    # inter-chunk recurrence over nc: h_prev[:, c] is the state entering chunk c
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # [B,nc,H]
    h = torch.zeros((Bb, H, P, N), dtype=F32, device=x.device) if h0 is None else h0
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # [B,nc,H,P,N]

    # off-diagonal contribution (grouped: no head-repeat materialization)
    state_decay = torch.exp(dA_cs)                           # [B,nc,Q,H]
    h_prev_g = _heads_grouped(h_prev, 2, G)
    y_off = einsum(
        "bnqgs,bngrps->bnqgrp", Cc.to(F32), h_prev_g
    ).reshape(Bb, nc, chunk, H, P) * state_decay[..., None]

    # on DTensors the gradient of y may come back with T sharded over two
    # mesh dims, which the view into chunks cannot split: y takes it in its
    # own placements
    y = pinned((y_diag.to(F32) + y_off).reshape(Bb, T, H, P))
    return y.to(x.dtype), h


def mamba2_forward(p: Dict[str, torch.Tensor], xin: torch.Tensor,
                   s: SSMConfig) -> torch.Tensor:
    """Full-sequence forward (training / prefill)."""
    d = xin.shape[-1]
    d_inner, H, conv_dim = ssm_dims(d, s)
    gN = s.n_groups * s.d_state
    z, x, B_, C_, dt = _project(p, xin, s)
    x = _causal_conv(x, p["conv_x_w"], p["conv_x_b"])
    bc = _causal_conv(torch.cat([B_, C_], dim=-1), p["conv_bc_w"], p["conv_bc_b"])
    B_, C_ = bc[..., :gN], bc[..., gN:]
    Bb, T = x.shape[:2]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(F32))
    y, _ = ssd_chunked(
        x.reshape(Bb, T, H, s.head_dim),
        dt,
        A,
        B_.reshape(Bb, T, s.n_groups, s.d_state),
        C_.reshape(Bb, T, s.n_groups, s.d_state),
        min(s.chunk, T),
    )
    y = y + x.reshape(Bb, T, H, s.head_dim) * p["D"][None, None, :, None]
    y = y.reshape(Bb, T, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"])
    return einsum("btk,kd->btd", y, p["out_proj"])


def mamba2_init_cache(batch: int, d: int, s: SSMConfig, dtype, device):
    d_inner, H, conv_dim = ssm_dims(d, s)
    gN = s.n_groups * s.d_state
    return {
        "conv_x": torch.zeros((batch, s.conv_width - 1, d_inner), dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, s.conv_width - 1, 2 * gN), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state), dtype=F32, device=device),
    }


def mamba2_decode_step(
    p: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    xin: torch.Tensor,   # [B, 1, d]
    s: SSMConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    d = xin.shape[-1]
    d_inner, H, conv_dim = ssm_dims(d, s)
    gN = s.n_groups * s.d_state
    z, x, B_, C_, dt = _project(p, xin, s)
    win_x = torch.cat([cache["conv_x"], x], dim=1)
    x = F.silu((win_x * p["conv_x_w"][None]).sum(dim=1, keepdim=True) + p["conv_x_b"])
    bc_new = torch.cat([B_, C_], dim=-1)
    win_bc = torch.cat([cache["conv_bc"], bc_new], dim=1)
    bc = F.silu((win_bc * p["conv_bc_w"][None]).sum(dim=1, keepdim=True) + p["conv_bc_b"])
    B_, C_ = bc[..., :gN], bc[..., gN:]
    Bb = x.shape[0]
    dt = F.softplus(dt + p["dt_bias"])[:, 0]                 # [B,H]
    A = -torch.exp(p["A_log"].to(F32))
    xh = x.reshape(Bb, H, s.head_dim).to(F32)
    rep = H // s.n_groups
    Bh = B_.reshape(Bb, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    Ch = C_.reshape(Bb, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * A[None, :]).to(F32)               # [B,H]
    h = cache["ssm"] * decay[:, :, None, None] + einsum(
        "bhp,bhs->bhps", xh * dt[..., None], Bh.to(F32))
    y = einsum("bhps,bhs->bhp", h, Ch.to(F32))
    y = y + xh * p["D"][None, :, None]
    y = gather_dim("mamba.decode_heads", y, 2)    # P into (H, P)
    y = y.reshape(Bb, 1, d_inner).to(xin.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = einsum("btk,kd->btd", y, p["out_proj"])
    write_at(cache["conv_x"], {}, win_x[:, 1:])
    write_at(cache["conv_bc"], {}, win_bc[:, 1:])
    write_at(cache["ssm"], {}, h)
    return out, cache
