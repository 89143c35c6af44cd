"""Mixture-of-Experts with static scatter dispatch + LPT expert placement.

The port of the JAX package's ``models/moe.py``, with its dispatch exactly:
top-k routing → per-expert capacity slots by a masked cumsum over the
flattened (token, choice) pairs → scatter of the tokens into an ``[E·C, d]``
buffer → batched expert matmul ``[E, C, d] × [E, d, f]`` → gather and an
``index_add_`` combine.  Pairs over capacity are dropped (counted in aux).
The capacity is ``C = N·K`` when ``N·K ≤ 4096`` and ``capacity_factor ≥ 1``
(decode and small batches drop nothing), else ``ceil(cf·N·K/E)``.

``lpt_expert_permutation`` LPT-packs experts onto EP ranks from a sampled
router histogram (the thesis' static balance, re-targeted), on the port's
own ``core/schedule.lpt_schedule``.

Routing ties: ``torch.topk`` and ``jax.lax.top_k`` may order equal router
probabilities differently; with random f32 weights no two are equal.

On DTensors the routing, the slots, the scatter and the combine run on
replicated tokens (``distributed.dtensor.replicated_call``): the slots are
running counts over the whole token set.  The expert products run sharded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.schedule import lpt_schedule
from repro_torch.distributed.dtensor import reduced, replicated_call, split_dim
from repro_torch.models.layers import ParamSpec, einsum, mlp_specs, swiglu


def moe_specs(d: int, m: MoEConfig) -> Dict[str, ParamSpec]:
    specs: Dict[str, ParamSpec] = {
        "router": ParamSpec((d, m.n_experts), ("embed", None), scale=0.02),
        "w_gate": ParamSpec((m.n_experts, d, m.expert_d_ff), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((m.n_experts, d, m.expert_d_ff), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((m.n_experts, m.expert_d_ff, d), ("experts", "ffn", "embed")),
    }
    if m.n_shared:
        specs["shared"] = mlp_specs(d, m.n_shared * m.expert_d_ff)
    return specs


def capacity(m: MoEConfig, N: int) -> int:
    """Slots an expert has for ``N`` tokens."""
    K, E = m.top_k, m.n_experts
    if N * K <= 4096 and m.capacity_factor >= 1.0:
        return N * K
    return int(math.ceil(m.capacity_factor * N * K / E))


def _route(probs: torch.Tensor, K: int, expert_perm: Optional[torch.Tensor]):
    """Top-``K`` experts of each token (``probs`` [B, T, E]) and their
    renormalised weights."""
    top_w, top_e = torch.topk(probs.reshape(-1, probs.shape[-1]), K, dim=-1)   # [N, K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    if expert_perm is not None:
        top_e = expert_perm.to(top_e.device)[top_e]
    return top_w, top_e


def _slots(top_e: torch.Tensor, E: int, C: int, K: int):
    """Each (token, choice) pair's row of the ``[E·C + 1, d]`` buffer (row
    E·C: dropped), whether it is kept, its token, and the one-hot of its
    expert.  The k-th choice of token n takes, within expert e, the running
    count of earlier pairs routed to e."""
    flat_e = top_e.reshape(-1)                                 # [N*K]
    onehot = F.one_hot(flat_e, E).to(torch.int32)              # [N*K, E]
    slots = ((torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot) * onehot).sum(-1)
    keep = slots < C
    buf_pos = torch.where(keep, flat_e * C + slots, E * C)     # E*C ⇒ dropped
    tok_idx = torch.arange(top_e.shape[0], device=top_e.device).repeat_interleave(K)
    return buf_pos, keep, tok_idx, onehot


def _dispatch(x: torch.Tensor, buf_pos: torch.Tensor, tok_idx: torch.Tensor, E: int,
              C: int) -> torch.Tensor:
    """The tokens (``x`` [B, T, d]) scattered into their experts' slots:
    ``[E, C, d]``."""
    xt = x.reshape(-1, x.shape[-1])
    buf = torch.zeros((E * C + 1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    buf[buf_pos] = xt[tok_idx]                                 # row E*C: the dropped
    return buf[: E * C].reshape(E, C, xt.shape[1])


def _combine(y: torch.Tensor, buf_pos: torch.Tensor, keep: torch.Tensor,
             top_w: torch.Tensor, tok_idx: torch.Tensor, lead: Tuple[int, int],
             dtype: torch.dtype) -> torch.Tensor:
    """The experts' rows ``y [E·C, d]`` gathered back to their tokens,
    weighted and summed in ``dtype`` (the tokens'): ``[B, T, d]`` for
    ``lead`` (B, T)."""
    E_C = y.shape[0]
    gathered = y[torch.clamp(buf_pos, max=E_C - 1)]
    gathered = torch.where(keep[:, None], gathered, torch.zeros((), dtype=y.dtype,
                                                                device=y.device))
    weighted = gathered * top_w.reshape(-1)[:, None].to(dtype)
    out = torch.zeros((lead[0] * lead[1], y.shape[1]), dtype=dtype, device=y.device)
    out.index_add_(0, tok_idx, weighted.to(dtype))
    return out.reshape(*lead, y.shape[1])


def moe_forward(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                 # [B, T, d]
    m: MoEConfig,
    expert_perm: Optional[torch.Tensor] = None,  # int[E] logical→physical
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, T, d = x.shape
    N = B * T
    if m.token_chunk and N > m.token_chunk and N % m.token_chunk == 0:
        # token-chunked dispatch: the [E·C, d] buffers at chunk granularity
        # (on a DTensor whose token shards do not divide the chunks, the
        # tokens gathered first: the dispatch replicates them anyway)
        nch = N // m.token_chunk
        xc = split_dim("moe.token_chunk", x.reshape(N, d), 0, nch).reshape(
            nch, 1, m.token_chunk, d)
        inner = dataclasses.replace(m, token_chunk=0)
        ys, lb, drop, load = [], [], [], []
        for i in range(nch):
            y, aux = moe_forward(p, xc[i], inner, expert_perm)
            ys.append(y)
            lb.append(aux["lb_loss"])
            drop.append(aux["dropped"])
            load.append(aux["expert_load"])
        aux = {
            "lb_loss": torch.stack(lb).mean(),
            "dropped": torch.stack(drop).sum(dtype=torch.int32),
            "expert_load": torch.stack(load).sum(dim=0, dtype=torch.int32),
        }
        return torch.stack(ys).reshape(B, T, d), aux
    E, K = m.n_experts, m.top_k
    C = capacity(m, N)

    # the tokens stay [B, T, d] into and out of the replicated calls: on
    # DTensors a flattened batch sharded over two mesh dims (or its
    # gradient, over batch and sequence) comes out strided, which DTensor
    # gathers only from real data
    logits = einsum("btd,de->bte", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # the routing, the slots and the scatter and combine run on the whole
    # token set, as on one device (the slots are global running counts)
    top_w, top_e = replicated_call("moe.topk", _route, probs, K, expert_perm)
    buf_pos, keep, tok_idx, onehot = _slots(top_e, E, C, K)
    dropped = (~keep).sum(dtype=torch.int32)
    eb = replicated_call("moe.dispatch", _dispatch, x, buf_pos, tok_idx, E, C)

    # on DTensors the replicated tokens meet FSDP-sharded weights: the
    # products come out as pending sums, reduced before the gate
    g = reduced(einsum("ecd,edf->ecf", eb, p["w_gate"]))
    u = reduced(einsum("ecd,edf->ecf", eb, p["w_up"]))
    h = F.silu(g) * u
    y = einsum("ecf,efd->ecd", h, p["w_down"]).reshape(E * C, d)
    out = replicated_call("moe.combine", _combine, y, buf_pos, keep, top_w, tok_idx, (B, T),
                          x.dtype)

    if m.n_shared:
        sp = p["shared"]
        out = out + swiglu(x, sp["gate"], sp["up"], sp["down"])

    # Switch-style load-balance aux loss + stats for the LPT placement
    frac_tokens = F.one_hot(top_e[:, 0], E).float().mean(0)
    frac_probs = probs.mean((0, 1))
    aux = {
        "lb_loss": E * torch.sum(frac_tokens * frac_probs),
        "dropped": dropped,
        "expert_load": onehot.sum(dim=0, dtype=torch.int32),
    }
    return out, aux


# ---------------------------------------------------------------------------
# Sampled-histogram LPT expert placement
# ---------------------------------------------------------------------------


def lpt_expert_permutation(sampled_load: np.ndarray, n_ranks: int) -> np.ndarray:
    """LPT-pack experts onto EP ranks; return the expert permutation.

    The returned ``perm`` maps logical expert e to physical slot ``perm[e]``
    such that physical slots are grouped by rank (slot // (E/R) = rank) and
    per-rank estimated load is ≈ balanced (Graham's 4/3 bound, as in Phase 2).
    """
    E = len(sampled_load)
    if E % n_ranks:
        raise ValueError(f"{E} experts do not divide over {n_ranks} EP ranks")
    per = E // n_ranks
    rank_of = lpt_schedule(sampled_load, n_ranks)
    # LPT can overfill a rank count-wise; rebalance counts while keeping the
    # heaviest experts where LPT put them
    order = np.argsort(-np.asarray(sampled_load), kind="stable")
    counts = np.zeros(n_ranks, dtype=np.int64)
    final_rank = np.zeros(E, dtype=np.int64)
    loads = np.zeros(n_ranks)
    for e in order:
        r = rank_of[e]
        if counts[r] >= per:  # fall back to least-loaded rank with room
            avail = np.nonzero(counts < per)[0]
            r = avail[np.argmin(loads[avail])]
        final_rank[e] = r
        counts[r] += 1
        loads[r] += sampled_load[e]
    # slot assignment within rank: stable order
    perm = np.zeros(E, dtype=np.int64)
    next_slot = {r: 0 for r in range(n_ranks)}
    for e in range(E):
        r = int(final_rank[e])
        perm[e] = r * per + next_slot[r]
        next_slot[r] += 1
    return perm


def apply_expert_permutation(p: Dict[str, torch.Tensor], perm: np.ndarray):
    """Re-index stacked expert weights so physical slot layout matches perm."""
    inv = torch.from_numpy(np.argsort(perm))
    out = dict(p)
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = p[k][inv.to(p[k].device)]
    return out
