"""Frontier-batched Eclat in PyTorch: depth-first FI mining over packed
tidlists (thesis §B.3, Alg. 34/35), the Phase-4 miner and, on the database
sample, the Phase-1 FI stream that feeds the reservoir.

The JAX package's ``lax.while_loop`` becomes a host loop over a stack kept on
the device.  Each trip follows ``repro/core/eclat.py`` step for step: pop the
top ``K = frontier_size`` nodes, count every extension of all of them in one
fused sweep (kernel B1 through :mod:`repro_torch.kernels.ops`), rank the
frequent extensions by support (a stable sort, as ``jnp.argsort`` is), emit
``prefix ∪ {e}``, feed the emissions to the reservoir, and push the child
classes.  The trip makes one host read: the number of children to push and
of FIs found, from which the host keeps the stack pointer and the counters.

Stack and output capacities are fixed; overflow is counted, never silently
dropped, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bitmap as bm

INT32_MAX = torch.iinfo(torch.int32).max

# (item_bits int32[I, W], prefix_tids int32[K, W]) -> int32[K, I] supports
MultiSupportFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EclatConfig:
    """Static configuration of the DFS miner."""

    max_out: int = 4096          # capacity of the FI output buffer
    max_stack: int = 1024        # DFS stack capacity
    max_iters: int = 1 << 20     # hard bound on loop trips
    reservoir_size: int = 0      # >0 enables the in-loop reservoir sampler
    count_only: bool = False     # skip writing the FI buffer (Phase-1 f_i count)
    frontier_size: int = 1       # K — DFS nodes mined per trip


class EclatResult(NamedTuple):
    """Mining result; buffers are valid up to their counts."""

    items: torch.Tensor               # int32[max_out, IW] packed itemset masks
    supports: torch.Tensor            # int32[max_out]
    n_out: int                        # FIs written (≤ max_out)
    n_total: int                      # FIs found (may exceed max_out)
    stack_overflow: int               # dropped pushes (0 ⇒ complete result)
    reservoir_items: torch.Tensor     # int32[R, IW]
    reservoir_supports: torch.Tensor  # int32[R]
    n_iters: int                      # loop trips
    n_popped: int                     # DFS nodes mined


def mine_seeded(
    item_bits: torch.Tensor,      # int32[I, W]
    seed_prefix: torch.Tensor,    # bool [S0, I]
    seed_ext: torch.Tensor,       # bool [S0, I]
    seed_tid: torch.Tensor,       # int32[S0, W]
    seed_valid: torch.Tensor,     # bool [S0]
    min_support: int,
    *,
    config: EclatConfig,
    n_items: int,
    generator: torch.Generator | None = None,
    reservoir_draws: torch.Tensor | None = None,
    multi_support_fn: Optional[MultiSupportFn] = None,
) -> EclatResult:
    """Mine all FIs in the union of the seed PBECs ``[prefix_k | ext_k]``.

    Exec-Eclat (thesis Alg. 21): the seeds are a miner's classes, the caller
    passes their tidlists, and the prefixes themselves are not emitted.

    The reservoir (Algorithm R, ``config.reservoir_size > 0``) draws
    ``j ~ U[0, t)`` for the t-th emitted FI from ``generator``, or takes
    ``reservoir_draws[t - 1]`` when given, so a test can replay the
    reference's draws.

    ``multi_support_fn`` computes each trip's fused ``[F, I]`` supports; it
    defaults to :func:`repro_torch.kernels.ops.multi_extension_supports`
    (kernel B1 on the card).
    """
    if multi_support_fn is None:
        multi_support_fn = bm.multi_extension_supports
    dev = item_bits.device
    I = n_items
    IW = bm.n_words(I)
    W = item_bits.shape[-1]
    S, O = config.max_stack, config.max_out
    R = max(config.reservoir_size, 1)
    if seed_prefix.shape[0] > S:
        raise ValueError("seed count exceeds stack capacity")
    F = max(1, min(config.frontier_size, S))

    # Valid seeds, in order, at the bottom of the stack.
    valid_idx = torch.nonzero(seed_valid.to(dev)).flatten()
    sp = int(valid_idx.numel())
    stk_items = torch.zeros((S, IW), dtype=torch.int32, device=dev)
    stk_ext = torch.zeros((S, IW), dtype=torch.int32, device=dev)
    stk_tid = torch.zeros((S, W), dtype=torch.int32, device=dev)
    stk_items[:sp] = bm.pack_bool(seed_prefix.to(dev)[valid_idx])
    stk_ext[:sp] = bm.pack_bool(seed_ext.to(dev)[valid_idx])
    stk_tid[:sp] = seed_tid.to(dev)[valid_idx]

    # Row O of the output and row R of the reservoir take dropped writes.
    out_items = torch.zeros((O + 1, IW), dtype=torch.int32, device=dev)
    out_supp = torch.zeros((O + 1,), dtype=torch.int32, device=dev)
    res_items = torch.zeros((R + 1, IW), dtype=torch.int32, device=dev)
    res_supp = torch.zeros((R + 1,), dtype=torch.int32, device=dev)
    if reservoir_draws is not None:
        reservoir_draws = reservoir_draws.to(dev, torch.int64)

    e_packed = bm.pack_bool(torch.eye(I, dtype=torch.bool, device=dev))  # [I, IW]
    lanes = torch.arange(F, device=dev)
    n_out = n_total = overflow = res_seen = it = popped = 0

    while sp > 0 and it < config.max_iters:
        # --- pop a frontier: the top min(sp, F) nodes ---------------------
        n_active = min(sp, F)
        idx = (sp - 1 - lanes).clamp_(min=0)
        active = lanes < n_active
        node_items = stk_items[idx]                     # [F, IW]
        node_tid = stk_tid[idx]                         # [F, W]
        # Inactive lanes alias slot 0; an empty extension set makes them
        # emit and push nothing.
        ext_bool = bm.unpack_bool(stk_ext[idx], I) & active[:, None]   # [F, I]

        # --- fused multi-prefix support count (kernel B1 or B2 on the card)
        supports = multi_support_fn(item_bits, node_tid)               # [F, I]
        freq = ext_bool & (supports >= min_support)
        nf = freq.sum(dim=-1)                                          # [F]

        # --- dynamic re-ordering: rank frequent extensions by support ----
        sort_key = torch.where(freq, supports, INT32_MAX)
        order = torch.argsort(sort_key, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        # Child of extension e keeps the frequent extensions ranked after e
        # (Prop. 2.23); a child with none is a leaf and is not pushed.
        child_ext_bool = (rank[:, None, :] > rank[:, :, None]) & freq[:, None, :]
        push = (freq & child_ext_bool.any(dim=-1)).reshape(-1)         # [F*I]
        n_push, nf_total = torch.stack([push.sum(), nf.sum()]).tolist()

        # --- emit FIs prefix_f ∪ {e}, in the reference's stream order ------
        child_items = (node_items[:, None, :] | e_packed[None, :, :]).reshape(F * I, IW)
        flat_supp = supports.reshape(F * I)
        if not config.count_only:
            node_off = n_out + torch.cumsum(nf, dim=0) - nf
            out_pos = torch.where(freq, node_off[:, None] + rank, O).clamp_(max=O)
            out_pos = out_pos.reshape(F * I)
            out_items[out_pos] = child_items
            out_supp[out_pos] = flat_supp
        n_out = min(n_out + nf_total, O)
        n_total += nf_total

        if config.reservoir_size > 0 and nf_total:
            if reservoir_draws is not None and res_seen + nf_total > reservoir_draws.numel():
                raise ValueError(
                    f"{res_seen + nf_total} FIs streamed but only "
                    f"{reservoir_draws.numel()} reservoir draws given"
                )
            _reservoir_update(
                res_items, res_supp, res_seen, child_items, flat_supp,
                freq.reshape(F * I), R, generator, reservoir_draws,
            )
            res_seen += nf_total

        # --- push child PBECs, in flat (node, item) order -----------------
        sp_pop = sp - n_active
        n_keep = min(n_push, S - sp_pop)
        overflow += n_push - n_keep
        if n_keep:
            sel = torch.argsort((~push).to(torch.uint8), stable=True)[:n_keep]
            f_sel, e_sel = sel // I, sel % I
            top = slice(sp_pop, sp_pop + n_keep)
            stk_items[top] = child_items[sel]
            stk_ext[top] = bm.pack_bool(child_ext_bool[f_sel, e_sel])
            stk_tid[top] = item_bits[e_sel] & node_tid[f_sel]
        sp = sp_pop + n_keep
        it += 1
        popped += n_active

    return EclatResult(
        items=out_items[:O],
        supports=out_supp[:O],
        n_out=n_out,
        n_total=n_total,
        stack_overflow=overflow,
        reservoir_items=res_items[:R],
        reservoir_supports=res_supp[:R],
        n_iters=it,
        n_popped=popped,
    )


def _reservoir_update(
    res_items, res_supp, res_seen, items, supports, emit, R, generator, draws
) -> None:
    """Algorithm R over one trip's emissions, in place (thesis Alg. 9).

    The t-th emitted FI takes slot t-1 while t ≤ R, else slot j ~ U[0, t) if
    j < R.  Several emissions of one trip may land on one slot; as in the
    sequential loop, the latest one wins.
    """
    seen = res_seen + torch.cumsum(emit, dim=0)          # t of each emission
    if draws is not None:
        j = draws[(seen - 1).clamp(0, draws.numel() - 1)]
    else:
        u = torch.rand(
            seen.shape, generator=generator, dtype=torch.float64, device=seen.device
        )
        j = (u * seen).floor().to(torch.int64)
    slot = torch.where(seen <= R, seen - 1, j)
    take = emit & ((seen <= R) | (j < R))
    slot = torch.where(take, slot, R)
    last = torch.full((R + 1,), -1, dtype=torch.int64, device=seen.device)
    last.scatter_reduce_(0, slot, torch.where(take, seen, -1), reduce="amax")
    slot = torch.where(take & (last[slot] == seen), slot, R)
    res_items[slot] = items
    res_supp[slot] = supports


def mine(
    item_bits: torch.Tensor,      # int32[I, W]
    prefix_mask: torch.Tensor,    # bool [I]
    ext_mask: torch.Tensor,       # bool [I]
    prefix_tid: torch.Tensor,     # int32[W]
    min_support: int,
    *,
    config: EclatConfig,
    n_items: int,
    generator: torch.Generator | None = None,
    reservoir_draws: torch.Tensor | None = None,
) -> EclatResult:
    """Single-PBEC wrapper over :func:`mine_seeded`."""
    return mine_seeded(
        item_bits,
        prefix_mask[None, :],
        ext_mask[None, :],
        prefix_tid[None, :],
        torch.ones((1,), dtype=torch.bool, device=item_bits.device),
        int(min_support),
        config=config,
        n_items=n_items,
        generator=generator,
        reservoir_draws=reservoir_draws,
    )


def mine_all(
    db: bm.BitmapDB,
    min_support: int,
    *,
    config: EclatConfig = EclatConfig(),
    generator: torch.Generator | None = None,
    reservoir_draws: torch.Tensor | None = None,
) -> EclatResult:
    """Mine all FIs of a database (the root PBEC [∅ | B])."""
    I = db.n_items
    dev = db.item_bits.device
    return mine_seeded(
        db.item_bits,
        torch.zeros((1, I), dtype=torch.bool, device=dev),
        torch.ones((1, I), dtype=torch.bool, device=dev),
        db.all_tids()[None, :],
        torch.ones((1,), dtype=torch.bool, device=dev),
        int(min_support),
        config=config,
        n_items=I,
        generator=generator,
        reservoir_draws=reservoir_draws,
    )


def result_fis(res: EclatResult, n_items: int) -> dict:
    """The written FIs of a result as ``{frozenset: support}``."""
    masks = bm.unpack_bool(res.items[: res.n_out], n_items).cpu().numpy()
    supports = res.supports[: res.n_out].cpu().tolist()
    return {frozenset(np.flatnonzero(m).tolist()): s for m, s in zip(masks, supports)}


def brute_force_fis(dense, min_support: int) -> dict:
    """All frequent itemsets of a dense bool matrix, as {frozenset: support}.

    Host-side oracle (level-wise over covers; tiny databases only).
    """
    dense = np.asarray(dense, dtype=bool)
    n_items = dense.shape[1]
    out = {}
    frontier = []
    for i in range(n_items):
        s = int(dense[:, i].sum())
        if s >= min_support:
            out[frozenset([i])] = s
            frontier.append(((i,), dense[:, i]))
    while frontier:
        nxt = []
        for items, cover in frontier:
            for j in range(items[-1] + 1, n_items):
                cov = cover & dense[:, j]
                s = int(cov.sum())
                if s >= min_support:
                    out[frozenset(items + (j,))] = s
                    nxt.append((items + (j,), cov))
        frontier = nxt
    return out
