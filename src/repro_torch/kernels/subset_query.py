"""Subset/superset query sweep (kernel B4) and its plain version.

Replaces the TPU kernel ``repro/kernels/subset_query.py::
subset_superset_counts_pallas`` (``pl.pallas_call`` at line 94):

    miss[q, f]  = Σ_w popcount(fi[f, w] & ~query[q, w])     (= |f ∖ q|)
    extra[q, f] = Σ_w popcount(query[q, w] & ~fi[f, w])     (= |q ∖ f|)

two int32 ``[Q, F]`` matrices from one pass over Q packed query masks and F
packed itemset masks of IW words each.  ``miss == 0`` ⇔ f ⊆ q (a rule's
antecedent applies to a basket), ``extra == 0`` ⇔ q ⊆ f (f is a superset of
the query), both ⇔ f = q (exact support lookup).  All three query kinds of
the serving engine (``repro_torch/serve/engine.py``) run it.

On the card: 2·Q·F·IW population counts over 4·IW·(Q+F) input bytes, and
8·Q·F output bytes.  IW is a few words (4 for 100 items), so the output
dominates the traffic: at the rules query, with Q=256 baskets against the
stacked ``[2R, IW]`` antecedent ∥ consequent slab, it is about 0.6 GB per
dispatch for 2R ≈ 3·10⁵ rows, and the kernel is bound by the bytes it
writes.  The design (``csrc/subset_query.cu``): Q×F carries the parallelism;
a block owns 16 queries × 256 itemsets, one itemset per thread, with both
tiles' words staged in shared memory and every store coalesced along F.  Any
IW works (the words are a loop), and ragged Q and F are bounded, not padded.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitmap_support import popcount

# grid.y is at most 65535 tiles of 16 queries
MAX_Q = 16 * 65535


def subset_superset_counts_plain(
    query_masks: torch.Tensor, fi_masks: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(miss, extra)`` int32 ``[Q, F]``, in plain torch (the CPU path and the
    oracle).  One word at a time, so no ``[Q, F, IW]`` temporary is made."""
    Q, IW = query_masks.shape
    F = fi_masks.shape[0]
    miss = torch.zeros((Q, F), dtype=torch.int32, device=query_masks.device)
    extra = torch.zeros_like(miss)
    for w in range(IW):
        q = query_masks[:, w, None]
        f = fi_masks[None, :, w]
        miss += popcount(f & ~q)
        extra += popcount(q & ~f)
    return miss, extra


def subset_superset_counts_cuda(
    query_masks: torch.Tensor, fi_masks: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(miss, extra)`` from the CUDA kernel B4 (CUDA int32 tensors only)."""
    if not (query_masks.is_cuda and fi_masks.is_cuda):
        raise ValueError("subset_superset_counts_cuda takes CUDA tensors")
    if query_masks.device != fi_masks.device:
        raise ValueError("query_masks and fi_masks lie on different devices")
    if query_masks.dtype != torch.int32 or fi_masks.dtype != torch.int32:
        raise TypeError("packed words are int32")
    if query_masks.dim() != 2 or fi_masks.dim() != 2 or fi_masks.shape[1] != query_masks.shape[1]:
        raise ValueError(
            f"shapes {tuple(query_masks.shape)} and {tuple(fi_masks.shape)} "
            "are not [Q, IW] and [F, IW]"
        )
    if not (query_masks.is_contiguous() and fi_masks.is_contiguous()):
        raise ValueError("subset_superset_counts_cuda takes contiguous tensors")
    Q, IW = query_masks.shape
    F = fi_masks.shape[0]
    if Q > MAX_Q:
        raise ValueError(f"Q={Q} exceeds {MAX_Q}")
    miss = torch.empty((Q, F), dtype=torch.int32, device=query_masks.device)
    extra = torch.empty_like(miss)
    if Q * F == 0:  # no pair: no launch
        return miss, extra
    with torch.cuda.device(query_masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.library().subset_superset_counts(
            query_masks.data_ptr(), fi_masks.data_ptr(), miss.data_ptr(), extra.data_ptr(),
            Q, F, IW, stream,
        )
    build.check(status, "subset_superset_counts")
    subset_superset_counts_cuda.launches += 1
    return miss, extra


subset_superset_counts_cuda.launches = 0
