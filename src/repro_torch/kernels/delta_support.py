"""Block containment sweep (kernel B5) and its plain version.

Replaces the TPU kernel ``repro/kernels/delta_support.py::
block_itemset_supports_pallas`` (``_kernel``, ``pl.pallas_call`` at line 101):

    counts[s, f] = Σ_t [ Σ_w popcount(fi[f, w] & ~tx[s, t, w]) == 0 ]

int32 ``[S, F]``: how many of the T rows of each of S stacked transaction
blocks ``[S, T, IW]`` contain each of F packed itemsets.  The streaming miner
runs it at S=2 for the arrive/expire delta of every admitted block
(``ops.delta_supports``), over the whole window for the exact recompute, and
at S=1 on the drift monitor's sample.

On the card: the test needs S·T·F·IW word operations on 4·IW·(S·T+F) input
bytes, so it is bound by operations, not bytes.  The zero test needs no
population count: f ⊆ t iff the OR over the words of ``f & ~t`` is zero, one
LOP3 a word on the 32-bit integer pipe.  The design
(``csrc/delta_support.cu``): a thread keeps four itemsets' words in
registers; a block stages 64 rows at a time in shared memory, read by every
thread at once as 16-byte vectors, so one staged row serves four itemsets;
T is split over blocks to fill the SMs, and one integer atomic per itemset
and block adds the counts, exact in any order.  Rows are bounded by T, so
the TPU kernel's sentinel word (it pads rows to tiles) is not needed: the
empty itemset counts every real row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.multi_support import _sm_count

# grid.z is at most 65535 blocks; one staged row holds at most 8192 words
MAX_S = 65535
MAX_IW = 8192
# elements of the plain version's [rows, F] temporaries
_PLAIN_CHUNK = 1 << 24


def block_itemset_supports_plain(tx_blocks: torch.Tensor, fi_masks: torch.Tensor) -> torch.Tensor:
    """``int32[S, F]`` containment counts, in plain torch (the CPU path and the
    oracle).  Rows go in chunks, one word at a time, so no ``[T, F, IW]``
    temporary is made."""
    S, T, IW = tx_blocks.shape
    F = fi_masks.shape[0]
    out = torch.zeros((S, F), dtype=torch.int32, device=tx_blocks.device)
    step = max(1, _PLAIN_CHUNK // max(F, 1))
    for s in range(S):
        for t0 in range(0, T, step):
            rows = tx_blocks[s, t0:t0 + step]
            missing = torch.zeros((rows.shape[0], F), dtype=torch.bool, device=rows.device)
            for w in range(IW):
                missing |= (fi_masks[None, :, w] & ~rows[:, w, None]) != 0
            out[s] += (~missing).sum(dim=0, dtype=torch.int32)
    return out


def block_itemset_supports_cuda(tx_blocks: torch.Tensor, fi_masks: torch.Tensor) -> torch.Tensor:
    """``int32[S, F]`` counts from the CUDA kernel B5 (CUDA int32 tensors only)."""
    if not (tx_blocks.is_cuda and fi_masks.is_cuda):
        raise ValueError("block_itemset_supports_cuda takes CUDA tensors")
    if tx_blocks.device != fi_masks.device:
        raise ValueError("tx_blocks and fi_masks lie on different devices")
    if tx_blocks.dtype != torch.int32 or fi_masks.dtype != torch.int32:
        raise TypeError("packed words are int32")
    if tx_blocks.dim() != 3 or fi_masks.dim() != 2 or fi_masks.shape[1] != tx_blocks.shape[2]:
        raise ValueError(
            f"shapes {tuple(tx_blocks.shape)} and {tuple(fi_masks.shape)} "
            "are not [S, T, IW] and [F, IW]"
        )
    if not (tx_blocks.is_contiguous() and fi_masks.is_contiguous()):
        raise ValueError("block_itemset_supports_cuda takes contiguous tensors")
    S, T, IW = tx_blocks.shape
    F = fi_masks.shape[0]
    if S > MAX_S or IW > MAX_IW:
        raise ValueError(f"S={S} or IW={IW} exceeds ({MAX_S}, {MAX_IW})")
    if S * T * F == 0:  # no pair of a row and an itemset: no launch
        return torch.zeros((S, F), dtype=torch.int32, device=tx_blocks.device)
    out = torch.empty((S, F), dtype=torch.int32, device=tx_blocks.device)
    with torch.cuda.device(tx_blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.library().block_itemset_supports(
            tx_blocks.data_ptr(), fi_masks.data_ptr(), out.data_ptr(), S, T, F, IW,
            _sm_count(tx_blocks.device.index), stream,
        )
    build.check(status, "block_itemset_supports")
    block_itemset_supports_cuda.launches += 1
    return out


block_itemset_supports_cuda.launches = 0
