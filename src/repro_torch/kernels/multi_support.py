"""Multi-prefix extension-support sweep (kernel B1) and its plain version.

Replaces the TPU kernel ``repro/kernels/multi_support.py::
multi_extension_supports_pallas`` (``_vpu_kernel``, ``pl.pallas_call`` at
line 86):

    S[k, i] = Σ_w popcount(item_bits[i, w] & prefix_tids[k, w])   int32[K, I]

The frontier-batched Eclat runs it once per DFS trip, in Phase 1 on the
sample and in Phase 4 on each miner's slab (main path: K=16, I=100,
W=15625).

On the card: K·I·W population counts, plus an AND and an ADD each, over
(I+K)·W input words.  Hopper issues 16 POPC per clock per SM against 64
other 32-bit integer operations, so the POPC pipe bounds it (6.0 µs at the
main shape, 132 SMs at 1.98 GHz) before the memory does (2.2 µs at 3.35
TB/s); the 6 MB item slab also stays in the 50 MB L2 from one trip to the
next.  The design (``csrc/support.cu``,
``multi_support_kernel``): a block owns a tile of 4 items × 8 prefixes and a
chunk of W; each thread strides the chunk with coalesced 32-bit loads and
keeps the 32 counts in registers, so one loaded word serves 8 (item) or 4
(prefix) popcounts.  Warp shuffles and shared memory reduce the block, and
one integer atomic per output adds the chunk's count.  The W axis,
sequential on the TPU, is split over blocks to fill the 132 SMs (about two
blocks per SM); integer atomics keep the result exact whatever order the
chunks land in.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitmap_support import popcount

# grid.y and grid.z are at most 65535 tiles of 8 prefixes and 4 items
MAX_K = 8 * 65535
MAX_I = 4 * 65535


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, looked up once: the grid is cut to fill them."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def multi_extension_supports_plain(
    item_bits: torch.Tensor, prefix_tids: torch.Tensor
) -> torch.Tensor:
    """``int32[K, I]`` supports, in plain torch (the CPU path and the oracle)."""
    inter = prefix_tids[:, None, :] & item_bits[None, :, :]  # [K, I, W]
    return popcount(inter).sum(dim=-1, dtype=torch.int32)


def multi_extension_supports_cuda(
    item_bits: torch.Tensor, prefix_tids: torch.Tensor
) -> torch.Tensor:
    """``int32[K, I]`` supports from the CUDA kernel (CUDA int32 tensors only)."""
    if not (item_bits.is_cuda and prefix_tids.is_cuda):
        raise ValueError("multi_extension_supports_cuda takes CUDA tensors")
    if item_bits.device != prefix_tids.device:
        raise ValueError("item_bits and prefix_tids lie on different devices")
    if item_bits.dtype != torch.int32 or prefix_tids.dtype != torch.int32:
        raise TypeError("packed words are int32")
    if (
        item_bits.dim() != 2
        or prefix_tids.dim() != 2
        or prefix_tids.shape[1] != item_bits.shape[1]
    ):
        raise ValueError(
            f"shapes {tuple(item_bits.shape)} and {tuple(prefix_tids.shape)} "
            "are not [I, W] and [K, W]"
        )
    if not (item_bits.is_contiguous() and prefix_tids.is_contiguous()):
        raise ValueError("multi_extension_supports_cuda takes contiguous tensors")
    I, W = item_bits.shape
    K = prefix_tids.shape[0]
    if K > MAX_K or I > MAX_I:
        raise ValueError(f"K={K} or I={I} exceeds the grid ({MAX_K}, {MAX_I})")
    if K * I * W == 0:  # nothing to count: no launch
        return torch.zeros((K, I), dtype=torch.int32, device=item_bits.device)
    out = torch.empty((K, I), dtype=torch.int32, device=item_bits.device)
    with torch.cuda.device(item_bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.library().multi_extension_supports(
            item_bits.data_ptr(), prefix_tids.data_ptr(), out.data_ptr(), K, I, W,
            _sm_count(item_bits.device.index), stream,
        )
    build.check(status, "multi_extension_supports")
    multi_extension_supports_cuda.launches += 1
    return out


multi_extension_supports_cuda.launches = 0
