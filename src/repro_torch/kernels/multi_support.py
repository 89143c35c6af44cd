"""Multi-prefix extension-support sweeps (kernels B1 and B2) and their plain
versions.

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
next.  At that size the fixed costs of a launch weigh as much as the
counting, so the design (``csrc/support.cu``, ``multi_support_kernel``)
cuts them: a block owns a tile of 4 items × 8 prefixes and a chunk of W;
each thread strides the chunk with coalesced 32-bit loads and keeps the
32 counts in registers, so one loaded word serves 8 (item) or 4 (prefix) popcounts.  The
chunks of one tile are the blocks of one thread-block cluster (at most 8):
a warp reduces its 32 counts in 31 shuffles, the block in shared memory,
and the cluster's first block adds the blocks' counts through distributed
shared memory and stores each output once, so there is no zeroing launch
and no atomic.  Blocks are 512 threads, one an SM, where W gives each
thread 4 words, else 128; the cluster size is chosen so that every cluster
is resident at once and the SM with most blocks carries the least work.

B2 computes the same ``S`` on the tensor cores, as its TPU kernel
``multi_extension_supports_mxu_pallas`` (``_mxu_kernel``, ``pl.pallas_call``
at line 146) does on the MXU: the dot product of the 0/1 unpacked bits.  The
TPU kernel takes it in bf16 with f32 accumulation, exact below 2^24; the
CUDA kernel (``csrc/mxu_support.cu``) takes the 1-bit MMA
``m16n8k256.s32.b1.b1.s32.and.popc`` with int32 accumulation, which forms the
dot product of 0/1 vectors as the population count of their AND on the
packed words themselves, exact at every size the output holds.  The cluster
executor selects it with ``ClusterParams(use_mxu=True)`` for Phase 4.  Its
design and bound are in the source's note.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitmap_support import popcount

# grid.y and grid.z are at most 65535 tiles: of 8 prefixes and 4 items in
# B1, of 16 prefixes and 32 items in B2
MAX_K = 8 * 65535
MAX_I = 4 * 65535
MXU_MAX_K = 16 * 65535
MXU_MAX_I = 32 * 65535
# a count is at most 32·W, which int32 holds
MAX_W = (2**31 - 1) // 32


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


def multi_extension_supports_mxu_plain(
    item_bits: torch.Tensor, prefix_tids: torch.Tensor
) -> torch.Tensor:
    """``int32[K, I]`` supports as one matrix product of the unpacked 0/1 bits,
    in plain torch (the CPU path of ``use_mxu=True`` and B2's oracle).

    The product is taken in float64, exact for every count below 2^53.
    """
    t = unpack_bits(prefix_tids)                       # [K, 32·W]
    a = unpack_bits(item_bits)                         # [I, 32·W]
    return (t @ a.T).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 words ``[N, W]`` → float64 0/1 ``[N, 32·W]``, bit t of word w at
    column 32·w + t (the masked ``>>`` also reads the sign bit right)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], words.shape[1] * 32).to(torch.float64)


def _check_inputs(name: str, item_bits: torch.Tensor, prefix_tids: torch.Tensor,
                  max_k: int, max_i: int) -> None:
    """Raise unless the operands are what the kernel ``name`` takes."""
    if not (item_bits.is_cuda and prefix_tids.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
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
        raise ValueError(f"{name} takes contiguous tensors")
    K, (I, W) = prefix_tids.shape[0], item_bits.shape
    if K > max_k or I > max_i or W > MAX_W:
        raise ValueError(f"K={K}, I={I} or W={W} exceeds ({max_k}, {max_i}, {MAX_W})")


def _launch(name: str, item_bits: torch.Tensor, prefix_tids: torch.Tensor):
    """Launch the C entry point ``name`` on the current stream.  Returns the
    counts and whether a kernel was launched: with K·I·W = 0 there is nothing
    to count, and nothing is launched."""
    I, W = item_bits.shape
    K = prefix_tids.shape[0]
    if K * I * W == 0:
        return torch.zeros((K, I), dtype=torch.int32, device=item_bits.device), False
    out = torch.empty((K, I), dtype=torch.int32, device=item_bits.device)
    with torch.cuda.device(item_bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(build.library(), name)(
            item_bits.data_ptr(), prefix_tids.data_ptr(), out.data_ptr(), K, I, W,
            _sm_count(item_bits.device.index), stream,
        )
    build.check(status, name)
    return out, True


def multi_extension_supports_cuda(
    item_bits: torch.Tensor, prefix_tids: torch.Tensor
) -> torch.Tensor:
    """``int32[K, I]`` supports from the CUDA kernel B1 (CUDA int32 tensors only)."""
    _check_inputs("multi_extension_supports_cuda", item_bits, prefix_tids, MAX_K, MAX_I)
    out, launched = _launch("multi_extension_supports", item_bits, prefix_tids)
    multi_extension_supports_cuda.launches += launched
    return out


def multi_extension_supports_mxu_cuda(
    item_bits: torch.Tensor, prefix_tids: torch.Tensor
) -> torch.Tensor:
    """``int32[K, I]`` supports from the tensor-core kernel B2 (CUDA int32
    tensors only)."""
    _check_inputs("multi_extension_supports_mxu_cuda", item_bits, prefix_tids,
                  MXU_MAX_K, MXU_MAX_I)
    out, launched = _launch("multi_extension_supports_mxu", item_bits, prefix_tids)
    multi_extension_supports_mxu_cuda.launches += launched
    return out


def launch_facts(item_bits: torch.Tensor, prefix_tids: torch.Tensor) -> dict:
    """How B1 is launched for these operands (CUDA tensors, no launch made):
    its grid, cluster size, resident blocks an SM and clusters at once,
    waves, and the kernel's registers and spilled (local) bytes a thread
    (``build.CLUSTER_FACTS``)."""
    _check_inputs("launch_facts", item_bits, prefix_tids, MAX_K, MAX_I)
    K, (I, W) = prefix_tids.shape[0], item_bits.shape
    dev = item_bits.device
    return build.launch_facts("multi_extension_supports_facts", build.CLUSTER_FACTS, dev,
                              K, I, W, _sm_count(dev.index))


def mxu_launch_facts(item_bits: torch.Tensor, prefix_tids: torch.Tensor) -> dict:
    """How B2 is launched for these operands (CUDA tensors, no launch made):
    its grid (W chunks, prefix tiles of 16, item tiles of 32), chunk words,
    shared bytes, resident blocks an SM, waves, and the kernel's registers
    and spilled (local) bytes a thread (``build.GRID_FACTS``).  K, I and W
    must be positive."""
    _check_inputs("mxu_launch_facts", item_bits, prefix_tids, MXU_MAX_K, MXU_MAX_I)
    K, (I, W) = prefix_tids.shape[0], item_bits.shape
    dev = item_bits.device
    return build.launch_facts("multi_extension_supports_mxu_facts", build.GRID_FACTS, dev,
                              K, I, W, _sm_count(dev.index))


multi_extension_supports_cuda.launches = 0
multi_extension_supports_mxu_cuda.launches = 0
