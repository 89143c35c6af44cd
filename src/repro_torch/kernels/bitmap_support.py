"""Single-prefix extension-support sweep (kernel B3) and its plain version.

Replaces the TPU kernel ``repro/kernels/bitmap_support.py::
extension_supports_pallas`` (``pl.pallas_call`` at line 67):

    S[i] = Σ_w popcount(item_bits[i, w] & prefix_tid[w])      int32[I]

It is the Eclat support count of one node: Phase-1 root supports and every
Phase-2 ``ext_supports`` call run it.

On the card: a GEMV shape that reads each word once and does three integer
operations (AND, POPC, ADD) per word, so it is bound by bytes.  At the main
path's shape (I=100, W=64 on the 2048-row Phase-1 sample) the work is a
launch's worth.  The design (``csrc/support.cu``, ``single_support_kernel``)
takes one of three launch shapes by W: short rows (W ≤ 64) blocks of 64
threads over 4 rows, a word a thread; middle rows blocks of 256 threads over
one row; long rows (W ≥ 8192) blocks of 256 threads over 2 rows whose W is
cut into chunks over a thread-block cluster of up to 8 blocks, as large as
one wave holds, whose first block adds the blocks' counts through
distributed shared memory.  A thread of a middle or long row keeps 4 words
of each row and of the tidlist in flight; one store a row, no atomics, no
zeroing launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of each int32 word, read as its 32 bits (int32).

    The SWAR count of the TPU kernel, on int32: the low 31 bits are
    non-negative, so no shift copies a sign and no sum overflows; the sign
    bit is counted on its own.
    """
    top = (x < 0).to(torch.int32)
    x = x & 0x7FFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F) + top


def extension_supports_plain(item_bits: torch.Tensor, prefix_tid: torch.Tensor) -> torch.Tensor:
    """``int32[I]`` supports, in plain torch (the CPU path and the oracle)."""
    return popcount(item_bits & prefix_tid[None, :]).sum(dim=-1, dtype=torch.int32)


def _check_inputs(name: str, item_bits: torch.Tensor, prefix_tid: torch.Tensor) -> None:
    """Raise unless the operands are what the kernel ``name`` takes."""
    if not (item_bits.is_cuda and prefix_tid.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if item_bits.device != prefix_tid.device:
        raise ValueError("item_bits and prefix_tid lie on different devices")
    if item_bits.dtype != torch.int32 or prefix_tid.dtype != torch.int32:
        raise TypeError("packed words are int32")
    if item_bits.dim() != 2 or prefix_tid.shape != (item_bits.shape[1],):
        raise ValueError(
            f"shapes {tuple(item_bits.shape)} and {tuple(prefix_tid.shape)} "
            "are not [I, W] and [W]"
        )
    if not (item_bits.is_contiguous() and prefix_tid.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def extension_supports_cuda(item_bits: torch.Tensor, prefix_tid: torch.Tensor) -> torch.Tensor:
    """``int32[I]`` supports from the CUDA kernel (CUDA int32 tensors only)."""
    _check_inputs("extension_supports_cuda", item_bits, prefix_tid)
    I, W = item_bits.shape
    out = torch.empty((I,), dtype=torch.int32, device=item_bits.device)
    if I == 0:  # no row: no launch
        return out
    with torch.cuda.device(item_bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.library().extension_supports(
            item_bits.data_ptr(), prefix_tid.data_ptr(), out.data_ptr(), I, W, stream
        )
    build.check(status, "extension_supports")
    extension_supports_cuda.launches += 1
    return out


def launch_facts(item_bits: torch.Tensor, prefix_tid: torch.Tensor) -> dict:
    """How B3 is launched for these operands (CUDA tensors, no launch made):
    its grid (rows × cluster), threads, cluster size, chunk words, resident
    blocks an SM and clusters at once, waves, and the kernel's registers and
    spilled (local) bytes a thread (``build.CLUSTER_FACTS``).  I must be
    positive."""
    _check_inputs("launch_facts", item_bits, prefix_tid)
    I, W = item_bits.shape
    return build.launch_facts("extension_supports_facts", build.CLUSTER_FACTS,
                              item_bits.device, I, W)


extension_supports_cuda.launches = 0
