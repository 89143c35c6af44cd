"""All-pairs support sweeps (kernels B6 and B7) and their plain versions.

Replaces the TPU kernels ``repro/kernels/pair_support.py::
pair_supports_pallas`` (``_vpu_kernel``, ``pl.pallas_call`` at line 74) and
``pair_supports_mxu_pallas`` (``_mxu_kernel``, ``pl.pallas_call`` at line
133):

    S[i, j] = Σ_w popcount(b[i, w] & b[j, w]),  b = item_bits & valid_tid

int32 ``[I, I]``: the support of every pair of rows, the C2 counting step
and the profit matrix of DB-Repl-Min (thesis Alg. 23).  B6 is the
DB-Repl-Min profit matrix of ``fimi.run(scheduler="repl_min")``
(``core/schedule.pairwise_shared_transactions``, I = the classes, W = the
sample's words); B7 is ``ops.pair_supports``'s default, which the profiled
demo runs on the whole database (I=100, W=15625).

On the card B6 is bound by the POPC pipe (16 per clock per SM); B7's 1-bit
MMAs, at the rate ``chip_smoke.py`` measures, take less time than its bytes,
so the bytes bound B7.  The designs
(``csrc/pair_support.cu``): B6 is B1's register tiling with both operands
the masked item rows, an 8 × 8 tile of counters per thread; B7 is B2's
staged 1-bit MMA ``m16n8k256 .and.popc`` on 32 × 32 tiles.  S is symmetric,
so both launch only the tile pairs of one triangle and store each
off-diagonal count twice.  B6 is one launch that stores each output once: a
tile pair's W chunks form a thread-block cluster, sized so that every
cluster is resident at once, whose first block adds the chunks' counts
through distributed shared memory.  B7 splits W over blocks whose integer
atomics add the partial counts into a zeroed output, exact in any order.  The
TPU's MXU kernel sums in f32, exact below 2^24; B7 sums in int32, exact to
the int32 range.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitmap_support import popcount
from repro_torch.kernels.multi_support import MAX_W, _sm_count, unpack_bits

# the number of tile pairs, ⌈I/8⌉·(⌈I/8⌉+1)/2, must fit grid.x
MAX_I = 1 << 18
# elements of the plain version's [rows, I, W] temporaries
_PLAIN_CHUNK = 1 << 24


def pair_supports_plain(item_bits: torch.Tensor, valid_tid: torch.Tensor) -> torch.Tensor:
    """``int32[I, I]`` pair supports, in plain torch (the CPU path and B6's
    oracle).  Rows go in chunks, so no temporary exceeds ``_PLAIN_CHUNK``
    words."""
    masked = item_bits & valid_tid[None, :]
    I, W = masked.shape
    out = torch.empty((I, I), dtype=torch.int32, device=masked.device)
    step = max(1, _PLAIN_CHUNK // max(I * W, 1))
    for i0 in range(0, I, step):
        inter = masked[i0:i0 + step, None, :] & masked[None, :, :]
        out[i0:i0 + step] = popcount(inter).sum(dim=-1, dtype=torch.int32)
    return out


def pair_supports_mxu_plain(item_bits: torch.Tensor, valid_tid: torch.Tensor) -> torch.Tensor:
    """``int32[I, I]`` pair supports as one matrix product of the unpacked 0/1
    bits, in plain torch (the CPU path of ``use_mxu=True`` and B7's oracle).

    The product is taken in float64, exact for every count below 2^53.
    """
    u = unpack_bits(item_bits & valid_tid[None, :])     # [I, 32·W]
    return (u @ u.T).to(torch.int32)


def _check_inputs(name: str, item_bits: torch.Tensor, valid_tid: torch.Tensor) -> None:
    """Raise unless the operands are what the kernel ``name`` takes."""
    if not (item_bits.is_cuda and valid_tid.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if item_bits.device != valid_tid.device:
        raise ValueError("item_bits and valid_tid lie on different devices")
    if item_bits.dtype != torch.int32 or valid_tid.dtype != torch.int32:
        raise TypeError("packed words are int32")
    if item_bits.dim() != 2 or valid_tid.shape != (item_bits.shape[1],):
        raise ValueError(
            f"shapes {tuple(item_bits.shape)} and {tuple(valid_tid.shape)} "
            "are not [I, W] and [W]"
        )
    if not (item_bits.is_contiguous() and valid_tid.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    I, W = item_bits.shape
    if I > MAX_I or W > MAX_W:
        raise ValueError(f"I={I} or W={W} exceeds ({MAX_I}, {MAX_W})")


def _launch(name: str, item_bits: torch.Tensor, valid_tid: torch.Tensor):
    """Launch the C entry point ``name`` on the current stream.  Returns the
    counts and whether a kernel was launched: with I·W = 0 there is nothing
    to count, and nothing is launched."""
    I, W = item_bits.shape
    if I * W == 0:
        return torch.zeros((I, I), dtype=torch.int32, device=item_bits.device), False
    out = torch.empty((I, I), dtype=torch.int32, device=item_bits.device)
    with torch.cuda.device(item_bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(build.library(), name)(
            item_bits.data_ptr(), valid_tid.data_ptr(), out.data_ptr(), I, W,
            _sm_count(item_bits.device.index), stream,
        )
    build.check(status, name)
    return out, True


def pair_supports_cuda(item_bits: torch.Tensor, valid_tid: torch.Tensor) -> torch.Tensor:
    """``int32[I, I]`` pair supports from the CUDA kernel B6 (CUDA int32 tensors
    only)."""
    _check_inputs("pair_supports_cuda", item_bits, valid_tid)
    out, launched = _launch("pair_supports", item_bits, valid_tid)
    pair_supports_cuda.launches += launched
    return out


def pair_supports_mxu_cuda(item_bits: torch.Tensor, valid_tid: torch.Tensor) -> torch.Tensor:
    """``int32[I, I]`` pair supports from the tensor-core kernel B7 (CUDA int32
    tensors only)."""
    _check_inputs("pair_supports_mxu_cuda", item_bits, valid_tid)
    out, launched = _launch("pair_supports_mxu", item_bits, valid_tid)
    pair_supports_mxu_cuda.launches += launched
    return out


def launch_facts(item_bits: torch.Tensor, valid_tid: torch.Tensor) -> dict:
    """How B6 is launched for these operands (CUDA tensors, no launch made):
    its grid (tile pairs × cluster), threads, cluster size, chunk words,
    resident blocks an SM and clusters at once, waves, and the kernel's
    registers and spilled (local) bytes a thread (``build.CLUSTER_FACTS``).
    I must be positive."""
    _check_inputs("launch_facts", item_bits, valid_tid)
    I, W = item_bits.shape
    dev = item_bits.device
    return build.launch_facts("pair_supports_facts", build.CLUSTER_FACTS, dev, I, W,
                              _sm_count(dev.index))


def mxu_launch_facts(item_bits: torch.Tensor, valid_tid: torch.Tensor) -> dict:
    """How B7 is launched for these operands (CUDA tensors, no launch made):
    its grid (pairs of 32-row tiles, W chunks), chunk words, shared bytes,
    resident blocks an SM, waves, and the kernel's registers and spilled
    (local) bytes a thread (``build.GRID_FACTS``).  I and W must be
    positive."""
    _check_inputs("mxu_launch_facts", item_bits, valid_tid)
    I, W = item_bits.shape
    dev = item_bits.device
    return build.launch_facts("pair_supports_mxu_facts", build.GRID_FACTS, dev, I, W,
                              _sm_count(dev.index))


pair_supports_cuda.launches = 0
pair_supports_mxu_cuda.launches = 0
