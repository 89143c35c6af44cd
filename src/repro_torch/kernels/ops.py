"""Dispatch of the sweeps by the tensors' device alone.

A CPU tensor goes to the plain torch version; a CUDA tensor goes to the
hand-written kernel, which launches or raises.  There is no override and no
fallback from the kernel.

Every dispatch family is wrapped by the kernel profiler
(:mod:`repro_torch.obs.profile`), as in the reference: when enabled, each
call is timed on its device and bucketed by shape; when disabled — the
default — the wrapper is one attribute check and a tail call.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import bitmap_support as _bs
from repro_torch.kernels import delta_support as _ds
from repro_torch.kernels import multi_support as _ms
from repro_torch.kernels import pair_support as _ps
from repro_torch.kernels import subset_query as _sq
from repro_torch.obs import profile as _prof


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sweep for device {t.device}")
    return t.device.type


def _profiled(family, dims_fn):
    """Route a dispatch through the kernel profiler when it is enabled."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _prof.PROFILER.enabled:
                return fn(*args, **kwargs)
            return _prof.PROFILER.call(
                family, dims_fn(*args), lambda: fn(*args, **kwargs), args[0].device
            )

        return wrapper

    return deco


@_profiled(
    "bitmap",
    lambda item_bits, prefix_tid: {
        "I": int(item_bits.shape[0]), "W": int(item_bits.shape[1]),
    },
)
def extension_supports(item_bits: torch.Tensor, prefix_tid: torch.Tensor) -> torch.Tensor:
    """``int32[I]`` supports of prefix ∪ {i} for all items (kernel B3)."""
    if _route(item_bits) == "cuda":
        return _bs.extension_supports_cuda(item_bits, prefix_tid)
    return _bs.extension_supports_plain(item_bits, prefix_tid)


@_profiled(
    "multi",
    lambda item_bits, prefix_tids: {
        "K": int(prefix_tids.shape[0]),
        "I": int(item_bits.shape[0]), "W": int(item_bits.shape[1]),
    },
)
def multi_extension_supports(
    item_bits: torch.Tensor, prefix_tids: torch.Tensor, *, use_mxu: bool = False
) -> torch.Tensor:
    """``int32[K, I]`` supports of prefix_k ∪ {i} for K prefixes.

    The frontier-batched Eclat plug-in (``multi_support_fn``).  ``use_mxu``
    chooses between two kernels, B2 on the tensor cores or B1 on the integer
    pipes, and on the CPU between their plain versions; it never chooses a
    plain version on the card.
    """
    if _route(item_bits) == "cuda":
        if use_mxu:
            return _ms.multi_extension_supports_mxu_cuda(item_bits, prefix_tids)
        return _ms.multi_extension_supports_cuda(item_bits, prefix_tids)
    if use_mxu:
        return _ms.multi_extension_supports_mxu_plain(item_bits, prefix_tids)
    return _ms.multi_extension_supports_plain(item_bits, prefix_tids)


@_profiled(
    "subset",
    lambda query_masks, fi_masks: {
        "Q": int(query_masks.shape[0]),
        "F": int(fi_masks.shape[0]), "IW": int(fi_masks.shape[1]),
    },
)
def subset_superset_counts(
    query_masks: torch.Tensor, fi_masks: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(miss, extra)`` int32[Q, F]: |f ∖ q| and |q ∖ f| for every pair of a
    query mask and an itemset mask (kernel B4), the serving engine's sweep."""
    if _route(query_masks) == "cuda":
        return _sq.subset_superset_counts_cuda(query_masks, fi_masks)
    return _sq.subset_superset_counts_plain(query_masks, fi_masks)


@_profiled(
    "delta",
    lambda tx_blocks, fi_masks: {
        "S": int(tx_blocks.shape[0]), "T": int(tx_blocks.shape[1]),
        "F": int(fi_masks.shape[0]), "IW": int(fi_masks.shape[1]),
    },
)
def block_itemset_supports(tx_blocks: torch.Tensor, fi_masks: torch.Tensor) -> torch.Tensor:
    """``int32[S, F]``: how many rows of each of S stacked transaction blocks
    ``[S, T, IW]`` contain each itemset (kernel B5), the streaming sweep."""
    if _route(tx_blocks) == "cuda":
        return _ds.block_itemset_supports_cuda(tx_blocks, fi_masks)
    return _ds.block_itemset_supports_plain(tx_blocks, fi_masks)


def delta_supports(
    arrive: torch.Tensor, expire: torch.Tensor, fi_masks: torch.Tensor
) -> torch.Tensor:
    """``int32[2, F]``: (arrive counts, expire counts) from one sweep of B5.

    The window support update is ``supports += counts[0] - counts[1]``; both
    ``[T, IW]`` blocks ride the S axis of :func:`block_itemset_supports`,
    whose profiler wrapper times it (so this one has none).
    """
    return block_itemset_supports(torch.stack([arrive, expire]), fi_masks)


@_profiled(
    "pair",
    lambda item_bits, valid_tid: {
        "I": int(item_bits.shape[0]), "W": int(item_bits.shape[1]),
    },
)
def pair_supports(
    item_bits: torch.Tensor, valid_tid: torch.Tensor, *, use_mxu: bool = True
) -> torch.Tensor:
    """``int32[I, I]`` supports of every pair of rows of ``item_bits``, masked
    by ``valid_tid``.  ``use_mxu`` chooses between two kernels, B7 on the
    tensor cores (the default, as in the reference) or B6 on the integer
    pipes, and on the CPU between their plain versions."""
    if _route(item_bits) == "cuda":
        if use_mxu:
            return _ps.pair_supports_mxu_cuda(item_bits, valid_tid)
        return _ps.pair_supports_cuda(item_bits, valid_tid)
    if use_mxu:
        return _ps.pair_supports_mxu_plain(item_bits, valid_tid)
    return _ps.pair_supports_plain(item_bits, valid_tid)


def kernel_launches() -> Dict[str, int]:
    """Launches of each kernel so far in this process (its wrapper's counter)."""
    return {
        "multi_extension_supports": _ms.multi_extension_supports_cuda.launches,
        "extension_supports": _bs.extension_supports_cuda.launches,
        "multi_extension_supports_mxu": _ms.multi_extension_supports_mxu_cuda.launches,
        "subset_superset_counts": _sq.subset_superset_counts_cuda.launches,
        "block_itemset_supports": _ds.block_itemset_supports_cuda.launches,
        "pair_supports": _ps.pair_supports_cuda.launches,
        "pair_supports_mxu": _ps.pair_supports_mxu_cuda.launches,
    }
