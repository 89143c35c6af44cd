"""Packed bitmap representation of a transaction database, in PyTorch.

The layout is the JAX package's: bit ``t % 32`` of word ``t // 32``.

  * vertical:   ``item_bits[i, w]`` — bit ``t`` of word ``w`` set iff
                transaction ``32*w + t`` contains item ``i``; ``[I, n_words(T)]``.
  * horizontal: ``tx_bits[t, w]``   — bit ``i`` of word ``w`` set iff
                transaction ``t`` contains item ``32*w + i``; ``[T, n_words(I)]``.

Words are held as ``torch.int32`` with the bits of the reference's
``uint32``: torch's ``uint32`` has no ``~``, shifts, ``+``/``-`` or
``index_put`` on the CPU.  ``>>`` on int32 copies the sign bit, so every
right shift here is masked or works on a non-negative value.  The CUDA
kernels read the same memory as ``uint32``.

Support of an itemset U is ``popcount(AND_{i in U} item_bits[i])``; the
support sweeps (single-prefix, multi-prefix, all pairs) go through
:mod:`repro_torch.kernels.ops`, which launches the hand-written kernels on
CUDA tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.bitmap_support import popcount  # noqa: F401 (re-export)

WORD_BITS = 32
ALL_ONES = -1  # 0xFFFFFFFF as int32


def n_words(n: int) -> int:
    """Number of 32-bit words needed for ``n`` bits."""
    return (n + WORD_BITS - 1) // WORD_BITS


def from_reference(words: np.ndarray) -> torch.Tensor:
    """A ``uint32`` numpy array as an int32 tensor with the same bits.

    The tensor shares the array's memory, unless the array is read-only (as
    arrays taken from JAX are): torch tensors are writable, so that one is
    copied.
    """
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if not words.flags.writeable:
        words = words.copy()
    return torch.from_numpy(words.view(np.int32))


def to_reference(words: torch.Tensor) -> np.ndarray:
    """An int32 word tensor as a ``uint32`` numpy array with the same bits."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def pack_bool(dense: torch.Tensor) -> torch.Tensor:
    """Pack a bool tensor ``[..., n]`` into int32 words ``[..., n_words(n)]``.

    Bit ``k`` of word ``w`` is column ``32*w + k``.  The 32 shifted bits of a
    word are disjoint, so their int32 sum is their OR (bit 31 lands on the
    sign and the rest never carries into it).
    """
    n = dense.shape[-1]
    W = n_words(n)
    pad = W * WORD_BITS - n
    if pad:
        dense = torch.cat(
            [dense, dense.new_zeros(dense.shape[:-1] + (pad,))], dim=-1
        )
    bits = dense.reshape(dense.shape[:-1] + (W, WORD_BITS)).to(torch.int32)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=dense.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.int32)


def unpack_bool(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bool`; returns bool ``[..., n]``."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * WORD_BITS,))
    return flat[..., :n].to(torch.bool)


def and_reduce(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise AND of int32 words along ``dim`` (all-ones for an empty dim).

    A halving tree on the device: torch has no AND reduction.
    """
    words = words.movedim(dim, 0)
    n = words.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size > n or n == 0:
        words = torch.cat(
            [words, words.new_full((size - n,) + words.shape[1:], ALL_ONES)]
        )
    while words.shape[0] > 1:
        half = words.shape[0] // 2
        words = words[:half] & words[half:]
    return words[0]


@dataclasses.dataclass
class BitmapDB:
    """A transaction database in packed vertical and horizontal form.

    Attributes:
      item_bits: ``int32[n_items, n_tx_words]`` vertical representation.
      tx_bits:   ``int32[n_tx, n_item_words]`` horizontal representation.
      n_tx:      number of transactions.
      n_items:   size of the base set B.
    """

    item_bits: torch.Tensor
    tx_bits: torch.Tensor
    n_tx: int
    n_items: int

    @classmethod
    def from_dense(cls, dense: torch.Tensor) -> "BitmapDB":
        """Build from a dense bool matrix ``[n_tx, n_items]``."""
        dense = dense.to(torch.bool)
        n_tx, n_items = dense.shape
        return cls(
            item_bits=pack_bool(dense.T),
            tx_bits=pack_bool(dense),
            n_tx=n_tx,
            n_items=n_items,
        )

    @property
    def n_tx_words(self) -> int:
        return self.item_bits.shape[-1]

    def all_tids(self) -> torch.Tensor:
        """Bitmap of all transaction ids: the tidlist of the empty itemset."""
        return valid_bitmap(self.n_tx, self.n_tx_words, self.item_bits.device)


def valid_bitmap(n: int, n_words_: int, device) -> torch.Tensor:
    """``int32[n_words_]`` with bits ``0..n-1`` set."""
    full = torch.full((n_words_,), ALL_ONES, dtype=torch.int32, device=device)
    tail_bits = n_words_ * WORD_BITS - n
    if tail_bits:
        full[-1] = (1 << (WORD_BITS - tail_bits)) - 1
    return full


def tidlist_of_itemset(db: BitmapDB, itemset_mask: torch.Tensor) -> torch.Tensor:
    """Tidlist bitmap ``int32[W]`` of an itemset given as a bool mask ``[I]``."""
    rows = torch.where(itemset_mask[:, None], db.item_bits, ALL_ONES)
    return and_reduce(rows, 0) & db.all_tids()


def support_of_tidlist(tid: torch.Tensor) -> torch.Tensor:
    """Support (int32 scalar): the popcount of a tidlist bitmap."""
    return popcount(tid).sum(dtype=torch.int32)


def support_of_itemset(db: BitmapDB, itemset_mask: torch.Tensor) -> torch.Tensor:
    """Support (int32 scalar) of an itemset given as a bool mask ``[I]``."""
    return support_of_tidlist(tidlist_of_itemset(db, itemset_mask))


def extension_supports(item_bits: torch.Tensor, prefix_tid: torch.Tensor) -> torch.Tensor:
    """``int32[I]`` supports of ``prefix ∪ {i}`` for every item i (kernel B3)."""
    return ops.extension_supports(item_bits, prefix_tid)


def multi_extension_supports(
    item_bits: torch.Tensor, prefix_tids: torch.Tensor
) -> torch.Tensor:
    """``int32[K, I]`` supports of ``prefix_k ∪ {i}`` (kernel B1)."""
    return ops.multi_extension_supports(item_bits, prefix_tids)


def pair_supports(item_bits: torch.Tensor, valid_tid: torch.Tensor) -> torch.Tensor:
    """All-pairs supports ``int32[I, I]``: support({i, j}) over the valid
    transactions, the C2 step of Parallel-Eclat (Alg. 5 line 3; kernel B6)."""
    return ops.pair_supports(item_bits, valid_tid, use_mxu=False)


def itemset_mask_to_packed(mask: torch.Tensor) -> torch.Tensor:
    """Pack a bool itemset mask ``[..., I]`` into int32 ``[..., n_words(I)]``."""
    return pack_bool(mask)


def is_subset_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise test a ⊆ b for packed itemset masks (last axis = words)."""
    return ((a & ~b) == 0).all(dim=-1)


def sample_indices(
    n_rows: int,
    n_sample: int,
    *,
    generator: torch.Generator | None = None,
    idx: torch.Tensor | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Row indices of the Phase-1 DB sample (thesis §6.1): ``n_sample``
    i.i.d. draws (with replacement) from ``[0, n_rows)`` on ``generator``,
    or ``idx`` itself (so a test can hand in the reference's draws)."""
    if idx is None:
        return torch.randint(0, n_rows, (n_sample,), generator=generator, device=device)
    if idx.shape != (n_sample,):
        raise ValueError(f"idx has shape {tuple(idx.shape)}, want ({n_sample},)")
    return idx


def sample_transactions(
    tx_bits: torch.Tensor,
    n_sample: int,
    *,
    generator: torch.Generator | None = None,
    idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """i.i.d. (with replacement) sample of transaction rows — the Phase-1 DB
    sample, at :func:`sample_indices`."""
    idx = sample_indices(tx_bits.shape[0], n_sample, generator=generator, idx=idx,
                         device=tx_bits.device)
    return tx_bits[idx.to(tx_bits.device)]


def rebuild_vertical(tx_bits: torch.Tensor, n_items: int, n_tx: int) -> BitmapDB:
    """Re-pack a horizontal bitmap slab into a full BitmapDB."""
    return BitmapDB.from_dense(unpack_bool(tx_bits, n_items)[:n_tx])
