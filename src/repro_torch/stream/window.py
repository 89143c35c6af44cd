"""Device-resident sliding window of packed transaction blocks.

The port of the JAX package's ``stream/window.py``.  The stream arrives in blocks of ``block_tx``
transactions, horizontally packed (``int32[block_tx, IW]``, the reference's
uint32 bits).  The window holds the most recent ``n_blocks`` blocks in a
ring ``int32[B, T_blk, IW]`` on the device that never moves: admit writes
one slot and expire is the overwritten slot, O(1) device work whatever the
window's length.

Unlike the reference's frozen structure, the port's window is updated in
place: :meth:`admit` copies the block into its slot and returns a copy of
the evicted block, so a window costs one ring of device memory, not one per
admitted block.  Ring position (``head``/``count``) is host state, and its
order is the reference's: slot ``(head + count) % B`` fills during warm-up,
then ``head`` is overwritten and advances.

Support bookkeeping against the window is the delta identity kernel B5
(``kernels/delta_support.py``) exists for::

  supp_W'(f) = supp_W(f) + |{t ∈ arrive : f ⊆ t}| − |{t ∈ expire : f ⊆ t}|

:meth:`rows` / :meth:`to_bitmap_db` materialize the logical window (oldest →
newest) for full re-mining, by a gather of block slots.  :class:`WindowSpill`
persists the evicted blocks into a store, the stream's history.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import bitmap as bm


class SlidingWindow:
    """Ring buffer of the last ``n_blocks`` packed transaction blocks.

    Attributes:
      blocks:   ``int32[B, T_blk, IW]`` ring; slot contents are valid for
                the ``count`` logical blocks, others are zero or stale.
      head:     slot index of the *oldest* resident block.
      count:    number of resident blocks, ≤ B.
      n_items:  |B| of the item universe.
    """

    def __init__(self, blocks: torch.Tensor, head: int, count: int, n_items: int):
        self.blocks = blocks
        self.head = head
        self.count = count
        self.n_items = n_items

    # -- constructors ---------------------------------------------------------
    @classmethod
    def empty(cls, n_blocks: int, block_tx: int, n_items: int, device=None) -> "SlidingWindow":
        """An empty window on ``device`` (CUDA unless the caller names another)."""
        dev = device_mod.resolve(device)
        ring = torch.zeros((n_blocks, block_tx, bm.n_words(n_items)), dtype=torch.int32,
                           device=dev)
        return cls(ring, 0, 0, n_items)

    @classmethod
    def from_reference(cls, *, blocks, head, count, n_items, device=None) -> "SlidingWindow":
        """The reference window's fields (``blocks`` as uint32 numpy) on
        ``device``."""
        dev = device_mod.resolve(device)
        return cls(bm.from_reference(np.asarray(blocks)).to(dev), int(head), int(count),
                   int(n_items))

    def to_reference(self) -> dict:
        """The reference window's fields: ``blocks`` as uint32 numpy."""
        return dict(blocks=bm.to_reference(self.blocks), head=self.head, count=self.count,
                    n_items=self.n_items)

    # -- ring geometry --------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def block_tx(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def n_words(self) -> int:
        return int(self.blocks.shape[2])

    @property
    def full(self) -> bool:
        return self.count == self.n_blocks

    @property
    def n_tx(self) -> int:
        """Transactions currently resident (count · block size)."""
        return self.count * self.block_tx

    def slot_order(self) -> Tuple[int, ...]:
        """Resident slot indices in logical (oldest → newest) order."""
        return tuple((self.head + i) % self.n_blocks for i in range(self.count))

    # -- admit / expire -------------------------------------------------------
    def admit(self, block: torch.Tensor) -> Optional[torch.Tensor]:
        """Admit one packed block ``int32[T_blk, IW]`` in place.

        Returns the evicted oldest block (a copy) once the ring is full, else
        None (warm-up: the window only grows).
        """
        if tuple(block.shape) != (self.block_tx, self.n_words) or block.dtype != torch.int32:
            raise ValueError(
                f"block of shape {tuple(block.shape)} and type {block.dtype}, want "
                f"int32 {(self.block_tx, self.n_words)}"
            )
        if not self.full:
            self.blocks[(self.head + self.count) % self.n_blocks] = block
            self.count += 1
            return None
        expired = self.blocks[self.head].clone()
        self.blocks[self.head] = block
        self.head = (self.head + 1) % self.n_blocks
        return expired

    # -- materialized views (re-mine path only) -------------------------------
    def stacked(self) -> torch.Tensor:
        """``int32[count, T_blk, IW]`` resident blocks, oldest → newest — the
        shape of the per-block sweep (``ops.block_itemset_supports``)."""
        order = torch.tensor(self.slot_order(), dtype=torch.int64, device=self.device)
        return self.blocks.index_select(0, order)

    def rows(self) -> torch.Tensor:
        """``int32[count·T_blk, IW]`` — resident rows, oldest → newest."""
        return self.stacked().reshape(-1, self.n_words)

    def to_bitmap_db(self) -> bm.BitmapDB:
        """Full BitmapDB of the current window (the re-mine input)."""
        return bm.rebuild_vertical(self.rows(), self.n_items, self.n_tx)


class WindowSpill:
    """Store-backed spill mode: expired blocks persist instead of vanishing.

    Wraps an append-only :class:`repro_torch.store.StoreWriter` on
    ``directory``; every block the ring evicts is appended (oldest → newest,
    the stream's arrival order), so the on-disk store is the stream's
    **history** beyond the window — re-minable later with
    ``fimi.run(store, …)`` or auditable with the streamed support counters.
    An existing store at ``directory`` is resumed (appended after its last
    block; geometry must match), never reset — a restarted stream extends
    its history.  The resume path runs the writer's shallow fsck pass first,
    which adopts any blocks a crashed stream saved but never indexed and
    clears torn residue.

    A block is the window's int32 words, on the device; the spill copies it
    to the host and writes its bits as the reference's uint32 (a view, not
    a value cast), so the store is byte-identical to the JAX package's
    spill of the same stream.

    The engine wires this up via ``StreamParams.spill_dir``; standalone use::

        spill = WindowSpill(directory, window.block_tx, window.n_items)
        expired = window.admit(block)
        if expired is not None:
            spill.append(expired)
    """

    def __init__(
        self, directory: str, block_tx: int, n_items: int, *,
        source: str = "stream-spill",
    ):
        from repro_torch.store.store import StoreWriter

        self.directory = directory
        self._writer = StoreWriter(
            directory, n_items=n_items, block_tx=block_tx, source=source,
            resume=True,
        )

    def append(self, expired_packed) -> int:
        """Persist one evicted packed block ``int32[T_blk, IW]`` (a tensor on
        any device) or ``uint32[T_blk, IW]`` (host words)."""
        if isinstance(expired_packed, torch.Tensor):
            expired_packed = bm.to_reference(expired_packed)
        return self._writer.append_packed(np.asarray(expired_packed))

    @property
    def n_spilled(self) -> int:
        return len(self._writer.manifest.blocks)

    def store(self):
        """Open the spilled history as a readable :class:`TxStore`."""
        return self._writer.close()
