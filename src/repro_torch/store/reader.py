"""Streamed read side of the transaction store: disk → pinned host → device.

:class:`BlockReader` is the double-buffer protocol of the JAX package's
``store/reader.py`` in PyTorch's idiom.  While the consumer sweeps block *i*
on the card, one worker thread reads block *i+1* off disk straight into a
host staging buffer (page-locked on CUDA): the ``.npy`` payload is
``readinto`` the buffer and CRC-checked there, so no other host copy of the
block exists.  The copy to the card is issued ``non_blocking`` from that
buffer on a side CUDA stream, and the consumer's stream waits on an event
recorded behind it, so the copy of block *i+1* overlaps the consumer's work
on block *i*.  There are two staging buffers; one is refilled only after
the event behind its last copy has completed, and its bytes leave the host
accounting at that point.  At most two blocks are ever resident on the host,
whatever the database size; the reader accounts its live host bytes and
raises if they would exceed the budget, so O(block) host residency is an
enforced invariant.  On the CPU (the tests) the same class runs without
pinning or streams: the copy is synchronous and frees its buffer at once.

On top of it:

  * :func:`to_device_shards` — the ``int32[P, T, IW]`` shards ``fimi.run``
    and ``cluster.execute`` mine, assembled in one buffer on the card that
    each block is copied straight into, bit-exact with
    ``fimi.shard_db(store.to_dense(), P)`` (same row order, same
    ``n_tx − n_tx mod P`` truncation);
  * :func:`gather_rows` / :func:`sample_rows` — the Thm 6.1 database sample
    drawn off disk at given row indices: the same rows as
    ``bitmap.sample_transactions`` over the in-RAM database with those
    indices;
  * :func:`streamed_itemset_supports` — exact containment supports of packed
    itemset masks over the whole store, one launch of kernel B5
    (``ops.block_itemset_supports``) per non-empty block.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.store.retry import RetriesExhausted, RetryPolicy
from repro_torch.store.store import StoreIntegrityError, TxStore

# staging buffers: one block on its way to the card, one being read
N_STAGING = 2


class HostBudgetExceeded(RuntimeError):
    """The reader would hold more host bytes than the configured budget."""


class BlockReadError(RuntimeError):
    """A block failed to read/transfer; the message names block and path."""


#: Errors that already carry their own block context (or are the budget
#: invariant itself) — re-raised as-is at the consumer, never wrapped.
_PASSTHROUGH = (StoreIntegrityError, RetriesExhausted, HostBudgetExceeded)


class _Staging:
    """One host staging buffer of ``words`` int32 words, page-locked for the
    card.  ``block`` is the block it holds (None when free); ``copied`` the
    CUDA event recorded behind its copy to the card, once that is issued."""

    def __init__(self, words: int, pin: bool):
        self.tensor = torch.empty(max(words, 1), dtype=torch.int32, pin_memory=pin)
        self.words = self.tensor.numpy().view(np.uint32)
        self.block: Optional[int] = None
        self.copied: Optional[torch.cuda.Event] = None
        self.first = 0      # the first staged row the copy takes


class BlockReader:
    """Double-buffered disk → host → device block iterator with residency
    accounting.

    ``host_budget_blocks`` is the host block budget in units of the largest
    block; double buffering needs 2 (read-ahead + in flight).  Every host
    copy of a block counts: a block is live from the moment the worker
    stages it until the copy out of its staging buffer has completed on the
    card.  The observed high-water mark is :attr:`peak_host_bytes`;
    :attr:`refills` logs each staging as ``(block, buffer, block the buffer
    still held or None, that block's copy issued and complete)``; a staging
    that finds the held block's copy not issued or not complete raises
    instead of overwriting it.  ``device`` defaults to CUDA.

    Fault behavior (as the reference's): disk reads and the copy to the
    device run under ``retry`` (bounded exponential backoff, ``OSError``
    only by default; a CUDA error is not one and propagates untouched).  A
    failure on the prefetch thread is raised to the consumer at the
    iteration that needed the block — typed integrity errors pass through
    unchanged, anything else is wrapped in :class:`BlockReadError` naming
    the failing block index and path — and the worker thread is joined
    before the error propagates.
    """

    def __init__(
        self,
        store: TxStore,
        host_budget_blocks: int = 2,
        *,
        retry: RetryPolicy = RetryPolicy(),
        device: str | torch.device | None = None,
    ):
        if host_budget_blocks < 2:
            raise ValueError(
                "double buffering needs a host budget of >= 2 blocks "
                f"(got {host_budget_blocks})"
            )
        self.store = store
        self.device = device_mod.resolve(device)
        self.host_budget_blocks = host_budget_blocks
        self.budget_bytes = host_budget_blocks * max(store.max_block_bytes, 1)
        self.peak_host_bytes = 0
        self.retry = retry
        self.read_attempts = 0      # telemetry: total read attempts made
        self.refills: List[Tuple[int, int, Optional[int], bool]] = []
        self._live: dict = {}
        self._lock = threading.Lock()
        self._slots: List[_Staging] = []

    @property
    def staging_bytes(self) -> int:
        """Host bytes of the staging buffers (0 before the first pass)."""
        return sum(s.tensor.numel() * 4 for s in self._slots)

    def _block_path(self, i: int) -> str:
        return os.path.join(
            self.store.directory, self.store.manifest.blocks[i].file
        )

    # -- residency accounting -------------------------------------------------
    def _counter(self) -> None:
        obs_trace.TRACER.counter(
            "host bytes", live=float(sum(self._live.values())),
            peak=float(self.peak_host_bytes))

    def _settle(self, slot: _Staging, wait: bool) -> None:
        """Free ``slot`` once the copy out of it has completed on the card
        (waiting for it with ``wait``); a slot whose copy is not issued yet
        stays held."""
        ev = slot.copied
        if ev is None:
            return
        if wait:
            ev.synchronize()
        elif not ev.query():
            return
        with self._lock:
            if slot.copied is not ev:
                return
            self._live.pop(slot.block, None)
            slot.block = slot.copied = None
            self._counter()

    def _free(self, slot: _Staging) -> None:
        """Free ``slot`` now: nothing on the card reads it."""
        with self._lock:
            self._live.pop(slot.block, None)
            slot.block = slot.copied = None
            self._counter()

    def _stage(self, i: int, k: int) -> np.ndarray:
        """Worker: read block ``i`` into staging buffer ``k``, verified."""
        slot = self._slots[k]
        with self._lock:
            prev, prev_ev = slot.block, slot.copied
        self._settle(slot, wait=True)
        # the block the buffer still held must have had its copy issued, and
        # that copy must have completed: else refilling would overwrite rows
        # the card has not read yet
        done = prev is None or (prev_ev is not None and prev_ev.query())
        nbytes = self.store.manifest.blocks[i].n_tx * self.store.n_words * 4
        with self._lock:
            self.refills.append((i, k, prev, done))
            if not done:
                raise RuntimeError(
                    f"staging buffer {k} still holds block {prev}, whose copy "
                    f"to {self.device} has not completed"
                )
            slot.block = i
            self._live[i] = nbytes
            live = sum(self._live.values())
            self.peak_host_bytes = max(self.peak_host_bytes, live)
            obs_metrics.registry().gauge("store/host_bytes_peak").update_max(
                float(self.peak_host_bytes)
            )
            self._counter()
            if live > self.budget_bytes:
                raise HostBudgetExceeded(
                    f"host residency {live}B exceeds budget "
                    f"{self.budget_bytes}B ({self.host_budget_blocks} blocks)"
                )

        def attempt() -> np.ndarray:
            with self._lock:
                self.read_attempts += 1
            return self.store.read_block(i, out=slot.words)

        return self.retry.call(
            attempt, describe=f"read block {i} ({self._block_path(i)})"
        )

    # -- the copy to the device -----------------------------------------------
    def _copy(
        self, slot: _Staging, n_rows: int, dst: Optional[torch.Tensor],
        side: Optional[torch.cuda.Stream],
    ) -> torch.Tensor:
        """Copy the first ``n_rows`` staged rows into ``dst`` (a fresh device
        tensor when None); the consumer's stream waits for it."""
        IW = self.store.n_words
        src = slot.tensor[slot.first * IW: (slot.first + n_rows) * IW].view(n_rows, IW)
        if side is None:            # the CPU: synchronous, the buffer is free
            if dst is None:
                dst = torch.empty((n_rows, IW), dtype=torch.int32, device=self.device)
            dst.copy_(src)
            self._free(slot)
            return dst
        consumer = torch.cuda.current_stream(self.device)
        ev = torch.cuda.Event()
        with torch.cuda.stream(side):
            if dst is None:
                # allocated on the side stream and used on the consumer's:
                # record_stream keeps the allocator from reusing it before
                # the consumer's work on it is done
                dst = torch.empty((n_rows, IW), dtype=torch.int32, device=self.device)
                dst.record_stream(consumer)
            dst.copy_(src, non_blocking=True)
            ev.record(side)
        consumer.wait_event(ev)
        slot.copied = ev
        return dst

    # -- the double-buffered stream -------------------------------------------
    def device_blocks(
        self, dest: Optional[torch.Tensor] = None, first_row: int = 0,
    ) -> Iterator[Tuple[int, int, torch.Tensor, int]]:
        """Yield ``(block_index, row_offset, device_block, n_rows)``.

        With ``dest`` (int32 ``[R, IW]`` on the reader's device), which
        stands for the store's rows ``[first_row, first_row + R)``, only the
        blocks holding some of those rows are read, and each block's rows
        among them are copied straight into their slice of ``dest``, which
        is what is yielded; otherwise every block is read into a device
        tensor of its own.  A prefetch failure raises here, at the iteration
        that needed the block, with the block's index and path in the
        message.
        """
        sizes = self.store.block_sizes
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        if dest is None:
            if first_row:
                raise ValueError("first_row needs a dest")
            order = list(range(len(sizes)))
        else:
            if dest.device.type != self.device.type or dest.dtype != torch.int32:
                raise ValueError(f"dest must be int32 on {self.device}")
            last = first_row + dest.shape[0]
            order = [i for i in range(len(sizes))
                     if starts[i] < last and starts[i + 1] > first_row]
        n = len(order)
        if n == 0:
            return
        cuda = self.device.type == "cuda"
        words = self.store.max_block_bytes // 4
        if len(self._slots) != N_STAGING or self._slots[0].words.size < max(words, 1):
            self._slots = [_Staging(words, pin=cuda) for _ in range(N_STAGING)]
        side = None
        if cuda:
            side = torch.cuda.Stream(self.device)
            # dest may still be in use by the consumer's earlier work
            side.wait_stream(torch.cuda.current_stream(self.device))
        reg = obs_metrics.registry()
        stall_h = reg.histogram("store/prefetch_stall_s")
        blocks_c = reg.counter("store/blocks_read")
        ex = ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(self._stage, order[0], 0)
        try:
            for j, i in enumerate(order):
                t_wait = time.perf_counter()
                try:
                    arr = fut.result()
                except _PASSTHROUGH:
                    raise
                except Exception as e:
                    raise BlockReadError(
                        f"prefetch of block {i} ({self._block_path(i)}) "
                        f"failed: {e!r}"
                    ) from e
                # stall = how long the consumer blocked on the prefetch: ~0
                # when the read hid behind the previous block's work
                stall_h.record(time.perf_counter() - t_wait)
                blocks_c.inc()
                if j + 1 < n:
                    fut = ex.submit(self._stage, order[j + 1], (j + 1) % N_STAGING)
                slot = self._slots[j % N_STAGING]
                n_rows = int(arr.shape[0])
                del arr  # the staging buffer's view
                off = int(starts[i])
                if dest is None:
                    slot.first, take, dst = 0, n_rows, None
                else:
                    slot.first = max(first_row - off, 0)
                    take = max(0, min(n_rows, last - off) - slot.first)
                    at = off + slot.first - first_row
                    dst = dest[at:at + take]
                if take == 0:
                    self._free(slot)
                    dev = dst if dst is not None else torch.empty(
                        (0, self.store.n_words), dtype=torch.int32, device=self.device)
                else:
                    dev = self.retry.call(
                        lambda: self._copy(slot, take, dst, side),
                        describe=f"copy block {i} to {self.device}",
                    )
                for other in self._slots:
                    if other is not slot:
                        self._settle(other, wait=False)
                yield i, off, dev, n_rows
        finally:
            # join the worker before any exception propagates: no leaked
            # thread, and the in-flight future's error (if any) is
            # retrieved so it cannot surface later as a bare warning
            ex.shutdown(wait=True)
            if not fut.cancelled():
                fut.exception()
            for slot in self._slots:
                self._settle(slot, wait=True)
            with self._lock:
                if self._live:
                    self._live.clear()
                    self._counter()
                for slot in self._slots:
                    slot.block = slot.copied = None


# ---------------------------------------------------------------------------
# Device assembly — the mining input, built one block at a time
# ---------------------------------------------------------------------------


def _reader_for(store: TxStore, host_budget_blocks: int, reader: Optional[BlockReader],
                device) -> BlockReader:
    if reader is None:
        return BlockReader(store, host_budget_blocks, device=device)
    if device is not None and device_mod.resolve(device).type != reader.device.type:
        raise ValueError(f"the reader streams to {reader.device}, not {device}")
    return reader


def to_device_rows(
    store: TxStore,
    n_rows: Optional[int] = None,
    *,
    host_budget_blocks: int = 2,
    reader: Optional[BlockReader] = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """All (or the first ``n_rows``) packed rows as one int32 device tensor.

    The buffer is allocated on the device once and each block is copied
    straight into its row slice: no per-block copy of the whole slab.  Host
    residency stays within the reader's budget.  Pass ``reader`` to account
    residency on a caller-owned :class:`BlockReader` (launchers report its
    ``peak_host_bytes``); ``device`` defaults to the reader's, else CUDA.
    """
    reader = _reader_for(store, host_budget_blocks, reader, device)
    total = store.n_tx if n_rows is None else min(n_rows, store.n_tx)
    buf = torch.empty((total, store.n_words), dtype=torch.int32, device=reader.device)
    if total == 0:
        return buf
    for _ in reader.device_blocks(dest=buf):
        pass
    return buf


def to_device_shards(
    store: TxStore,
    P: int,
    *,
    miners: Optional[Sequence[int]] = None,
    host_budget_blocks: int = 2,
    reader: Optional[BlockReader] = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """``int32[P, T, IW]`` horizontal shards, bit-exact with
    ``fimi.shard_db(store.to_dense(), P)`` (row order preserved, the last
    ``n_tx mod P`` rows dropped), assembled block by block so the host never
    holds more than the reader's budget.

    With ``miners`` only those shards are assembled,
    ``int32[len(miners), T, IW]``, and only the blocks holding their rows
    are read: a rank passes its collectives' ``miners`` and reads its own
    shard off disk alone."""
    T = store.n_tx // P
    if miners is None:
        rows = to_device_rows(store, T * P, host_budget_blocks=host_budget_blocks,
                              reader=reader, device=device)
        return rows.view(P, T, store.n_words)
    reader = _reader_for(store, host_budget_blocks, reader, device)
    out = torch.empty((len(miners), T, store.n_words), dtype=torch.int32,
                      device=reader.device)
    for j, p in enumerate(miners):
        if not 0 <= p < P:
            raise ValueError(f"miner {p} is not one of the {P}")
        for _ in reader.device_blocks(dest=out[j], first_row=p * T):
            pass
    return out


# ---------------------------------------------------------------------------
# Off-disk sampling + streamed support counting (Phase-1/2, O(block))
# ---------------------------------------------------------------------------


def gather_rows(store: TxStore, indices) -> np.ndarray:
    """Gather arbitrary row indices (duplicates allowed) in one pass over the
    blocks that hold them; ``uint32[len(indices), IW]`` on the host."""
    idx = np.asarray(indices.cpu() if isinstance(indices, torch.Tensor) else indices,
                     np.int64).reshape(-1)
    assert idx.size == 0 or (idx.min() >= 0 and idx.max() < store.n_tx), (
        f"row index out of range [0, {store.n_tx})"
    )
    out = np.zeros((idx.shape[0], store.n_words), np.uint32)
    off = 0
    for i, nb in enumerate(store.block_sizes):
        sel = np.nonzero((idx >= off) & (idx < off + nb))[0]
        if sel.size:   # a block none of the rows lies in is not read
            out[sel] = store.read_block(i)[idx[sel] - off]
        off += nb
    return out


def sample_rows(
    store: TxStore, idx, *, device: str | torch.device | None = None,
) -> torch.Tensor:
    """Thm 6.1 i.i.d. transaction sample drawn off disk: the rows ``idx``
    (an index tensor or array, duplicates allowed) as int32 ``[n, IW]`` on
    ``device`` (CUDA unless the caller names another).

    The reference draws the indices with ``jax.random.randint``; the port
    takes them, as ``bitmap.sample_transactions(rows, n, idx=idx)`` does,
    and returns the same rows, so every plan built from them is the in-RAM
    path's at O(block) host cost.
    """
    rows = gather_rows(store, idx)
    return torch.from_numpy(rows.view(np.int32)).to(device_mod.resolve(device))


def streamed_itemset_supports(
    store: TxStore,
    masks: torch.Tensor,
    *,
    host_budget_blocks: int = 2,
    reader: Optional[BlockReader] = None,
) -> torch.Tensor:
    """Exact supports ``int64[F]`` of packed itemset masks (int32
    ``[F, IW]``) over the store, on the masks' device.

    One ``block_itemset_supports`` sweep (kernel B5 on the card) per
    non-empty block, accumulated on the device in int64; empty blocks are
    skipped (they support nothing).
    """
    from repro_torch.kernels import ops

    masks = masks.contiguous()
    reader = _reader_for(store, host_budget_blocks, reader, masks.device)
    total = torch.zeros((masks.shape[0],), dtype=torch.int64, device=masks.device)
    for _, _, dev, n_rows in reader.device_blocks():
        if n_rows == 0:
            continue
        total += ops.block_itemset_supports(dev[None], masks)[0]
    return total
