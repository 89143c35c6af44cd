"""On-disk columnar transaction store — the out-of-core tier.

The port's own copy of the JAX package's ``store/store.py``, with the same
behaviour and the **same on-disk format**: a store directory written by
either package reads back in the other.  A store is a directory::

    store/
      manifest.json          # n_tx, n_items, block sizes, per-block sketches
      blocks/
        block_000000.npy     # uint32[T_blk, IW] packed transaction rows
        block_000001.npy
        ...

Each block holds ``pack_bool``-layout horizontal bitmap rows (bit ``k`` of
word ``w`` = item ``32·w + k``), so a block read from disk is device-ready
without any host transform: the double-buffered
:class:`~repro_torch.store.reader.BlockReader` reads it straight into a
pinned staging buffer and copies it to the card.  Blocks may be ragged (a
partial final block, or even empty blocks from an idle stream spill); the
manifest records every block's row count so readers never guess.

This module is deliberately **numpy-only** (no torch import): the write path
(`ibm_gen` spill, FIMI ``.dat`` ingest) must run O(block) on hosts that
never touch a device.  The device-facing read path lives in
:mod:`repro_torch.store.reader`.  Host arrays stay uint32, as on disk; they
become the port's int32 words only through ``arr.view(np.int32)`` where
they cross into torch.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np
from numpy.lib import format as npy_format

from repro_torch.store.checksum import crc32c

MANIFEST_NAME = "manifest.json"
BLOCK_DIR = "blocks"
FORMAT = "txstore-v2"           # written by this code: per-block crc32c
LEGACY_FORMATS = ("txstore-v1",)  # still readable (no checksums to verify)
WORD_BITS = 32
SKETCH_K = 16  # per-block item-frequency sketch width


# ---------------------------------------------------------------------------
# Integrity errors (DESIGN.md, "Failure model")
# ---------------------------------------------------------------------------


class StoreIntegrityError(RuntimeError):
    """The store's on-disk state contradicts its manifest.

    Every subclass names a *distinct, actionable* damage class — the reader
    raises these instead of ever returning silently wrong rows, and
    :mod:`repro_torch.store.fsck` classifies a whole store with them.
    """


class MissingBlockError(StoreIntegrityError):
    """A manifest-indexed block file does not exist on disk."""


class TruncatedBlockError(StoreIntegrityError):
    """A block file is shorter than its payload (torn/partial write)."""


class ChecksumMismatchError(StoreIntegrityError):
    """A block payload fails its CRC32C (bit rot / silent corruption)."""


class StaleManifestError(StoreIntegrityError):
    """Manifest metadata and block payload disagree structurally
    (hand-edited or out-of-date manifest: wrong shape, dtype, or byte
    count for a payload that otherwise reads cleanly)."""


def n_words(n: int) -> int:
    return (n + WORD_BITS - 1) // WORD_BITS


def block_file_index(rel_or_name: str) -> Optional[int]:
    """The NNNNNN of a ``block_NNNNNN.npy`` file name (None if not one)."""
    name = os.path.basename(rel_or_name)
    if name.startswith("block_") and name.endswith(".npy"):
        digits = name[len("block_"):-len(".npy")]
        if digits.isdigit():
            return int(digits)
    return None


# ---------------------------------------------------------------------------
# Host-side packing (bit-exact mirror of core.bitmap.{pack,unpack}_bool)
# ---------------------------------------------------------------------------


def pack_bool_np(dense: np.ndarray) -> np.ndarray:
    """Pack bool ``[..., n]`` into uint32 ``[..., n_words(n)]`` on host.

    Same layout as ``core.bitmap.pack_bool`` (little-endian within words):
    ``np.packbits(bitorder="little")`` puts column ``8b + k`` at bit ``k`` of
    byte ``b``, and viewing 4 bytes as a little-endian uint32 puts byte ``b``
    at bits ``8b..8b+7`` — composing to column ``32w + k`` ↔ bit ``k`` of
    word ``w``.
    """
    dense = np.asarray(dense, dtype=bool)
    n = dense.shape[-1]
    W = n_words(n)
    pad = W * WORD_BITS - n
    if pad:
        dense = np.concatenate(
            [dense, np.zeros(dense.shape[:-1] + (pad,), bool)], axis=-1
        )
    packed8 = np.packbits(dense, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed8).view(np.uint32).reshape(
        dense.shape[:-1] + (W,)
    )


def unpack_bool_np(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bool_np`: bool ``[..., n]``."""
    packed = np.ascontiguousarray(np.asarray(packed, np.uint32))
    bits8 = packed.view(np.uint8)
    bits = np.unpackbits(bits8, axis=-1, bitorder="little")
    return bits[..., :n].astype(bool)


def _read_npy_header(f) -> tuple:
    """``(shape, fortran_order, dtype)`` of the ``.npy`` file at ``f``'s
    start, leaving ``f`` at its payload; raises ``ValueError`` or
    ``EOFError`` where ``np.load`` would."""
    version = npy_format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = npy_format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = npy_format.read_array_header_2_0(f)
    else:
        raise ValueError(f"unsupported .npy format version {version}")
    if dtype.hasobject:
        raise ValueError("object arrays cannot be read without pickle")
    return tuple(int(d) for d in shape), bool(fortran), dtype


def _read_exact(f, arr: np.ndarray) -> np.ndarray:
    """Fill the contiguous ``arr`` from ``f``; ``EOFError`` if it ends first."""
    view = memoryview(arr.reshape(-1).view(np.uint8))
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise EOFError(f"payload ended after {got} of {len(view)} bytes")
        got += n
    return arr


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """One block's manifest entry.

    ``n_bytes``/``crc32c`` are the v2 integrity fields (payload byte size
    and CRC32C of the packed rows); ``None`` on blocks indexed by a legacy
    v1 manifest, which read without verification.
    """

    file: str               # relative path under the store dir
    n_tx: int               # rows in this block (0 = empty block)
    sketch_items: List[int]     # top-K item ids by in-block frequency
    sketch_counts: List[int]    # their in-block supports
    n_bytes: Optional[int] = None   # packed payload bytes (v2)
    crc32c: Optional[int] = None    # CRC32C of the payload bytes (v2)

    def as_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "BlockMeta":
        return cls(
            file=d["file"],
            n_tx=int(d["n_tx"]),
            sketch_items=[int(x) for x in d["sketch_items"]],
            sketch_counts=[int(x) for x in d["sketch_counts"]],
            n_bytes=None if d.get("n_bytes") is None else int(d["n_bytes"]),
            crc32c=None if d.get("crc32c") is None else int(d["crc32c"]),
        )


@dataclasses.dataclass
class Manifest:
    """The store's JSON metadata (everything a reader plans with)."""

    n_tx: int
    n_items: int
    n_words: int
    block_tx: int           # nominal rows per block (blocks may be ragged)
    blocks: List[BlockMeta]
    item_counts: List[int]  # exact global per-item supports, length n_items
    item_labels: Optional[List[str]]  # dense id -> source label (.dat ingest)
    source: str

    def as_json(self) -> dict:
        return {
            "format": FORMAT,
            "n_tx": self.n_tx,
            "n_items": self.n_items,
            "n_words": self.n_words,
            "block_tx": self.block_tx,
            "blocks": [b.as_json() for b in self.blocks],
            "item_counts": self.item_counts,
            "item_labels": self.item_labels,
            "source": self.source,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Manifest":
        if d.get("format") not in (FORMAT,) + LEGACY_FORMATS:
            raise ValueError(f"not a {FORMAT} manifest: {d.get('format')!r}")
        return cls(
            n_tx=int(d["n_tx"]),
            n_items=int(d["n_items"]),
            n_words=int(d["n_words"]),
            block_tx=int(d["block_tx"]),
            blocks=[BlockMeta.from_json(b) for b in d["blocks"]],
            item_counts=[int(x) for x in d["item_counts"]],
            item_labels=d.get("item_labels"),
            source=d.get("source", ""),
        )


def write_manifest(directory: str, manifest: Manifest) -> None:
    """Atomically publish a manifest (write-temp + ``os.replace``).

    Shared by the writer, fsck's repairs, and the cluster checkpoint —
    readers never observe a torn metadata file.
    """
    path = os.path.join(directory, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest.as_json(), f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class StoreWriter:
    """Append packed transaction blocks to a store directory, O(block) host.

    The manifest is rewritten every ``flush_every`` appends (default: every
    append) and on :meth:`close`, so a store is readable at any point of a
    long spill; after a crash at most ``flush_every`` trailing blocks are
    unindexed.  Serializing the manifest costs O(n_blocks), so bulk writers
    (``write_ibm_store``, ``ingest_dat``) raise the cadence to keep a long
    spill O(n_blocks) total instead of O(n_blocks²).
    ``append_dense`` / ``append_packed`` both return the block index.

    ``resume=True`` re-opens an existing store and keeps appending after its
    last block (geometry must match) instead of resetting it — the window
    spill uses this so a restarted stream extends its history rather than
    silently destroying it.  Resume first runs :func:`repro_torch.store.fsck.fsck`
    in repair mode to clean up after a crashed writer: block files appended
    after the last manifest flush are deterministically **adopted** (their
    counts and checksums recomputed into the manifest) and a torn trailing
    payload is deleted, so the crash window between ``np.save`` and the
    manifest publish can neither lose indexed data nor miscount it.
    """

    def __init__(
        self,
        directory: str,
        n_items: int,
        block_tx: int,
        *,
        item_labels: Optional[Sequence[str]] = None,
        source: str = "",
        resume: bool = False,
        flush_every: int = 1,
    ):
        self.directory = directory
        self.flush_every = max(1, int(flush_every))
        os.makedirs(os.path.join(directory, BLOCK_DIR), exist_ok=True)
        manifest_path = os.path.join(directory, MANIFEST_NAME)
        if resume and os.path.exists(manifest_path):
            from repro_torch.store.fsck import fsck as run_fsck

            # adopt blocks a crashed writer saved but never indexed, delete
            # torn partial payloads — then the manifest below is trustworthy.
            # Shallow scan: one stat per indexed block, payload reads only
            # for orphans, so restarting a long stream spill stays cheap.
            rep = run_fsck(directory, repair=True, deep=False)
            if not rep.clean:
                raise StoreIntegrityError(
                    f"cannot resume {directory}: unrepaired damage —\n"
                    f"{rep.summary()}\n"
                    f"run repro_torch.launch.fsck --quarantine to salvage it"
                )
            with open(manifest_path) as f:
                self.manifest = Manifest.from_json(json.load(f))
            if (self.manifest.n_items != int(n_items)
                    or self.manifest.block_tx != int(block_tx)):
                raise ValueError(
                    f"cannot resume {directory}: existing geometry "
                    f"(n_items={self.manifest.n_items}, "
                    f"block_tx={self.manifest.block_tx}) != requested "
                    f"({n_items}, {block_tx})"
                )
            self._counts = np.asarray(self.manifest.item_counts, np.int64)
            self._next_idx = 1 + max(
                (i for i in (block_file_index(b.file)
                             for b in self.manifest.blocks) if i is not None),
                default=-1,
            )
            return
        self.manifest = Manifest(
            n_tx=0,
            n_items=int(n_items),
            n_words=n_words(n_items),
            block_tx=int(block_tx),
            blocks=[],
            item_counts=[0] * int(n_items),
            item_labels=list(item_labels) if item_labels is not None else None,
            source=source,
        )
        self._counts = np.zeros(int(n_items), np.int64)
        self._next_idx = 0
        self._flush()

    # -- append ---------------------------------------------------------------
    def append_dense(self, dense: np.ndarray) -> int:
        """Append a dense bool block ``[T, n_items]`` (packed here, O(block))."""
        dense = np.asarray(dense, dtype=bool)
        assert dense.ndim == 2 and dense.shape[1] == self.manifest.n_items
        return self._append(pack_bool_np(dense), dense.sum(axis=0))

    def append_packed(self, packed: np.ndarray) -> int:
        """Append an already-packed block ``uint32[T, IW]``."""
        packed = np.asarray(packed, np.uint32)
        assert packed.ndim == 2 and packed.shape[1] == self.manifest.n_words, (
            f"block shape {packed.shape} != (*, {self.manifest.n_words})"
        )
        if packed.shape[0]:
            counts = unpack_bool_np(packed, self.manifest.n_items).sum(axis=0)
        else:
            counts = np.zeros(self.manifest.n_items, np.int64)
        return self._append(packed, counts)

    def _append(self, packed: np.ndarray, item_counts: np.ndarray) -> int:
        bidx = len(self.manifest.blocks)
        # file names use a monotone counter, not len(blocks): after fsck
        # quarantines a mid-store block the two diverge, and reusing a name
        # would overwrite a payload the manifest still indexes
        rel = os.path.join(BLOCK_DIR, f"block_{self._next_idx:06d}.npy")
        self._next_idx += 1
        packed = np.ascontiguousarray(packed)
        np.save(os.path.join(self.directory, rel), packed, allow_pickle=False)
        counts = np.asarray(item_counts, np.int64)
        k = min(SKETCH_K, self.manifest.n_items)
        top = np.argsort(-counts, kind="stable")[:k]
        top = top[counts[top] > 0]
        self.manifest.blocks.append(
            BlockMeta(
                file=rel,
                n_tx=int(packed.shape[0]),
                sketch_items=[int(i) for i in top],
                sketch_counts=[int(counts[i]) for i in top],
                n_bytes=int(packed.nbytes),
                crc32c=crc32c(packed),
            )
        )
        self.manifest.n_tx += int(packed.shape[0])
        self._counts += counts
        if len(self.manifest.blocks) % self.flush_every == 0:
            self._flush()
        return bidx

    def _flush(self) -> None:
        self.manifest.item_counts = [int(c) for c in self._counts]
        write_manifest(self.directory, self.manifest)

    def close(self) -> "TxStore":
        self._flush()
        return TxStore.open(self.directory)


# ---------------------------------------------------------------------------
# Store handle (read side, host)
# ---------------------------------------------------------------------------


class TxStore:
    """Handle on an on-disk store: manifest + lazy block reads.

    Pure host metadata object — opening a store reads only the manifest.
    Block payloads are read on demand (:meth:`read_block`) by the streamed
    consumers in :mod:`repro_torch.store.reader`; nothing here ever materializes
    more than one block.

    Every block read is verified against the manifest's integrity fields
    (payload byte size + CRC32C) and raises a typed
    :class:`StoreIntegrityError` on any disagreement — never a silently
    wrong count.  ``verify=False`` skips the CRC pass (the IO benchmark's
    overhead baseline); legacy v1 manifests carry no checksums and read
    unverified either way.
    """

    def __init__(self, directory: str, manifest: Manifest, verify: bool = True):
        self.directory = directory
        self.manifest = manifest
        self.verify = verify

    @classmethod
    def open(cls, directory: str, verify: bool = True) -> "TxStore":
        path = os.path.join(directory, MANIFEST_NAME)
        with open(path) as f:
            return cls(directory, Manifest.from_json(json.load(f)), verify)

    @staticmethod
    def exists(directory: str) -> bool:
        return os.path.exists(os.path.join(directory, MANIFEST_NAME))

    # -- metadata views -------------------------------------------------------
    @property
    def n_tx(self) -> int:
        return self.manifest.n_tx

    @property
    def n_items(self) -> int:
        return self.manifest.n_items

    @property
    def n_words(self) -> int:
        return self.manifest.n_words

    @property
    def n_blocks(self) -> int:
        return len(self.manifest.blocks)

    @property
    def block_tx(self) -> int:
        return self.manifest.block_tx

    @property
    def block_sizes(self) -> List[int]:
        return [b.n_tx for b in self.manifest.blocks]

    @property
    def total_bytes(self) -> int:
        """Packed payload bytes across all blocks (the out-of-core size)."""
        return sum(b.n_tx * self.n_words * 4 for b in self.manifest.blocks)

    @property
    def max_block_bytes(self) -> int:
        return max(
            (b.n_tx * self.n_words * 4 for b in self.manifest.blocks),
            default=0,
        )

    @property
    def item_labels(self) -> Optional[List[str]]:
        return self.manifest.item_labels

    def item_counts(self) -> np.ndarray:
        """Exact global per-item supports (maintained by the writer)."""
        return np.asarray(self.manifest.item_counts, np.int64)

    # -- block reads ----------------------------------------------------------
    def read_block(self, i: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        """One packed block ``uint32[T_i, IW]`` from disk, verified.

        With ``out`` (a C-contiguous uint32 array of at least ``T_i·IW``
        elements, e.g. the numpy view of a pinned staging buffer) the
        payload is read straight into it and the result is a view of it:
        the ``.npy`` header is parsed with ``np.lib.format`` and the payload
        ``readinto`` the buffer, so no second host copy of the block exists.

        Raises :class:`MissingBlockError` / :class:`TruncatedBlockError` /
        :class:`StaleManifestError` / :class:`ChecksumMismatchError` — each
        damage class is distinct so callers (and the fsck CLI) can act on
        it — for the same files as the reference's ``np.load``-based read.
        OS-level read failures propagate as ``OSError`` for the reader's
        retry policy.
        """
        meta = self.manifest.blocks[i]
        path = os.path.join(self.directory, meta.file)
        if not os.path.exists(path):
            raise MissingBlockError(
                f"block {i}: {path} does not exist (manifest expects "
                f"{meta.n_tx} rows) — restore the file or fsck --quarantine"
            )
        want = f"manifest expects {meta.n_tx}x{self.n_words} uint32"
        with open(path, "rb") as f:
            try:
                shape, fortran, dtype = _read_npy_header(f)
            except (ValueError, EOFError) as e:
                raise TruncatedBlockError(
                    f"block {i}: {path} is truncated or torn ({want}): {e}"
                ) from e
            n_payload = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            if os.fstat(f.fileno()).st_size - f.tell() < n_payload:
                # np.save is not atomic: a crash mid-write leaves a payload
                # shorter than its own header claims
                raise TruncatedBlockError(
                    f"block {i}: {path} is truncated or torn ({want}): "
                    f"payload shorter than its header's {n_payload}B"
                )
            if dtype != np.uint32 or shape != (meta.n_tx, self.n_words):
                raise StaleManifestError(
                    f"block {i}: payload {dtype}{list(shape)} != "
                    f"manifest uint32[{meta.n_tx}, {self.n_words}] at {path} — "
                    f"manifest is stale or hand-edited"
                )
            if meta.n_bytes is not None and n_payload != meta.n_bytes:
                raise StaleManifestError(
                    f"block {i}: payload is {n_payload}B but manifest records "
                    f"{meta.n_bytes}B at {path}"
                )
            n_words = meta.n_tx * self.n_words
            if out is None:
                arr = np.empty((meta.n_tx, self.n_words), np.uint32)
            else:
                if out.dtype != np.uint32 or not out.flags.c_contiguous \
                        or out.size < n_words:
                    raise ValueError(
                        f"out must be a C-contiguous uint32 array of at least "
                        f"{n_words} words (got {out.dtype}{list(out.shape)})"
                    )
                arr = out.reshape(-1)[:n_words].reshape(meta.n_tx, self.n_words)
            try:
                if fortran and meta.n_tx > 1 and self.n_words > 1:
                    # the writer saves C order; a Fortran-ordered payload
                    # (only by hand) reads through one transient copy
                    arr[...] = _read_exact(f, np.empty(shape[::-1], np.uint32)).T
                else:
                    _read_exact(f, arr)
            except EOFError as e:   # the file shrank under the read
                raise TruncatedBlockError(
                    f"block {i}: {path} is truncated or torn ({want}): {e}"
                ) from e
        if self.verify and meta.crc32c is not None:
            got = crc32c(arr)
            if got != meta.crc32c:
                raise ChecksumMismatchError(
                    f"block {i}: CRC32C {got:#010x} != manifest "
                    f"{meta.crc32c:#010x} at {path} — payload bits flipped "
                    f"since the writer sealed it"
                )
        return arr

    def iter_blocks(self) -> Iterator[np.ndarray]:
        """Host-side block iterator (one block resident at a time)."""
        for i in range(self.n_blocks):
            yield self.read_block(i)

    # -- materialized views (parity gates / tests only — O(n_tx) host) --------
    def read_all_packed(self) -> np.ndarray:
        """All rows ``uint32[n_tx, IW]`` — parity/tests only, O(n_tx) host."""
        out = np.empty((self.n_tx, self.n_words), np.uint32)
        off = 0
        for i, n in enumerate(self.block_sizes):
            self.read_block(i, out=out[off:off + n])
            off += n
        return out

    def to_dense(self) -> np.ndarray:
        """Dense bool ``[n_tx, n_items]`` — parity/tests only, O(n_tx·I) host."""
        return unpack_bool_np(self.read_all_packed(), self.n_items)


# ---------------------------------------------------------------------------
# IBM-generator spill: synthesize straight to disk, O(block) host memory
# ---------------------------------------------------------------------------


def write_ibm_store(
    params, directory: str, block_tx: int = 4096
) -> TxStore:
    """Spill an IBM-generator database to a store, one block at a time.

    Uses :func:`repro_torch.data.ibm_gen.generate_blocks`, so peak host residency
    is one dense block + one packed block — never the full ``[N, I]`` matrix
    the old generate-then-pack pipeline materialized.
    """
    from repro_torch.data.ibm_gen import generate_blocks

    w = StoreWriter(
        directory,
        n_items=params.n_items,
        block_tx=block_tx,
        source=f"ibm:{params.name}:seed={params.seed}",
        flush_every=16,  # bulk spill: amortize the O(n_blocks) manifest dump
    )
    for dense_block in generate_blocks(params, block_tx):
        w.append_dense(dense_block)
    return w.close()
