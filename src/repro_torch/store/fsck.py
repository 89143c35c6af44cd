"""Store fsck: scan a TxStore, classify damage, repair or quarantine.

The port's own copy of the JAX package's ``store/fsck.py`` (numpy only): the
same findings, actions and report for the same store.

The store's failure model (DESIGN.md, "Failure model") names four damage
classes plus one recoverable crash artifact:

  ``missing``         an indexed block file is gone;
  ``truncated``       an indexed payload is shorter than the manifest
                      records (torn ``np.save``, partial copy);
  ``bit-flip``        payload bytes fail their CRC32C;
  ``stale-manifest``  payload reads cleanly but disagrees structurally
                      with its manifest entry (shape/dtype/bytes), or the
                      manifest's totals disagree with its own blocks;
  ``orphan``          a ``block_NNNNNN.npy`` on disk that no manifest entry
                      indexes — the normal residue of a writer that crashed
                      between ``np.save`` and the manifest flush.

:func:`fsck` only ever *adds* safety: without flags it is a read-only scan;
``repair=True`` adopts the contiguous run of valid orphans left by a
crashed writer (recomputing their counts, sketches, and checksums into the
manifest — deterministic, so two resumes of the same crash agree) and
deletes torn or non-contiguous orphans; ``quarantine=True`` additionally
moves damaged *indexed* blocks into ``quarantine/`` and rebuilds the
manifest's exact totals from the surviving payloads, so what remains is a
smaller but internally consistent store.  Damage repair never guesses at
payload bits: a block that fails its checksum is quarantined, not patched.

``StoreWriter(resume=True)`` runs the ``deep=False`` mode before touching
an existing store: orphan adoption plus cheap size/existence checks (one
``stat`` per block, no payload reads), which keeps stream-spill restarts
O(orphans) while still closing the writer's crash window.  The CLI
(``launch/fsck.py``) defaults to ``deep=True``, which reads and checksums
every payload.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from repro_torch.store.checksum import crc32c
from repro_torch.store.store import (
    BLOCK_DIR,
    BlockMeta,
    ChecksumMismatchError,
    MissingBlockError,
    SKETCH_K,
    StaleManifestError,
    StoreIntegrityError,
    TruncatedBlockError,
    TxStore,
    block_file_index,
    unpack_bool_np,
    write_manifest,
)

QUARANTINE_DIR = "quarantine"


@dataclasses.dataclass
class Damage:
    """One classified finding (and what, if anything, was done about it)."""

    kind: str                   # missing|truncated|bit-flip|stale-manifest|orphan
    path: str
    detail: str
    block_index: Optional[int] = None   # manifest position, None for orphans
    action: str = "none"        # none|adopted|deleted|quarantined|repaired


@dataclasses.dataclass
class FsckReport:
    directory: str
    n_blocks: int               # manifest-indexed blocks after fsck
    n_tx: int
    damages: List[Damage]
    deep: bool

    @property
    def clean(self) -> bool:
        """True when no damage remains unhandled after the requested mode."""
        return all(d.action != "none" for d in self.damages)

    def summary(self) -> str:
        if not self.damages:
            return (f"{self.directory}: clean "
                    f"({self.n_blocks} blocks, {self.n_tx} tx, "
                    f"{'deep' if self.deep else 'shallow'} scan)")
        lines = [
            f"{self.directory}: {len(self.damages)} finding(s) "
            f"({'deep' if self.deep else 'shallow'} scan)"
        ]
        for d in self.damages:
            where = f"block {d.block_index}" if d.block_index is not None \
                else "orphan"
            lines.append(f"  [{d.kind}] {where} {d.path}: {d.detail}"
                         f" -> {d.action}")
        return "\n".join(lines)


def _classify_indexed(store: TxStore, i: int, deep: bool) -> Optional[Damage]:
    """Damage of manifest block ``i``, or None if it checks out."""
    meta = store.manifest.blocks[i]
    path = os.path.join(store.directory, meta.file)
    if not deep:
        # shallow: one stat per block — existence plus a payload-size floor
        if not os.path.exists(path):
            return Damage("missing", path, "file does not exist", i)
        if meta.n_bytes is not None and os.path.getsize(path) < meta.n_bytes:
            return Damage(
                "truncated", path,
                f"{os.path.getsize(path)}B on disk < {meta.n_bytes}B payload",
                i,
            )
        return None
    try:
        store.read_block(i)
    except MissingBlockError as e:
        return Damage("missing", path, str(e), i)
    except TruncatedBlockError as e:
        return Damage("truncated", path, str(e), i)
    except ChecksumMismatchError as e:
        return Damage("bit-flip", path, str(e), i)
    except StaleManifestError as e:
        return Damage("stale-manifest", path, str(e), i)
    return None


def _adoptable(path: str, n_words: int) -> Optional[np.ndarray]:
    """The orphan's payload if it is a well-formed packed block, else None."""
    try:
        arr = np.load(path, allow_pickle=False)
    except (ValueError, EOFError, OSError):
        return None
    if arr.dtype != np.uint32 or arr.ndim != 2 or arr.shape[1] != n_words:
        return None
    return np.ascontiguousarray(arr)


def _adopt(store: TxStore, rel: str, arr: np.ndarray) -> None:
    """Index an orphan payload: recompute counts, sketch, and checksum."""
    m = store.manifest
    counts = (
        unpack_bool_np(arr, m.n_items).sum(axis=0).astype(np.int64)
        if arr.shape[0] else np.zeros(m.n_items, np.int64)
    )
    k = min(SKETCH_K, m.n_items)
    top = np.argsort(-counts, kind="stable")[:k]
    top = top[counts[top] > 0]
    m.blocks.append(BlockMeta(
        file=rel,
        n_tx=int(arr.shape[0]),
        sketch_items=[int(i) for i in top],
        sketch_counts=[int(counts[i]) for i in top],
        n_bytes=int(arr.nbytes),
        crc32c=crc32c(arr),
    ))
    m.n_tx += int(arr.shape[0])
    m.item_counts = [
        int(a + b) for a, b in zip(m.item_counts, counts)
    ]


def _recount(store: TxStore) -> None:
    """Rebuild manifest totals (n_tx, item_counts) from surviving payloads."""
    m = store.manifest
    counts = np.zeros(m.n_items, np.int64)
    n_tx = 0
    for i in range(len(m.blocks)):
        arr = store.read_block(i)
        if arr.shape[0]:
            counts += unpack_bool_np(arr, m.n_items).sum(axis=0)
        n_tx += int(arr.shape[0])
    m.n_tx = n_tx
    m.item_counts = [int(c) for c in counts]


def fsck(
    directory: str,
    *,
    repair: bool = False,
    quarantine: bool = False,
    deep: bool = True,
) -> FsckReport:
    """Scan (and optionally heal) the store at ``directory``.

    ``repair`` adopts a crashed writer's contiguous valid orphans and
    deletes torn ones; ``quarantine`` (implies ``repair``) also moves
    damaged indexed blocks to ``quarantine/`` and recounts the manifest
    exactly from what survives.  Returns a :class:`FsckReport`; raises
    ``FileNotFoundError`` if there is no manifest to check against.
    """
    repair = repair or quarantine
    store = TxStore.open(directory)
    m = store.manifest
    damages: List[Damage] = []

    # ---- orphan scan: block files no manifest entry indexes ---------------
    indexed = {os.path.normpath(b.file) for b in m.blocks}
    block_dir = os.path.join(directory, BLOCK_DIR)
    orphans = sorted(
        (idx, name) for name in os.listdir(block_dir)
        if os.path.normpath(os.path.join(BLOCK_DIR, name)) not in indexed
        and (idx := block_file_index(name)) is not None
    ) if os.path.isdir(block_dir) else []
    # a crashed writer leaves orphans at consecutive indices right after the
    # last indexed block; that contiguous valid run is adoptable, in order
    next_idx = 1 + max(
        (i for i in (block_file_index(b.file) for b in m.blocks)
         if i is not None),
        default=-1,
    )
    manifest_dirty = False
    adopt_run = True
    for idx, name in orphans:
        rel = os.path.join(BLOCK_DIR, name)
        path = os.path.join(block_dir, name)
        arr = (
            _adoptable(path, m.n_words)
            if adopt_run and idx == next_idx else None
        )
        if arr is not None:
            next_idx += 1
            d = Damage("orphan", path,
                       f"{arr.shape[0]} rows written after the last manifest "
                       f"flush", block_index=None)
            if repair:
                _adopt(store, rel, arr)
                manifest_dirty = True
                d.action = "adopted"
            damages.append(d)
            continue
        adopt_run = False  # gap or torn payload: nothing later is trustworthy
        d = Damage("orphan", path,
                   "not adoptable (torn payload, wrong geometry, or "
                   "non-contiguous index)", block_index=None)
        if repair:
            os.remove(path)
            d.action = "deleted"
        damages.append(d)

    # ---- indexed blocks ----------------------------------------------------
    bad: List[int] = []
    for i in range(len(m.blocks)):
        d = _classify_indexed(store, i, deep)
        if d is not None:
            damages.append(d)
            bad.append(i)

    # ---- manifest self-consistency ----------------------------------------
    blocks_n_tx = sum(b.n_tx for b in m.blocks)
    if m.n_tx != blocks_n_tx or len(m.item_counts) != m.n_items:
        d = Damage(
            "stale-manifest", os.path.join(directory, "manifest.json"),
            f"totals disagree: n_tx={m.n_tx} vs blocks sum {blocks_n_tx}, "
            f"|item_counts|={len(m.item_counts)} vs n_items={m.n_items}",
        )
        if repair and not bad:
            _recount(store)
            manifest_dirty = True
            d.action = "repaired"
        damages.append(d)

    # ---- quarantine damaged indexed blocks + exact recount -----------------
    if quarantine and bad:
        qdir = os.path.join(directory, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        for d in damages:
            if d.block_index is None or d.action != "none":
                continue
            if os.path.exists(d.path):
                os.replace(d.path, os.path.join(qdir, os.path.basename(d.path)))
            d.action = "quarantined"
        m.blocks = [b for i, b in enumerate(m.blocks) if i not in set(bad)]
        _recount(store)
        manifest_dirty = True
        # the totals finding (if any) is subsumed by the recount
        for d in damages:
            if d.kind == "stale-manifest" and d.block_index is None:
                d.action = "repaired"

    if manifest_dirty:
        write_manifest(directory, m)

    return FsckReport(
        directory=directory,
        n_blocks=len(m.blocks),
        n_tx=m.n_tx,
        damages=damages,
        deep=deep,
    )


def check(directory: str, *, deep: bool = True) -> FsckReport:
    """Read-only scan; raises :class:`StoreIntegrityError` on any damage."""
    rep = fsck(directory, deep=deep)
    if rep.damages:
        raise StoreIntegrityError(rep.summary())
    return rep
