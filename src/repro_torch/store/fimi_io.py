"""FIMI ``.dat`` reader/writer — the standard frequent-itemset exchange format.

The port's own copy of the JAX package's ``store/fimi_io.py`` (numpy only).

One transaction per line, items as whitespace-separated tokens (the public
FIMI repository datasets — retail, kosarak, T10I4D100K … — all use it).
Item tokens are remapped to **dense ids** in first-occurrence order; the
inverse map (dense id → source label) is kept alongside so a store round-
trips back to the original labels.

Everything streams line-by-line / block-by-block: ingesting a multi-GB
``.dat`` into a :class:`~repro_torch.store.store.TxStore` holds one block of
transactions at a time (two passes: label scan, then packed spill).
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.store.store import StoreWriter, TxStore, unpack_bool_np


def iter_dat(path: str) -> Iterator[List[str]]:
    """Yield one transaction per line as raw item tokens (blank lines skipped)."""
    with open(path) as f:
        for line in f:
            toks = line.split()
            if toks:
                yield toks


def scan_labels(path: str) -> List[str]:
    """First pass: distinct item tokens in first-occurrence order."""
    seen: Dict[str, int] = {}
    for toks in iter_dat(path):
        for t in toks:
            if t not in seen:
                seen[t] = len(seen)
    return list(seen)


def parse_dat(path: str) -> Tuple[List[List[int]], List[str]]:
    """Parse a ``.dat`` file into dense-id transactions + the label map.

    Returns ``(transactions, labels)`` where ``transactions[t]`` is the
    sorted list of dense item ids of line ``t`` (duplicates within a line
    collapse — a transaction is a set) and ``labels[i]`` is the source token
    of dense id ``i``.  In-RAM convenience for small files; use
    :func:`ingest_dat` for anything large.
    """
    labels: List[str] = []
    ids: Dict[str, int] = {}
    txs: List[List[int]] = []
    for toks in iter_dat(path):
        row = set()
        for t in toks:
            if t not in ids:
                ids[t] = len(labels)
                labels.append(t)
            row.add(ids[t])
        txs.append(sorted(row))
    return txs, labels


def write_dat(
    path: str,
    transactions: Iterable[Sequence[int]],
    labels: Optional[Sequence[str]] = None,
) -> None:
    """Write transactions to ``.dat``: one line per transaction, items in
    ascending dense-id order, rendered through ``labels`` when given (else
    the dense ids themselves) — the canonical form :func:`parse_dat` reads
    back bit-exactly."""
    with open(path, "w") as f:
        for tx in transactions:
            items = sorted(set(int(i) for i in tx))
            toks = [labels[i] if labels is not None else str(i) for i in items]
            f.write(" ".join(toks) + "\n")


def ingest_dat(path: str, directory: str, block_tx: int = 1024) -> TxStore:
    """Stream a ``.dat`` file into an on-disk store, O(block) host memory.

    Two passes: (1) scan the distinct item tokens to fix the dense universe,
    (2) re-read, densify ``block_tx`` transactions at a time, pack, append.
    The label map lands in the manifest (``item_labels``), so
    :func:`export_dat` restores the original tokens.
    """
    labels = scan_labels(path)
    ids = {t: i for i, t in enumerate(labels)}
    n_items = max(len(labels), 1)
    w = StoreWriter(
        directory,
        n_items=n_items,
        block_tx=block_tx,
        item_labels=labels,
        source=f"fimi:{path}",
        flush_every=16,  # bulk ingest: amortize the O(n_blocks) manifest dump
    )
    block = np.zeros((block_tx, n_items), dtype=bool)
    fill = 0
    for toks in iter_dat(path):
        for t in toks:
            block[fill, ids[t]] = True
        fill += 1
        if fill == block_tx:
            w.append_dense(block)
            block[:] = False
            fill = 0
    if fill:
        w.append_dense(block[:fill])
    return w.close()


def export_dat(store: TxStore, path: str) -> None:
    """Stream a store back to ``.dat`` (original labels when ingested from
    one, dense ids otherwise) — the inverse of :func:`ingest_dat`."""
    labels = store.item_labels
    with open(path, "w") as f:
        for blk in store.iter_blocks():
            dense = unpack_bool_np(blk, store.n_items)
            for row in dense:
                items = np.nonzero(row)[0]
                toks = [
                    labels[i] if labels is not None else str(i) for i in items
                ]
                f.write(" ".join(toks) + "\n")
