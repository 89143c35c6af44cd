"""Out-of-core transaction store — mine databases bigger than host memory.

The port's store, with the JAX package's names, behaviour and on-disk
format (a store written by either package reads back in the other):

``store``    Disk format: JSON manifest + packed-bitmap block files
             (``uint32[T_blk, IW]``), append-only :class:`StoreWriter`,
             host-side :class:`TxStore` handle, IBM-generator spill.
``reader``   Streamed read side: double-buffered disk → pinned host →
             device :class:`BlockReader` (host residency within a block
             budget, enforced), block-wise shard assembly on the card,
             off-disk Thm 6.1 sampling, streamed exact support counting
             (kernel B5).
``fimi_io``  Standard FIMI ``.dat`` parse / write / streamed ingest with
             dense-id remapping and inverse label map.
``checksum`` CRC32C (Castagnoli) in vectorized numpy — per-block payload
             integrity, verified on every read.
``fsck``     Scan / repair / quarantine: classifies every damage class of
             the failure model, adopts a crashed writer's residue.
``retry``    Bounded exponential-backoff :class:`RetryPolicy` for disk
             reads and host→device copies (injectable clock/sleep).
"""
from repro_torch.store.checksum import crc32c  # noqa: F401
from repro_torch.store.fimi_io import (  # noqa: F401
    export_dat,
    ingest_dat,
    parse_dat,
    write_dat,
)
from repro_torch.store.fsck import Damage, FsckReport, fsck  # noqa: F401
from repro_torch.store.retry import (  # noqa: F401
    NO_RETRY,
    RetriesExhausted,
    RetryPolicy,
)
from repro_torch.store.store import (  # noqa: F401
    ChecksumMismatchError,
    Manifest,
    MissingBlockError,
    StaleManifestError,
    StoreIntegrityError,
    StoreWriter,
    TruncatedBlockError,
    TxStore,
    pack_bool_np,
    unpack_bool_np,
    write_ibm_store,
)

# The read side imports torch; the write path above is numpy-only and must
# stay importable on hosts that never touch a device (PEP 562 lazy load).
_READER_EXPORTS = (
    "BlockReadError",
    "BlockReader",
    "HostBudgetExceeded",
    "gather_rows",
    "sample_rows",
    "streamed_itemset_supports",
    "to_device_rows",
    "to_device_shards",
)


def __getattr__(name):
    if name in _READER_EXPORTS:
        from repro_torch.store import reader

        return getattr(reader, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_READER_EXPORTS))
