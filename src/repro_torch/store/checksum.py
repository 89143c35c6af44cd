"""CRC32C (Castagnoli) in vectorized numpy — the store's integrity hash.

The port's own copy of the JAX package's ``store/checksum.py``: the store
seals every block payload with it and the cluster checkpoint guards its
payload with it, so a store or a checkpoint written by either package
verifies in the other.

Every block payload in a ``txstore-v2`` manifest carries a CRC32C; the
reader verifies it on every disk read, so a single flipped bit anywhere in
a block is detected before it can corrupt a support count (DESIGN.md,
"Failure model").  The container has no C crc32c extension and a per-byte
Python loop would cost far more than the <5% checksum budget the IO
benchmark gates, so this module computes the CRC with O(COL_W + 32·log n)
**vectorized** numpy passes instead of O(n) interpreted ones:

  1. *Column scan*: view the message as ``[k, COL_W]`` chunks and run the
     byte-at-a-time table recurrence down the columns — one numpy op per
     byte *position*, parallel across all ``k`` chunks.
  2. *Combine tree*: CRC is linear over GF(2), so
     ``crc(A‖B) = shift_{8·|B|}(crc(A)) ^ crc(B)`` where ``shift_m`` (the
     operator that appends ``m`` zero bytes) is a fixed 32×32 bit matrix.
     Adjacent chunk CRCs are folded pairwise, squaring the shift matrix per
     level — log₂(k) vectorized folds.

The message is cut into pieces of a power of two of chunks (the binary
digits of its chunk count) plus a tail of under ``COL_W`` bytes, and the
pieces' CRCs are joined by the same rule.  Each piece is a view of the
message, so checking a block costs no copy of it: the store's reader
checks a block in the pinned buffer it was read into, inside its host
budget.

Init/xorout handling uses the same linearity: seeding the register with
``0xFFFFFFFF`` equals XORing ``shift_{8n}(0xFFFFFFFF)`` into the raw
(zero-seeded) CRC.  Zero-seeded CRCs ignore leading zero bytes
(``TABLE[0] == 0``), which is what makes the front-padding of the tail safe.

Verified against the RFC 3720 check value (``crc32c(b"123456789") ==
0xE3069283``) and the per-byte reference ``crc32c_ref``.
"""
from __future__ import annotations

import functools
from typing import Union

import numpy as np

_POLY = np.uint32(0x82F63B78)   # Castagnoli, reflected
_INIT = 0xFFFFFFFF
_COL_W = 64                     # bytes per chunk in the column scan


def _make_table() -> np.ndarray:
    """Byte-at-a-time table: TABLE[b] = zero-seeded CRC of the byte b."""
    idx = np.arange(256, dtype=np.uint32)
    c = idx
    for _ in range(8):
        c = (c >> np.uint32(1)) ^ np.where(c & np.uint32(1), _POLY, np.uint32(0))
    return c


_TABLE = _make_table()


def _apply_op(mat: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Apply a 32×32 GF(2) operator to uint32 values, vectorized over them.

    ``mat[i]`` is the operator's image of basis vector ``1 << i``; the image
    of ``v`` is the XOR of rows selected by v's set bits.
    """
    out = np.zeros_like(values)
    for i in range(32):
        bit = (values >> np.uint32(i)) & np.uint32(1)
        out ^= bit * mat[i]
    return out


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Operator composition a∘b (apply b, then a), as basis images."""
    return _apply_op(a, b)


@functools.lru_cache(maxsize=64)
def _zero_op(n_bytes: int) -> np.ndarray:
    """32×32 GF(2) matrix of "extend the CRC register by n zero bytes"."""
    assert n_bytes >= 1
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    one = (basis >> np.uint32(8)) ^ _TABLE[basis & np.uint32(0xFF)]
    if n_bytes == 1:
        return one
    half = _zero_op(n_bytes // 2)
    op = _compose(half, half)
    if n_bytes % 2:
        op = _compose(one, op)
    return op


def _crc_chunks(cols: np.ndarray) -> int:
    """Zero-seeded CRC of ``cols`` (uint8 ``[k, COL_W]``, k a power of two)."""
    state = np.zeros(cols.shape[0], np.uint32)
    for j in range(_COL_W):                    # parallel across all k chunks
        state = (state >> np.uint32(8)) ^ _TABLE[
            (state ^ cols[:, j]) & np.uint32(0xFF)
        ]
    level = 0
    while state.size > 1:                      # crc(A‖B) = op(crc A) ^ crc B
        op = _zero_op(_COL_W << level)
        state = _apply_op(op, state[0::2]) ^ state[1::2]
        level += 1
    return int(state[0])


def _extend(crc: int, n_bytes: int) -> int:
    """The zero-seeded CRC of a message ``crc`` stands for, followed by
    ``n_bytes`` zero bytes."""
    if crc == 0:
        return 0
    return int(_apply_op(_zero_op(n_bytes), np.array([crc], np.uint32))[0])


def _crc_raw(data: np.ndarray) -> int:
    """Zero-seeded, zero-xorout CRC32C of a contiguous uint8 array
    (vectorized, on views of it)."""
    n = int(data.size)
    q, r = divmod(n, _COL_W)
    crc, pos = 0, 0
    for b in reversed(range(q.bit_length())):  # pieces of 2^b chunks, largest first
        if q >> b & 1:
            size = _COL_W << b
            piece = data[pos:pos + size].reshape(1 << b, _COL_W)
            crc = _extend(crc, size) ^ _crc_chunks(piece)
            pos += size
    if r:
        tail = np.zeros(_COL_W, np.uint8)
        tail[_COL_W - r:] = data[pos:]         # front zero-pad: crc-neutral
        crc = _extend(crc, r) ^ _crc_chunks(tail.reshape(1, _COL_W))
    return crc


def crc32c(data: Union[bytes, bytearray, memoryview, np.ndarray]) -> int:
    """CRC32C (Castagnoli; init and xorout ``0xFFFFFFFF``) of ``data``."""
    arr = np.frombuffer(memoryview(data), np.uint8) if not isinstance(
        data, np.ndarray
    ) else np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    n = int(arr.size)
    if n == 0:
        return 0
    seed = _apply_op(_zero_op(n), np.array([_INIT], np.uint32))[0]
    return int(_crc_raw(arr) ^ seed ^ np.uint32(_INIT))


def crc32c_ref(data) -> int:
    """Per-byte reference implementation (tests only — O(n) Python)."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    c = _INIT
    for b in data:
        c = (c >> 8) ^ int(_TABLE[(c ^ int(b)) & 0xFF])
    return c ^ _INIT
