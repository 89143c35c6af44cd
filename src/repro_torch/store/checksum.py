"""CRC32C (Castagnoli) in vectorized numpy — the store's integrity hash.

The port's own copy of the JAX package's ``store/checksum.py``: the cluster
checkpoint guards its payload with it, so a checkpoint written by either
package verifies in the other.  The rest of the store is not ported yet.

Every block payload in a ``txstore-v2`` manifest carries a CRC32C; the
reader verifies it on every disk read, so a single flipped bit anywhere in
a block is detected before it can corrupt a support count (DESIGN.md,
"Failure model").  The container has no C crc32c extension and a per-byte
Python loop would cost far more than the <5% checksum budget the IO
benchmark gates, so this module computes the CRC with O(COL_W + 32·log n)
**vectorized** numpy passes instead of O(n) interpreted ones:

  1. *Column scan*: reshape the message into ``[k, COL_W]`` chunks and run
     the byte-at-a-time table recurrence down the columns — one numpy op
     per byte *position*, parallel across all ``k`` chunks.
  2. *Combine tree*: CRC is linear over GF(2), so
     ``crc(A‖B) = shift_{8·|B|}(crc(A)) ^ crc(B)`` where ``shift_m`` (the
     operator that appends ``m`` zero bytes) is a fixed 32×32 bit matrix.
     Adjacent chunk CRCs are folded pairwise, squaring the shift matrix per
     level — log₂(k) vectorized folds.

Init/xorout handling uses the same linearity: seeding the register with
``0xFFFFFFFF`` equals XORing ``shift_{8n}(0xFFFFFFFF)`` into the raw
(zero-seeded) CRC.  Zero-seeded CRCs ignore leading zero bytes
(``TABLE[0] == 0``), which is what makes the front-padding in step 1 safe.

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


def _crc_raw(data: np.ndarray) -> int:
    """Zero-seeded, zero-xorout CRC32C of a uint8 array (vectorized)."""
    n = int(data.size)
    if n == 0:
        return 0
    k = -(-n // _COL_W)
    k = 1 << max(k - 1, 0).bit_length()       # power of two for the fold tree
    buf = np.zeros(k * _COL_W, np.uint8)
    buf[-n:] = data                            # front zero-pad: crc-neutral
    cols = buf.reshape(k, _COL_W)
    state = np.zeros(k, np.uint32)
    for j in range(_COL_W):                    # parallel across all k chunks
        state = (state >> np.uint32(8)) ^ _TABLE[
            (state ^ cols[:, j]) & np.uint32(0xFF)
        ]
    op = _zero_op(_COL_W)
    while state.size > 1:                      # crc(A‖B) = op(crc A) ^ crc B
        state = _apply_op(op, state[0::2]) ^ state[1::2]
        op = _compose(op, op)
    return int(state[0])


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
