"""Vectorized MurmurHash3 x64_128 (first 64 bits) for k-mer hashing.

Instead of hashing one k-mer string at a time (reference: sourmash's
`src/core/src/lib.rs:57-59` `_hash_murmur`), we hash a whole batch of
fixed-length byte rows `[n, L]` in one vectorized numpy uint64 pass. This is
the port's host oracle, a copy of `sourmash_tpu/ops/murmur.py`; the CUDA
kernels (`csrc/sketch.cu`) run the same algorithm in native uint64_t.

The algorithm is MurmurHash3 x64_128 (public domain, Austin Appleby), of which
sourmash keeps only the first 64-bit word (`h1`), seed default 42.
"""

from __future__ import annotations

import numpy as np

# 64-bit constants (kept as np.uint64 so numpy never promotes to float64)
C1 = np.uint64(0x87C37B91114253D5)
C2 = np.uint64(0x4CF5AD432745937F)
F1 = np.uint64(0xFF51AFD7ED558CCD)
F2 = np.uint64(0xC4CEB9FE1A85EC53)
M5 = np.uint64(5)
N1 = np.uint64(0x52DCE729)
N2 = np.uint64(0x38495AB5)
U64_1 = np.uint64(1)
U64_0 = np.uint64(0)

_SHIFTS = {r: np.uint64(r) for r in (27, 29, 31, 33, 37)}


def _u64(xp, v):
    return xp.uint64(v) if xp is np else v


def _rotl(xp, x, r: int):
    r_ = np.uint64(r)
    rr = np.uint64(64 - r)
    return (x << r_) | (x >> rr)


def _fmix64(xp, k):
    s33 = np.uint64(33)
    k = k ^ (k >> s33)
    k = k * F1
    k = k ^ (k >> s33)
    k = k * F2
    k = k ^ (k >> s33)
    return k


def murmur3_x64_128_first64(data, length: int, seed: int = 42, xp=np):
    """Hash rows of `data` ([n, L] uint8, L == length static) -> [n] uint64.

    Matches murmurhash3_x64_128(bytes, seed).0 as used by sourmash
    (reference behavior: `src/core/src/lib.rs:57`).
    `xp` is the array namespace (numpy).
    """
    n = data.shape[0]
    L = length
    assert data.shape[1] == L

    seed_u = np.uint64(seed)
    h1 = xp.full((n,), seed_u, dtype=xp.uint64)
    h2 = xp.full((n,), seed_u, dtype=xp.uint64)

    b = data.astype(xp.uint64)

    def le64(cols):
        # cols: list of 8 column indices -> little-endian u64
        acc = b[:, cols[0]]
        for i in range(1, 8):
            acc = acc | (b[:, cols[i]] << np.uint64(8 * i))
        return acc

    nblocks = L // 16
    for blk in range(nblocks):
        base = blk * 16
        k1 = le64([base + i for i in range(8)])
        k2 = le64([base + 8 + i for i in range(8)])

        k1 = k1 * C1
        k1 = _rotl(xp, k1, 31)
        k1 = k1 * C2
        h1 = h1 ^ k1

        h1 = _rotl(xp, h1, 27)
        h1 = h1 + h2
        h1 = h1 * M5 + N1

        k2 = k2 * C2
        k2 = _rotl(xp, k2, 33)
        k2 = k2 * C1
        h2 = h2 ^ k2

        h2 = _rotl(xp, h2, 31)
        h2 = h2 + h1
        h2 = h2 * M5 + N2

    # tail
    t = L & 15
    base = nblocks * 16
    if t > 8:
        k2 = xp.zeros((n,), dtype=xp.uint64)
        for i in range(t - 1, 7, -1):
            k2 = k2 ^ (b[:, base + i] << np.uint64(8 * (i - 8)))
        k2 = k2 * C2
        k2 = _rotl(xp, k2, 33)
        k2 = k2 * C1
        h2 = h2 ^ k2
    if t > 0:
        k1 = xp.zeros((n,), dtype=xp.uint64)
        for i in range(min(t, 8) - 1, -1, -1):
            k1 = k1 ^ (b[:, base + i] << np.uint64(8 * i))
        k1 = k1 * C1
        k1 = _rotl(xp, k1, 31)
        k1 = k1 * C2
        h1 = h1 ^ k1

    ln = np.uint64(L)
    h1 = h1 ^ ln
    h2 = h2 ^ ln
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(xp, h1)
    h2 = _fmix64(xp, h2)
    h1 = h1 + h2
    return h1


def hash_murmur_scalar(data: bytes, seed: int = 42) -> int:
    """Host scalar helper: murmur64 of a byte string (Python `hash_murmur`
    parity, reference `src/sourmash/minhash.py:88`)."""
    return murmur64_scalar(data, seed)


def _hash_murmur_scalar_numpy(data: bytes, seed: int = 42) -> int:
    arr = np.frombuffer(data, dtype=np.uint8).reshape(1, -1)
    if len(data) == 0:
        arr = np.zeros((1, 0), dtype=np.uint8)
    with np.errstate(over="ignore"):
        return int(murmur3_x64_128_first64(arr, len(data), seed, xp=np)[0])


_M64 = 0xFFFFFFFFFFFFFFFF
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix64_py(k):
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M64
    k ^= k >> 33
    return k


def murmur64_scalar(data: bytes, seed: int = 42) -> int:
    """Pure-Python MurmurHash3 x64_128 first word — fast path for single
    k-mer hashing where numpy per-call overhead dominates."""
    length = len(data)
    h1 = h2 = seed
    nblocks = length // 16
    for b in range(nblocks):
        k1 = int.from_bytes(data[b * 16 : b * 16 + 8], "little")
        k2 = int.from_bytes(data[b * 16 + 8 : b * 16 + 16], "little")

        k1 = (k1 * _C1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64

        k2 = (k2 * _C2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64

    tail = data[nblocks * 16 :]
    t = len(tail)
    if t > 8:
        k2 = int.from_bytes(tail[8:], "little")
        k2 = (k2 * _C2) & _M64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
    if t > 0:
        k1 = int.from_bytes(tail[:8], "little")
        k1 = (k1 * _C1) & _M64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _fmix64_py(h1)
    h2 = _fmix64_py(h2)
    h1 = (h1 + h2) & _M64
    return h1
