"""Plain numpy reference of `sourmash sketch dna -p k=..,scaled=..,abund`.

Independent of the program: MurmurHash3_x64_128 (its first 64 bits) of
each canonical k-mer, written from the published algorithm on numpy uint64
arrays. A k-mer's canonical form is the lesser, as bytes, of the k-mer and
its reverse complement, after the sequence is upper-cased; windows holding
any byte other than A, C, G or T are skipped (sourmash's `force=True`, which
`sketch dna` passes). A hash is kept when it is at most the scaled sketch's
max_hash, and its abundance is the number of windows of the file that give
it. Imports numpy alone.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
SEED = 42
_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_F1 = np.uint64(0xFF51AFD7ED558CCD)
_F2 = np.uint64(0xC4CEB9FE1A85EC53)
_N1 = np.uint64(0x52DCE729)
_N2 = np.uint64(0x38495AB5)
_FIVE = np.uint64(5)
_WINDOWS = 1 << 18  # windows hashed at a time

UPPER = np.arange(256, dtype=np.uint8)
UPPER[ord("a") : ord("z") + 1] -= 32
ACGT = np.zeros(256, dtype=bool)
ACGT[list(b"ACGT")] = True
COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    COMPLEMENT[_a] = _b


def max_hash_for_scaled(scaled: int) -> int:
    "sourmash's cutoff: round((2^64 - 1) / scaled), as Python floats round it."
    if scaled <= 1:
        return MASK64
    return min(int(round(MASK64 / scaled, 0)), MASK64)


def _rotl(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _fmix(h):
    h ^= h >> np.uint64(33)
    h *= _F1
    h ^= h >> np.uint64(33)
    h *= _F2
    h ^= h >> np.uint64(33)
    return h


def murmur64(words: list, length: int, seed: int = SEED):
    """The first 64 bits of MurmurHash3_x64_128 of `length` bytes per
    element, given as little-endian uint64 words (zero past the end)."""
    n = len(words[0]) if words else 0
    h1 = np.full(n, seed, dtype=np.uint64)
    h2 = np.full(n, seed, dtype=np.uint64)
    blocks, tail = divmod(length, 16)
    with np.errstate(over="ignore"):
        for b in range(blocks):
            k1 = words[2 * b] * _C1
            k1 = _rotl(k1, 31)
            k1 *= _C2
            h1 ^= k1
            h1 = _rotl(h1, 27)
            h1 += h2
            h1 = h1 * _FIVE + _N1
            k2 = words[2 * b + 1] * _C2
            k2 = _rotl(k2, 33)
            k2 *= _C1
            h2 ^= k2
            h2 = _rotl(h2, 31)
            h2 += h1
            h2 = h2 * _FIVE + _N2
        if tail > 8:
            k2 = words[2 * blocks + 1] * _C2
            k2 = _rotl(k2, 33)
            k2 *= _C1
            h2 ^= k2
        if tail > 0:
            k1 = words[2 * blocks] * _C1
            k1 = _rotl(k1, 31)
            k1 *= _C2
            h1 ^= k1
        h1 ^= np.uint64(length)
        h2 ^= np.uint64(length)
        h1 += h2
        h2 += h1
        h1 = _fmix(h1)
        h2 = _fmix(h2)
        h1 += h2
    return h1


def _word_view(buf: np.ndarray, order: str) -> np.ndarray:
    "The 8 bytes at every offset of buf (padded by 8) as uint64 words."
    return np.ndarray((len(buf) - 7,), dtype=order + "u8", buffer=buf, offset=0, strides=(1,))


def _masks(k: int) -> tuple:
    "(LE, BE) masks of the last word of a k-mer, which holds k - 8 * (words - 1) bytes."
    t = k - 8 * ((k - 1) // 8)
    if t == 8:
        return np.uint64(MASK64), np.uint64(MASK64)
    return np.uint64((1 << (8 * t)) - 1), np.uint64(MASK64 ^ ((1 << (8 * (8 - t))) - 1))


def record_hashes(seq: bytes | np.ndarray, k: int, max_hash: int, seed: int = SEED,
                  canonical: bool = True) -> np.ndarray:
    """Kept hashes of every valid window of one record, one per window (so
    repeats count). canonical=False hashes the forward strand alone."""
    s = UPPER[np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray))
              else seq]
    n = len(s)
    nw = n - k + 1
    if nw <= 0:
        return np.zeros(0, dtype=np.uint64)
    bad = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(~ACGT[s], out=bad[1:])
    ok = (bad[k:] - bad[:-k]) == 0
    fw = np.zeros(n + 8, dtype=np.uint8)
    fw[:n] = s
    rc = np.zeros(n + 8, dtype=np.uint8)
    rc[:n] = COMPLEMENT[s[::-1]]
    fw_le, fw_be = _word_view(fw, "<"), _word_view(fw, ">")
    rc_le, rc_be = _word_view(rc, "<"), _word_view(rc, ">")
    nwords = (k + 7) // 8
    le_mask, be_mask = _masks(k)
    cut = np.uint64(max_hash)
    out = []
    for lo in range(0, nw, _WINDOWS):
        hi = min(nw, lo + _WINDOWS)
        keep = ok[lo:hi]
        if not keep.any():
            continue
        # window i's reverse complement starts at n - k - i in rc: a
        # descending run of offsets
        fwords = [fw_le[lo + 8 * j : hi + 8 * j] for j in range(nwords)]
        fwords[-1] = fwords[-1] & le_mask
        if canonical:
            r0 = n - k - lo
            rwords = [rc_le[r0 + 8 * j - (hi - lo) + 1 : r0 + 8 * j + 1][::-1]
                      for j in range(nwords)]
            rwords[-1] = rwords[-1] & le_mask
            use_rc = np.zeros(hi - lo, dtype=bool)
            decided = np.zeros(hi - lo, dtype=bool)
            for j in range(nwords):
                a = fw_be[lo + 8 * j : hi + 8 * j]
                b = rc_be[r0 + 8 * j - (hi - lo) + 1 : r0 + 8 * j + 1][::-1]
                if j == nwords - 1:
                    a = a & be_mask
                    b = b & be_mask
                use_rc |= ~decided & (b < a)
                decided |= a != b
            fwords = [np.where(use_rc, r, f) for r, f in zip(rwords, fwords)]
        else:
            fwords = [np.ascontiguousarray(f) for f in fwords]
        if nwords % 2:
            fwords.append(np.zeros(hi - lo, dtype=np.uint64))
        h = murmur64(fwords, k, seed)
        out.append(h[keep & (h <= cut)])
    return np.concatenate(out) if out else np.zeros(0, dtype=np.uint64)


def sketch(records, k: int, scaled: int, seed: int = SEED, canonical: bool = True) -> tuple:
    """(mins, abundances) of a scaled sketch with abundances over records
    (an iterable of byte strings or uint8 arrays), mins ascending."""
    cut = max_hash_for_scaled(scaled)
    parts = [record_hashes(r, k, cut, seed, canonical) for r in records]
    allh = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint64)
    mins, counts = np.unique(allh, return_counts=True)
    return mins, counts.astype(np.uint64)


def kept_hashes(records: list, k: int, scaled: int, canonical: bool) -> np.ndarray:
    "Kept hashes of every valid window of the records (a worker's share)."
    cut = max_hash_for_scaled(scaled)
    parts = [record_hashes(r, k, cut, canonical=canonical) for r in records]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint64)


def reference_sketches(jobs: dict, ks, scaled: int, workers: int, canonical: bool = True) -> dict:
    """{(key, k): (mins, abundances)} of the numpy reference over each job's
    records (jobs: key -> list of records), in `workers` processes."""
    tasks = []
    for key, records in jobs.items():
        # a job's records in shares of about 8 Mbp each, so that one long input spreads
        share, size = [], 0
        for r in records:
            share.append(r)
            size += len(r)
            if size >= 8_000_000:
                tasks.append((key, share))
                share, size = [], 0
        if share:
            tasks.append((key, share))
    work = [(key, k, share) for key, share in tasks for k in ks]
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = [ex.submit(kept_hashes, share, k, scaled, canonical) for _, k, share in work]
            got = [f.result() for f in futs]
    else:
        got = [kept_hashes(share, k, scaled, canonical) for _, k, share in work]
    merged = {}
    for (key, k, _), h in zip(work, got):
        merged.setdefault((key, k), []).append(h)
    out = {}
    for key_k, parts in merged.items():
        mins, counts = np.unique(np.concatenate(parts), return_counts=True)
        out[key_k] = (mins, counts.astype(np.uint64))
    return out
