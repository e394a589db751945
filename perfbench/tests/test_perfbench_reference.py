"""The plain references against independent hand computations: the numpy
murmur against a scalar MurmurHash3_x64_128 written here from the
published algorithm, and the greedy gather against a hand-worked case."""

import numpy as np
import pytest

from perfbench.reference import gather as rg
from perfbench.reference import sketch as rs

M64 = (1 << 64) - 1


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & M64


def _fmix(k):
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & M64
    k ^= k >> 33
    return k


def murmur3_x64_128_h1(data: bytes, seed: int = 42) -> int:
    "MurmurHash3_x64_128 (Austin Appleby's published algorithm), first 64 bits."
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed
    n = len(data)
    nblocks = n // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[16 * i : 16 * i + 8], "little")
        k2 = int.from_bytes(data[16 * i + 8 : 16 * i + 16], "little")
        k1 = (k1 * c1) & M64
        k1 = _rotl(k1, 31)
        k1 = (k1 * c2) & M64
        h1 ^= k1
        h1 = _rotl(h1, 27)
        h1 = (h1 + h2) & M64
        h1 = (h1 * 5 + 0x52DCE729) & M64
        k2 = (k2 * c2) & M64
        k2 = _rotl(k2, 33)
        k2 = (k2 * c1) & M64
        h2 ^= k2
        h2 = _rotl(h2, 31)
        h2 = (h2 + h1) & M64
        h2 = (h2 * 5 + 0x38495AB5) & M64
    tail = data[16 * nblocks :]
    k1 = k2 = 0
    for i in range(len(tail) - 1, 7, -1):
        k2 ^= tail[i] << (8 * (i - 8))
    if len(tail) > 8:
        k2 = (k2 * c2) & M64
        k2 = _rotl(k2, 33)
        k2 = (k2 * c1) & M64
        h2 ^= k2
    for i in range(min(len(tail), 8) - 1, -1, -1):
        k1 ^= tail[i] << (8 * i)
    if len(tail) > 0:
        k1 = (k1 * c1) & M64
        k1 = _rotl(k1, 31)
        k1 = (k1 * c2) & M64
        h1 ^= k1
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & M64
    h2 = (h2 + h1) & M64
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    return (h1 + h2) & M64


def _canonical(kmer: bytes) -> bytes:
    rc = kmer[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    return min(kmer, rc)


def test_scalar_murmur_known_value():
    # sourmash's own test value of hash_murmur("ACG") at seed 42
    assert murmur3_x64_128_h1(b"ACG") == 1731421407650554201


@pytest.mark.parametrize("length", [1, 3, 7, 8, 9, 15, 16, 17, 21, 31, 33, 51, 63])
def test_numpy_murmur_equals_scalar_on_random_bytes(length):
    rng = np.random.default_rng(length)
    data = [rng.integers(0, 256, size=length, dtype=np.uint8).tobytes() for _ in range(40)]
    nwords = (length + 7) // 8
    words = []
    for j in range(nwords + (nwords % 2)):
        col = [int.from_bytes(d[8 * j : 8 * j + 8].ljust(8, b"\0"), "little") for d in data]
        words.append(np.array(col, dtype=np.uint64))
    got = rs.murmur64(words, length)
    assert [int(x) for x in got] == [murmur3_x64_128_h1(d) for d in data]


@pytest.mark.parametrize("k", [21, 31, 51])
def test_record_hashes_equal_scalar_canonical_kmers(k):
    rng = np.random.default_rng(k)
    seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=600,
                     p=[0.22, 0.22, 0.22, 0.22, 0.025, 0.025, 0.025, 0.025, 0.02]).tobytes()
    up = seq.upper()
    want = [murmur3_x64_128_h1(_canonical(up[i : i + k])) for i in range(len(up) - k + 1)
            if set(up[i : i + k]) <= set(b"ACGT")]
    got = rs.record_hashes(seq, k, rs.MASK64)
    assert sorted(int(x) for x in got) == sorted(want)
    fw = [murmur3_x64_128_h1(up[i : i + k]) for i in range(len(up) - k + 1)
          if set(up[i : i + k]) <= set(b"ACGT")]
    assert sorted(int(x) for x in rs.record_hashes(seq, k, rs.MASK64, canonical=False)) == sorted(fw)


def test_palindrome_and_scaled_cut():
    k = 20
    kmer = b"ACGTACGTAATTACGTACGT"  # its own reverse complement
    assert _canonical(kmer) == kmer
    got = rs.record_hashes(kmer, k, rs.MASK64)
    assert [int(x) for x in got] == [murmur3_x64_128_h1(kmer)]
    cut = rs.max_hash_for_scaled(1000)
    assert cut == int(round(M64 / 1000, 0))
    seq = np.random.default_rng(0).choice(np.frombuffer(b"ACGT", np.uint8), 20000).tobytes()
    kept = rs.record_hashes(seq, 31, cut)
    assert np.all(kept <= np.uint64(cut)) and 0 < len(kept) < 60


def test_sketch_counts_repeats():
    mins, ab = rs.sketch([b"ACGT" * 40, b"ACGT" * 10], 21, 1)
    # ACGT repeats: period-4 windows give two canonical 21-mers, 120 + 20 windows in all
    assert int(ab.sum()) == (160 - 20) + (40 - 20)
    assert len(mins) <= 4


def test_greedy_gather_hand_worked():
    # members: 0 = {1..6}, 1 = {4..9}, 2 = {1..3, 10}, 3 = {20}; query {1..10} with
    # abundances 1..10; threshold 2 hashes at scaled 1.
    members = [[1, 2, 3, 4, 5, 6], [4, 5, 6, 7, 8, 9], [1, 2, 3, 10], [20]]
    offsets = np.cumsum([0] + [len(m) for m in members])
    flat = np.array([h for m in members for h in m], dtype=np.uint64)
    q = np.arange(1, 11, dtype=np.uint64)
    ab = np.arange(1, 11)
    holders = rg.Holders(flat, offsets, q)
    rows = rg.gather(q, ab, flat, offsets, holders, threshold_bp=2, scaled=1)
    # round 1: member 0 and 1 both hold 6; the lowest index wins. It removes 1..6
    # (abundance 21 of 55); 4 left. Round 2: member 1 holds 7, 8, 9 of what remains
    # (abundance 24); 1 left. Member 2 holds only 10 of what remains: below 2.
    assert rows == [(0, 6, 6, 21 / 55, 4), (1, 6, 3, 24 / 55, 1)]
    control = rg.gather(q, ab, flat, offsets, holders, threshold_bp=2, scaled=1, greedy=False)
    # the control never recounts: member 2 (4 of the query) follows with 1 unique hash
    assert control == [(0, 6, 6, 21 / 55, 4), (1, 6, 3, 24 / 55, 1), (2, 4, 1, 10 / 55, 0)]


def test_gather_below_threshold_and_flat():
    members = [[1, 2], [3]]
    offsets = np.cumsum([0, 2, 1])
    flat = np.array([1, 2, 3], dtype=np.uint64)
    q = np.array([1, 2, 3, 4], dtype=np.uint64)
    holders = rg.Holders(flat, offsets, q)
    assert rg.gather(q, None, flat, offsets, holders, threshold_bp=2000, scaled=1000) == [
        (0, 2000, 2000, 0.5, 2000)]
    assert rg.gather(q, None, flat, offsets, holders, threshold_bp=3000, scaled=1000) == []
