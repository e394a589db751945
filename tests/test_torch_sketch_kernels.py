"""The plain PyTorch versions of the port's two sketch kernels against the
JAX package's Pallas kernels in interpret mode, bit for bit:

- K2 `cuda_sketch.window_hashes` vs `window_hash_pairs_pallas`;
- K1 `cuda_sketch.survivor_slots` vs `sketch_survivor_slots_pallas`.

On the CPU the port's wrappers run their plain versions (the CUDA kernels
themselves are held against these plain versions on the card by
`chip_smoke.py`). Rows are seeded numpy bytes with N and other non-ACGT
runs, effective lengths at and around 128-window segment boundaries (zero
padding past the end, as seq_chunks_to_hashes pads chunks) and a tandem repeat
whose surviving k-mer overflows the slots. The JAX kernels pad to their
own block size; past the port's segments their outputs must be empty.

A numpy emulation of K2's CUDA design (the staged tile, its ballot planes,
the plane strand with the byte compare for windows holding a byte that is
not ACGT, murmur words by funnel shifts) is held to the Pallas kernel on
edge rows: random bytes, palindromes, N runs at tile and segment
boundaries, zero tails.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sourmash_tpu.ops.encodings import dna_hashes
from sourmash_tpu.ops.pallas_sketch import (
    sketch_survivor_slots_pallas,
    window_hash_pairs_pallas,
)
from sourmash_tpu_torch.ops import cuda_sketch, u64

SEG = 128
MAX_U64 = 2**64 - 1
# (ksize, batch rows, slots): every k, both batch sizes, both slot counts
CASES = [(7, 1, 4), (21, 3, 8), (31, 3, 4), (33, 1, 8), (51, 3, 4), (63, 1, 8)]


def _tandem_unit(k, max_hash, rng):
    "A repeat unit of period <= 14 with a k-mer that survives max_hash."
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    while True:
        p = int(rng.integers(6, 15))
        unit = rng.choice(acgt, size=p)
        h, valid = dna_hashes(np.tile(unit, (k + 2 * p) // p + 1), k, 42)
        if (valid & (h <= np.uint64(max_hash))).any():
            return unit


def _rows(k, B, rng, unit):
    """[B, S] uppercased rows whose real content ends at and around
    segment boundaries; row 0 carries a 300-byte tandem repeat."""
    lengths = [SEG + k - 1, SEG + k, 2 * SEG + k - 2][:B] if B > 1 else [3 * SEG + k + 4]
    S = max(lengths) + 17
    rows = np.zeros((B, S), dtype=np.uint8)
    alphabet = np.frombuffer(b"ACGTNR", dtype=np.uint8)
    for b, n in enumerate(lengths):
        rows[b, :n] = rng.choice(alphabet, size=n, p=[0.24, 0.24, 0.24, 0.24, 0.02, 0.02])
    rep = np.tile(unit, 300 // len(unit) + 1)[: min(300, lengths[0] - 4)]
    rows[0, 2 : 2 + rep.size] = rep
    return rows


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(2024)


@pytest.mark.parametrize("k,B,slots", CASES)
def test_kernels_match_pallas_interpret(k, B, slots, rng):
    mh1000 = (2**64 - 1) // 1000
    rows = _rows(k, B, rng, _tandem_unit(k, mh1000, rng))
    n, R, n_pad = cuda_sketch.geometry(rows.shape[1], k)
    t = torch.from_numpy(rows)

    # K2: every window, valid or not, hashes the same bits
    h, valid = cuda_sketch.window_hashes(t, ksize=k)
    assert h.shape == valid.shape == (B, n_pad)
    jhi, jlo, jvalid = (np.asarray(a) for a in window_hash_pairs_pallas(
        jnp.asarray(rows), ksize=k, interpret=True))
    jh = (jhi.astype(np.uint64) << np.uint64(32)) | jlo.astype(np.uint64)
    assert np.array_equal(u64.to_numpy(h), jh[:, :n_pad])
    assert np.array_equal(valid.numpy(), jvalid[:, :n_pad].astype(np.uint8))
    assert not jvalid[:, n_pad:].any()
    assert valid.numpy()[:, :n].any() and not valid.numpy()[:, n:].any()

    # K1: per-segment slots and TRUE counts, incl. forced overflow
    for mh in (mh1000, MAX_U64):
        shi, slo, cnt = cuda_sketch.survivor_slots(t, mh, ksize=k, slots=slots)
        assert shi.shape == slo.shape == (B, R, slots) and cnt.shape == (B, R)
        assert shi.dtype == slo.dtype == cnt.dtype == torch.int32
        jshi, jslo, jcnt = (np.asarray(a) for a in sketch_survivor_slots_pallas(
            jnp.asarray(rows), jnp.asarray(np.uint64(mh)), ksize=k, slots=slots,
            interpret=True))
        assert np.array_equal(shi.numpy().view(np.uint32), jshi[:, :R])
        assert np.array_equal(slo.numpy().view(np.uint32), jslo[:, :R])
        assert np.array_equal(cnt.numpy(), jcnt[:, :R])
        assert not jcnt[:, R:].any()
        assert int(cnt.max()) > slots, "the tandem repeat must overflow a segment"


def test_survivor_slots_are_the_threshold_of_window_hashes(rng):
    """K1 = K2 + threshold + per-segment compaction, on a longer input with
    many segments (plain versions only)."""
    k, slots = 31, 8
    rows = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=(2, 20_000),
                      p=[0.245, 0.245, 0.245, 0.245, 0.02])
    t = torch.from_numpy(rows)
    mh = (2**64 - 1) // 200
    h, valid = cuda_sketch.window_hashes(t, ksize=k)
    shi, slo, cnt = cuda_sketch.survivor_slots(t, mh, ksize=k, slots=slots)
    hn, vn = u64.to_numpy(h), valid.numpy() != 0
    keep = vn & (hn <= np.uint64(mh))
    vals = u64.to_numpy(u64.join32(shi, slo))
    for b in range(2):
        seg_keep = keep[b].reshape(-1, SEG)
        assert np.array_equal(cnt[b].numpy(), seg_keep.sum(axis=1))
        for r in range(seg_keep.shape[0]):
            want = hn[b].reshape(-1, SEG)[r][seg_keep[r]][:slots]
            got = vals[b, r, : min(slots, int(cnt[b, r]))]
            assert np.array_equal(got, want)
            assert not vals[b, r, want.size :].any()


# -- K2's tile design, emulated ---------------------------------------------

TILE = 1024  # windows a block stages (csrc/sketch_common.cuh kDnaTile)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_BREV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint32)


def _brev32(x):
    x = x.astype(np.uint32)
    return ((_BREV8[x & 0xFF] << 24) | (_BREV8[(x >> 8) & 0xFF] << 16)
            | (_BREV8[(x >> 16) & 0xFF] << 8) | _BREV8[x >> 24]).astype(np.uint32)


def _funnel_r(lo, hi, sh):
    "__funnelshift_r: the low 32 bits of (hi:lo) >> sh (sh < 32)."
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (both >> np.asarray(sh, dtype=np.uint64)) & np.uint64(0xFFFFFFFF)


def _plane_bits(plane, q):
    return _funnel_r(plane[q >> 5], plane[(q >> 5) + 1], q & 31)


def _pack_plane(bits, words):
    "bool [32 * words] -> uint32 [words + 1]: bit i of word m is position 32m + i; a spare 0."
    w = np.packbits(bits.reshape(words, 32), axis=1, bitorder="little").view("<u4").ravel()
    return np.r_[w, np.uint32(0)].astype(np.uint32)


def _dna_tile(fwd):
    """stage_dna_tile over the L staged bytes `fwd`: the shared-memory image
    (the bytes, their reverse complement, 16 bytes of reach) as uint32
    words, and the five planes (not-ACGT, the forward and the rc code bits)."""
    L = fwd.size
    words = L // 32
    comp = fwd ^ np.where(fwd & 2, 4, 21).astype(np.uint32)
    w32 = np.r_[fwd, comp[::-1], np.zeros(16, np.uint32)].astype(np.uint8).view("<u4")
    code = ((fwd >> 1) & 3) ^ ((fwd >> 2) & 1)
    bad = _pack_plane(~np.isin(fwd, ACGT), words)
    f1 = _pack_plane((code & 2) != 0, words)
    f0 = _pack_plane((code & 1) != 0, words)
    r1 = np.r_[(~_brev32(f1[:words]))[::-1], np.uint32(0)]
    r0 = np.r_[(~_brev32(f0[:words]))[::-1], np.uint32(0)]
    return w32, (bad, f1, f0, r1, r0)


def _plane_strand(planes, L, s, k):
    """plane_strand at tile positions s: validity from the not-ACGT plane,
    the strand from the code planes, 32 bases a step (meaningless for an
    invalid window)."""
    bad, f1, f0, r1, r0 = planes
    ok = np.ones(s.size, dtype=bool)
    rev = np.zeros(s.size, dtype=bool)
    decided = np.zeros(s.size, dtype=bool)
    for c in range(0, k, 32):
        m = np.uint64((1 << min(32, k - c)) - 1)
        ok &= (_plane_bits(bad, s + c) & m) == 0
        a1, a0 = _plane_bits(f1, s + c) & m, _plane_bits(f0, s + c) & m
        q = L - s - k + c
        b1, b0 = _plane_bits(r1, q) & m, _plane_bits(r0, q) & m
        diff = (a1 ^ b1) | (a0 ^ b0)
        greater = (a1 & ~b1) | (~(a1 ^ b1) & a0 & ~b0)
        lowest = diff & ((np.uint64(2**32) - diff) & np.uint64(0xFFFFFFFF))
        rev = np.where(decided, rev, (greater & lowest) != 0)
        decided |= diff != 0
    return ok, rev


def _tile_window_hashes(rows, k, seed=42):
    """K2's algorithm in numpy, tile by tile: the staged bytes, their reverse
    complement and the five planes; validity from the not-ACGT plane; the
    strand from the code planes, or, for a window holding a byte that is
    not ACGT, from the reference's byte compare; the murmur words from
    funnel shifts of aligned 32-bit loads of the forward or the rc run.
    An index past the staged bytes' reach raises."""
    B, S = rows.shape
    _n, _R, n_pad = cuda_sketch.geometry(S, k)
    L = (TILE + k - 1 + 31) // 32 * 32
    hashes = np.zeros((B, n_pad), dtype=np.uint64)
    valid = np.zeros((B, n_pad), dtype=np.uint8)
    for b in range(B):
        for w0 in range(0, n_pad, TILE):
            p = w0 + np.arange(L)
            fwd = np.zeros(L, dtype=np.uint32)
            fwd[p < S] = rows[b, p[p < S]]
            comp = fwd ^ np.where(fwd & 2, 4, 21).astype(np.uint32)
            w32, planes = _dna_tile(fwd)
            s = np.arange(min(TILE, n_pad - w0))
            ok, rev = _plane_strand(planes, L, s, k)
            bytewise = np.flatnonzero(~ok)
            if bytewise.size:
                j = np.arange(k)
                f = fwd[s[bytewise, None] + j]
                r = comp[s[bytewise, None] + k - 1 - j]
                first = np.argmax(f != r, axis=1)
                at = np.arange(bytewise.size)
                rev[bytewise] = (f != r).any(axis=1) & (r[at, first] < f[at, first])

            off = np.where(rev, 2 * L - s - k, s)
            hashes[b, w0 + s] = _funnel_murmur(w32, off, k, seed)
            valid[b, w0 + s] = ok
    return hashes, valid


def _funnel_murmur(w32, off, k, seed=42):
    """tile_murmur at run offsets `off` of a staged tile's image (uint32
    words): each murmur word two funnel shifts of aligned 32-bit loads,
    masked past k. Returns the uint64 hashes."""
    sh = 8 * (off & 3)

    def word(i):
        p0 = (off >> 2) + 2 * i
        x = (_funnel_r(w32[p0 + 1], w32[p0 + 2], sh) << np.uint64(32)) | _funnel_r(
            w32[p0], w32[p0 + 1], sh)
        n_bytes = min(8, k - 8 * i)
        if n_bytes < 8:
            x &= np.uint64((1 << (8 * n_bytes)) - 1)
        return torch.from_numpy(x.view(np.int64))

    h = cuda_sketch.murmur_words(word, k, seed, torch.zeros(off.size, dtype=torch.int64))
    return u64.to_numpy(h)


def _edge_rows(kind, k, rng, S):
    """[4, S] rows of one kind of K2 edge input:
    - "edges": row 0 uniformly random bytes (all 256 values), row 1 ACGT
      with 2 % random bytes, row 2 ACGT with N runs of 1 to k + 2 bases
      across the 128- and 1,024-window boundaries, row 3 the same ending
      in a zero-padded tail;
    - "palindromes": rows 0-1 ACGT repeats from A and from C (at even k
      every other window is its own reverse complement), rows 2-3 random
      ACGT holding k-long reverse-complement palindromes, row 3 with a
      zero tail."""
    rows = rng.choice(ACGT, size=(4, S))
    if kind == "edges":
        rows[0] = rng.integers(0, 256, size=S, dtype=np.uint8)
        hit = rng.random(S) < 0.02
        rows[1, hit] = rng.integers(0, 256, size=int(hit.sum()), dtype=np.uint8)
        for b in (2, 3):
            for at in (*range(SEG, S, SEG), *range(TILE, S, TILE), TILE, TILE):
                length = int(rng.integers(1, k + 3))
                start = at - int(rng.integers(0, length + k))
                rows[b, max(start, 0) : start + length] = ord("N")
        rows[3, S - 200 :] = 0
        return rows
    rep = np.tile(ACGT, S // 4 + 2)
    rows[0], rows[1] = rep[:S], rep[1 : S + 1]
    for b in (2, 3):
        for start in rng.integers(0, S - k, size=40):
            half = rng.choice(ACGT, size=k // 2)
            rows[b, start : start + k // 2] = half
            comp = np.frombuffer(b"TGCA", dtype=np.uint8)[np.searchsorted(ACGT, half)][::-1]
            rows[b, start + k // 2 : start + 2 * (k // 2)] = comp
    rows[3, S - 150 :] = 0
    return rows


@pytest.mark.parametrize("kind,k", [("edges", 7), ("edges", 21), ("edges", 31), ("edges", 51),
                                    ("edges", 63), ("palindromes", 20), ("palindromes", 32)])
def test_k2_tile_design_matches_pallas_interpret(kind, k):
    """K2's tile design (plane strand and validity; the byte compare for a
    window holding a byte that is not ACGT; words from funnel shifts of the
    forward or the rc run) equals window_hash_pairs_pallas in interpret
    mode and the plain version on every window, invalid and pad windows
    included: random bytes, palindromes at even k, N runs across the 128-
    and 1,024-window boundaries and zero tails, over three tiles."""
    rng = np.random.default_rng(1000 + k)
    S = 2 * TILE + 300 + k
    rows = _edge_rows(kind, k, rng, S)
    _n, _R, n_pad = cuda_sketch.geometry(S, k)
    hashes, valid = _tile_window_hashes(rows, k)
    jhi, jlo, jvalid = (np.asarray(a) for a in window_hash_pairs_pallas(
        jnp.asarray(rows), ksize=k, interpret=True))
    jh = (jhi.astype(np.uint64) << np.uint64(32)) | jlo.astype(np.uint64)
    assert np.array_equal(hashes, jh[:, :n_pad])
    assert np.array_equal(valid, jvalid[:, :n_pad].astype(np.uint8))
    ph, pv = cuda_sketch.window_hashes(torch.from_numpy(rows), ksize=k)
    assert np.array_equal(hashes, u64.to_numpy(ph)) and np.array_equal(valid, pv.numpy())
    assert valid.any() and not valid.all()
    if kind == "palindromes":  # row 0's first window is its own reverse complement
        first = rows[0, :k]
        assert np.array_equal(np.frombuffer(b"TGCA", np.uint8)[np.searchsorted(ACGT, first)][::-1], first)
