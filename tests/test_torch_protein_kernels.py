"""The plain PyTorch version of the port's amino-acid kernel K3
`cuda_sketch.aa_window_hashes` against the JAX package's Pallas kernel
`aa_window_hash_pairs_pallas` in interpret mode, bit for bit.

On the CPU the wrapper runs its plain version (the CUDA kernel is held
against that plain version on the card by `chip_smoke.py`). Rows are
uppercased residues (the 20 amino acids, X and *) or residues remapped
through DAYHOFF and HP, with zero separators of length k between records
and a zero-padded tail, as `command_sketch._sketch_aa_file` builds them. Hashes are compared over the
real windows, validity over every window the port writes; past the port's
n_pad the JAX kernel's padding must be invalid.

A numpy emulation of K3's CUDA design (the staged tile with its zero ballot
plane and 16 zeroed bytes of reach, four consecutive windows a thread,
murmur words by funnel shifts, the partial last tile) is held to the Pallas
kernel and the plain version on every window, on edge rows: zeros at and k
either side of the 1,024-window tile boundaries, zero runs in the k-1 halo,
random bytes, an odd row base and a zero-padded tail. Without the reach or
the zeroed row end it fails.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sourmash_tpu.ops.pallas_sketch import aa_window_hash_pairs_pallas
from sourmash_tpu_torch.ops import cuda_sketch, u64
from sourmash_tpu_torch.ops.encodings import DAYHOFF, HP
from test_torch_sketch_kernels import _funnel_r, _pack_plane  # K2's tile emulation helpers

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX*", dtype=np.uint8)


def _rows(k, rng, remap):
    """[3, S] rows of records joined by k zero bytes; row 1 ends in zero
    padding, row 2 has real windows up to a 128-window segment boundary."""
    S = 3 * 128 + k + 45
    rows = np.zeros((3, S), dtype=np.uint8)
    for b, end in enumerate((S, S - 150, 2 * 128 + k - 1)):
        at = 0
        while at < end:
            n = min(int(rng.integers(k, 4 * k + 60)), end - at)
            rows[b, at : at + n] = remap[rng.choice(AA, size=n)]
            at += n + k  # k zero bytes separate records
    return rows


@pytest.mark.parametrize("moltype", ["protein", "dayhoff", "hp"])
@pytest.mark.parametrize("k", [3, 10, 16, 42])
def test_aa_window_hashes_match_pallas_interpret(k, moltype):
    remap = {"protein": np.arange(256, dtype=np.uint8), "dayhoff": DAYHOFF, "hp": HP}[moltype]
    rng = np.random.default_rng(100 + k)
    rows = _rows(k, rng, remap)
    n, _, n_pad = cuda_sketch.geometry(rows.shape[1], k)

    h, valid = cuda_sketch.aa_window_hashes(torch.from_numpy(rows), ksize=k)
    assert h.shape == valid.shape == (3, n_pad)
    assert h.dtype == torch.int64 and valid.dtype == torch.uint8
    jhi, jlo, jvalid = (np.asarray(a) for a in aa_window_hash_pairs_pallas(
        jnp.asarray(rows), ksize=k, interpret=True))
    jh = (jhi.astype(np.uint64) << np.uint64(32)) | jlo.astype(np.uint64)

    assert np.array_equal(u64.to_numpy(h)[:, :n], jh[:, :n])
    assert np.array_equal(valid.numpy(), jvalid[:, :n_pad].astype(np.uint8))
    assert not jvalid[:, n_pad:].any()
    v = valid.numpy()
    assert v[:, :n].any() and not v[:, :n].all()  # separators are invalid
    assert not v[:, n:].any()
    assert cuda_sketch.LAUNCHES["aa_window_hashes"] == 0  # plain version only


# -- K3's tile design, emulated ---------------------------------------------

TILE = 1024  # windows a block stages (csrc/sketch_common.cuh kAaTile)
WIN = 4  # consecutive windows a thread (kAaWin)
REACH = 16  # zeroed bytes staged after the tile


def _tile_aa_window_hashes(rows, k, seed=42, reach=REACH, zero_past_row=True):
    """K3's algorithm in numpy, tile by tile: the staged bytes (0 past the
    row) and `reach` zeroed bytes after them, the zero ballot plane;
    thread t of a tile takes windows 4t..4t+3, their validity by funnel
    shifts of the zero plane and their murmur words by funnel shifts of
    the aligned 32-bit words from t on; a thread whose windows lie past
    n_pad writes nothing (the partial last tile). An index past the
    staged bytes' reach raises. With zero_past_row false, staging reads on
    into the next row (and 0x5A past the last), as a kernel that did not
    guard the row's end would."""
    B, S = rows.shape
    _n, _R, n_pad = cuda_sketch.geometry(S, k)
    L = (TILE + k - 1 + 31) // 32 * 32
    flat = np.r_[rows.ravel(), np.full(L, 0x5A, dtype=np.uint8)]
    hashes = np.zeros((B, n_pad), dtype=np.uint64)
    valid = np.zeros((B, n_pad), dtype=np.uint8)
    for b in range(B):
        for w0 in range(0, n_pad, TILE):
            p = w0 + np.arange(L)
            if zero_past_row:
                staged = np.where(p < S, rows[b, np.minimum(p, S - 1)], 0).astype(np.uint8)
            else:
                staged = flat[b * S + p]
            zero = _pack_plane(staged == 0, L // 32)
            w32 = np.r_[staged, np.zeros(reach, dtype=np.uint8)].view("<u4")
            t = np.arange(min(TILE, n_pad - w0) // WIN)
            s = WIN * t
            for j in range(WIN):

                def word(i):
                    p0 = t + 2 * i
                    x = (_funnel_r(w32[p0 + 1], w32[p0 + 2], 8 * j) << np.uint64(32)) | _funnel_r(
                        w32[p0], w32[p0 + 1], 8 * j)
                    n_bytes = min(8, k - 8 * i)
                    if n_bytes < 8:
                        x &= np.uint64((1 << (8 * n_bytes)) - 1)
                    return torch.from_numpy(x.view(np.int64))

                h = cuda_sketch.murmur_words(word, k, seed, torch.zeros(t.size, dtype=torch.int64))
                ok = np.ones(t.size, dtype=bool)
                for c in range(0, k, 32):
                    q = s + c
                    bits = _funnel_r(zero[q >> 5], zero[(q >> 5) + 1], (q & 31) + j)
                    ok &= (bits & np.uint64((1 << min(32, k - c)) - 1)) == 0
                hashes[b, w0 + s + j] = u64.to_numpy(h)
                valid[b, w0 + s + j] = ok
    return hashes, valid


def _aa_edge_rows(k, rng):
    """[3, S] rows of K3's edge inputs, S odd (row 1 starts at an odd byte)
    and n_pad not a multiple of 1,024 (a partial last tile):
    - row 0: residues with zeros at the tile boundaries' positions 1023 and
      1024 and k either side of them, and a zero run across 2047/2048;
    - row 1: uniformly random bytes (all 256 values) with a zero inside the
      first tile's k-1 halo and a zero run filling the second's;
    - row 2: DAYHOFF-remapped records joined by k zero bytes, ending in a
      zero-padded tail."""
    S = (2 * TILE + 300 + k) | 1
    rows = AA[rng.integers(0, AA.size, size=(3, S))]
    for at in (TILE - 1, TILE):
        rows[0, [at - k, at, at + k]] = 0
    rows[0, 2 * TILE - 3 : 2 * TILE + 2] = 0
    rows[1] = rng.integers(0, 256, size=S, dtype=np.uint8)
    rows[1, TILE + (k - 1) // 2] = 0
    rows[1, 2 * TILE : 2 * TILE + k - 1] = 0
    at = 0
    while at < S:
        n = int(rng.integers(k, 4 * k + 60))
        rows[2, at : at + n] = DAYHOFF[AA[rng.integers(0, AA.size, size=min(n, S - at))]]
        at += n + k
    rows[2, S - 200 :] = 0
    return rows


@pytest.mark.parametrize("k", [3, 10, 16, 42, 64, 129])
def test_k3_tile_design_matches_pallas_interpret(k):
    """K3's tile design (the zero plane, funnel-shifted words, the 16-byte
    reach, four consecutive windows a thread, the partial last tile)
    equals aa_window_hash_pairs_pallas in interpret mode and the plain
    version on every window, garbage hashes of windows holding a zero byte
    and the pad windows past n included."""
    rng = np.random.default_rng(2000 + k)
    rows = _aa_edge_rows(k, rng)
    S = rows.shape[1]
    n, _R, n_pad = cuda_sketch.geometry(S, k)
    assert S % 2 == 1 and n_pad % TILE != 0
    hashes, valid = _tile_aa_window_hashes(rows, k)
    jhi, jlo, jvalid = (np.asarray(a) for a in aa_window_hash_pairs_pallas(
        jnp.asarray(rows), ksize=k, interpret=True))
    jh = (jhi.astype(np.uint64) << np.uint64(32)) | jlo.astype(np.uint64)
    assert np.array_equal(hashes, jh[:, :n_pad])
    assert np.array_equal(valid, jvalid[:, :n_pad].astype(np.uint8))
    ph, pv = cuda_sketch.aa_window_hashes(torch.from_numpy(rows), ksize=k)
    assert np.array_equal(hashes, u64.to_numpy(ph)) and np.array_equal(valid, pv.numpy())
    # the edges are there: windows over each boundary zero are invalid
    for at in (TILE - 1, TILE):
        assert not valid[0, max(at - k + 1, 0) : at + 1].any()
    assert not valid[1, 2 * TILE - k + 1 : 2 * TILE + k - 1].any()
    assert valid[:, :n].any() and not valid[:, n:].any()


@pytest.mark.parametrize("k", [3, 10, 129])
def test_k3_tile_needs_its_reach_and_zeroed_row_end(k):
    """Without the staged bytes' reach the last thread's word loads run
    past the tile (at k = 129, where the tile ends with the last window);
    staging that reads on past the row's end hashes other bytes into the
    pad windows."""
    rng = np.random.default_rng(3000 + k)
    rows = _aa_edge_rows(k, rng)
    want_h, want_v = (a.numpy() for a in cuda_sketch.aa_window_hashes(
        torch.from_numpy(rows), ksize=k))
    want_h = want_h.view(np.uint64)
    if k == 129:
        with pytest.raises(IndexError):
            _tile_aa_window_hashes(rows, k, reach=0)
    else:
        assert np.array_equal(_tile_aa_window_hashes(rows, k, reach=0)[0], want_h)
    h, v = _tile_aa_window_hashes(rows, k, zero_past_row=False)
    assert not np.array_equal(h, want_h)
