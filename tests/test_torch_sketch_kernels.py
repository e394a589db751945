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
