"""The port's host-side sketch loop `seq_chunks_to_hashes` (sourmash_tpu_torch/ops/
sketch.py) on the CPU against the JAX one with its Pallas kernels in
interpret mode (SOURMASH_PALLAS=1): the same survivor hashes, in the same
order, with the same multiplicity.

The thresholds cover the dense K2 path (scaled 100 and 500, num sketches),
the K1 slot path with 8 slots (scaled 600) and with 4 (scaled 1000, 2000);
the inputs cover several chunks, more than one batch of 32 chunks, and a
tandem repeat that overflows K1's slots (dense reroute) and the survivor
cap (full-chunk retry).
"""

import numpy as np
import pytest

from sourmash_tpu.minhash import _get_max_hash_for_scaled
from sourmash_tpu.ops.encodings import dna_hashes
from sourmash_tpu.ops import sketch as jax_sketch
from sourmash_tpu_torch.ops import cuda_sketch
from sourmash_tpu_torch.ops import sketch as torch_sketch

CHUNK = 1 << 17
MAX_U64 = 2**64 - 1


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SOURMASH_PALLAS", "1")


def _genome(rng, size):
    "ACGT with N runs and lowercase stretches, a prefix repeated at the end."
    seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=size)
    for start in rng.integers(0, size - 500, size=max(size // 40_000, 3)):
        seq[start : start + int(rng.integers(1, 300))] = ord("N")
    for start in rng.integers(0, size - 5000, size=max(size // 100_000, 2)):
        seq[start : start + int(rng.integers(10, 5000))] |= 32
    return seq.tobytes() + seq[:3000].tobytes()


def _both(seq, k, max_hash, device="cpu"):
    want = jax_sketch.seq_chunks_to_hashes(seq, k, max_hash, chunk=CHUNK)
    got = torch_sketch.seq_chunks_to_hashes(seq, k, max_hash, chunk=CHUNK, device=device)
    return got, want


@pytest.fixture(scope="module")
def genome():
    return _genome(np.random.default_rng(31), 400_000)


@pytest.mark.parametrize("scaled", [100, 500, 600, 1000, 2000, 0])
def test_matches_jax_in_order_and_multiplicity(genome, scaled):
    max_hash = _get_max_hash_for_scaled(scaled) if scaled else MAX_U64
    got, want = _both(genome, 31, max_hash)
    assert got.dtype == np.uint64
    assert len(want) > 0
    assert np.array_equal(got, want)
    slot_path = scaled >= 512
    assert torch_sketch._slot_path_ok(max_hash) == slot_path
    if slot_path:
        assert torch_sketch._pick_slots(max_hash) == (4 if scaled >= 768 else 8)


def test_more_than_one_batch():
    seq = _genome(np.random.default_rng(32), 33 * CHUNK + 1000)
    n_chunks = -(-(len(seq) - 20) // CHUNK)
    assert n_chunks > torch_sketch.MAX_BATCH
    got, want = _both(seq, 21, _get_max_hash_for_scaled(1000))
    assert len(want) > 0 and np.array_equal(got, want)


def test_overflow_reroute_and_full_chunk_retry(monkeypatch):
    """A tandem repeat whose k-mer survives fills its segments past the
    slots (the row is redone on the dense path) and its chunk past the
    survivor cap (the chunk is redone alone at full capacity)."""
    k, max_hash = 31, _get_max_hash_for_scaled(1000)
    rng = np.random.default_rng(33)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    while True:
        unit = rng.choice(acgt, size=int(rng.integers(6, 15)))
        h, valid = dna_hashes(np.tile(unit, 10), k, 42)
        if (valid & (h <= np.uint64(max_hash))).any():
            break
    seq = bytearray(_genome(rng, 300_000))
    rep = np.tile(unit, 150_000 // len(unit)).tobytes()
    seq[140_000 : 140_000 + len(rep)] = rep
    seq = bytes(seq)

    calls = []
    dense = torch_sketch._dense_compact

    def counting(rows, *args):
        calls.append(rows.shape[0])
        return dense(rows, *args)

    monkeypatch.setattr(torch_sketch, "_dense_compact", counting)
    got, want = _both(seq, k, max_hash)
    assert np.array_equal(got, want)
    assert len(calls) == 2 and calls[1] == 1  # reroute, then one full-chunk retry
    assert len(got) > 4096  # more survivors than one chunk's cap


def test_small_input_and_hashes_to_mins():
    rng = np.random.default_rng(34)
    seq = _genome(rng, 20_000)  # below the device threshold: numpy twin
    got, want = _both(seq, 21, _get_max_hash_for_scaled(100), device="cuda")
    assert np.array_equal(got, want)  # never touches the (absent) device
    for track in (False, True):
        a = torch_sketch.hashes_to_mins(got, track)
        b = jax_sketch.hashes_to_mins(want, track)
        assert np.array_equal(a[0], b[0])
        assert (a[1] is None and b[1] is None) or np.array_equal(a[1], b[1])
    assert cuda_sketch.LAUNCHES == {"survivor_slots": 0, "window_hashes": 0,
                                    "aa_window_hashes": 0}
