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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sourmash_tpu.ops.pallas_sketch import aa_window_hash_pairs_pallas
from sourmash_tpu_torch.ops import cuda_sketch, u64
from sourmash_tpu_torch.ops.encodings import DAYHOFF, HP

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
