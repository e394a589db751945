"""Sequence encodings: DNA validation/revcomp, codon translation, dayhoff/hp
amino-acid compression, and in-order hashing paths (numpy host twin of the
device ops).

Behavioral reference: sourmash's `src/core/src/encodings.rs` (tables at
:85-304) and `signature.rs:167-399` (SeqToHashes). Implementation here is
original: table-driven numpy vectorization over all k-mer windows at once
instead of a per-window iterator.

The port's copy of `sourmash_tpu/ops/encodings.py`. Long protein-family
streams hash on the device (K3 through `ops/sketch.py:aa_chunks_to_hashes`),
short ones on the host (native loop or numpy).
"""

from __future__ import annotations

import os

import numpy as np

from .murmur import murmur3_x64_128_first64

# ---- tables -------------------------------------------------------------

COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in [(b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A"), (b"N", b"N")]:
    COMPLEMENT[_a[0]] = _b[0]

VALID_DNA = np.zeros(256, dtype=bool)
for _c in b"ACGT":
    VALID_DNA[_c] = True

UPPER = np.arange(256, dtype=np.uint8)
UPPER[ord("a") : ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1, dtype=np.uint8)

_CODONS = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S", "TCN": "S",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*", "TGA": "*",
    "TGT": "C", "TGC": "C", "TGG": "W",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L", "CTN": "L",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P", "CCN": "P",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R", "CGN": "R",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T", "ACN": "T",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V", "GTN": "V",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A", "GCN": "A",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G", "GGN": "G",
}

# codon lookup as a dense [256,256,256]-keyed table is wasteful; use base-5
# digit encoding: A,C,G,T,N -> 0..4, everything else -> invalid (-> 'X')
_B5 = np.full(256, 5, dtype=np.int64)
for _i, _c in enumerate(b"ACGTN"):
    _B5[_c] = _i

CODON_AA = np.full(6 * 6 * 6, ord("X"), dtype=np.uint8)
for _codon, _aa in _CODONS.items():
    _i0, _i1, _i2 = (_B5[ord(c)] for c in _codon)
    CODON_AA[(_i0 * 6 + _i1) * 6 + _i2] = ord(_aa)

DAYHOFF = np.full(256, ord("X"), dtype=np.uint8)
for _aas, _cls in [("C", "a"), ("AGPST", "b"), ("DENQ", "c"), ("HKR", "d"),
                   ("ILMV", "e"), ("FWY", "f"), ("*", "*")]:
    for _aa in _aas:
        DAYHOFF[ord(_aa)] = ord(_cls)

HP = np.full(256, ord("X"), dtype=np.uint8)
for _aas, _cls in [("AFGILMPVWY", "h"), ("NCSTDERHKQ", "p"), ("*", "*")]:
    for _aa in _aas:
        HP[ord(_aa)] = ord(_cls)


def upper(seq: np.ndarray) -> np.ndarray:
    return UPPER[seq]


def revcomp(seq: np.ndarray) -> np.ndarray:
    return COMPLEMENT[seq][::-1]


def translate_codon(codon) -> str:
    """Single-codon translation (reference `encodings.rs:307-330`)."""
    if isinstance(codon, str):
        codon = codon.encode("ascii")
    if len(codon) == 1:
        return "X"
    if len(codon) == 2:
        codon = codon + b"N"
    if len(codon) != 3:
        raise ValueError(f"invalid codon length: {len(codon)}")
    c = UPPER[np.frombuffer(codon, dtype=np.uint8)]
    idx = (_B5[c[0]] * 6 + _B5[c[1]]) * 6 + _B5[c[2]]
    return chr(CODON_AA[idx])


def translate_frame(seq: np.ndarray) -> np.ndarray:
    """DNA bytes (uppercased) -> amino-acid bytes, dropping the trailing
    partial codon. Codons not in the table (incl. any invalid base) -> 'X'."""
    n = (seq.shape[0] // 3) * 3
    s = seq[:n].reshape(-1, 3)
    idx = (_B5[s[:, 0]] * 6 + _B5[s[:, 1]]) * 6 + _B5[s[:, 2]]
    return CODON_AA[idx]


def _windows_np(seq: np.ndarray, k: int) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(seq, k)


def dna_hashes(seq: np.ndarray, ksize: int, seed: int = 42):
    """In-order canonical k-mer hashes for an uppercased DNA byte array.

    Returns (hashes[N] uint64, valid[N] bool) for N = len-k+1 windows; valid
    is False for windows containing non-ACGT bytes (whose hash is undefined).
    Numpy twin of the device op in `ops/sketch.py`.
    """
    S = seq.shape[0]
    n = S - ksize + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    rc = revcomp(seq)
    fwd = _windows_np(seq, ksize)
    rcw = _windows_np(rc, ksize)[::-1]

    valid_pos = VALID_DNA[seq]
    bad = (~valid_pos).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[ksize:] - cs[:-ksize]) == 0

    diff = fwd != rcw
    any_diff = diff.any(axis=1)
    first = np.argmax(diff, axis=1)
    ar = np.arange(n)
    use_fwd = (~any_diff) | (fwd[ar, first] < rcw[ar, first])
    canon = np.where(use_fwd[:, None], fwd, rcw)
    with np.errstate(over="ignore"):
        h = murmur3_x64_128_first64(np.ascontiguousarray(canon), ksize, seed, xp=np)
    return h, valid


def host_sketch_mode() -> str:
    """SOURMASH_TORCH_HOST_SKETCH: 'auto' (long inputs hash on the device),
    'native' (every length on the native C++ loop) or 'numpy'."""
    mode = os.environ.get("SOURMASH_TORCH_HOST_SKETCH", "auto")
    if mode not in ("auto", "native", "numpy"):
        raise ValueError(
            f"SOURMASH_TORCH_HOST_SKETCH must be auto, native or numpy, not {mode!r}"
        )
    return mode


def protein_hashes(
    aa_seq: np.ndarray, aa_ksize: int, moltype: str, seed: int = 42, *, device=None
):
    """In-order hashes of an amino-acid byte array (already uppercased).

    moltype: 'protein' hashes raw aa windows; 'dayhoff'/'hp' remap each
    residue first (reference `signature.rs:362-393`). No validity filtering —
    the reference hashes every window, including ones with 'X'/'*'.

    Streams of at least 2^16 windows hash on `device` (default:
    `ops.resolve_device()`); shorter ones on the native loop.
    SOURMASH_TORCH_HOST_SKETCH=native (or =numpy) keeps every length on the
    native loop (or numpy)."""
    aa_seq = remap_aa(aa_seq, moltype)
    n = aa_seq.shape[0] - aa_ksize + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)

    mode = host_sketch_mode()
    if n >= (1 << 16) and mode == "auto":
        from .sketch import aa_chunks_to_hashes

        return aa_chunks_to_hashes(
            np.ascontiguousarray(aa_seq), aa_ksize, seed, device=device
        )

    from .. import native

    if mode != "numpy":
        return native.hash_windows(aa_seq, aa_ksize, seed)
    w = _windows_np(np.ascontiguousarray(aa_seq), aa_ksize)
    with np.errstate(over="ignore"):
        return murmur3_x64_128_first64(np.ascontiguousarray(w), aa_ksize, seed, xp=np)


def remap_aa(aa_seq: np.ndarray, moltype: str) -> np.ndarray:
    "Apply the moltype's residue compression (no-op for 'protein')."
    if moltype == "dayhoff":
        return DAYHOFF[aa_seq]
    if moltype == "hp":
        return HP[aa_seq]
    if moltype != "protein":
        raise ValueError(f"invalid protein moltype {moltype!r}")
    return aa_seq


def translate_hashes(
    seq: np.ndarray, aa_ksize: int, moltype: str, seed: int = 42, *, device=None
):
    """Six-frame translation hashes for uppercased DNA bytes, in the exact
    frame order of the reference (`signature.rs:307-351`): for each frame
    0,1,2 — forward frame then revcomp frame."""
    rc = revcomp(seq)
    out = []
    for frame in range(3):
        for s in (seq[frame:], rc[frame:]):
            aa = translate_frame(s)
            out.append(protein_hashes(aa, aa_ksize, moltype, seed, device=device))
    if not out:
        return np.zeros(0, dtype=np.uint64)
    return np.concatenate(out)
