"""The port's protein-family sketch path on the CPU against the JAX package:

- `aa_chunks_to_hashes` against the JAX function (Pallas K3 in interpret
  mode) over several batches of chunks, with and without `mask_invalid`:
  the same hashes in the same order with the same multiplicity;
- `protein_hashes` through its device branch (plain K3 on the CPU) against
  the JAX host path, for protein, dayhoff and hp;
- `MinHash.add_protein` and translate `add_sequence` against JAX mins,
  abundances and md5sum;
- `sketch protein` and `sketch translate` through both packages'
  `__main__.main` write byte-identical `.sig`, `.sig.gz` and `.zip` files
  (the port with SOURMASH_TORCH_DEVICE=cpu takes its batched K3 path, JAX on
  the CPU its per-record host path);
- the batched path's flushes split records at any boundary without gaining
  or losing windows.
"""

import gzip

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu.command_sketch as jax_cs
import sourmash_tpu_torch
import sourmash_tpu_torch.command_sketch as torch_cs
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.ops import encodings as jax_enc
from sourmash_tpu.ops import sketch as jax_sketch
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.ops import encodings as torch_enc
from sourmash_tpu_torch.ops import sketch as torch_sketch

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX*", dtype=np.uint8)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
MOLTYPES = ["protein", "dayhoff", "hp"]


def _protein(rng, size):
    "Residues with X and * and a lowercase stretch."
    seq = rng.choice(AA[:20], size=size)
    for start in rng.integers(0, size, size=max(size // 300, 1)):
        seq[start : start + int(rng.integers(1, 12))] = AA[20 + int(rng.integers(0, 2))]
    at = int(rng.integers(0, size))
    seq[at : at + int(rng.integers(5, 80))] |= 32
    return seq.tobytes()


def _dna(rng, size):
    "ACGT with N runs and a lowercase stretch."
    seq = rng.choice(ACGT, size=size)
    for start in rng.integers(0, size, size=max(size // 20_000, 2)):
        seq[start : start + int(rng.integers(1, 200))] = ord("N")
    at = int(rng.integers(0, size))
    seq[at : at + int(rng.integers(10, size // 2))] |= 32
    return seq.tobytes()


def _fasta(path, records):
    path.write_bytes(b"".join(
        b">" + name.encode() + b"\n"
        + b"\n".join(seq[j : j + 60] for j in range(0, len(seq), 60)) + b"\n"
        for name, seq in records
    ))
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A protein FASTA (records of 50-1500 aa and one of 70,000 aa, above
    the device threshold) and a DNA FASTA for translate (one 200 kbp record,
    whose frames are above it, and short ones)."""
    rng = np.random.default_rng(91)
    d = tmp_path_factory.mktemp("aa")
    prot = [(f"prot{i} synthetic protein", _protein(rng, int(rng.integers(50, 1500))))
            for i in range(40)]
    prot.insert(7, ("long_protein", _protein(rng, 70_000)))
    dna = [(f"dna{i} synthetic", _dna(rng, n))
           for i, n in enumerate((200_000, 1_500, 40, 30_000))]
    faa = _fasta(d / "proteins.faa", prot)
    faa_gz = d / "proteins.faa.gz"
    faa_gz.write_bytes(gzip.compress(faa.read_bytes(), mtime=0))
    return dict(prot=prot, dna=dna, faa=faa, faa_gz=faa_gz, fna=_fasta(d / "genes.fna", dna))


@pytest.fixture
def torch_cpu(monkeypatch):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")


def _joined(rng, k, n_records, size):
    "Uppercased records joined by k zero bytes, as _sketch_aa_file builds them."
    parts = []
    for _ in range(n_records):
        parts.append(torch_enc.upper(np.frombuffer(_protein(rng, size), dtype=np.uint8)))
        parts.append(np.zeros(k, dtype=np.uint8))
    return np.concatenate(parts[:-1])


@pytest.mark.parametrize("mask_invalid", [False, True])
def test_aa_chunks_to_hashes_matches_jax(mask_invalid):
    k, chunk = 10, 4096
    aa = _joined(np.random.default_rng(92), k, 60, 2_300)
    assert -(-(aa.size - k + 1) // chunk) > torch_sketch.MAX_BATCH  # two batches
    want = jax_sketch.aa_chunks_to_hashes(aa, k, chunk=chunk, mask_invalid=mask_invalid)
    got = torch_sketch.aa_chunks_to_hashes(aa, k, chunk=chunk, mask_invalid=mask_invalid,
                                           device="cpu")
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)
    assert got.size == (aa.size - k + 1 if not mask_invalid else aa.size - k + 1 - 59 * (2 * k - 1))


def test_protein_hashes_device_branch(monkeypatch):
    """At >= 2^16 windows protein_hashes goes through aa_chunks_to_hashes
    (plain K3 here) and equals JAX's host loop; with
    SOURMASH_TORCH_HOST_SKETCH=native it stays on the native loop."""
    aa = np.frombuffer(_protein(np.random.default_rng(93), (1 << 16) + 123), np.uint8)
    aa = torch_enc.upper(aa)
    calls = []
    real = torch_sketch.aa_chunks_to_hashes

    def counting(*args, **kw):
        calls.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(torch_sketch, "aa_chunks_to_hashes", counting)
    for moltype in MOLTYPES:
        want = jax_enc.protein_hashes(aa, 10, moltype)
        assert np.array_equal(torch_enc.protein_hashes(aa, 10, moltype, device="cpu"), want)
        monkeypatch.setenv("SOURMASH_TORCH_HOST_SKETCH", "native")
        assert np.array_equal(torch_enc.protein_hashes(aa, 10, moltype, device="cpu"), want)
        monkeypatch.delenv("SOURMASH_TORCH_HOST_SKETCH")
    assert calls == ["cpu"] * 3
    with pytest.raises(ValueError, match="invalid protein moltype"):
        torch_enc.protein_hashes(aa, 10, "dna")


def _mh_pair(moltype, **kw):
    flags = dict(is_protein=moltype == "protein", dayhoff=moltype == "dayhoff",
                 hp=moltype == "hp")
    return (sourmash_tpu.MinHash(ksize=7, **flags, **kw),
            sourmash_tpu_torch.MinHash(ksize=7, **flags, **kw))


@pytest.mark.parametrize("kind", ["add_protein", "translate"])
@pytest.mark.parametrize("moltype", MOLTYPES)
def test_add_protein_and_translate_match(inputs, kind, moltype, torch_cpu):
    for kw in (dict(n=0, scaled=10, track_abundance=True), dict(n=200)):
        a, b = _mh_pair(moltype, **kw)
        if kind == "add_protein":
            for _, seq in inputs["prot"]:  # the 70,000-aa record: device branch
                a.add_protein(seq)
                b.add_protein(seq)
        else:
            for _, seq in inputs["dna"]:  # the 200 kbp record's frames: device branch
                a.add_sequence(seq, True)
                b.add_sequence(seq, True)
        assert len(a) > 0
        assert np.array_equal(a.mins_array(), b.mins_array())
        if kw.get("track_abundance"):
            assert np.array_equal(a.abunds_array(), b.abunds_array())
        assert a.md5sum() == b.md5sum()
    with pytest.raises(ValueError, match="DNA"):
        sourmash_tpu_torch.MinHash(0, 21, scaled=10).add_protein("ACDEF")


PROTEIN_PARAMS = ["-p", "k=7,scaled=10,abund", "-p", "dayhoff,k=7,num=50", "-p", "hp,k=9,scaled=10"]

CLI_CASES = [
    ("protein", "faa", [], ".sig"),
    ("protein", "faa_gz", ["--dayhoff"], ".sig.gz"),
    ("protein", "faa", ["--hp"], ".zip"),
    ("protein", "faa", PROTEIN_PARAMS, ".zip"),
    ("protein", "faa_gz", [*PROTEIN_PARAMS, "--singleton"], ".sig"),
    ("protein", "faa", [*PROTEIN_PARAMS, "--name", "merged"], ".sig.gz"),
    ("translate", "fna", ["-p", "k=7,scaled=10"], ".sig"),
    ("translate", "fna", ["--dayhoff", "-p", "k=7,scaled=10,abund"], ".zip"),
    ("translate", "fna", ["--hp", "-p", "k=9,num=100", "--singleton"], ".sig.gz"),
    ("translate", "fna", ["-p", "k=7,scaled=10", "-p", "dayhoff,k=7,scaled=10",
                          "--name", "merged", "--check-sequence"], ".zip"),
]


@pytest.mark.parametrize("cmd,src,extra,suffix", CLI_CASES)
def test_sketch_protein_and_translate_files_are_byte_identical(
    inputs, cmd, src, extra, suffix, tmp_path, torch_cpu, monkeypatch
):
    # every case reaches K3: the batched path, or add_protein / translate
    # on the long record
    calls = []
    real = torch_sketch.aa_chunks_to_hashes
    monkeypatch.setattr(torch_sketch, "aa_chunks_to_hashes",
                        lambda *a, **kw: calls.append(a[1]) or real(*a, **kw))
    outs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / f"{tag}{suffix}"
        argv = ["sketch", cmd, str(inputs[src]), *extra, "-o", str(out), "-q"]
        assert main(argv) in (None, 0)
        outs[tag] = out.read_bytes()
    assert outs["jax"] == outs["torch"]
    assert calls
    if suffix != ".zip":
        sigs = list(sourmash_tpu_torch.load_signatures_from_json(outs["torch"]))
        assert sigs and all(len(s.minhash) > 0 for s in sigs)


@pytest.mark.parametrize("translate", [False, True])
def test_batched_aa_flush_boundaries(inputs, translate, monkeypatch, torch_cpu):
    """Flushing every ~1000 aa bytes gives the same sketch as one flush and
    as the JAX per-record loop."""

    def build(pkg, sketch_mod):
        mh = pkg.MinHash(0, 7, is_protein=True, scaled=10, track_abundance=True)
        sketch_mod._sketch_whole_file(
            [pkg.SourmashSignature(mh)], str(inputs["fna" if translate else "faa"]),
            input_is_protein=not translate, check_sequence=False,
        )
        return mh

    want = build(sourmash_tpu, jax_cs)
    whole = build(sourmash_tpu_torch, torch_cs)
    monkeypatch.setattr(torch_cs, "_AA_FLUSH_BYTES", 1000)
    flushed = build(sourmash_tpu_torch, torch_cs)
    assert len(want) > 0
    assert want.hashes == whole.hashes == flushed.hashes  # values and abundances
