"""The port's slice as a whole on the CPU, against the JAX package:

- `sketch dna` through both packages' `__main__.main` on a generated
  multi-record FASTA and FASTA.gz writes byte-identical .sig files (the port
  with SOURMASH_TORCH_DEVICE=cpu, so its kernels run their plain versions);
- `MinHash.add_sequence` gives the same mins, abundances and md5sum on
  sequences below and above the device threshold;
- a sketch carried across from `sourmash_tpu` with `minhash_from_arrays` /
  `signature_from_arrays` serializes to the same JSON and merges and
  downsamples the same.
"""

import gzip
import io

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu_torch.__main__ import main as torch_main

PARAMS = ["-p", "k=21,k=31,k=51,scaled=1000", "-p", "k=31,scaled=100", "-p", "k=31,num=500"]


def _seq(rng, size):
    seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=size)
    for start in rng.integers(0, size - 300, size=max(size // 20_000, 2)):
        seq[start : start + int(rng.integers(1, 200))] = ord("N")
    for start in rng.integers(0, size // 2, size=2):
        seq[start : start + int(rng.integers(10, size // 2))] |= 32
    return seq.tobytes()


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(77)
    records = [(f"rec{i} test record", _seq(rng, n))
               for i, n in enumerate((90_000, 1_500, 70_000, 30_000))]
    text = b"".join(
        b">" + name.encode() + b"\n"
        + b"\n".join(seq[j : j + 70] for j in range(0, len(seq), 70)) + b"\n"
        for name, seq in records
    )
    d = tmp_path_factory.mktemp("fa")
    plain, gz = d / "genomes.fa", d / "genomes.fa.gz"
    plain.write_bytes(text)
    gz.write_bytes(gzip.compress(text, mtime=0))
    return records, plain, gz


@pytest.fixture
def torch_cpu(monkeypatch):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")


@pytest.fixture(autouse=True)
def _view_cache(monkeypatch, tmp_path_factory):
    "The port's flat-view cache in a directory of the test's own, outside its tmp_path."
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path_factory.mktemp("viewcache")))


@pytest.mark.parametrize("which", ["plain", "gz"])
@pytest.mark.parametrize("merge", [False, True])
def test_sketch_dna_sig_files_are_byte_identical(fasta, which, merge, tmp_path, torch_cpu):
    _, plain, gz = fasta
    src = str(plain if which == "plain" else gz)
    extra = ["--name", "merged"] if merge else []
    outs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / f"{tag}.sig{'.gz' if which == 'gz' else ''}"
        assert main(["sketch", "dna", src, *PARAMS, *extra, "-o", str(out)]) in (None, 0)
        outs[tag] = out.read_bytes()
    assert outs["jax"] == outs["torch"]
    sigs = list(sourmash_tpu_torch.load_signatures_from_json(outs["torch"]))
    assert [(s.minhash.ksize, s.minhash.scaled, s.minhash.num) for s in sigs] == [
        (21, 1000, 0), (31, 1000, 0), (51, 1000, 0), (31, 100, 0), (31, 0, 500)]


def test_sketch_dna_to_stdout_and_not_ported_outputs(fasta, tmp_path, capsys, torch_cpu):
    """`-o -` prints the signature; `-o x.zip` writes the same zip as
    sourmash_tpu and a second run appends to it through its manifest;
    `-o x.sqldb` and `sketch fromfile` write sourmash_tpu's bytes."""
    _, plain, gz = fasta
    assert torch_main(["sketch", "dna", str(plain), "-o", "-"]) in (None, 0)
    printed = capsys.readouterr().out
    (sig,) = sourmash_tpu_torch.load_signatures_from_json(printed)
    assert sig.minhash.ksize == 31 and sig.minhash.scaled == 1000

    zips = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = str(tmp_path / f"{tag}.zip")
        assert main(["sketch", "dna", str(plain), *PARAMS, "-o", out]) in (None, 0)
        first = open(out, "rb").read()
        assert main(["sketch", "dna", str(gz), "-p", "k=21,scaled=500", "--name", "second",
                     "-o", out]) in (None, 0)
        zips[tag] = (first, open(out, "rb").read())
    assert zips["jax"] == zips["torch"]
    import zipfile
    from sourmash_tpu_torch.manifest import CollectionManifest

    with zipfile.ZipFile(tmp_path / "torch.zip") as zf:
        manifest = CollectionManifest.load_from_csv(
            io.StringIO(zf.read("SOURMASH-MANIFEST.csv").decode()))
        assert len(manifest) == 6 == len(zf.namelist()) - 1
        assert [r["name"] for r in manifest.rows] == [""] * 5 + ["second"]
        for row in manifest.rows:
            (s,) = sourmash_tpu_torch.load_signatures_from_json(zf.read(row["internal_location"]))
            assert s.md5sum() == row["md5"] and s in manifest

    # sqlite keeps scaled sketches only; fromfile names each file's sketches
    (tmp_path / "list.csv").write_text(
        f"name,genome_filename,protein_filename\nplain genomes,{plain},\ngz genomes,{gz},\n")
    outs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        sqldb, fromfile = tmp_path / f"{tag}.sqldb", tmp_path / f"{tag}_fromfile.zip"
        assert main(["sketch", "dna", str(plain), "-p", "k=21,k=31,scaled=1000",
                     "-o", str(sqldb)]) in (None, 0)
        assert main(["sketch", "fromfile", str(tmp_path / "list.csv"),
                     "-p", "dna,k=21,k=31,scaled=1000", "-p", "dna,k=31,num=500",
                     "-o", str(fromfile)]) in (None, 0)
        outs[tag] = (sqldb.read_bytes(), fromfile.read_bytes())
    assert outs["jax"] == outs["torch"]
    from sourmash_tpu_torch.save_load import load_file_as_index

    assert len(load_file_as_index(str(tmp_path / "torch.sqldb"))) == 2
    names = [s.name for s in load_file_as_index(str(tmp_path / "torch_fromfile.zip")).signatures()]
    assert names == ["plain genomes"] * 3 + ["gz genomes"] * 3


@pytest.mark.parametrize("track_abundance", [False, True])
@pytest.mark.parametrize("kw", [dict(n=0, scaled=100), dict(n=0, scaled=1000), dict(n=300)])
def test_add_sequence_matches(fasta, track_abundance, kw, torch_cpu):
    records, _, _ = fasta
    kw = dict(kw)
    n = kw.pop("n")
    a = sourmash_tpu.MinHash(n, 31, track_abundance=track_abundance, **kw)
    b = sourmash_tpu_torch.MinHash(n, 31, track_abundance=track_abundance, **kw)
    for _, seq in records:  # 90 kbp and 70 kbp go to the device path
        a.add_sequence(seq, force=True)
        b.add_sequence(seq, force=True)
    assert len(a) > 0
    assert np.array_equal(a.mins_array(), b.mins_array())
    if track_abundance:
        assert np.array_equal(a.abunds_array(), b.abunds_array())
    assert a.md5sum() == b.md5sum()
    with pytest.raises(ValueError, match="invalid DNA character"):
        b.add_sequence(records[0][1])


def _params(mh):
    "What a sourmash_tpu MinHash exposes, as plain values."
    return dict(ksize=mh.ksize, moltype=mh.moltype, num=mh.num, scaled=mh.scaled,
                seed=mh.seed, track_abundance=mh.track_abundance)


@pytest.mark.parametrize("track_abundance", [False, True])
def test_carry_sketch_across(fasta, track_abundance):
    records, _, _ = fasta
    jmh = sourmash_tpu.MinHash(0, 21, scaled=100, track_abundance=track_abundance)
    other = sourmash_tpu.MinHash(0, 21, scaled=100, track_abundance=track_abundance)
    for i, (_, seq) in enumerate(records):
        (jmh if i % 2 else other).add_sequence(seq, force=True)
    jsig = sourmash_tpu.SourmashSignature(jmh, name="carried", filename="genomes.fa")

    def carry(mh):
        return sourmash_tpu_torch.minhash_from_arrays(
            _params(mh), mh.mins_array().copy(),
            mh.abunds_array().copy() if track_abundance else None)

    tsig = sourmash_tpu_torch.signature_from_arrays(
        _params(jmh), jmh.mins_array(), jmh.abunds_array() if track_abundance else None,
        name="carried", filename="genomes.fa")
    assert tsig.md5sum() == jsig.md5sum()
    assert (sourmash_tpu_torch.save_signatures_to_json([tsig])
            == sourmash_tpu.save_signatures_to_json([jsig]))

    tmh, tother = carry(jmh), carry(other)
    jm = jmh.copy()
    jm.merge(other)
    tm = tmh.copy()
    tm.merge(tother)
    assert np.array_equal(jm.mins_array(), tm.mins_array()) and jm.md5sum() == tm.md5sum()
    if track_abundance:
        assert np.array_equal(jm.abunds_array(), tm.abunds_array())
    jd, td = jm.downsample(scaled=1000), tm.downsample(scaled=1000)
    assert np.array_equal(jd.mins_array(), td.mins_array()) and jd.md5sum() == td.md5sum()

    with pytest.raises(ValueError):
        sourmash_tpu_torch.minhash_from_arrays(_params(jmh), np.r_[jmh.mins_array(), jmh.mins_array()[:1]],
                                               None if not track_abundance else np.ones(len(jmh) + 1))
