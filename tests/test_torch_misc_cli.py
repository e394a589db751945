"""`categorize`, `import_csv`, `watch` and `info` in the port against the
JAX package, on the CPU (SOURMASH_TORCH_DEVICE=cpu: the kernels run their
plain versions).

Every case runs both packages' `main`s in this process from one directory
with a fresh copy of the inputs, and compares exit codes, stdout, stderr
(the package name aside) and every file, byte for byte; `info -v` differs
by design in its dependency lines (torch for jax, and the port's own
sequence reader for the screed shim), which are checked by form. Inputs
are made with numpy from a seed.

`categorize` runs through the flat view (SOURMASH_TORCH_FLAT_VIEW=1 and
SOURMASH_TPU_FLAT_VIEW=1), the route a collection of 512 or more takes:
the port must call `counts_rows` with cuts (T1's cutoff form). `watch`
reads a DNA record of 2^16 bytes or more, which the port sketches through
its device branch (here K2's plain version, a num sketch) and the JAX
package through its Pallas kernels in interpret mode (SOURMASH_PALLAS=1).
"""

import re

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.save_load import SaveSignaturesToLocation as JaxSave
from sourmash_tpu_torch.ops import cuda_gather, cuda_sketch
from torch_cli_parity import assert_same, both, isolated, setup_run  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
SCALED = 1000
LONG_DNA = (1 << 16) + 5_000  # past minhash._DEVICE_MIN_LEN


def _hashes(rng, n):
    return np.unique(rng.integers(0, (1 << 64) // SCALED, size=n, dtype=np.uint64))


def _sig(k, mins, abunds=None, *, name, filename=""):
    params = dict(ksize=k, moltype="DNA", num=0, scaled=SCALED, seed=42,
                  track_abundance=abunds is not None)
    return sourmash_tpu_torch.signature_from_arrays(params, mins, abunds, name=name,
                                                    filename=filename)


def _save(path, sigs):
    with JaxSave(str(path)) as save:
        for ss in sigs:
            save.add(ss)


def _fasta(path, records):
    with open(path, "w") as fp:
        for name, seq in records:
            fp.write(f">{name}\n{seq}\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A zip of k=31 (and k=21) genomes in clades, query `.sig` files, a
    mash CSV, and for `watch` an SBT per moltype with the sequences they
    were sketched from."""
    rng = np.random.default_rng(4242)
    d = tmp_path_factory.mktemp("misc")

    genomes = []
    for k in (31, 21):
        core = _hashes(rng, 500)
        for i in range(12):
            kept = rng.permutation(core)[: int(rng.integers(100, 400))] if i % 4 else core[:0]
            mins = np.unique(np.concatenate([kept, _hashes(rng, int(rng.integers(200, 500)))]))
            genomes.append(_sig(k, mins, name=f"genome {i} k{k} clade {i % 4}",
                                filename=f"genome_{i}.fa"))
    _save(d / "db.zip", genomes)
    k31 = [ss for ss in genomes if ss.minhash.ksize == 31]
    g3 = np.fromiter(k31[3].minhash.hashes, np.uint64)
    g7 = np.fromiter(k31[7].minhash.hashes, np.uint64)
    _save(d / "self.sig", [k31[5]])  # itself in db.zip
    _save(d / "part.sig", [_sig(31, np.unique(np.r_[g3[::2], _hashes(rng, 100)]),
                                name="part of genome 3")])
    _save(d / "two.sig", [_sig(31, np.unique(np.r_[g7[1::3], _hashes(rng, 50)]), name="near 7"),
                          _sig(31, _hashes(rng, 300), name="stranger")])
    ab = np.unique(np.r_[g3[:200], _hashes(rng, 50)])
    _save(d / "abund.sig", [_sig(31, ab, rng.integers(1, 9, size=len(ab)), name="abund q")])
    (d / "prev.csv").write_text("part.sig,part of genome 3,genome 3 k31 clade 3,0.5\n")

    mins = [sorted(int(h) for h in _hashes(rng, n)) for n in (40, 75)]
    (d / "mash.csv").write_text("".join(
        f"murmur64,42,31,mash_{i}.fa,{' '.join(map(str, m))}\n" for i, m in enumerate(mins)))

    # watch: trees of num=500 sketches per moltype, and their sequences
    dna = [rng.choice(ACGT, size=n).tobytes().decode() for n in (LONG_DNA, 9_000, 12_000, 7_000)]
    aa = [rng.choice(AA, size=n).tobytes().decode() for n in (3_000, 2_500, 4_000)]
    trees = {"dna": (dict(ksize=21), dna, "add_sequence"),
             "protein": (dict(ksize=10, is_protein=True), aa, "add_protein"),
             "dayhoff": (dict(ksize=16, dayhoff=True), dna, "add_sequence"),
             "hp": (dict(ksize=30, hp=True), dna, "add_sequence")}
    for moltype, (kw, recs, add) in trees.items():
        sigs = []
        for i, rec in enumerate(recs):
            mh = sourmash_tpu.MinHash(500, **kw)
            getattr(mh, add)(rec)
            sigs.append(sourmash_tpu.SourmashSignature(mh, name=f"{moltype} genome {i}"))
        _save(d / f"{moltype}.sig", sigs)
        assert setup_run(jax_main, ["index", f"{moltype}.sbt.zip", f"{moltype}.sig", "-q"],
                         d) in (None, 0)
        (d / f"{moltype}.sig").unlink()
    _fasta(d / "records.fa", [("whole genome 0", dna[0]), ("piece of 1", dna[1][:3_000])])
    _fasta(d / "short.fa", [("piece of 2", dna[2][1_000:9_000])])
    _fasta(d / "prot.faa", [("prot 1", aa[1]), ("prot 0 piece", aa[0][:1_500])])
    _fasta(d / "stranger.fa", [("stranger", rng.choice(ACGT, size=6_000).tobytes().decode())])
    return d


CATEGORIZE = {
    "categorize --csv": [["categorize", "db.zip", "part.sig", "two.sig", "-k", "31",
                          "--csv", "out.csv"]],
    "categorize, the self-hit left out": [["categorize", "db.zip", "self.sig", "part.sig",
                                           "--ksize", "31", "--csv", "out.csv"]],
    "categorize --load-csv": [["categorize", "db.zip", "part.sig", "two.sig", "-k", "31",
                               "--load-csv", "prev.csv", "--csv", "out.csv"]],
    "categorize --threshold": [["categorize", "db.zip", "part.sig", "two.sig", "-k", "31",
                                "--threshold", "0.3"]],
    "categorize --ignore-abundance": [["categorize", "db.zip", "abund.sig", "-k", "31",
                                       "--ignore-abundance", "--csv", "out.csv"]],
    "categorize abundances: refused": [["categorize", "db.zip", "abund.sig", "-k", "31"]],
    "categorize -q": [["categorize", "db.zip", "part.sig", "-k", "31", "-q", "--csv", "o.csv"]],
}

IMPORT_CSV = {
    "import_csv to stdout": [["import_csv", "mash.csv"]],
    "import_csv -o": [["import_csv", "mash.csv", "-o", "imported.sig"]],
    "import_csv -o zip, -q": [["import_csv", "mash.csv", "-o", "imported.zip", "-q"]],
}

WATCH = {
    "watch --dna, found": [["watch", "dna.sbt.zip", "records.fa", "--dna", "-o", "w.sig"]],
    "watch --dna -k 21, short records": [["watch", "dna.sbt.zip", "short.fa", "--dna",
                                          "-k", "21", "--name", "piece"]],
    "watch --dna, no match": [["watch", "dna.sbt.zip", "stranger.fa", "--dna", "-o", "w.sig"]],
    "watch --protein --input-is-protein": [["watch", "protein.sbt.zip", "prot.faa", "--protein",
                                            "--input-is-protein", "-o", "w.sig"]],
    "watch --input-is-protein with --dna": [["watch", "protein.sbt.zip", "prot.faa", "--dna",
                                             "--input-is-protein", "-o", "w.zip"]],
    "watch --dayhoff": [["watch", "dayhoff.sbt.zip", "records.fa", "--dayhoff", "-o", "w.sig"]],
    "watch --hp": [["watch", "hp.sbt.zip", "records.fa", "--hp", "--threshold", "0.2"]],
    "watch, no moltype flag": [["watch", "hp.sbt.zip", "short.fa", "-n", "100", "-q"]],
}


@pytest.mark.parametrize("case", list(CATEGORIZE))
def test_categorize_is_identical(world, case, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SOURMASH_TORCH_FLAT_VIEW", "1")
    monkeypatch.setenv("SOURMASH_TPU_FLAT_VIEW", "1")
    cuts = []
    real = cuda_gather.counts_rows

    def spy(*a, **kw):
        cuts.append(len(a) > 4 and a[4] is not None or kw.get("cut_hi") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(cuda_gather, "counts_rows", spy)
    outputs = both(world, CATEGORIZE[case], tmp_path, monkeypatch, capsys)
    assert_same(outputs)
    (rc,), out, err, files = outputs["torch"]
    if "refused" in case:
        assert rc not in (None, 0), err
        return
    assert rc in (None, 0), err
    assert any(cuts), "the flat view's find did not run counts_rows with cuts"
    if "out.csv" in files:
        rows = files["out.csv"].decode().splitlines()
        assert rows and all(not row.startswith("self.sig") or "genome 5 k31" not in row
                            for row in rows)
    if "self-hit" in case:
        assert "genome 5 k31" not in files["out.csv"].decode().split(",", 3)[2]
    if "load-csv" in case:
        assert "part.sig" not in files["out.csv"].decode()


@pytest.mark.parametrize("case", list(IMPORT_CSV))
def test_import_csv_is_identical(world, case, tmp_path, monkeypatch, capsys):
    outputs = both(world, IMPORT_CSV[case], tmp_path, monkeypatch, capsys)
    assert_same(outputs)
    (rc,), out, err, files = outputs["torch"]
    assert rc in (None, 0), err
    assert out or {"imported.sig", "imported.zip"} & set(files)


@pytest.mark.parametrize("case", list(WATCH))
def test_watch_is_identical(world, case, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SOURMASH_PALLAS", "1")
    # the JAX package's add_sequence takes its device branch on a CPU backend only so
    monkeypatch.setenv("SOURMASH_TPU_HOST_SKETCH", "numpy")
    calls = []
    for name in ("survivor_slots", "window_hashes"):
        real = getattr(cuda_sketch, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(cuda_sketch, name, spy)
    outputs = both(world, WATCH[case], tmp_path, monkeypatch, capsys)
    assert_same(outputs)
    (rc,), out, err, files = outputs["torch"]
    assert rc in (None, 0), err
    if "no match" in case:
        assert "no matches found" in err and not out
    elif "-q" not in WATCH[case][0]:
        assert out.startswith("FOUND: ")
    if case == "watch --dna, found":
        assert "dna genome 0" in out
        assert "window_hashes" in calls  # the long record's num sketch: K2's dense path


DEPENDENCY_LINE = {
    "jax": re.compile(r"^(screed version \S+|- loaded from path: .*screed|jax version .*"
                      r"|jax devices: .*)$"),
    "torch": re.compile(r"^(screed version: None \(internal sequence_io\)|torch version .*"
                        r"|torch devices: .*)$"),
}


@pytest.mark.parametrize("verbose", [False, True])
def test_info_is_identical_but_for_its_dependency_lines(world, verbose, tmp_path, monkeypatch,
                                                        capsys):
    import torch

    argv = ["info", "-v"] if verbose else ["info"]
    outputs = both(world, [argv], tmp_path, monkeypatch, capsys)
    kept = {}
    for tag, (rcs, out, err, files) in outputs.items():
        assert rcs == [None] and out == ""
        lines = err.splitlines()
        dep = [line for line in lines if DEPENDENCY_LINE[tag].match(line)]
        kept[tag] = [line for line in lines if not DEPENDENCY_LINE[tag].match(line)]
        assert len(dep) == (4 if tag == "jax" else 3) * verbose, dep
    assert kept["torch"] == kept["jax"]
    assert kept["torch"][0] == "sourmash version 0.1.0"
    if verbose:
        err = outputs["torch"][2]
        assert f"torch version {torch.__version__}\n" in err
        want = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                if torch.cuda.is_available() else "none (no CUDA device)")
        assert f"torch devices: {want}\n" in err
        assert "khmer version: None (internal Nodegraph)" in err
        assert "the following plugins are installed:" in err
