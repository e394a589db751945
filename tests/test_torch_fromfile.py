"""`sketch fromfile` through both packages' `__main__.main` on generated
genomes and proteomes, on the CPU (the port with SOURMASH_TORCH_DEVICE=cpu,
so K1-K3 run their plain versions): every written file (signatures as
`.zip`, `.sig.gz` and `.sqldb`, `--output-csv-info`,
`--output-manifest-matching`), stdout and the exit code must be the same.

Cases: DNA, protein-family and mixed CSVs; `--already-done` with the
manifest of what matched; `--report-duplicated`; a missing proteome with
and without `--ignore-missing`; nothing left to build.
"""

import csv
import gzip
import os

import numpy as np
import pytest

from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu_torch.__main__ import main as torch_main

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)

DNA_PARAMS = ["-p", "dna,k=21,k=31,scaled=100", "-p", "dna,k=31,num=200,abund"]
AA_PARAMS = ["-p", "protein,k=10,scaled=20", "-p", "dayhoff,k=16,scaled=20",
             "-p", "hp,k=42,scaled=20"]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "_torch_viewcache"))


def _fasta(path, records, gz):
    text = b"".join(
        b">" + name.encode() + b"\n"
        + b"\n".join(seq[j : j + 70] for j in range(0, len(seq), 70)) + b"\n"
        for name, seq in records
    )
    path.write_bytes(gzip.compress(text, mtime=0) if gz else text)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Five genomes (1-3 records of 2-9 kbp, N runs, lowercase) and five
    proteomes (3-12 records of 50-400 aa with X and *), as .fa, .fa.gz and
    .faa files, and the CSVs that name them."""
    rng = np.random.default_rng(1008)
    d = tmp_path_factory.mktemp("fromfile")
    rows = []
    for i in range(5):
        recs = []
        for r in range(int(rng.integers(1, 4))):
            seq = rng.choice(ACGT, size=int(rng.integers(2_000, 9_000)))
            at = int(rng.integers(0, len(seq) - 100))
            seq[at : at + int(rng.integers(1, 60))] = ord("N")
            seq[: int(rng.integers(0, 500))] |= 32
            recs.append((f"chr{r} of genome {i}", seq.tobytes()))
        genome = f"genome{i}.fa" + (".gz" if i % 2 else "")
        _fasta(d / genome, recs, gz=i % 2 == 1)
        prots = []
        for r in range(int(rng.integers(3, 13))):
            seq = rng.choice(AA, size=int(rng.integers(50, 400)))
            seq[int(rng.integers(0, 50))] = ord("X" if r % 2 else "*")
            prots.append((f"protein {r} of {i}", seq.tobytes()))
        proteome = f"proteome{i}.faa"
        _fasta(d / proteome, prots, gz=False)
        rows.append(dict(name=f"strain {i}", genome_filename=genome, protein_filename=proteome))

    def write(name, rows_):
        with open(d / name, "w", newline="") as fp:
            w = csv.DictWriter(fp, fieldnames=["name", "genome_filename", "protein_filename"])
            w.writeheader()
            w.writerows(rows_)

    write("all.csv", rows)
    write("first.csv", rows[:2])
    write("missing.csv", rows[:3] + [dict(rows[3], protein_filename=""),
                                      dict(rows[4], genome_filename="")])
    write("dup.csv", rows[:3] + [dict(rows[1], genome_filename=rows[2]["genome_filename"])])
    return d


def _run(main, argv, capsys):
    "(exit code, stdout) of one command; sys.exit codes are caught."
    try:
        rc = main(argv)
    except SystemExit as exc:
        rc = exc.code
    return rc or 0, capsys.readouterr().out


def _both(inputs, argv, capsys, tmp_path, monkeypatch, setup=None):
    """Run `sketch fromfile` + argv in both packages, each writing under its
    own directory ('{out}' in argv): {tag: (rc, stdout, {file: bytes})}."""
    monkeypatch.chdir(inputs)
    results = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / tag
        out.mkdir()
        if setup is not None:
            setup(main, out, capsys)
        rc, stdout = _run(main, ["sketch", "fromfile", *(a.format(out=out) for a in argv)],
                          capsys)
        files = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
        results[tag] = (rc, stdout, files)
    return results


def _assert_same(results):
    jax_rc, jax_out, jax_files = results["jax"]
    rc, out, files = results["torch"]
    assert (rc, out) == (jax_rc, jax_out)
    assert sorted(files) == sorted(jax_files)
    for name in jax_files:
        assert files[name] == jax_files[name], name


CASES = {
    "dna to zip, csv info": (["all.csv", *DNA_PARAMS, "-o", "{out}/out.zip",
                              "--output-csv-info", "{out}/info.csv"], 0),
    "protein family to sig.gz": (["all.csv", *AA_PARAMS, "-o", "{out}/out.sig.gz"], 0),
    "mixed, two CSVs": (["first.csv", "all.csv", "-p", "dna,k=31,scaled=100",
                         "-p", "protein,k=10,scaled=20", "-o", "{out}/out.zip",
                         "--output-csv-info", "{out}/info.csv"], -1),
    "missing, --ignore-missing": (["missing.csv", "-p", "dna,k=31,scaled=100",
                                   "-p", "protein,k=10,scaled=20", "--ignore-missing",
                                   "-o", "{out}/out.zip", "--output-csv-info",
                                   "{out}/info.csv"], 0),
    "missing fails": (["missing.csv", "-p", "dna,k=31,scaled=100", "-p", "protein,k=10,scaled=20",
                       "-o", "{out}/out.zip"], -1),
    "duplicated, --report-duplicated": (["dup.csv", *DNA_PARAMS, "--report-duplicated",
                                         "-o", "{out}/out.zip"], -1),
    "sqldb output": (["all.csv", "-p", "dna,k=21,k=31,scaled=100", "-o", "{out}/out.sqldb"], 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fromfile_outputs_are_identical(inputs, case, capsys, tmp_path, monkeypatch):
    argv, want_rc = CASES[case]
    results = _both(inputs, argv, capsys, tmp_path, monkeypatch)
    _assert_same(results)
    rc, out, files = results["torch"]
    if case == "mixed, two CSVs":  # both CSVs name strains 0 and 1: duplicates
        assert rc == want_rc and not files
        return
    assert rc == want_rc
    if want_rc == 0:
        assert "summary of sketches to build" in out
        name = next(n for n in files if n.startswith("out."))
        assert len(files[name]) > 1000


def test_fromfile_mixed_and_csv_info(inputs, capsys, tmp_path, monkeypatch):
    """DNA and protein parameters over one CSV: each name builds from its
    genome and its proteome; the CSV info lists one row a file."""
    argv = ["all.csv", "-p", "dna,k=31,scaled=100", "-p", "protein,k=10,scaled=20",
            "-p", "dayhoff,k=16,num=100", "-o", "{out}/out.zip",
            "--output-csv-info", "{out}/info.csv"]
    results = _both(inputs, argv, capsys, tmp_path, monkeypatch)
    _assert_same(results)
    rc, _out, files = results["torch"]
    assert rc == 0
    info = list(csv.DictReader(files["info.csv"].decode().splitlines()))
    assert len(info) == 10
    assert {r["sketchtype"] for r in info} == {"dna", "protein"}
    from sourmash_tpu_torch.save_load import load_file_as_index

    idx = load_file_as_index(str(tmp_path / "torch" / "out.zip"))
    assert len(idx) == 15
    assert {(r["moltype"], r["ksize"]) for r in idx.manifest.rows} == {
        ("DNA", 31), ("protein", 10), ("dayhoff", 16)}


@pytest.mark.parametrize("rest", ["some left", "nothing left"])
def test_fromfile_already_done(inputs, rest, capsys, tmp_path, monkeypatch):
    """A first run builds part of the request into done.zip; a second with
    --already-done skips it, writes the manifest of what matched and builds
    the rest (or exits 0 with nothing to build)."""
    first_csv = "first.csv" if rest == "some left" else "all.csv"

    def setup(main, out, capsys_):
        rc, _ = _run(main, ["sketch", "fromfile", first_csv, *DNA_PARAMS,
                            "-o", str(out / "done.zip")], capsys_)
        assert rc == 0

    argv = ["all.csv", *DNA_PARAMS, "--already-done", "{out}/done.zip",
            "--output-manifest-matching", "{out}/matching.csv",
            "--output-csv-info", "{out}/info.csv", "-o", "{out}/rest.zip"]
    results = _both(inputs, argv, capsys, tmp_path, monkeypatch, setup=setup)
    _assert_same(results)
    rc, out, files = results["torch"]
    assert rc == 0 and "summary of already-done sketches" in out
    assert b"SOURMASH-MANIFEST-VERSION" in files["matching.csv"]
    n_done = files["matching.csv"].count(b"\n") - 2
    assert n_done == (6 if rest == "some left" else 15)
    assert ("rest.zip" in files) == (rest == "some left")
