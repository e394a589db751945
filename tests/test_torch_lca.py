"""LCA databases in the port against the JAX package, on the CPU (the port
with SOURMASH_TORCH_DEVICE=cpu, so its kernels run their plain versions):

- `lca index` with a generated taxonomy spreadsheet to `.lca.json`,
  `.lca.json.gz` (compared decompressed: gzip stamps the time) and
  `-F sql`, with `--scaled`, `--split-identifiers`, `--report` and the
  default scaled of 10,000: the same bytes;
- `lca classify`, `summarize`, `rankinfo` and `compare_csv`: the same
  stdout and CSV;
- `gather`, `search` and `prefetch` against `.lca.json` and the sqlite LCA
  database write the same stdout and CSV, with the flat-view threshold
  lowered below the database's size in both packages (gather's device
  engine) and at 0 (the host route);
- the loader chain's order: a sqlite LCA database loads at the sqlite
  step, and a zip or a `.sig` is refused by the LCA loader after one
  character.
"""

import gzip
import os

import numpy as np
import pytest

import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.lca import lca_db as jax_lca_db
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.lca import lca_db as torch_lca_db
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation, load_file_as_index

SCALED = 1000
MAX_HASH = (1 << 64) // SCALED
N_GENOMES = 60
FLAT_VIEW = 10  # the lowered flat-view threshold both packages take on the device route
MAINS = (("jax", jax_main), ("torch", torch_main))
RANKS = ("superkingdom", "phylum", "class", "order", "family", "genus", "species", "strain")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "_torch_viewcache"))


def _clades(rng, n):
    "n (clade, mins) pairs: sketches of 200-600 hashes in clades of 1-8 sharing a core."
    out = []
    clade = 0
    while len(out) < n:
        core = np.unique(rng.integers(0, MAX_HASH, size=600, dtype=np.uint64))
        for _ in range(int(rng.integers(1, 9))):
            size = int(rng.integers(200, 601))
            kept = rng.permutation(core)[: int(size * rng.uniform(0.5, 0.95))]
            own = rng.integers(0, MAX_HASH, size=size - len(kept), dtype=np.uint64)
            out.append((clade, np.unique(np.concatenate([kept, own]))))
        clade += 1
    return out[:n]


def _sig(mins, name, abunds=None):
    params = dict(ksize=31, moltype="DNA", num=0, scaled=SCALED, seed=42,
                  track_abundance=abunds is not None)
    return sourmash_tpu_torch.signature_from_arrays(params, mins, abunds, name=name,
                                                    filename=f"{name.split()[0]}.fa.gz")


def _save(path, sigs):
    with SaveSignaturesToLocation(str(path)) as save:
        for ss in sigs:
            save.add(ss)


def _lineage(clade, i):
    return ["d__Bacteria", f"p__P{clade % 3}", f"c__C{clade % 4}", f"o__O{clade % 5}",
            f"f__F{clade % 6}", f"g__G{clade}", f"s__G{clade} sp{i % 2}", ""]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """60 genomes named 'genome_N clade_C' in a zip, a taxonomy spreadsheet
    (one genome left out of it, one row with no genome), three genome
    queries, a metagenome, and an LCA database of each form built by the
    port."""
    rng = np.random.default_rng(1859)
    d = tmp_path_factory.mktemp("lca")
    genomes = _clades(rng, N_GENOMES)
    sigs = [_sig(m, f"genome_{i} clade_{c}") for i, (c, m) in enumerate(genomes)]
    _save(d / "coll.zip", sigs)
    rows = [",".join(("identifiers",) + RANKS)]
    for i, (c, _) in enumerate(genomes):
        if i != 11:
            rows.append(",".join([f"genome_{i}"] + _lineage(c, i)))
    rows.append(",".join(["genome_absent"] + _lineage(99, 0)))
    (d / "tax.csv").write_text("\n".join(rows) + "\n")
    for i in (3, 11, 40):
        _save(d / f"q{i}.sig", [sigs[i]])
    pick = [m[rng.random(len(m)) < rng.uniform(0.3, 1.0)]
            for _, m in (genomes[i] for i in rng.choice(N_GENOMES, size=12, replace=False))]
    q = np.unique(np.concatenate(pick + [rng.integers(0, MAX_HASH, size=800, dtype=np.uint64)]))
    _save(d / "meta.sig", [_sig(q, "metagenome", rng.integers(1, 20, size=len(q)))])
    cwd = os.getcwd()
    os.chdir(d)
    try:
        for out, flags in (("db.lca.json", []), ("db.lca.sql", ["-F", "sql"])):
            assert torch_main(["lca", "index", "tax.csv", out, "coll.zip", "--scaled", "1000",
                               "--split-identifiers", "-q", *flags]) in (None, 0)
    finally:
        os.chdir(cwd)
    return d


def _files(root):
    "{name: bytes} of root's files, `.gz` members decompressed."
    out = {}
    for name in sorted(os.listdir(root)):
        data = open(os.path.join(root, name), "rb").read()
        out[name] = gzip.decompress(data) if name.endswith(".gz") else data
    return out


INDEX_CASES = {
    "json": ["db.lca.json", "--scaled", "1000", "--split-identifiers", "--report", "r.txt"],
    "json.gz": ["db.lca.json.gz", "--scaled", "1000", "--split-identifiers"],
    "sql": ["db", "-F", "sql", "--scaled", "1000", "--split-identifiers"],
    "json, default scaled, no name suffix": ["db", "--split-identifiers"],
    "json, --scaled 2000, --require-taxonomy": [
        "db.lca.json", "--scaled", "2000", "--split-identifiers", "--require-taxonomy"],
}


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_lca_index_writes_identical_databases(world, case, tmp_path, monkeypatch, capsys):
    outputs = {}
    for tag, main in MAINS:
        out = tmp_path / tag
        out.mkdir()
        monkeypatch.chdir(out)
        argv = ["lca", "index", str(world / "tax.csv"), *INDEX_CASES[case][:1],
                str(world / "coll.zip"), *INDEX_CASES[case][1:]]
        assert main(argv) in (None, 0)
        outputs[tag] = (capsys.readouterr().out, _files(out))
    assert outputs["torch"] == outputs["jax"]
    files = outputs["torch"][1]
    db = next(name for name in files if ".lca." in name)
    loaded = load_file_as_index(str(tmp_path / "torch" / db))
    n = N_GENOMES - 1 if "require-taxonomy" in case else N_GENOMES  # genome_11 has no lineage
    assert len(loaded) == n and type(loaded).__name__ == (
        "LCA_SqliteDatabase" if "sql" in case else "LCA_Database")
    if case == "json":
        assert b"No lineage provided for these identifiers: 1" in files["r.txt"]


def test_each_package_loads_the_others_database(world):
    "Lineages, hash index and rebuilt signatures (in their order) agree both ways."
    for path in ("db.lca.json", "db.lca.sql"):
        t = torch_lca_db.LCA_Database.load(str(world / path))
        j = jax_lca_db.LCA_Database.load(str(world / path))
        assert len(t) == len(j) == N_GENOMES
        assert [(s.md5sum(), s.name) for s in t.signatures()] == \
            [(s.md5sum(), s.name) for s in j.signatures()]
        hashes = sorted(t.hashvals)[:200:7]
        for h in hashes:
            assert [tuple(x) for x in t.get_lineage_assignments(h)] == \
                [tuple(x) for x in j.get_lineage_assignments(h)]
        assert sorted(t.hashvals) == sorted(j.hashvals)


CMD_CASES = {
    "classify": ["lca", "classify", "--db", "db.lca.json", "--query", "q3.sig", "q11.sig",
                 "q40.sig", "-o", "{out}/o.csv"],
    "classify, sqlite db, --majority, stdout": [
        "lca", "classify", "--db", "db.lca.sql", "--query", "q3.sig", "q40.sig", "--majority"],
    "summarize": ["lca", "summarize", "--db", "db.lca.json", "--query", "meta.sig",
                  "-o", "{out}/o.csv"],
    "summarize, two queries, --threshold 20": [
        "lca", "summarize", "--db", "db.lca.sql", "--query", "q3.sig", "meta.sig",
        "--threshold", "20", "--ignore-abundance"],
    "rankinfo": ["lca", "rankinfo", "db.lca.json"],
    "rankinfo, sqlite db, --minimum-num 2": ["lca", "rankinfo", "db.lca.sql", "--minimum-num", "2"],
}


@pytest.mark.parametrize("case", list(CMD_CASES))
def test_lca_commands_are_identical(world, case, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(world)
    capsys.readouterr()
    outputs = {}
    for tag, main in MAINS:
        out = tmp_path / tag
        out.mkdir()
        assert main([a.format(out=out) for a in CMD_CASES[case]]) in (None, 0)
        outputs[tag] = (capsys.readouterr().out, _files(out))
    assert outputs["torch"] == outputs["jax"]
    stdout, files = outputs["torch"]
    assert "g__G" in stdout + b"".join(files.values()).decode() or "rankinfo" in case
    if "rankinfo" in case:
        assert "species:" in stdout


def test_lca_compare_csv_is_identical(world, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(world)
    outputs = {}
    for tag, main in MAINS:
        out = tmp_path / f"{tag}.csv"
        assert main(["lca", "classify", "--db", "db.lca.json", "--query", "q3.sig", "q11.sig",
                     "q40.sig", "-o", str(out)]) in (None, 0)
        capsys.readouterr()
        assert main(["lca", "compare_csv", str(out), "tax.csv"]) in (None, 0)
        captured = capsys.readouterr()
        outputs[tag] = (captured.out, out.read_bytes())
    assert outputs["torch"] == outputs["jax"]


SEARCH_CASES = {
    "gather, json": ["gather", "meta.sig", "db.lca.json", "-o", "{out}/o.csv",
                     "--save-matches", "{out}/m.zip"],
    "gather, sqlite": ["gather", "meta.sig", "db.lca.sql", "-o", "{out}/o.csv"],
    "search --containment, json": ["search", "q3.sig", "db.lca.json", "--containment",
                                   "--threshold", "0.05", "-o", "{out}/o.csv"],
    "search, sqlite": ["search", "q40.sig", "db.lca.sql", "--threshold", "0.05",
                       "-o", "{out}/o.csv"],
    "prefetch, json": ["prefetch", "meta.sig", "db.lca.json", "-o", "{out}/o.csv"],
    "prefetch, sqlite": ["prefetch", "meta.sig", "db.lca.sql", "-o", "{out}/o.csv"],
}


@pytest.mark.parametrize("route", ["flat view", "host"])
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_prefetch_gather_against_lca(world, case, route, tmp_path, capsys, monkeypatch):
    from sourmash_tpu_torch.index.flat import FlatIndex

    threshold = str(FLAT_VIEW) if route == "flat view" else "0"
    for env in ("SOURMASH_TORCH_FLAT_VIEW", "SOURMASH_TPU_FLAT_VIEW"):
        monkeypatch.setenv(env, threshold)
    views = []
    counter_gather = FlatIndex.counter_gather
    monkeypatch.setattr(FlatIndex, "counter_gather",
                        lambda self, *a, **k: views.append(self) or counter_gather(self, *a, **k))
    monkeypatch.chdir(world)
    capsys.readouterr()
    outputs = {}
    for tag, main in MAINS:
        out = tmp_path / tag
        out.mkdir()
        assert main([a.format(out=out) for a in SEARCH_CASES[case]]) in (None, 0)
        outputs[tag] = (capsys.readouterr().out, _files(out))
    assert outputs["torch"] == outputs["jax"]
    stdout, files = outputs["torch"]
    assert files["o.csv"].count(b"\n") > 1 and "genome_" in files["o.csv"].decode()
    assert bool(views) == (case.startswith("gather") and route == "flat view")


def test_loader_chain_order(world, monkeypatch):
    """A sqlite LCA database loads at the sqlite step; the LCA loader refuses
    a zip and a `.sig` file after reading one character of each."""
    from sourmash_tpu_torch import save_load

    assert type(load_file_as_index(str(world / "db.lca.sql"))).__name__ == "LCA_SqliteDatabase"
    for path in ("coll.zip", "q3.sig"):
        with pytest.raises(ValueError, match="is not an LCA database file"):
            save_load._load_revindex(str(world / path))
    assert type(load_file_as_index(str(world / "coll.zip"))).__name__ == "ZipFileLinearIndex"
