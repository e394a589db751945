"""Sqlite databases and standalone manifests in the port against the JAX
package, on the CPU (the port with SOURMASH_TORCH_DEVICE=cpu):

- `SqliteIndex` create, insert, select and manifest: the same file bytes,
  rows, selections and refusals (num and abundance sketches);
- the `.sqldb` saver writes the JAX package's bytes;
- `gather`, `search` and `prefetch` against a `.sqldb` and against
  standalone manifests (CSV, gzipped CSV and sqlite) write the same CSV
  and stdout in both packages, above the flat-view threshold (the device
  engine; lowered to 100 sketches in both packages) and below it;
- a sqlite LCA database loads in both packages, and gather against it
  writes the same CSV and stdout.
"""

import os

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu.save_load
import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.index import sqlite_index as jax_sql
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.index import sqlite_index as torch_sql
from sourmash_tpu_torch.manifest import CollectionManifest
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation, load_file_as_index

SCALED = 1000
MAX_HASH = (1 << 64) // SCALED
FLAT_VIEW = 100  # the flat-view threshold both packages take here (default 512)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "_torch_viewcache"))
    for env in ("SOURMASH_TORCH_FLAT_VIEW", "SOURMASH_TPU_FLAT_VIEW"):
        monkeypatch.setenv(env, str(FLAT_VIEW))


def _sketches(rng, n):
    "n sketches of 200-600 hashes in clades of 1-8 sharing 50-95 % of a core."
    mins = []
    while len(mins) < n:
        core = np.unique(rng.integers(0, MAX_HASH, size=600, dtype=np.uint64))
        for _ in range(int(rng.integers(1, 9))):
            size = int(rng.integers(200, 601))
            kept = rng.permutation(core)[: int(size * rng.uniform(0.5, 0.95))]
            own = rng.integers(0, MAX_HASH, size=size - len(kept), dtype=np.uint64)
            mins.append(np.unique(np.concatenate([kept, own])))
    return mins[:n]


def _sig(mins, name, abunds=None, ksize=31):
    params = dict(ksize=ksize, moltype="DNA", num=0, scaled=SCALED, seed=42,
                  track_abundance=abunds is not None)
    return sourmash_tpu_torch.signature_from_arrays(params, mins, abunds, name=name,
                                                    filename=f"{name}.fa.gz")


def _save(path, sigs):
    with SaveSignaturesToLocation(str(path)) as save:
        for ss in sigs:
            save.add(ss)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """200 sketches as db.zip, db.sqldb and four zips of 50 named by
    standalone manifests (CSV, .csv.gz, sqlite); 60 more as small.sqldb
    (below the threshold); a metagenome query with abundances and genome
    queries."""
    rng = np.random.default_rng(752)
    d = tmp_path_factory.mktemp("sqlite")
    mins = _sketches(rng, 200)
    sigs = [_sig(m, f"genome_{i}") for i, m in enumerate(mins)]
    _save(d / "db.zip", sigs)
    _save(d / "db.sqldb", sigs)
    rows = []
    for part in range(4):
        name = f"part{part}.zip"
        _save(d / name, sigs[50 * part : 50 * (part + 1)])
        rows.extend(CollectionManifest.make_manifest_row(ss, name, include_signature=False)
                    for ss in sigs[50 * part : 50 * (part + 1)])
    mf = CollectionManifest(rows)
    mf.write_to_filename(str(d / "mf.csv"))
    import gzip

    (d / "mf.csv.gz").write_bytes(gzip.compress((d / "mf.csv").read_bytes(), mtime=0))
    mf.write_to_filename(str(d / "mf.sqlmf"), database_format="sql")
    small = [_sig(m, f"small_{i}") for i, m in enumerate(_sketches(rng, 60))]
    _save(d / "small.sqldb", small)
    pick = [mins[i][rng.random(len(mins[i])) < rng.uniform(0.4, 1.0)]
            for i in rng.choice(len(mins), size=12, replace=False)]
    pick += [small[i].minhash.mins_array() for i in range(0, 60, 10)]
    q = np.unique(np.concatenate(pick + [rng.integers(0, MAX_HASH, size=500,
                                                      dtype=np.uint64)]))
    _save(d / "meta.sig", [_sig(q, "metagenome", rng.integers(1, 40, size=len(q)))])
    _save(d / "genome.sig", [_sig(mins[33], "genome query")])
    _save(d / "small_genome.sig", [small[20]])
    return d


def test_sqldb_saver_matches_jax(world, tmp_path):
    "The port's .sqldb saver writes the JAX package's bytes."
    sigs = list(load_file_as_index(str(world / "db.zip")).signatures())
    _save(tmp_path / "t.sqldb", sigs)
    with sourmash_tpu.save_load.SaveSignaturesToLocation(str(tmp_path / "j.sqldb")) as save:
        for ss in sourmash_tpu.load_file_as_signatures(str(world / "db.zip")):
            save.add(ss)
    assert (tmp_path / "t.sqldb").read_bytes() == (tmp_path / "j.sqldb").read_bytes()
    idx = load_file_as_index(str(tmp_path / "t.sqldb"))
    assert isinstance(idx, torch_sql.SqliteIndex) and len(idx) == 200


def test_sqlite_index_create_insert_select_manifest(world, tmp_path):
    """Create and insert through both packages' SqliteIndex: the same
    bytes; then the same manifest rows, selections, loaded sketches and
    refusals."""
    sigs_t = list(load_file_as_index(str(world / "db.zip")).signatures())[:50]
    sigs_j = list(sourmash_tpu.load_file_as_signatures(str(world / "db.zip")))[:50]
    for tag, mod, sigs in (("t", torch_sql, sigs_t), ("j", jax_sql, sigs_j)):
        idx = mod.SqliteIndex.create(str(tmp_path / f"{tag}.sqldb"))
        for ss in sigs:
            idx.insert(ss)
        idx.close()
    assert (tmp_path / "t.sqldb").read_bytes() == (tmp_path / "j.sqldb").read_bytes()

    t = torch_sql.SqliteIndex.load(str(tmp_path / "t.sqldb"))
    j = jax_sql.SqliteIndex.load(str(tmp_path / "t.sqldb"))
    assert t.scaled == j.scaled == SCALED and len(t) == len(j) == 50
    assert list(t.manifest.rows) == list(j.manifest.rows)
    assert [s.md5sum() for s in t.signatures()] == [s.md5sum() for s in sigs_t]
    for a, b in zip(t.signatures(), j.signatures()):
        assert np.array_equal(a.minhash.mins_array(), b.minhash.mins_array())
        assert (a.name, a.filename) == (b.name, b.filename)
    assert len(t.select(ksize=31, moltype="DNA", containment=True)) == 50
    assert len(t.select(ksize=21)) == len(j.select(ksize=21)) == 0
    with pytest.raises(ValueError, match="num"):
        t.select(num=100)
    assert sigs_t[3] in t.manifest and sigs_t[3] in t.select(ksize=31).manifest

    # the reverse index: hash -> sketch ids, as the JAX package reads it
    hv_t = torch_sql._SqliteIndexHashvalToIndex(t)
    hv_j = jax_sql._SqliteIndexHashvalToIndex(j)
    some = [int(h) for h in sigs_t[0].minhash.mins_array()[:20]]
    assert [hv_t[h] for h in some] == [hv_j[h] for h in some]
    assert sorted(hv_t) == sorted(hv_j)

    # refusals: num and abundance sketches, another scaled
    num_mh = sourmash_tpu_torch.MinHash(100, 31)
    num_mh.add_many(sigs_t[0].minhash.mins_array()[:50])
    with pytest.raises(ValueError, match="num"):
        t.insert(sourmash_tpu_torch.SourmashSignature(num_mh, name="num"))
    ab = _sig(sigs_t[0].minhash.mins_array(), "ab", np.ones(len(sigs_t[0].minhash), np.int64))
    with pytest.raises(ValueError, match="abundance"):
        t.insert(ab)
    coarse = sigs_t[1].minhash.downsample(scaled=2 * SCALED)
    with pytest.raises(ValueError, match="scaled"):
        t.insert(sourmash_tpu_torch.SourmashSignature(coarse, name="coarse"))


def test_lca_sqlite_database_loads_and_gathers(world, tmp_path, capsys, monkeypatch):
    """A sqlite LCA database (a lineage table beside the index) that the
    port's `lca index -F sql` writes is the JAX package's file; both load it
    as an LCA_SqliteDatabase, and gather against it (above the lowered
    flat-view threshold) writes the same CSV and stdout."""
    monkeypatch.chdir(tmp_path)
    tax = ["identifiers,superkingdom,phylum,class,order,family,genus,species"]
    tax += [f"genome_{i},d__B,p__P{i % 3},c__C{i % 5},o__O{i % 7},f__F{i % 11},g__G{i % 13},"
            f"s__S{i}" for i in range(0, 200, 2)]
    (tmp_path / "tax.csv").write_text("\n".join(tax) + "\n")
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        assert main(["lca", "index", "tax.csv", f"{tag}.lca.sql", str(world / "db.zip"),
                     "-F", "sql", "--scaled", "1000", "-q"]) in (None, 0)
    assert (tmp_path / "torch.lca.sql").read_bytes() == (tmp_path / "jax.lca.sql").read_bytes()
    path = str(tmp_path / "torch.lca.sql")
    db = load_file_as_index(path)
    assert type(db).__name__ == "LCA_SqliteDatabase" and len(db) == 200
    assert type(sourmash_tpu.save_load.load_file_as_index(path)).__name__ == "LCA_SqliteDatabase"
    assert len(db.lid_to_lineage) == 100
    capsys.readouterr()
    outputs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / f"{tag}.csv"
        assert main(["gather", str(world / "meta.sig"), path, "-o", str(out)]) in (None, 0)
        outputs[tag] = (capsys.readouterr().out, out.read_bytes())
    assert outputs["torch"] == outputs["jax"]
    assert outputs["torch"][1].count(b"\n") > 2


CASES = {
    "gather, sqldb": ("gather", "meta.sig", ["db.sqldb"], []),
    "gather, sqldb below the threshold": ("gather", "meta.sig", ["small.sqldb"], []),
    "gather, two sqldbs, saved matches": (
        "gather", "meta.sig", ["db.sqldb", "small.sqldb"], ["--save-matches", "{out}/m.zip"]),
    "gather, csv manifest": ("gather", "meta.sig", ["mf.csv"], []),
    "gather, gzipped manifest": ("gather", "meta.sig", ["mf.csv.gz"], ["--threshold-bp", "20000"]),
    "gather, sqlite manifest": ("gather", "meta.sig", ["mf.sqlmf"], []),
    "search, sqldb": ("search", "genome.sig", ["db.sqldb"], []),
    "search --containment, sqldb below": ("search", "small_genome.sig", ["small.sqldb"],
                                          ["--containment"]),
    "search, csv manifest": ("search", "genome.sig", ["mf.csv"], ["--containment", "-n", "4"]),
    "prefetch, sqldb": ("prefetch", "meta.sig", ["db.sqldb"], []),
    "prefetch, sqlite manifest": ("prefetch", "meta.sig", ["mf.sqlmf"],
                                  ["--save-matching-hashes", "{out}/k.sig"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_against_sqlite_and_manifests_is_byte_identical(world, case, tmp_path, capsys,
                                                            monkeypatch):
    monkeypatch.chdir(world)
    cmd, query, dbs, flags = CASES[case]
    outputs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / tag
        out.mkdir()
        try:
            rc = main([cmd, query, *dbs, "-o", str(out / "out.csv"),
                       *(f.format(out=out) for f in flags)])
        except SystemExit as exc:
            rc = exc.code
        files = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
        outputs[tag] = (rc or 0, capsys.readouterr().out, files)
    assert outputs["torch"][:2] == outputs["jax"][:2]
    jax_files, torch_files = outputs["jax"][2], outputs["torch"][2]
    assert sorted(torch_files) == sorted(jax_files)
    for name in jax_files:
        assert torch_files[name] == jax_files[name], name
    assert torch_files["out.csv"].count(b"\n") > (2 if cmd != "search" else 1)


@pytest.mark.parametrize("db", ["db.sqldb", "mf.csv", "mf.sqlmf"])
def test_gather_goes_through_the_flat_view(world, db, monkeypatch):
    """Above the threshold, gather's counter is the device engine's
    (FlatCounterGather over a FlatIndex view), with the zip's rows."""
    from sourmash_tpu_torch.index.flat import FlatIndex

    monkeypatch.chdir(world)
    idx = load_file_as_index(db)
    view = idx._as_flat_view()
    assert isinstance(view, FlatIndex) and len(view) == 200
    assert [s.md5sum() for s in view.signatures()] == [
        s.md5sum() for s in load_file_as_index("db.zip").signatures()]
    q = next(iter(load_file_as_index("meta.sig").signatures()))
    counter = idx.counter_gather(q, 50_000)
    assert type(counter).__name__ == "FlatCounterGather"
    assert load_file_as_index("small.sqldb")._as_flat_view() is None
