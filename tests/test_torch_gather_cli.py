"""`gather` through both packages' `__main__.main` on generated collections,
on the CPU (the port with SOURMASH_TORCH_DEVICE=cpu, so its kernels run
their plain versions): the CSV, stdout and every saved file must be
byte-identical.

Collections: a `.zip`, a `.sig.gz` file, several `.sig` files as separate
databases, a directory and a pathlist, below and above the 512-signature
flat-view threshold; flags --threshold-bp, --scaled, --num-results,
--save-matches, --save-prefetch-csv, --output-unassigned, --no-prefetch,
--ignore-abundance, with an abundance query and a flat one.
"""

import os

import numpy as np
import pytest

import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

SCALED = 1000


def _sketches(rng, n):
    "n sketches of 300-700 hashes in clades of 1-8 sharing 50-95 % of a core."
    mh = (1 << 64) // SCALED
    mins = []
    while len(mins) < n:
        core = np.unique(rng.integers(0, mh, size=700, dtype=np.uint64))
        for _ in range(int(rng.integers(1, 9))):
            size = int(rng.integers(300, 701))
            kept = rng.permutation(core)[: int(size * rng.uniform(0.5, 0.95))]
            own = rng.integers(0, mh, size=size - len(kept), dtype=np.uint64)
            mins.append(np.unique(np.concatenate([kept, own])))
    return mins[:n]


def _sig(mins, name, abunds=None):
    params = dict(ksize=31, moltype="DNA", num=0, scaled=SCALED, seed=42,
                  track_abundance=abunds is not None)
    return sourmash_tpu_torch.signature_from_arrays(params, mins, abunds, name=name,
                                                    filename=f"{name}.fa.gz")


def _save(path, sigs):
    with SaveSignaturesToLocation(path) as save:
        for ss in sigs:
            save.add(ss)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two collections of 600 sketches (big) and one of 150 (small) in every
    layout, and two queries (abundance and flat) taking parts of 30 sketches
    of each plus fresh hashes."""
    rng = np.random.default_rng(2026)
    d = tmp_path_factory.mktemp("gather")
    big = [_sig(m, f"big_{i}") for i, m in enumerate(_sketches(rng, 600))]
    other = [_sig(m, f"other_{i}") for i, m in enumerate(_sketches(rng, 600))]
    small = [_sig(m, f"small_{i}") for i, m in enumerate(_sketches(rng, 150))]
    _save(str(d / "big.zip"), big)
    _save(str(d / "other.zip"), other)
    _save(str(d / "small.zip"), small)
    _save(str(d / "big.sig.gz"), big)
    os.mkdir(d / "bigdir")
    for i in range(0, 600, 50):
        _save(str(d / "bigdir" / f"part{i:03d}.sig"), big[i : i + 50])
    parts = []
    for i in range(3):
        path = d / f"small{i}.sig"
        _save(str(path), small[50 * i : 50 * (i + 1)])
        parts.append(str(path))
    (d / "pathlist.txt").write_text("\n".join(parts) + "\n")
    pick = []
    for coll in (big, other, small):
        for i in rng.choice(len(coll), size=30, replace=False):
            m = coll[i].minhash.mins_array()
            pick.append(m[rng.random(len(m)) < rng.uniform(0.4, 1.0)])
    q = np.unique(np.concatenate(pick + [rng.integers(0, (1 << 64) // SCALED, size=3000,
                                                           dtype=np.uint64)]))
    _save(str(d / "q_abund.sig"), [_sig(q, "metagenome", rng.integers(1, 51, size=len(q)))])
    _save(str(d / "q_flat.sig"), [_sig(q, "metagenome flat")])
    return d


@pytest.fixture(autouse=True)
def _view_cache(monkeypatch, tmp_path_factory):
    "The port's flat-view cache in a directory of the test's own, outside its tmp_path."
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path_factory.mktemp("viewcache")))


CASES = {
    "zip above threshold": ("q_abund.sig", ["big.zip"], []),
    "zip below threshold": ("q_abund.sig", ["small.zip"], []),
    "sig.gz above, --threshold-bp": ("q_abund.sig", ["big.sig.gz"], ["--threshold-bp", "120000"]),
    "directory above, saved files": ("q_abund.sig", ["bigdir"], [
        "--save-matches", "{out}/matches.zip", "--save-prefetch-csv", "{out}/prefetch.csv",
        "--output-unassigned", "{out}/unassigned.sig"]),
    "two zips above, --scaled": ("q_abund.sig", ["big.zip", "other.zip"], ["--scaled", "2000"]),
    "zips above and below, --num-results": (
        "q_flat.sig", ["small.zip", "big.zip"], ["--num-results", "4"]),
    ".sig files below, flat query": (
        "q_flat.sig", ["small0.sig", "small1.sig", "small2.sig"],
        ["--output-unassigned", "{out}/unassigned.sig"]),
    "pathlist, --ignore-abundance": ("q_abund.sig", ["pathlist.txt"], ["--ignore-abundance"]),
    # the flat-view threshold lowered to 100 (both packages) for the small zip
    "small zip above a lowered threshold, --no-prefetch": (
        "q_abund.sig", ["small.zip"], ["--no-prefetch"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gather_outputs_are_byte_identical(world, case, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    if "no-prefetch" in case:
        monkeypatch.setenv("SOURMASH_TORCH_FLAT_VIEW", "100")
        monkeypatch.setenv("SOURMASH_TPU_FLAT_VIEW", "100")
    monkeypatch.chdir(world)
    query, dbs, flags = CASES[case]
    outputs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / tag
        out.mkdir()
        argv = ["gather", query, *dbs, "-o", str(out / "gather.csv"),
                *(f.format(out=out) for f in flags)]
        assert main(argv) in (None, 0)
        files = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
        outputs[tag] = (capsys.readouterr().out, files)
    jax_out, jax_files = outputs["jax"]
    torch_out, torch_files = outputs["torch"]
    assert torch_out == jax_out
    assert sorted(torch_files) == sorted(jax_files)
    for name in jax_files:
        assert torch_files[name] == jax_files[name], name
    assert b"\n" in torch_files["gather.csv"] and "p_query" in torch_out
    n_rows = torch_files["gather.csv"].count(b"\n") - 1
    assert n_rows > (1 if "num-results" not in case else 3)


@pytest.mark.parametrize("kind", ["sqlite database", "standalone manifest", "SBT",
                                  "revindex directory", "LCA database", "LCA sqlite database"])
def test_gather_against_each_database_format(kind, world, tmp_path, capsys, monkeypatch):
    """Every database format the loader chain knows besides zips, `.sig`
    files, directories and pathlists, built by the port from the small
    collection (150 sketches, above a lowered flat-view threshold: the
    device engine): gather against each writes the JAX package's CSV and
    stdout."""
    from sourmash_tpu_torch.save_load import load_file_as_index

    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_FLAT_VIEW", "100")
    monkeypatch.setenv("SOURMASH_TPU_FLAT_VIEW", "100")
    monkeypatch.chdir(tmp_path)
    small_zip = str(world / "small.zip")
    small = list(load_file_as_index(small_zip).signatures())
    if kind == "sqlite database":
        db = "db.sqldb"
        _save(db, small)
    elif kind == "standalone manifest":
        from sourmash_tpu_torch.manifest import CollectionManifest

        db = "mf.csv"
        rows = [CollectionManifest.make_manifest_row(ss, small_zip,
                                                     include_signature=False) for ss in small]
        CollectionManifest(rows).write_to_filename(db)
    elif kind == "SBT":
        db = "db.sbt.zip"
        assert torch_main(["index", db, small_zip]) in (None, 0)
    elif kind == "revindex directory":
        db = "rev"
        assert torch_main(["index", "-F", "revindex", db, small_zip]) in (None, 0)
    else:
        tax = ["identifiers,superkingdom,phylum,class,order,family,genus,species"]
        tax += [f"small_{i},d__B,p__P{i % 3},c__C{i % 5},o__O{i % 7},f__F{i % 11},"
                f"g__G{i % 13},s__S{i}" for i in range(150)]
        with open("tax.csv", "w") as fp:
            fp.write("\n".join(tax) + "\n")
        db = "db.lca.json" if kind == "LCA database" else "db.lca.sql"
        fmt = ["-F", "sql"] if kind == "LCA sqlite database" else []
        assert torch_main(["lca", "index", "tax.csv", db, small_zip, "--scaled", "1000",
                           *fmt]) in (None, 0)
    assert type(load_file_as_index(db)).__name__ == {
        "sqlite database": "SqliteIndex", "standalone manifest": "StandaloneManifestIndex",
        "SBT": "SBT", "revindex directory": "RevIndex", "LCA database": "LCA_Database",
        "LCA sqlite database": "LCA_SqliteDatabase"}[kind]
    capsys.readouterr()
    outputs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / f"{tag}.csv"
        assert main(["gather", str(world / "q_abund.sig"), db, "-o", str(out)]) in (None, 0)
        outputs[tag] = (capsys.readouterr().out, out.read_bytes())
    assert outputs["torch"] == outputs["jax"]
    assert outputs["torch"][1].count(b"\n") > 5
