"""Sequence Bloom Trees in the port against the JAX package, on the CPU
(the port with SOURMASH_TORCH_DEVICE=cpu, so its kernels run their plain
versions):

- `index` to `.sbt.zip` and to `.sbt.json` (every file of the directory)
  at `-n 2` and `-n 5`, with `--scaled`, `--append`, `--from-file` and
  `--sparseness 0` and `1`: byte-identical trees;
- each package loads the other's tree, leaf for leaf;
- `search` (Jaccard and `--containment`), `prefetch` and `gather` against
  a tree write the same stdout and CSV, with the flat-view threshold
  lowered below the tree's size in both packages (gather's device
  engine) and at 0 (the host route);
- `sbt_combine`, `migrate` and `storage convert` to zip and back to fs
  (of a `.sbt.json` tree and of a `.sbt.zip` one) write the same files;
- mixed ksizes fail alike.
"""

import os
import shutil

import numpy as np
import pytest

import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.sbtmh import load_sbt_index as jax_load_sbt
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation, load_file_as_index
from sourmash_tpu_torch.sbtmh import load_sbt_index as torch_load_sbt

SCALED = 1000
MAX_HASH = (1 << 64) // SCALED
N_SKETCHES = 40
FLAT_VIEW = 10  # the lowered flat-view threshold both packages take on the device route
MAINS = (("jax", jax_main), ("torch", torch_main))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "_torch_viewcache"))


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
    """A collection of 40 sketches (a zip, two halves, a pathlist, one with
    abundances), a tree of it, a genome query and a metagenome query."""
    rng = np.random.default_rng(1917)
    d = tmp_path_factory.mktemp("sbt")
    mins = _sketches(rng, N_SKETCHES)
    sigs = [_sig(m, f"genome_{i}") for i, m in enumerate(mins)]
    _save(d / "coll.zip", sigs)
    _save(d / "half_a.zip", sigs[:25])
    _save(d / "half_b.sig", sigs[25:])
    _save(d / "abund.sig", [_sig(mins[3], "abund", rng.integers(1, 9, size=len(mins[3])))])
    _save(d / "k21.sig", [_sig(mins[5], "k21", ksize=21)])
    (d / "pathlist.txt").write_text(f"{d}/half_a.zip\n{d}/half_b.sig\n")
    pick = [m[rng.random(len(m)) < rng.uniform(0.3, 1.0)]
            for m in (mins[i] for i in rng.choice(N_SKETCHES, size=12, replace=False))]
    q = np.unique(np.concatenate(pick + [rng.integers(0, MAX_HASH, size=800, dtype=np.uint64)]))
    _save(d / "meta.sig", [_sig(q, "metagenome", rng.integers(1, 20, size=len(q)))])
    _save(d / "genome.sig", [sigs[7]])
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert torch_main(["index", "db.sbt.zip", "coll.zip"]) in (None, 0)
        assert torch_main(["index", "db.sbt.json", "coll.zip", "-n", "3"]) in (None, 0)
    finally:
        os.chdir(cwd)
    return d


def _tree_files(root):
    """{relative path: bytes} of every file under root; root's own absolute
    path, which a tree description records for a `ZipStorage`, reads "."."""
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            data = open(path, "rb").read()
            files[os.path.relpath(path, root)] = data.replace(str(root).encode(), b".")
    return files


def _run_both(world, tmp_path, monkeypatch, argv_for, *, setup=None):
    "Run the commands in a fresh directory per package; return {tag: its files}."
    outputs = {}
    for tag, main in MAINS:
        out = tmp_path / tag
        out.mkdir(parents=True)
        if setup:
            setup(out)
        monkeypatch.chdir(out)
        for argv in argv_for(out):
            assert main(argv) in (None, 0), argv
        outputs[tag] = _tree_files(out)
    return outputs


def _assert_same_files(outputs):
    jax_files, torch_files = outputs["jax"], outputs["torch"]
    assert sorted(torch_files) == sorted(jax_files)
    for name in jax_files:
        assert torch_files[name] == jax_files[name], name
    return torch_files


INDEX_CASES = {
    "zip -n 2": ["db.sbt.zip", "{w}/coll.zip"],
    "zip -n 5": ["db.sbt.zip", "{w}/coll.zip", "-n", "5"],
    "zip, name without suffix": ["db", "{w}/coll.zip"],
    "json -n 2": ["db.sbt.json", "{w}/coll.zip"],
    "json -n 5, --scaled": ["db.sbt.json", "{w}/coll.zip", "-n", "5", "--scaled", "2000"],
    "zip --sparseness 0": ["db.sbt.zip", "{w}/coll.zip", "--sparseness", "0"],
    "zip --sparseness 1": ["db.sbt.zip", "{w}/coll.zip", "--sparseness", "1"],
    "json --sparseness 1": ["db.sbt.json", "{w}/coll.zip", "--sparseness", "1", "-n", "4"],
    "zip --from-file, abundance sketch": [
        "db.sbt.zip", "{w}/abund.sig", "--from-file", "{w}/pathlist.txt"],
}


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_index_writes_identical_trees(world, case, tmp_path, monkeypatch, capsys):
    files = _assert_same_files(_run_both(
        world, tmp_path, monkeypatch,
        lambda out: [["index", *(a.format(w=world) for a in INDEX_CASES[case])]]))
    capsys.readouterr()
    if "json" in case:
        assert "db.sbt.json" in files
        nodes = [f for f in files if f.startswith(".sbt.db" + os.sep)]
        n_internal = sum(os.path.basename(f).startswith("internal") for f in nodes)
        assert (n_internal == 0) == ("sparseness 1" in case)
        assert len(nodes) - n_internal == N_SKETCHES + 1  # the leaves and the manifest
    else:
        assert list(files) == ["db.sbt.zip"]


def test_index_append_is_identical(world, tmp_path, monkeypatch, capsys):
    _assert_same_files(_run_both(world, tmp_path, monkeypatch, lambda out: [
        ["index", "db.sbt.zip", f"{world}/half_a.zip"],
        ["index", "db.sbt.zip", f"{world}/half_b.sig", "--append"],
    ]))
    tree = torch_load_sbt(str(tmp_path / "torch" / "db.sbt.zip"))
    assert len(tree) == N_SKETCHES
    capsys.readouterr()


@pytest.mark.parametrize("tree,d", [("db.sbt.zip", 2), ("db.sbt.json", 3)])
def test_each_package_loads_the_others_tree(world, tree, d, tmp_path, monkeypatch):
    "The port's tree in the JAX package and the JAX package's tree in the port."
    monkeypatch.chdir(tmp_path)
    assert jax_main(["index", "-q", tree, str(world / "coll.zip"), "-n", str(d)]) in (None, 0)
    jax_built = str(tmp_path / tree)
    ported = str(world / tree)

    def leaves(t):
        return [(pos, leaf.data.md5sum(), leaf.data.name) for pos, leaf in t.leaves(with_pos=True)]

    def nodes(t):
        return sorted((pos, n.data.to_bytes(compression=0), n.metadata) for pos, n in t._nodes.items())

    for path in (jax_built, ported):
        t, j = torch_load_sbt(path), jax_load_sbt(path)
        assert leaves(t) == leaves(j) and len(leaves(t)) == N_SKETCHES
        assert nodes(t) == nodes(j)
        assert t.d == j.d == d
    assert type(load_file_as_index(jax_built)).__name__ == "SBT"
    assert [ss.md5sum() for ss in load_file_as_index(jax_built).signatures()] == \
        [ss.md5sum() for ss in torch_load_sbt(ported).signatures()]


SEARCH_CASES = {
    "search": ["search", "genome.sig", "db.sbt.zip", "--threshold", "0.05", "-o", "{out}/o.csv"],
    "search --containment": ["search", "genome.sig", "db.sbt.json", "--containment",
                             "--threshold", "0.05", "-o", "{out}/o.csv"],
    "prefetch": ["prefetch", "meta.sig", "db.sbt.zip", "-o", "{out}/o.csv",
                 "--save-matching-hashes", "{out}/k.sig"],
    "gather": ["gather", "meta.sig", "db.sbt.zip", "-o", "{out}/o.csv",
               "--save-matches", "{out}/m.zip"],
    "gather, fs tree, --threshold-bp": ["gather", "meta.sig", "db.sbt.json", "-o", "{out}/o.csv",
                                        "--threshold-bp", "5000"],
}


@pytest.mark.parametrize("route", ["flat view", "host"])
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_prefetch_gather_against_a_tree(world, case, route, tmp_path, capsys, monkeypatch):
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
        outputs[tag] = (capsys.readouterr().out, _tree_files(out))
    assert outputs["torch"] == outputs["jax"]
    stdout, files = outputs["torch"]
    assert files["o.csv"].count(b"\n") > 1
    assert ("genome_" in stdout) or case.startswith("prefetch")
    # gather takes the device engine's view of the tree; the tree walk searches on the host
    assert bool(views) == (case.startswith("gather") and route == "flat view")


def test_search_rows_are_the_flat_collections(world, monkeypatch):
    "The tree walk finds what a linear scan of the same sketches finds."
    query = next(iter(load_file_as_index(str(world / "genome.sig")).signatures()))
    tree = torch_load_sbt(str(world / "db.sbt.zip"))
    flat = load_file_as_index(str(world / "coll.zip"))
    monkeypatch.setenv("SOURMASH_TORCH_FLAT_VIEW", "0")
    for containment in (False, True):
        got = [(r.score, r.signature.md5sum())
               for r in tree.search(query, threshold=0.05, do_containment=containment)]
        want = [(r.score, r.signature.md5sum())
                for r in flat.search(query, threshold=0.05, do_containment=containment)]
        assert sorted(got) == sorted(want) and len(got) > 1


def test_sbt_combine_is_identical(world, tmp_path, monkeypatch, capsys):
    def setup(out):
        for src in ("half_a.zip", "half_b.sig"):
            shutil.copy(world / src, out / src)

    files = _assert_same_files(_run_both(world, tmp_path, monkeypatch, lambda out: [
        ["index", "a.sbt.zip", "half_a.zip"],
        ["index", "b.sbt.zip", "half_b.sig"],
        ["sbt_combine", "ab.sbt.zip", "a.sbt.zip", "b.sbt.zip"],
    ], setup=setup))
    assert "ab.sbt.zip" in files
    assert len(torch_load_sbt(str(tmp_path / "torch" / "ab.sbt.zip"))) == N_SKETCHES
    capsys.readouterr()


@pytest.mark.parametrize("tree", ["db.sbt.zip", "db.sbt.json"])
def test_migrate_is_identical(world, tree, tmp_path, monkeypatch, capsys):
    def setup(out):
        if tree.endswith(".zip"):
            shutil.copy(world / tree, out / tree)
        else:
            shutil.copy(world / tree, out / tree)
            shutil.copytree(world / ".sbt.db", out / ".sbt.db")

    _assert_same_files(_run_both(world, tmp_path, monkeypatch,
                                 lambda out: [["migrate", tree]], setup=setup))
    capsys.readouterr()


@pytest.mark.parametrize("tree", ["db.sbt.json", "db.sbt.zip"])
def test_storage_convert_to_zip_and_to_fs(world, tree, tmp_path, monkeypatch, capsys):
    """`storage convert` of a tree to a ZipStorage, then back to an FSStorage:
    the same files at each step in both packages, and the tree's sketches
    kept."""
    def setup(out):
        shutil.copy(world / tree, out / tree)
        if tree.endswith(".json"):
            shutil.copytree(world / ".sbt.db", out / ".sbt.db")

    steps = {}
    for backend in ('ZipStorage("nodes.zip")', "fs"):
        steps[backend] = _assert_same_files(_run_both(
            world, tmp_path / backend.split("(")[0], monkeypatch,
            lambda out: [["storage", "convert", "-b", 'ZipStorage("nodes.zip")', tree],
                         *([["storage", "convert", "-b", "fs", tree]]
                           if backend == "fs" else [])],
            setup=setup))
    if tree.endswith(".json"):
        assert "nodes.zip" in steps['ZipStorage("nodes.zip")']
        assert b'"ZipStorage"' in steps['ZipStorage("nodes.zip")'][tree]
        assert b'"FSStorage"' in steps["fs"][tree]
    tree_t = torch_load_sbt(str(tmp_path / "fs" / "torch" / tree))
    assert sorted(ss.md5sum() for ss in tree_t.signatures()) == \
        sorted(ss.md5sum() for ss in load_file_as_index(str(world / "coll.zip")).signatures())
    capsys.readouterr()


def test_mixed_ksizes_fail_alike(world, tmp_path, monkeypatch, capsys):
    capsys.readouterr()
    results = {}
    for tag, main in MAINS:
        out = tmp_path / tag
        out.mkdir()
        monkeypatch.chdir(out)
        with pytest.raises(SystemExit) as exc:
            main(["index", "db.sbt.zip", str(world / "genome.sig"), str(world / "k21.sig")])
        captured = capsys.readouterr()
        results[tag] = (exc.value.code, captured.out, captured.err.splitlines()[-3:])
        assert not os.path.exists(out / "db.sbt.zip")
    assert results["torch"] == results["jax"]
    assert results["torch"][0] == -1
    assert "multiple k-mer sizes" in "\n".join(results["torch"][2])
