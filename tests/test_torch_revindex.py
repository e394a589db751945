"""Disk revindexes (`sourmash index -F revindex`) in the port against the
JAX package, on the CPU (the port with SOURMASH_TORCH_DEVICE=cpu, its
kernels' plain versions):

- the files `index -F revindex` writes are byte-identical across the
  packages (`planes/*.npy`, `banks.json`, `hashes.npy`, `offsets.npy`,
  `revindex.json`), over several length classes and a sketch whose hashes
  spill past the planes' depth;
- a directory written by either package loads in the other, with the
  save-time dataset order, and v1 and v2 directories load too;
- `gather`, `search` and `prefetch` against a revindex directory write the
  same CSV and stdout in both packages;
- the resident route (raw mins packed for the device) and the disk-plane
  route (mmapped planes streamed per pass, SOURMASH_TORCH_GPU_BUDGET_BYTES
  below their bytes) give the same counts and gather CSV, and each place
  that uploads a streamed chunk (counts, cutoff counts, block counts,
  membership) takes the read-only mmapped planes;
- `update_revindex` (the processed md5 list, skipping what is already in)
  and `select`.
"""

import json
import os
import shutil

import numpy as np
import pytest

import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.index import revindex as jax_rev
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.index import revindex as torch_rev
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation, load_file_as_index

SCALED = 1000
MAX_HASH = (1 << 64) // SCALED
BUDGET = "SOURMASH_TORCH_GPU_BUDGET_BYTES"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "_torch_viewcache"))


def _sketches(rng, n):
    "n sketches in clades of 1-8 sharing 50-95 % of a core, 60-2,400 hashes."
    mins = []
    while len(mins) < n:
        top = int(rng.choice([150, 700, 2400]))
        core = np.unique(rng.integers(0, MAX_HASH, size=top, dtype=np.uint64))
        for _ in range(int(rng.integers(1, 9))):
            size = int(rng.integers(top // 2 - 15, top + 1))
            kept = rng.permutation(core)[: int(size * rng.uniform(0.5, 0.95))]
            own = rng.integers(0, MAX_HASH, size=size - len(kept), dtype=np.uint64)
            mins.append(np.unique(np.concatenate([kept, own])))
    return mins[:n]


def _sig(mins, name, abunds=None):
    params = dict(ksize=31, moltype="DNA", num=0, scaled=SCALED, seed=42,
                  track_abundance=abunds is not None)
    return sourmash_tpu_torch.signature_from_arrays(params, mins, abunds, name=name,
                                                    filename=f"{name}.fa.gz")


def _save(path, sigs):
    with SaveSignaturesToLocation(str(path)) as save:
        for ss in sigs:
            save.add(ss)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A zip of 200 sketches in several length classes, one of them 40
    hashes in one bucket (past the planes' depth: spills), a second zip of
    30 more (10 of them duplicates of the first), a metagenome query with
    abundances and a genome query; and one revindex directory written by
    each package. (A FlatIndex is the device engine at any size.)"""
    rng = np.random.default_rng(1442)
    d = tmp_path_factory.mktemp("revindex")
    mins = _sketches(rng, 199)
    spill = np.unique((rng.integers(0, MAX_HASH >> 12, size=40, dtype=np.uint64)
                       << np.uint64(12)) | np.uint64(7))
    mins.insert(100, spill)
    sigs = [_sig(m, f"genome_{i}") for i, m in enumerate(mins)]
    _save(d / "db.zip", sigs)
    extra = [_sig(m, f"extra_{i}") for i, m in enumerate(_sketches(rng, 20))] + sigs[:10]
    _save(d / "extra.zip", extra)
    pick = [mins[i][rng.random(len(mins[i])) < rng.uniform(0.4, 1.0)]
            for i in rng.choice(len(mins), size=12, replace=False)]
    q = np.unique(np.concatenate(pick + [spill, rng.integers(0, MAX_HASH, size=500,
                                                             dtype=np.uint64)]))
    _save(d / "meta.sig", [_sig(q, "metagenome", rng.integers(1, 40, size=len(q)))])
    _save(d / "genome.sig", [_sig(mins[17], "genome query")])
    cwd = os.getcwd()
    os.chdir(d)
    try:
        os.environ["SOURMASH_TORCH_DEVICE"] = "cpu"
        for tag, main in (("jax", jax_main), ("torch", torch_main)):
            assert main(["index", "-F", "revindex", f"rev_{tag}", "db.zip"]) in (None, 0)
    finally:
        os.environ.pop("SOURMASH_TORCH_DEVICE", None)
        os.chdir(cwd)
    return d


def _files(root):
    return sorted(os.path.relpath(os.path.join(p, f), root)
                  for p, _dirs, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("part", ["planes", "hashes.npy", "offsets.npy", "revindex.json"])
def test_index_files_are_byte_identical(world, part):
    "Every file of the planes (npy planes, banks.json) and of the header."
    a, b = world / "rev_jax", world / "rev_torch"
    assert _files(a) == _files(b)
    names = [f for f in _files(a) if f.startswith(part)]
    if part == "planes":
        names = [f for f in names if not f.endswith(".npz")]  # npz: zip members' mtimes
        meta = json.loads((a / "planes" / "banks.json").read_text())
        assert len(meta["banks"]) >= 4 and any(c["spilled"] for b_ in meta["banks"]
                                               for c in b_["chunks"])
        for name in names:
            if name.endswith("_hi.npy") or name.endswith("_lo.npy"):
                assert np.load(a / name).dtype == np.uint32
            elif name.endswith("_cnt.npy"):
                assert np.load(a / name).dtype == np.uint8
        # the spill lists themselves are equal
        for name in (f for f in _files(a) if f.endswith(".npz")):
            za, zb = np.load(a / name), np.load(b / name)
            for key in ("rows", "lens", "vals"):
                assert np.array_equal(za[key], zb[key]) and za[key].dtype == zb[key].dtype
    assert names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_directories_load_in_either_package(world, writer, monkeypatch):
    """Each package loads the other's directory: the same signatures in the
    save-time order, the same raw mins and the same counts."""
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    path = str(world / f"rev_{writer}")
    a, b = jax_rev.load_revindex(path), torch_rev.load_revindex(path)
    assert [s.md5sum() for s in a.signatures()] == [s.md5sum() for s in b.signatures()]
    assert [s.name for s in a.signatures()] == [s.name for s in b.signatures()]
    assert b._scaled == a._scaled == SCALED and b._banks_dir == os.path.join(path, "planes")
    for ma, mb in zip(a._ds_mins, b._ds_mins):
        assert np.array_equal(ma, mb)
    q = load_file_as_index(str(world / "meta.sig"))
    qm = next(iter(q.signatures())).minhash.mins_array()
    assert np.array_equal(a.counts_for(qm), b.counts_for(qm))
    assert b.counts_for(qm).max() > 50


CLI_CASES = {
    "gather": ("gather", "meta.sig", []),
    "gather, --threshold-bp, saved matches": (
        "gather", "meta.sig", ["--threshold-bp", "20000", "--save-matches", "{out}/m.zip"]),
    "search": ("search", "genome.sig", []),
    "search --containment": ("search", "genome.sig", ["--containment", "-n", "5"]),
    "prefetch": ("prefetch", "meta.sig", ["--save-matching-hashes", "{out}/k.sig"]),
}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_against_revindex_is_byte_identical(world, case, writer, tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(world)
    cmd, query, flags = CLI_CASES[case]
    outputs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / tag
        out.mkdir()
        try:
            rc = main([cmd, query, f"rev_{writer}", "-o", str(out / "out.csv"),
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


def test_resident_and_disk_plane_routes_agree(world, tmp_path, monkeypatch, capsys):
    """The same directory through both routes: raw mins packed for the
    device (the budget fits) and mmapped planes streamed per pass (the
    budget below the planes' bytes): equal counts, cutoff counts and gather
    CSV, and the second route really holds the disk planes."""
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(world)
    q = next(iter(load_file_as_index("meta.sig").signatures())).minhash.mins_array()
    got = {}
    for route, budget in (("resident", None), ("disk planes", "1")):
        if budget is None:
            monkeypatch.delenv(BUDGET, raising=False)
        else:
            monkeypatch.setenv(BUDGET, budget)
        idx = torch_rev.load_revindex("rev_jax")
        counts = idx.counts_for(q)
        chunks = [c for b in idx._banks for c in b.chunks]
        if route == "resident":
            assert all(c.resident for c in chunks)
        else:
            assert not any(c.resident for c in chunks)
            assert all(isinstance(c.hi, np.memmap) and c.raw is None for c in chunks)
        out = tmp_path / route.replace(" ", "_")
        assert torch_main(["gather", "meta.sig", "rev_jax", "-o", str(out)]) in (None, 0)
        got[route] = (counts, out.read_bytes())
    capsys.readouterr()
    assert np.array_equal(got["resident"][0], got["disk planes"][0])
    assert got["resident"][1] == got["disk planes"][1]
    want = jax_rev.load_revindex(str(world / "rev_jax")).counts_for(q)
    assert np.array_equal(got["resident"][0], want)


@pytest.mark.parametrize("site", ["counts", "cutoff counts", "block counts", "membership"])
def test_mmapped_plane_sites_agree(world, site, monkeypatch):
    """Each place that uploads a streamed chunk's planes takes the
    directory's read-only mmapped planes (chunks without raw limb rows) and
    gives what the resident banks give."""
    from sourmash_tpu_torch.ops import index_ops

    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    metas = [next(iter(load_file_as_index(str(world / n)).signatures())).minhash.mins_array()
             for n in ("meta.sig", "genome.sig")]
    got = {}
    for route, budget in (("resident", None), ("disk planes", "1")):
        if budget is None:
            monkeypatch.delenv(BUDGET, raising=False)
        else:
            monkeypatch.setenv(BUDGET, budget)
        idx = torch_rev.load_revindex(str(world / "rev_torch"))
        idx._build()
        banks, n = idx._banks, len(idx)
        if route == "disk planes":
            assert all(isinstance(c.hi, np.memmap) and not c.hi.flags.writeable and c.raw is None
                       for b in banks for c in b.chunks)
        q = metas[0]
        if site == "counts":
            got[route] = index_ops.counts_for_banks(banks, q, n)
        elif site == "cutoff counts":
            cuts = np.full(n, np.uint64(MAX_HASH // 3))
            cuts[::2] = np.uint64(MAX_HASH)
            got[route] = index_ops.cutoff_counts_for_banks(banks, q, cuts, n)
        elif site == "block counts":
            got[route] = index_ops.counts_for_banks_batch(banks, metas, n, block=2)
        else:
            ids = np.flatnonzero(index_ops.counts_for_banks(banks, q, n))[:50]
            got[route] = [(int(b.B), [int(i) for i in sel], M.cpu().numpy())
                          for b, _qp, sel, M in index_ops.membership_for_banks(banks, q, ids)]
    if site == "membership":
        assert len(got["resident"]) == len(got["disk planes"]) > 0
        for a, b in zip(got["resident"], got["disk planes"]):
            assert a[:2] == b[:2] and np.array_equal(a[2], b[2])
    else:
        assert np.array_equal(got["resident"], got["disk planes"])
        assert got["resident"].max() > 0


def test_v1_and_v2_directories_load(world, tmp_path, monkeypatch):
    """A v2 directory (no planes/) and a v1 directory (hashes sorted
    globally, a parallel datasets.npy) load to the same mins and counts."""
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    v2 = tmp_path / "v2"
    shutil.copytree(world / "rev_jax", v2)
    shutil.rmtree(v2 / "planes")
    v1 = tmp_path / "v1"
    shutil.copytree(v2, v1)
    H = np.load(v1 / "hashes.npy")
    offs = np.load(v1 / "offsets.npy")
    D = np.repeat(np.arange(len(offs) - 1), np.diff(offs))
    order = np.argsort(H, kind="stable")
    np.save(v1 / "hashes.npy", H[order])
    np.save(v1 / "datasets.npy", D[order])
    os.unlink(v1 / "offsets.npy")
    q = next(iter(load_file_as_index(str(world / "meta.sig")).signatures())).minhash.mins_array()
    ref = torch_rev.load_revindex(str(world / "rev_jax"))
    for path in (v2, v1):
        idx = torch_rev.load_revindex(str(path))
        assert idx._banks_dir is None
        for a, b in zip(ref._ds_mins, idx._ds_mins):
            assert np.array_equal(a, b)
        assert np.array_equal(idx.counts_for(q), ref.counts_for(q))
        jidx = jax_rev.load_revindex(str(path))
        assert np.array_equal(jidx.counts_for(q), ref.counts_for(q))


def test_update_revindex_and_select(world, tmp_path, monkeypatch):
    """update_revindex adds only signatures whose md5 is not processed yet,
    in both packages to byte-identical files; select keeps the order."""
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    extra = list(load_file_as_index(str(world / "extra.zip")).signatures())
    paths = {}
    for tag, rev in (("jax", jax_rev), ("torch", torch_rev)):
        path = tmp_path / tag
        shutil.copytree(world / "rev_jax", path)
        if tag == "jax":
            import sourmash_tpu

            new = list(sourmash_tpu.load_file_as_signatures(str(world / "extra.zip")))
        else:
            new = extra
        idx, added = rev.update_revindex(str(path), new)
        assert added == 20
        assert len(idx) == 220
        again, added = rev.update_revindex(str(path), new)
        assert added == 0 and len(again) == 220
        paths[tag] = path
    for name in ("revindex.json", "hashes.npy", "offsets.npy", "planes/banks.json"):
        assert (paths["jax"] / name).read_bytes() == (paths["torch"] / name).read_bytes(), name
    header = json.loads((paths["torch"] / "revindex.json").read_text())
    assert header["processed"] == sorted(header["processed"]) and len(header["processed"]) == 220
    assert header["format"] == torch_rev.FORMAT_NAME and header["version"] == 3

    idx = torch_rev.load_revindex(str(paths["torch"]))
    sel = idx.select(ksize=31, moltype="DNA", containment=True)
    assert isinstance(sel, torch_rev.RevIndex) and len(sel) == 220
    assert [s.md5sum() for s in sel.signatures()] == [s.md5sum() for s in idx.signatures()]
    assert len(idx.select(ksize=21)) == 0
    assert sel.scaled == SCALED
