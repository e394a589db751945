"""The port's flat-view sidecar cache (`index/view_cache.py`) on the CPU,
against the JAX package's:

- a warm load rebuilds the same signatures (md5, mins, abundances, name and
  filename None-ness) as the cold one, and the same gather CSV, for zips
  and standalone manifests; its keys are the JAX package's;
- a rewritten zip or member file misses; SOURMASH_TORCH_VIEW_CACHE=0
  disables the cache; a corrupt entry is a miss that re-reads the
  collection; the byte budget evicts the oldest entries;
- entries of all four moltypes, with and without abundances, round-trip,
  and hold the JAX package's arrays;
- a revindex directory's sigs.zip loads through the cache: the second
  load is a hit with the same signatures in the save-time order.
"""

import os

import numpy as np
import pytest

import sourmash_tpu_torch
from sourmash_tpu.index import view_cache as jax_vc
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.index import ZipFileLinearIndex, StandaloneManifestIndex
from sourmash_tpu_torch.index import view_cache
from sourmash_tpu_torch.manifest import CollectionManifest
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation


@pytest.fixture(autouse=True)
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "vc"))
    monkeypatch.setenv("SOURMASH_TPU_VIEW_CACHE_DIR", str(tmp_path / "vc_jax"))
    monkeypatch.setenv("SOURMASH_TORCH_FLAT_VIEW", "1")  # any size takes the view
    monkeypatch.delenv("SOURMASH_TORCH_VIEW_CACHE", raising=False)
    monkeypatch.delenv("SOURMASH_TORCH_VIEW_CACHE_BYTES", raising=False)
    view_cache.reset_stats()
    return tmp_path


def _mk(mins, name, abunds=None, filename=None, moltype="DNA", ksize=31, scaled=1000):
    params = dict(ksize=ksize, moltype=moltype, num=0, scaled=scaled, seed=42,
                  track_abundance=abunds is not None)
    sig = sourmash_tpu_torch.signature_from_arrays(params, mins, abunds, name=name or "",
                                                   filename=filename or "")
    sig._name = name
    sig._filename = filename
    return sig


def _write(path, sigs):
    with SaveSignaturesToLocation(str(path)) as save:
        for s in sigs:
            save.add(s)


def _collection(rng, n=12):
    sigs = []
    for i in range(n):
        mins = np.unique(rng.integers(0, (1 << 64) // 1000, 80, dtype=np.uint64))
        ab = rng.integers(1, 9, size=len(mins)) if i % 3 == 0 else None
        sigs.append(_mk(mins, f"s{i}" if i != 5 else None, ab,
                        filename=f"f{i}.fa" if i % 2 else None))
    return sigs


def _same_sigs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.md5sum() == y.md5sum()
        assert (x._name, x._filename) == (y._name, y._filename)
        assert np.array_equal(x.minhash.mins_array(), y.minhash.mins_array())
        if x.minhash.track_abundance:
            assert np.array_equal(x.minhash.abunds_array(), y.minhash.abunds_array())


def _entries(cache_env):
    d = cache_env / "vc"
    return sorted(os.listdir(d)) if d.exists() else []


def test_warm_zip_view_equals_cold(cache_env, capsys, monkeypatch):
    """The first load stores one entry (a miss), a fresh index on the same
    zip hits it: equal signatures, locations and gather CSV; the key is
    the JAX package's for the same rows."""
    rng = np.random.default_rng(1)
    sigs = _collection(rng)
    zpath = cache_env / "db.zip"
    _write(zpath, sigs)
    cold = ZipFileLinearIndex.load(str(zpath))._as_flat_view()
    assert view_cache.STATS["misses"] == 1 and len(_entries(cache_env)) == 1
    warm = ZipFileLinearIndex.load(str(zpath))._as_flat_view()
    assert view_cache.STATS["hits"] == 1 and view_cache.STATS["bytes_read"] > 0
    _same_sigs(cold._signatures, warm._signatures)
    assert warm._locations == [str(zpath)] * len(sigs)
    rows = ZipFileLinearIndex.load(str(zpath)).manifest.rows
    assert view_cache.collection_cache_key(str(zpath), rows) == jax_vc.collection_cache_key(
        str(zpath), rows) is not None

    # gather with the cache warm, cold and disabled: one CSV
    q = np.unique(np.concatenate([s.minhash.mins_array()[:60] for s in sigs[:6]]))
    _write(cache_env / "q.sig", [_mk(q, "q")])
    monkeypatch.chdir(cache_env)
    csvs = []
    for env in ("1", "1", "0"):
        monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE", env)
        out = cache_env / f"g{len(csvs)}.csv"
        assert torch_main(["gather", "q.sig", "db.zip", "-o", str(out),
                           "--threshold-bp", "10000"]) in (None, 0)
        csvs.append(out.read_bytes())
    capsys.readouterr()
    assert csvs[0] == csvs[1] == csvs[2] and csvs[0].count(b"\n") > 3


def test_rewritten_zip_misses(cache_env):
    "Rewriting the zip (another size and mtime) is a miss and a new entry."
    rng = np.random.default_rng(2)
    zpath = cache_env / "db.zip"
    _write(zpath, _collection(rng))
    ZipFileLinearIndex.load(str(zpath))._as_flat_view()
    os.unlink(zpath)
    more = _collection(rng, 13)
    _write(zpath, more)
    st = os.stat(zpath)
    os.utime(zpath, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    view = ZipFileLinearIndex.load(str(zpath))._as_flat_view()
    assert view_cache.STATS == dict(hits=0, misses=2, bytes_read=0,
                                    bytes_written=view_cache.STATS["bytes_written"])
    assert len(_entries(cache_env)) == 2
    _same_sigs(view._signatures, ZipFileLinearIndex.load(str(zpath))._as_flat_view()._signatures)
    assert len(view) == 13


def test_cache_disabled(cache_env, monkeypatch):
    "SOURMASH_TORCH_VIEW_CACHE=0: no key, no entry, the view all the same."
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE", "0")
    zpath = cache_env / "db.zip"
    _write(zpath, _collection(np.random.default_rng(3)))
    idx = ZipFileLinearIndex.load(str(zpath))
    assert view_cache.collection_cache_key(str(zpath), idx.manifest.rows) is None
    assert len(idx._as_flat_view()) == 12
    assert _entries(cache_env) == [] and view_cache.STATS["misses"] == 0


@pytest.mark.parametrize("damage", ["garbage", "truncated", "wrong counts"])
def test_corrupt_entry_is_a_miss(cache_env, damage):
    "A damaged entry is a miss: the view is read from the zip again."
    rng = np.random.default_rng(4)
    sigs = _collection(rng)
    zpath = cache_env / "db.zip"
    _write(zpath, sigs)
    ZipFileLinearIndex.load(str(zpath))._as_flat_view()
    (entry,) = _entries(cache_env)
    path = cache_env / "vc" / entry
    if damage == "garbage":
        path.write_bytes(b"not an npz")
    elif damage == "truncated":
        path.write_bytes(path.read_bytes()[:200])
    else:
        with np.load(path) as z:
            arrays = dict(z)
        arrays["num"] = arrays["num"][:-1]
        with open(path, "wb") as fp:
            np.savez(fp, **arrays)
    view_cache.reset_stats()
    view = ZipFileLinearIndex.load(str(zpath))._as_flat_view()
    assert view_cache.STATS["hits"] == 0 and view_cache.STATS["misses"] == 1
    _same_sigs([s for s in view._signatures], [s.to_frozen() for s in
                                               ZipFileLinearIndex.load(str(zpath)).signatures()])


def test_standalone_manifest_cache(cache_env):
    """A standalone manifest's view is cached with per-signature locations;
    editing a member file misses."""
    rng = np.random.default_rng(6)
    sigs = _collection(rng)
    rows = []
    for part in range(3):
        name = f"part{part}.zip"
        _write(cache_env / name, sigs[4 * part : 4 * part + 4])
        rows += [CollectionManifest.make_manifest_row(s, name, include_signature=False)
                 for s in sigs[4 * part : 4 * part + 4]]
    CollectionManifest(rows).write_to_filename(str(cache_env / "mf.csv"))
    cold = StandaloneManifestIndex.load(str(cache_env / "mf.csv"))._as_flat_view()
    warm = StandaloneManifestIndex.load(str(cache_env / "mf.csv"))._as_flat_view()
    assert view_cache.STATS["misses"] == 1 and view_cache.STATS["hits"] == 1
    _same_sigs(cold._signatures, warm._signatures)
    assert warm._locations == cold._locations == [
        str(cache_env / f"part{i // 4}.zip") for i in range(12)]
    st = os.stat(cache_env / "part1.zip")
    os.utime(cache_env / "part1.zip", ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    StandaloneManifestIndex.load(str(cache_env / "mf.csv"))._as_flat_view()
    assert view_cache.STATS["misses"] == 2


def test_eviction_budget(cache_env, monkeypatch):
    "A budget of one byte keeps at most the entry just written."
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_BYTES", "1")
    rng = np.random.default_rng(5)
    for j in range(3):
        zpath = cache_env / f"db{j}.zip"
        _write(zpath, _collection(rng, 3))
        ZipFileLinearIndex.load(str(zpath))._as_flat_view()
    assert len(_entries(cache_env)) <= 1
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_BYTES", "1e9")
    for j in range(3):
        ZipFileLinearIndex.load(str(cache_env / f"db{j}.zip"))._as_flat_view()
    assert len(_entries(cache_env)) == 3


def test_payload_roundtrip_all_moltypes(cache_env):
    """store/load rebuild every sketch flavour bit-identically, and the
    port's entry holds the arrays the JAX package's does."""
    import sourmash_tpu

    rng = np.random.default_rng(7)
    sigs, jsigs = [], []
    for moltype in ("DNA", "protein", "dayhoff", "hp"):
        for track in (False, True):
            mins = np.unique(rng.integers(0, 2**55, 30, dtype=np.uint64))
            ab = (mins % np.uint64(11) + np.uint64(1)).astype(np.int64) if track else None
            ksize = 33 if moltype == "DNA" else 11
            sigs.append(_mk(mins, f"{moltype}-{track}", ab, moltype=moltype, ksize=ksize,
                            scaled=200))
            mh = sourmash_tpu.MinHash(n=0, ksize=ksize, scaled=200, track_abundance=track,
                                      is_protein=moltype == "protein",
                                      dayhoff=moltype == "dayhoff", hp=moltype == "hp")
            if track:
                mh.set_abundances({int(m): int(a) for m, a in zip(mins, ab)})
            else:
                mh.add_many(mins)
            jsigs.append(sourmash_tpu.SourmashSignature(mh, name=f"{moltype}-{track}"))
    key = "k" * 64
    assert view_cache.store(key, sigs)
    got, locs = view_cache.load(key)
    assert locs is None
    _same_sigs(sigs, got)
    for a, b in zip(sigs, got):
        assert (a.minhash.moltype, a.minhash.ksize, a.minhash.scaled, a.minhash.seed) == (
            b.minhash.moltype, b.minhash.ksize, b.minhash.scaled, b.minhash.seed)
        assert a == b
    assert jax_vc.store(key, jsigs)
    with np.load(cache_env / "vc" / f"{key}.npz") as t, \
            np.load(cache_env / "vc_jax" / f"{key}.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for name in t.files:
            assert t[name].dtype == j[name].dtype and np.array_equal(t[name], j[name]), name


def test_revindex_signatures_come_through_the_cache(cache_env):
    "The second load of a revindex directory reads its signatures from the cache."
    from sourmash_tpu_torch.index.flat import FlatIndex
    from sourmash_tpu_torch.index.revindex import load_revindex, save_revindex

    sigs = [s for s in _collection(np.random.default_rng(8)) if not s.minhash.track_abundance]
    path = str(cache_env / "rev")
    save_revindex(FlatIndex(sigs), path)
    cold = load_revindex(path)
    assert view_cache.STATS["misses"] == 1 and view_cache.STATS["hits"] == 0
    warm = load_revindex(path)
    assert view_cache.STATS["hits"] == 1
    _same_sigs(list(cold.signatures()), list(warm.signatures()))
    assert [s.md5sum() for s in warm.signatures()] == [s.md5sum() for s in sigs]
    q = sigs[2].minhash.mins_array()
    assert np.array_equal(cold.counts_for(q), warm.counts_for(q))
