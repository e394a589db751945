"""`search`, `prefetch` and `multigather` through both packages'
`__main__.main` on generated collections, on the CPU (the port with
SOURMASH_TORCH_DEVICE=cpu, so its kernels run their plain versions):
stdout and every written file must be byte-identical.

Collections: a zip of 530 sketches (above the 512-signature flat-view
threshold, so the device engine runs) and one of 150 (below it, the host
path), flat and with abundances. Queries: a genome of the collection, a
metagenome mix with abundances and samples of a few genomes each.

Then the batched multigather schedules on the library level: with device
membership forced, `compute_schedules_batch` and `converge_schedules_batch`
(also under a candidate cap of 6, which forces convergence iterations)
give every query the rounds of its own schedule and of host rounds, and
`warm_gather_counts` answers every counter's counts from its cache.
"""

import os

import numpy as np
import pytest

import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.index import flat as tflat
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

SCALED = 1000
BIG, SMALL = 530, 150


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


def _mix(rng, colls, n_genomes, n_fresh):
    "Parts of n_genomes random sketches of the collections plus fresh hashes."
    pick = []
    for coll in colls:
        for i in rng.choice(len(coll), size=n_genomes, replace=False):
            m = coll[i]
            pick.append(m[rng.random(len(m)) < rng.uniform(0.4, 1.0)])
    fresh = rng.integers(0, (1 << 64) // SCALED, size=n_fresh, dtype=np.uint64)
    return np.unique(np.concatenate(pick + [fresh]))


@pytest.fixture(autouse=True)
def _view_cache(monkeypatch, tmp_path_factory):
    "The port's flat-view cache in a directory of the test's own, outside its tmp_path."
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path_factory.mktemp("viewcache")))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(2027)
    d = tmp_path_factory.mktemp("search")
    big, small = _sketches(rng, BIG), _sketches(rng, SMALL)
    _save(str(d / "big.zip"), [_sig(m, f"big_{i}") for i, m in enumerate(big)])
    _save(str(d / "small.zip"), [_sig(m, f"small_{i}") for i, m in enumerate(small)])
    _save(str(d / "big_abund.zip"), [_sig(m, f"ab_{i}", rng.integers(1, 20, size=len(m)))
                                     for i, m in enumerate(big)])
    (d / "dbs.txt").write_text("big.zip\nsmall.zip\n")
    # a genome of a clade as the search query, with and without abundances
    g = big[7]
    _save(str(d / "genome.sig"), [_sig(g, "genome")])
    _save(str(d / "genome_small.sig"), [_sig(small[4], "small genome")])
    _save(str(d / "genome_abund.sig"), [_sig(g, "genome abund", rng.integers(1, 20, size=len(g)))])
    q = _mix(rng, [big, small], 12, 2000)
    _save(str(d / "meta.sig"), [_sig(q, "metagenome", rng.integers(1, 51, size=len(q)))])
    samples = []
    for i in range(5):
        s = _mix(rng, [big, small], int(rng.integers(2, 6)), 300)
        ab = rng.integers(1, 30, size=len(s)) if i % 2 else None
        path = d / f"sample{i}.sig"
        _save(str(path), [_sig(s, f"sample {i}", ab)])
        samples.append(path.name)
    (d / "samples.txt").write_text("\n".join(samples[3:]) + "\n")
    return d


SEARCH = {
    "jaccard above": ("genome.sig", ["big.zip"], []),
    "jaccard below, -n 0": ("genome_small.sig", ["small.zip"], ["-n", "0", "-t", "0.01"]),
    "containment above": ("genome.sig", ["big.zip"], ["--containment", "-n", "5"]),
    "containment below": ("genome_small.sig", ["small.zip"], ["--containment", "-t", "0.02"]),
    "max-containment above, saved matches": (
        "genome.sig", ["big.zip"], ["--max-containment", "--save-matches", "{out}/m.zip"]),
    "best-only, both": ("genome.sig", ["big.zip", "small.zip"], ["--best-only"]),
    "abundance query above": ("genome_abund.sig", ["big_abund.zip"], ["-n", "4"]),
    "ignore-abundance above, --scaled": (
        "genome_abund.sig", ["big.zip"], ["--ignore-abundance", "--scaled", "2000"]),
}

PREFETCH = {
    "above, every output": ("meta.sig", ["big.zip"], [
        "--save-matches", "{out}/m.zip", "--save-matching-hashes", "{out}/k.sig",
        "--save-unmatched-hashes", "{out}/u.sig"]),
    "below, --scaled": ("meta.sig", ["small.zip"], [
        "--scaled", "2000", "--save-unmatched-hashes", "{out}/u.sig"]),
    "above, --linear": ("meta.sig", ["big.zip"], ["--linear", "--threshold-bp", "100000"]),
    "--db-from-file, both": ("meta.sig", [], ["--db-from-file", "dbs.txt",
                                              "--save-matching-hashes", "{out}/k.sig"]),
}

MULTIGATHER = {
    "above": (["--query", "sample0.sig", "sample1.sig", "sample2.sig", "--db", "big.zip"]),
    "below, -U": (["--query", "sample0.sig", "sample3.sig", "--db", "small.zip", "-U"]),
    "both, --query-from-file": (
        ["--query", "sample2.sig", "--query-from-file", "samples.txt",
         "--db", "big.zip", "small.zip"]),
}


def _run_both(world, tmp_path, capsys, monkeypatch, argv_of):
    "Run argv_of(out_dir) through both packages; return their (stdout, files)."
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(world)
    outputs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / tag
        out.mkdir()
        assert main(argv_of(out)) in (None, 0)
        files = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
        outputs[tag] = (capsys.readouterr().out, files)
    (jax_out, jax_files), (torch_out, torch_files) = outputs["jax"], outputs["torch"]
    assert torch_out == jax_out
    assert sorted(torch_files) == sorted(jax_files)
    for name in jax_files:
        assert torch_files[name] == jax_files[name], name
    return torch_out, torch_files


@pytest.mark.parametrize("case", list(SEARCH))
def test_search_outputs_are_byte_identical(world, case, tmp_path, capsys, monkeypatch):
    query, dbs, flags = SEARCH[case]
    out, files = _run_both(world, tmp_path, capsys, monkeypatch, lambda d: [
        "search", query, *dbs, "-o", str(d / "search.csv"), *(f.format(out=d) for f in flags)])
    assert "similarity   match" in out
    assert files["search.csv"].count(b"\n") > 1


@pytest.mark.parametrize("case", list(PREFETCH))
def test_prefetch_outputs_are_byte_identical(world, case, tmp_path, capsys, monkeypatch):
    query, dbs, flags = PREFETCH[case]
    _out, files = _run_both(world, tmp_path, capsys, monkeypatch, lambda d: [
        "prefetch", query, *dbs, "-o", str(d / "prefetch.csv"),
        *(f.format(out=d) for f in flags)])
    assert files["prefetch.csv"].count(b"\n") > 2


@pytest.mark.parametrize("case", list(MULTIGATHER))
def test_multigather_outputs_are_byte_identical(world, case, tmp_path, capsys, monkeypatch):
    argv = MULTIGATHER[case]
    out, files = _run_both(world, tmp_path, capsys, monkeypatch, lambda d: [
        "multigather", *argv, "--output-dir", str(d)])
    csvs = [f for f in files if f.endswith(".csv")]
    assert len(csvs) >= 2 and all(files[f].count(b"\n") > 1 for f in csvs)
    assert "found" in out


def test_multigather_batches_samples_with_abundances(world, tmp_path, monkeypatch):
    """Every sample above the flat-view threshold, with abundances or not,
    gets its counts from the warm cache and its schedule from the batched
    phase (sourmash_tpu's batched phase drops samples with abundances:
    their sweep fails and the output loop redoes them one by one)."""
    from sourmash_tpu_torch import commands

    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(world)
    seen, views = [], []
    converge, warm = tflat.converge_schedules_batch, tflat.FlatIndex.warm_gather_counts
    monkeypatch.setattr(tflat, "converge_schedules_batch",
                        lambda coords, *a, **kw: seen.extend(coords) or converge(coords, *a, **kw))
    monkeypatch.setattr(tflat.FlatIndex, "warm_gather_counts",
                        lambda self, *a, **kw: views.append(self) or warm(self, *a, **kw))
    sweeps = []  # one per sample: none is swept again by the output loop
    init = commands._PrefetchSweep.__init__
    monkeypatch.setattr(commands._PrefetchSweep, "__init__",
                        lambda self, *a: sweeps.append(1) or init(self, *a))
    samples = [f"sample{i}.sig" for i in range(5)]
    assert torch_main(["multigather", "--query", *samples, "--db", "big.zip",
                       "--output-dir", str(tmp_path), "-q"]) in (None, 0)
    assert len(seen) == len(samples) and len(sweeps) == len(samples)
    assert views[0].counts_cache_hits == len(samples)


def test_multigather_batched_phase_errors_propagate(world, tmp_path, monkeypatch):
    """An error of the batched phase other than a sweep's ValueError (a
    kernel launch failing, say) stops multigather before any output is
    written: the output loop would sweep that sample again and succeed,
    and the fault would not show."""
    from sourmash_tpu_torch import commands

    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(world)

    sweep_one, calls = commands._PrefetchSweep.sweep_one, []

    def fail_once(self, db, **kw):  # the output loop's sweeps would succeed
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return sweep_one(self, db, **kw)

    monkeypatch.setattr(commands._PrefetchSweep, "sweep_one", fail_once)
    with pytest.raises(RuntimeError, match="launch failure"):
        torch_main(["multigather", "--query", "sample0.sig", "sample1.sig", "--db", "big.zip",
                    "--output-dir", str(tmp_path), "-q"])
    assert not list(tmp_path.iterdir())


def test_multigather_negative_threshold_fails_alike(world, tmp_path, capsys, monkeypatch):
    """The one error other than a ValueError that a sweep raises from its
    inputs: a negative --threshold-bp. The port fails in its batched phase,
    sourmash_tpu in its output loop's rerun of the first sample; both with
    the same TypeError, the same stdout and no file written."""
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(world)
    outs = []
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / tag
        out.mkdir()
        with pytest.raises(TypeError, match="threshold_bp must be non-negative"):
            main(["multigather", "--query", "sample0.sig", "sample1.sig", "--db", "big.zip",
                  "--output-dir", str(out), "--threshold-bp", "-1"])
        assert not list(out.iterdir())
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


# -- batched schedules on the library level -----------------------------------


def _rounds(counter, qsig, threshold_bp):
    from sourmash_tpu_torch.search import GatherDatabases

    return [(r.match.name, r.intersect_bp)
            for r in GatherDatabases(qsig, [counter], threshold_bp=threshold_bp)]


@pytest.fixture(scope="module")
def library():
    """A collection of 600 sketches (some holding 2^64-1), and 7 samples of
    parts of 4-8 of them, half with a shared pool of hashes, all with the
    2^64-1 tail: sketches of the port and the host rounds of each."""
    from sourmash_tpu_torch import MinHash, SourmashSignature
    from sourmash_tpu_torch.index import CounterGather

    rng = np.random.default_rng(131)
    pool = np.unique(rng.integers(1, 2**63, size=500, dtype=np.uint64))
    genomes = []
    for i in range(600):
        own = np.unique(rng.integers(1, 2**63, size=int(rng.integers(200, 400)),
                                     dtype=np.uint64))
        g = np.unique(np.concatenate([own, rng.choice(pool, size=120, replace=False)]))
        if i % 9 == 0:
            g = np.unique(np.concatenate([g, [np.uint64(2**64 - 1)]]))
        genomes.append(g)

    def sig(m, name):
        mh = MinHash(0, 31, scaled=1)
        mh.add_many(m)
        return SourmashSignature(mh, name=name).to_frozen()

    sigs = [sig(g, f"g{i}") for i, g in enumerate(genomes)]
    queries = []
    for qi in range(7):
        srcs = rng.choice(600, size=int(rng.integers(4, 9)), replace=False)
        m = np.concatenate([genomes[i][rng.random(len(genomes[i])) < 0.8] for i in srcs]
                           + ([pool] if qi % 2 else []) + [[np.uint64(2**64 - 1)]])
        queries.append(sig(np.unique(m), f"meta{qi}"))
    host = []
    for q in queries:
        counter = CounterGather(q)
        for s in sigs:
            if s.minhash.count_common(q.minhash):
                counter.add(s)
        host.append(_rounds(counter, q, 0))
    return sigs, queries, host


@pytest.mark.parametrize("how", ["compute", "converge", "converge, cap 6"])
def test_batched_schedules_equal_per_query(library, how, monkeypatch):
    """Batched device-membership schedules (`_membership_rows_device_batch`
    taken) equal each coordinator's own compute() and host rounds, for
    queries whose candidates hold 2^64-1; a cap of 6 truncates them and
    converge_schedules_batch extends them in place."""
    sigs, queries, host = library
    monkeypatch.setenv(tflat.DEV_MEMBERSHIP_ENV, "1")
    if "cap" in how:
        monkeypatch.setenv(tflat.SCHEDULE_CAP_ENV, "6")
    seen = []
    orig = tflat._membership_rows_device_batch
    monkeypatch.setattr(tflat, "_membership_rows_device_batch",
                        lambda *a, **kw: seen.append(len(a[0])) or orig(*a, **kw))
    fi = tflat.FlatIndex(sigs, device="cpu")
    single = []
    for q in queries:
        coord = tflat.schedule_device_gather([fi.counter_gather(q, 0)])
        coord.compute(0)
        single.append(list(coord._sched))
    counters = [fi.counter_gather(q, 0) for q in queries]
    coords = [tflat.schedule_device_gather([c]) for c in counters]
    if how == "compute":
        tflat.compute_schedules_batch(coords, 0, block=4)
        for got, want in zip(coords, single):
            assert got.ready and got._sched == want
    else:
        tflat.converge_schedules_batch(coords, 0)
    assert seen and max(seen) > 1, "the batched device membership was not taken"
    if "cap" in how:
        assert all(c.reschedules > 0 for c in coords)
    for qi, q in enumerate(queries):
        assert _rounds(counters[qi], q, 0) == host[qi], qi
    assert sum(len(h) for h in host) >= 20


def test_warm_gather_counts_feeds_every_counter(library):
    """warm_gather_counts' rows are the counts counter_gather takes: one
    cache hit per query, counts equal to counts_for, and the cache empty
    after (each row is handed out once)."""
    sigs, queries, _host = library
    fi = tflat.FlatIndex(sigs, device="cpu")
    want = [fi.counter_gather(q, 0).counts.copy() for q in queries]
    fi.warm_gather_counts([q.minhash for q in queries], block=3)
    assert len(fi._counts_cache) == len(queries)
    got = [fi.counter_gather(q, 0).counts for q in queries]
    assert fi.counts_cache_hits == len(queries) and not fi._counts_cache
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
