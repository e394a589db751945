"""The generator: the same seed gives the same inputs, another seed other
contents at the same sizes."""

import gzip

import numpy as np

from perfbench.lib import traffic as T

COLL = dict(genomes=300, core_hashes=6000, clade_size=[1, 20], genome_hashes=[2000, 6000],
            core_share=[0.0, 0.2])
META = dict(size=dict(dist="log_uniform", min=3000, max=12000), abundance=[1, 50],
            kinds=[{"weight": 1.0, "from": "genomes", "share": 0.7, "keep": [0.4, 1.0]}])
GENOMES = dict(size=dict(dist="uniform", min=2000, max=6000), abundance=None,
               kinds=[{"weight": 0.5, "name": "strain", "from": "member", "keep": [0.5, 0.95]},
                      {"weight": 0.5, "name": "relative", "from": "member", "keep": [0.0, 0.2]}])
ASSEMBLIES = dict(pool=3, files_per_request=2, line_width=60,
                  length_bp=dict(dist="lognormal", median=40000, sigma=0.4, min=20000, max=80000),
                  contigs=dict(dist="log_uniform", min=1, max=5),
                  features=dict(n_runs_per_mbp=50, n_run_length=[10, 200], lowercase_per_mbp=40,
                                lowercase_length=[10, 500], repeats_per_mbp=100,
                                repeat_period=[1, 7], repeat_length=[20, 300]))
READS = dict(reads_bp=30000, read_length=150, genomes=3, abundance_sigma=1.0,
             genome_bp=dict(dist="lognormal", median=20000, sigma=0.4, min=10000, max=40000),
             substitution_rate=0.005, quality_mix=[0.85, 0.1, 0.04, 0.01], gzip_level=1)


def test_collection_deterministic_and_distinct():
    a, b = T.Collection(COLL, 2**40 + 7), T.Collection(COLL, 2**40 + 7)
    assert np.array_equal(a.hashes, b.hashes) and np.array_equal(a.offsets, b.offsets)
    c = T.Collection(COLL, 2**40 + 8)
    assert not np.array_equal(a.hashes[:100], c.hashes[:100])
    for i in range(a.n):
        g = a.genome(i)
        assert np.all(g[1:] > g[:-1]) and 2000 <= len(g) <= 6000
    assert int(a.hashes.max()) < 2**T.HASH_BITS
    # two members of one clade share at most a fifth of either; the fresh draws are new
    for c in range(5):
        m = np.flatnonzero(a.clade == c)
        for x, y in zip(m[:-1], m[1:]):
            shared = len(np.intersect1d(a.genome(x), a.genome(y)))
            assert shared <= 0.2 * min(len(a.genome(x)), len(a.genome(y)))
    fresh = a.fresh(1000)
    assert not np.isin(fresh, a.hashes).any()


def test_mix_is_a_bijection_on_a_range():
    x = np.arange(1 << 16, dtype=np.uint64)
    assert len(np.unique(T.mix_hashes(x, 12345))) == len(x)


def test_queries_same_sizes_every_seed():
    a = T.Collection(COLL, 11)
    b = T.Collection(COLL, 12)
    qa = T.gather_queries(META, a, 11, 6)
    qa2 = T.gather_queries(META, T.Collection(COLL, 11), 11, 6)
    qb = T.gather_queries(META, b, 12, 6)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(qa, qa2))
    # sizes come from the shared grid: about the same for any seed
    for x, y in zip(qa, qb):
        assert abs(len(x[0]) - len(y[0])) <= 0.1 * len(x[0])
        assert x[1].min() >= 1 and x[1].max() <= 50
    g = T.gather_queries(GENOMES, a, 11, 8)
    assert [k for _, _, k in g] == [k for _, _, k in T.gather_queries(GENOMES, b, 12, 8)]
    assert {k for _, _, k in g} == {"strain", "relative"}
    assert all(ab is None and 2000 <= len(q) <= 6000 for q, ab, _ in g)


def test_assemblies_deterministic(tmp_path):
    p1 = T.assemblies(ASSEMBLIES, 99, str(tmp_path / "a"))
    p2 = T.assemblies(ASSEMBLIES, 99, str(tmp_path / "b"))
    for (f1, r1, n1), (f2, r2, n2) in zip(p1, p2):
        assert open(f1, "rb").read() == open(f2, "rb").read() and n1 == n2
        assert sum(len(r) for r in r1) == n1
    text = open(p1[0][0], "rb").read()
    assert text.startswith(b">contig_0_0\n")
    seq = b"".join(r.tobytes() for r in p1[0][1])
    assert b"N" in seq and any(c in seq for c in b"acgt")
    assert sorted(n for _, _, n in p1) == sorted(n for _, _, n in T.assemblies(
        ASSEMBLIES, 100, str(tmp_path / "c")))


def test_reads_deterministic(tmp_path):
    r1, n1 = T.reads(READS, 5, str(tmp_path / "a.fq.gz"))
    r2, n2 = T.reads(READS, 5, str(tmp_path / "b.fq.gz"))
    assert np.array_equal(r1, r2) and n1 == n2 == 30000
    lines = gzip.open(str(tmp_path / "a.fq.gz"), "rb").read().split(b"\n")
    assert lines[0] == b"@read_00000000" and lines[1] == r1[0].tobytes() and lines[2] == b"+"
    assert len(lines[3]) == 150 and set(r1.ravel().tolist()) <= set(b"ACGT")


def test_van_der_corput_grid():
    assert list(T.van_der_corput(4)) == [0.5, 0.25, 0.75, 0.125]
    v = T.grid_values(dict(dist="log_uniform", min=50000, max=600000), np.array([0.0, 1.0]))
    assert np.allclose(v, [50000, 600000])


def test_cycle_sizes_repeat_each_cycle():
    meta = dict(META, cycle=4)
    pts = T.size_points(meta, 9)
    assert list(pts[:4]) == [0.125, 0.375, 0.625, 0.875] and list(pts[4:8]) == list(pts[:4])
    q = T.gather_queries(meta, T.Collection(COLL, 11), 11, 8)
    for x, y in zip(q[:4], q[4:]):
        assert abs(len(x[0]) - len(y[0])) <= 0.05 * len(x[0]) and not np.array_equal(x[0], y[0])
