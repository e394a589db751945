"""The port's Nodegraph (the khmer/OXLI Bloom filter under SBT nodes)
against the JAX package's, on the same seeded hashes: table sizes, bits,
counters, `count`/`get` on hashes and k-mer strings, `count_many` /
`get_many`, `update` from a MinHash and from another nodegraph, the saved
bytes (plain and gzipped with mtime 0) both ways, `extract_nodegraph_info`
and `calc_expected_collisions`."""

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu_torch
from sourmash_tpu import nodegraph as jax_ng
from sourmash_tpu_torch import nodegraph as torch_ng


def _pair(ksize=1, size=1e5, n_tables=4):
    return (torch_ng.Nodegraph(ksize, size, n_tables), jax_ng.Nodegraph(ksize, size, n_tables))


def _state(ng):
    return (ng.hashsizes(), [bytes(b) for b in ng._bits], ng.n_occupied(), ng.unique_kmers,
            ng.ksize())


@pytest.mark.parametrize("size,n_tables", [(1e5, 4), (997, 2), (64, 3)])
def test_count_many_get_many_and_bytes(size, n_tables, tmp_path):
    rng = np.random.default_rng(int(size) + n_tables)
    t, j = _pair(21, size, n_tables)
    assert t.hashsizes() == j.hashsizes() and len(t.hashsizes()) == n_tables
    hashes = rng.integers(0, 2**64, size=3000, dtype=np.uint64)
    hashes[:50] = hashes[50:100]  # repeats: not new the second time
    t.count_many(hashes)
    j.count_many(hashes)
    assert _state(t) == _state(j)
    probe = np.concatenate([hashes[::3], rng.integers(0, 2**64, size=3000, dtype=np.uint64)])
    np.testing.assert_array_equal(t.get_many(probe), j.get_many(probe))
    assert t.get_many(hashes).all()

    for level in (0, 1):
        assert t.to_bytes(compression=level) == j.to_bytes(compression=level)
    t.save(str(tmp_path / "t.ng"))
    j.save(str(tmp_path / "j.ng"))
    assert (tmp_path / "t.ng").read_bytes() == (tmp_path / "j.ng").read_bytes()
    for path in ("t.ng", "j.ng"):
        assert _state(torch_ng.Nodegraph.load(str(tmp_path / path))) == \
            _state(jax_ng.Nodegraph.load(str(tmp_path / path)))[:3] + (0, 21)
    gz = t.to_bytes(compression=1)
    assert _state(torch_ng.Nodegraph.from_buffer(gz))[:3] == _state(j)[:3]
    (tmp_path / "g.ng").write_bytes(gz)
    info = torch_ng.extract_nodegraph_info(str(tmp_path / "g.ng"))
    assert info == jax_ng.extract_nodegraph_info(str(tmp_path / "g.ng"))
    assert info == torch_ng.extract_nodegraph_info(str(tmp_path / "t.ng"))
    assert info[0] == 21 and info[2] == n_tables


def test_count_get_on_hashes_and_kmers():
    t, j = _pair(5, 1000, 3)
    for item in [17, 2**63 + 5, 17, "ACGTA", "acgta", "TTTTT", 2**64 - 1]:
        assert t.count(item) == j.count(item)
        assert t.get(item) == j.get(item) == 1
    for item in [18, "CCCCC", 2**40]:
        assert t.get(item) == j.get(item)
    assert t.get("ACGTA") == 1 and t.get(sourmash_tpu_torch.hash_murmur("ACGTA")) == 1
    assert _state(t) == _state(j)


def test_update_similarity_containment_and_matches():
    rng = np.random.default_rng(5)
    mins = np.unique(rng.integers(0, 2**64 // 1000, size=800, dtype=np.uint64))
    t_mh = sourmash_tpu_torch.MinHash(0, 31, scaled=1000)
    j_mh = sourmash_tpu.MinHash(0, 31, scaled=1000)
    t_mh.add_many(mins[:500])
    j_mh.add_many(mins[:500])
    (t, j), (t2, j2) = _pair(), _pair()
    t.update(t_mh)
    j.update(j_mh)
    t2.count_many(mins[300:])
    j2.count_many(mins[300:])
    assert t.similarity(t2) == j.similarity(j2) and 0 < t.similarity(t2) < 1
    assert t.containment(t2) == j.containment(j2)
    t.update(t2)
    j.update(j2)
    assert _state(t) == _state(j)
    t_all = sourmash_tpu_torch.MinHash(0, 31, scaled=1000)
    t_all.add_many(mins)
    j_all = sourmash_tpu.MinHash(0, 31, scaled=1000)
    j_all.add_many(mins)
    assert t.matches(t_all) == j.matches(j_all) == len(mins)
    with pytest.raises(TypeError):
        t.update([1, 2])
    with pytest.raises(sourmash_tpu_torch.exceptions.SourmashError):
        t.update(torch_ng.Nodegraph(1, 997, 2))


def test_calc_expected_collisions(capsys):
    t, j = _pair(1, 64, 2)
    assert torch_ng.calc_expected_collisions(t) == jax_ng.calc_expected_collisions(j) == 0.0
    hashes = np.arange(1, 200, dtype=np.uint64)
    t.count_many(hashes)
    j.count_many(hashes)
    assert t.expected_collisions == j.expected_collisions > 0.2
    assert torch_ng.calc_expected_collisions(t, force=True) == \
        jax_ng.calc_expected_collisions(j, force=True)
    forced = capsys.readouterr().err
    assert forced.count("the graph structure is too small") == 2
    outs = []
    for mod, ng in ((torch_ng, t), (jax_ng, j)):
        with pytest.raises(SystemExit):
            mod.calc_expected_collisions(ng)
        outs.append(capsys.readouterr().err)
    assert outs[0] == outs[1] and "the graph structure is too small" in outs[0]
