"""The port's `HLL` (host numpy, `sourmash_tpu_torch/hll.py`) against the
JAX package's on the same inputs, made with numpy from a seed: registers
byte-equal after every way of adding, estimates equal, the binary format
byte-equal and read back by either, and the same errors."""

import gzip

import numpy as np
import pytest

from sourmash_tpu import MinHash as JaxMinHash
from sourmash_tpu.hll import HLL as JaxHLL
from sourmash_tpu_torch import MinHash as TorchMinHash
from sourmash_tpu_torch.hll import HLL as TorchHLL

KSIZE = 21
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pair(error_rate=0.01, ksize=KSIZE):
    return JaxHLL(error_rate, ksize), TorchHLL(error_rate, ksize)


def _same(j, t):
    assert t.p == j.p and t.q == j.q and t.ksize == j.ksize
    assert t.registers.dtype == j.registers.dtype
    assert t.registers.tobytes() == j.registers.tobytes()


@pytest.fixture(scope="module")
def seqs():
    rng = np.random.default_rng(5150)
    a = rng.choice(ACGT, size=30_000).tobytes()
    b = a[10_000:] + rng.choice(ACGT, size=25_000).tobytes()
    return a, b


@pytest.mark.parametrize("error_rate", [0.3, 0.05, 0.01, 0.003])
def test_add_many_registers_and_cardinality(error_rate):
    rng = np.random.default_rng(int(error_rate * 1e4))
    hashes = rng.integers(0, 2**64, size=40_000, dtype=np.uint64)
    j, t = _pair(error_rate)
    j.add_many(hashes)
    t.add_many(hashes)
    j.add_many([])
    t.add_many([])
    _same(j, t)
    assert t.cardinality() == j.cardinality() == len(t) > 0
    for h in (0, 1, 2**64 - 1, int(hashes[7])):
        j.add(h)
        t.add(h)
        j.count(h)
        t.count(h)
    _same(j, t)


def test_add_sequence_with_invalid_bytes_and_force(seqs):
    a, _ = seqs
    bad = a[:5_000] + b"N" + a[5_001:9_000].lower() + b"x" + a[9_001:12_000]
    j, t = _pair()
    for hll in (j, t):
        hll.add_sequence(a)
        hll.add_sequence(a[:4_000].decode().lower())
        hll.add_sequence(b"ACG")  # shorter than k
    _same(j, t)
    for hll in (j, t):
        with pytest.raises(ValueError) as exc:
            hll.add_sequence(bad)
        hll.msg = str(exc.value)
    assert t.msg == j.msg and "invalid DNA character" in t.msg
    j.add_sequence(bad, force=True)
    t.add_sequence(bad, force=True)
    _same(j, t)
    assert t.cardinality() == j.cardinality()


def test_add_kmer(seqs):
    a, _ = seqs
    j, t = _pair()
    for i in range(0, 2_000, 7):
        kmer = a[i:i + KSIZE]
        j.add_kmer(kmer)
        t.add_kmer(kmer.decode().lower() if i % 2 else kmer)
        j.add(kmer.decode())
        t.add(kmer.decode())
    _same(j, t)
    for hll in (j, t):
        with pytest.raises(ValueError, match="not 21 in length"):
            hll.add_kmer("ACGT")
        with pytest.raises(ValueError, match="invalid DNA character"):
            hll.add_kmer("N" * KSIZE)


def test_update_merge_and_minhash(seqs):
    a, b = seqs
    ja, ta = _pair()
    jb, tb = _pair()
    ja.add_sequence(a)
    ta.add_sequence(a)
    jb.add_sequence(b)
    tb.add_sequence(b)
    ja.update(jb)
    ta.update(tb)
    _same(ja, ta)
    jmh, tmh = JaxMinHash(0, KSIZE, scaled=1), TorchMinHash(0, KSIZE, scaled=1)
    jmh.add_sequence(b[:8_000])
    tmh.add_sequence(b[:8_000])
    jc, tc = _pair()
    jc.merge(jmh)
    tc.merge(tmh)
    _same(jc, tc)
    assert tc.cardinality() == jc.cardinality()
    assert tb.matches(tmh) == jb.matches(jmh) > 0
    for hll in (jc, tc):
        with pytest.raises(TypeError):
            hll.update(42)
        with pytest.raises(ValueError, match="different ksizes"):
            hll.update(type(hll)(0.01, KSIZE + 2))
        with pytest.raises(ValueError, match="different sizes"):
            hll.update(type(hll)(0.3, KSIZE))
    with pytest.raises(ValueError, match="mh must be a MinHash"):
        tc.matches(ta)


def test_joint_estimates(seqs):
    a, b = seqs
    ja, ta = _pair()
    jb, tb = _pair()
    for hll, seq in ((ja, a), (ta, a), (jb, b), (tb, b)):
        hll.add_sequence(seq)
    assert ta.union(tb) == ja.union(jb)
    assert ta.similarity(tb) == ja.similarity(jb)
    assert ta.containment(tb) == ja.containment(jb)
    assert tb.containment(ta) == jb.containment(ja)
    assert ta.intersection(tb) == ja.intersection(jb) > 0
    for name in ("similarity", "containment", "intersection"):
        with pytest.raises(TypeError):
            getattr(ta, name)("x")


def test_binary_format(seqs, tmp_path):
    a, _ = seqs
    j, t = _pair(0.02, 31)
    j.add_sequence(a[:10_000].replace(b"A", b"C"))
    t.add_sequence(a[:10_000].replace(b"A", b"C"))
    assert t.to_bytes() == j.to_bytes()
    t.save(str(tmp_path / "t.hll"))
    j.save(str(tmp_path / "j.hll"))
    assert (tmp_path / "t.hll").read_bytes() == (tmp_path / "j.hll").read_bytes()
    for path in ("t.hll", "j.hll"):
        _same(JaxHLL.load(str(tmp_path / path)), TorchHLL.load(str(tmp_path / path)))
    gz = gzip.compress(t.to_bytes())
    _same(JaxHLL.from_buffer(gz), TorchHLL.from_buffer(gz))
    back = TorchHLL.from_buffer(memoryview(j.to_bytes()))
    _same(j, back)
    assert back.cardinality() == j.cardinality()
    for buf, msg in ((b"XYZ" + t.to_bytes()[3:], "bad magic"),
                     (b"HLL\x02" + t.to_bytes()[4:], "unsupported HLL version")):
        for cls in (JaxHLL, TorchHLL):
            with pytest.raises(ValueError, match=msg):
                cls.from_buffer(buf)


def test_error_rate_guards():
    for cls in (JaxHLL, TorchHLL):
        with pytest.raises(ValueError, match="too large"):
            cls(0.5, KSIZE)
        with pytest.raises(ValueError, match="too small"):
            cls(0.0005, KSIZE)
        with pytest.raises(NotImplementedError):
            cls(0.01, KSIZE).get(1)
    assert TorchHLL(0.26, KSIZE).p == JaxHLL(0.26, KSIZE).p == 4
    assert TorchHLL(0.0021, KSIZE).p == JaxHLL(0.0021, KSIZE).p == 18
    empty_j, empty_t = _pair()
    assert empty_t.cardinality() == empty_j.cardinality() == 0
