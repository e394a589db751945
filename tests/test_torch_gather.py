"""The port's gather engine against the JAX package and the host
CounterGather, on the CPU (the port's kernels run their plain versions).

The same seeded collections go through both packages as signatures built
from the same hash arrays. Checked: whole greedy gathers (GatherDatabases
rows) through the device FlatCounterGather in every mode (host rounds with
sorted joins or membership groups, the device schedule on the host- and
device-membership routes, a small candidate cap that truncates and
reschedules, NO_SCHEDULE), peek/consume sequences against the host
CounterGather, md5-duplicate candidates, and the flat-view threshold.
"""

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu_torch
from sourmash_tpu.index import CounterGather as JaxCounterGather
from sourmash_tpu.index import LinearIndex as JaxLinearIndex
from sourmash_tpu.index.flat import FlatIndex as JaxFlatIndex
from sourmash_tpu.index.flat import schedule_device_gather as jax_schedule
from sourmash_tpu.search import GatherDatabases as JaxGatherDatabases
from sourmash_tpu_torch.index import CounterGather, LinearIndex
from sourmash_tpu_torch.index import flat as tflat
from sourmash_tpu_torch.search import GatherDatabases, GatherRoundRestart

SCALED = 100


def _collection(n, seed=3, dup=False):
    """n sketches in clades sharing cores, so rounds must choose between
    near relatives, and all holding ~150 hashes of one shared pool, so
    every sketch overlaps the query; the query holds parts of 12 sketches,
    half the pool and fresh hashes, with abundances."""
    rng = np.random.default_rng(seed)
    mh = (1 << 64) // SCALED
    pool = rng.integers(0, mh, size=1500, dtype=np.uint64)
    mins = []
    while len(mins) < n:
        core = np.unique(rng.integers(0, mh, size=int(rng.integers(300, 700)), dtype=np.uint64))
        for _ in range(int(rng.integers(1, 12))):
            keep = core[rng.random(len(core)) < rng.uniform(0.5, 0.95)]
            own = rng.integers(0, mh, size=int(rng.integers(20, 200)), dtype=np.uint64)
            mins.append(np.unique(np.concatenate([keep, own, rng.choice(pool, 150)])))
    mins = mins[:n]
    if dup:  # md5 duplicates: same sketch, other names, at three positions
        for j in (n // 3, n // 2):
            mins[j] = mins[5].copy()
    parts = [mins[i][rng.random(len(mins[i])) < rng.uniform(0.4, 1.0)]
             for i in rng.choice(n, size=12, replace=False)]
    if dup:
        parts.append(mins[5])
    parts += [pool[:750], rng.integers(0, mh, size=400, dtype=np.uint64)]
    q = np.unique(np.concatenate(parts))
    return mins, q, rng.integers(1, 50, size=len(q))


def _sigs(pkg, mins, q, abunds):
    def sig(m, name, a=None):
        mh = pkg.MinHash(0, 31, scaled=SCALED, track_abundance=a is not None)
        if a is None:
            mh.add_many(m)
        else:
            mh.set_abundances(dict(zip(m.tolist(), a.tolist())))
        return pkg.SourmashSignature(mh, name=name, filename=f"{name}.fa")

    return [sig(m, f"g{i}") for i, m in enumerate(mins)], sig(q, "query", abunds)


def _rows(gather_iter):
    """(md5, intersect_bp, unique_intersect_bp, f_unique_weighted, location)
    of every round."""
    return [(r.match.md5sum(), r.intersect_bp, r.unique_intersect_bp, r.f_unique_weighted,
             r.filename) for r in gather_iter]


def _jax_rows(jsigs, jq, threshold_bp):
    counter = JaxFlatIndex(jsigs, "db").counter_gather(jq, threshold_bp)
    jax_schedule([counter])
    return _rows(JaxGatherDatabases(jq, [counter], threshold_bp=threshold_bp))


@pytest.fixture(scope="module")
def data():
    mins, q, abunds = _collection(420)
    jsigs, jq = _sigs(sourmash_tpu, mins, q, abunds)
    tsigs, tq = _sigs(sourmash_tpu_torch, mins, q, abunds)
    return dict(jsigs=jsigs, jq=jq, tsigs=tsigs, tq=tq,
                want=_jax_rows(jsigs, jq, 5000))


MODES = {
    "host rounds": {"SOURMASH_TORCH_NO_SCHEDULE": "1"},
    "scheduled, host membership": {"SOURMASH_TORCH_DEV_MEMBERSHIP": "0"},
    "scheduled, device membership": {"SOURMASH_TORCH_DEV_MEMBERSHIP": "1"},
    "capped schedule": {"SOURMASH_TORCH_SCHEDULE_CAP": "4", "SOURMASH_TORCH_DEV_MEMBERSHIP": "1"},
    "capped host schedule": {"SOURMASH_TORCH_SCHEDULE_CAP": "7"},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_gather_rounds_equal_jax(data, mode, monkeypatch):
    for key, val in MODES[mode].items():
        monkeypatch.setenv(key, val)
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    counter = tflat.FlatIndex(data["tsigs"], "db").counter_gather(data["tq"], 5000)
    assert int((counter.counts > 0).sum()) > 256  # enough candidates for membership groups
    coord = tflat.schedule_device_gather([counter])
    assert (coord is None) == (mode == "host rounds")
    got = _rows(GatherDatabases(data["tq"], [counter], threshold_bp=5000))
    assert len(got) > 5
    assert got == data["want"]
    if coord is not None:
        assert coord.route == ("device membership" if "device" in mode or mode == "capped schedule"
                               else "host membership")
        assert coord.reschedules > 0 or "capped" not in mode
    else:
        assert counter._groups  # consume went through the membership groups


def _peek_consume(counter, start_mh, threshold_bp):
    "The (md5, intersection) sequence of peek/consume rounds, restarts re-peeked."
    cur, seen = start_mh.to_mutable(), []
    while True:
        try:
            got = counter.peek(cur, threshold_bp=threshold_bp)
        except GatherRoundRestart:
            continue
        if not got:
            return seen
        seen.append((got[0].signature.md5sum(), sorted(got[1].hashes)))
        counter.consume(got[1])
        cur.remove_many(got[1].hashes)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("dup", [False, True])
def test_peek_consume_equals_host_counter_and_jax(schedule, dup, monkeypatch):
    """FlatCounterGather's peek/consume sequence equals the host
    CounterGather's and JAX's, with md5-duplicate candidates collapsing to
    the first position (and the last signature)."""
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    mins, q, abunds = _collection(60, seed=8, dup=dup)
    tsigs, tq = _sigs(sourmash_tpu_torch, mins, q, abunds)
    jsigs, jq = _sigs(sourmash_tpu, mins, q, abunds)
    flat_q = tq.minhash.flatten()

    counter = tflat.FlatIndex(tsigs, "db").counter_gather(tq, 0)
    if schedule:
        counter.enable_device_schedule()
    host = CounterGather(sourmash_tpu_torch.SourmashSignature(flat_q))
    for ss in tsigs:
        host.add(ss, require_overlap=False)
    jcounter = JaxCounterGather(sourmash_tpu.SourmashSignature(jq.minhash.flatten()))
    for ss in jsigs:
        jcounter.add(ss, require_overlap=False)

    got = _peek_consume(counter, flat_q, 0)
    assert got == _peek_consume(host, flat_q, 0)
    want = _peek_consume(jcounter, jq.minhash.flatten(), 0)
    assert [(m, [int(h) for h in hs]) for m, hs in got] == [(m, [int(h) for h in hs]) for m, hs in want]
    assert len(got) > 3
    if dup:  # the first position, the last signature
        assert counter._remap == {5: 30}
        assert tsigs[5].md5sum() in [m for m, _ in got]


@pytest.mark.parametrize("n,env,flat", [
    (511, None, False), (512, None, True), (40, "1", True), (600, "0", False), (40, "30", True),
])
def test_flat_view_threshold(n, env, flat, monkeypatch):
    "Gather goes through a FlatIndex view at SOURMASH_TORCH_FLAT_VIEW signatures (512)."
    if env is None:
        monkeypatch.delenv("SOURMASH_TORCH_FLAT_VIEW", raising=False)
    else:
        monkeypatch.setenv("SOURMASH_TORCH_FLAT_VIEW", env)
    monkeypatch.setenv("SOURMASH_TPU_FLAT_VIEW", env or "")
    mh = sourmash_tpu_torch.MinHash(0, 31, scaled=SCALED)
    mh.add_many(np.arange(1, 200, dtype=np.uint64))
    sigs = [sourmash_tpu_torch.SourmashSignature(mh, name=f"s{i}") for i in range(n)]
    view = LinearIndex(sigs, "db.sig")._as_flat_view()
    assert (view is not None) == flat
    jmh = sourmash_tpu.MinHash(0, 31, scaled=SCALED)
    jmh.add_many(np.arange(1, 200, dtype=np.uint64))
    jsigs = [sourmash_tpu.SourmashSignature(jmh, name=f"s{i}") for i in range(n)]
    assert (JaxLinearIndex(jsigs, "db.sig")._as_flat_view() is not None) == flat
    if flat:
        assert isinstance(view, tflat.FlatIndex) and len(view) == n


def test_no_schedule_env_and_ineligible_groups(monkeypatch):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    mins, q, abunds = _collection(30, seed=9)
    tsigs, tq = _sigs(sourmash_tpu_torch, mins, q, abunds)
    counter = tflat.FlatIndex(tsigs, "db").counter_gather(tq, 0)
    monkeypatch.setenv("SOURMASH_TORCH_NO_SCHEDULE", "1")
    assert tflat.schedule_device_gather([counter]) is None
    monkeypatch.delenv("SOURMASH_TORCH_NO_SCHEDULE")
    assert tflat.schedule_device_gather([]) is None
    assert tflat.schedule_device_gather([counter, CounterGather(tq)]) is None
    assert tflat.schedule_device_gather([counter]) is not None
