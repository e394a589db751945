"""The block joins on the CPU: `counts_block` (X3b) and `products_block`
(X6's block route), a hash join of a query block's valid slots against a
chunk's rows (`csrc/block_join.cu`), whose plain versions (sort,
searchsorted, pair expansion) run on CPU tensors.

The same inputs, made with numpy from a seed, go through `sourmash_tpu`
(JAX on the CPU: `_counts_block_impl`, the broadcast compare minus its
PAD==PAD correction, and `_products_block_impl`) and through the port,
compared exactly: spills, 2^64-1 in rows and queries (a tail of the counts
packs, a valid hash of the weighted planes), an empty query, a bucket at
the block's full depth, a row with cnt = 8 and spills, zero abundances,
20-deep weighted buckets, and a host-streamed chunk
(`_counts_block_from_raw`). Then the join's tile plan from the block's
host loads (no readback) against the one from its occupancy, the widest
tile that fits and an overloaded bucket's global tile (capacities fixed
here: the card's come from the kernel library), and the wrappers' input
checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sourmash_tpu.ops import bucketed as jbk
from sourmash_tpu_torch.ops import bucketed as tbk
from sourmash_tpu_torch.ops import cuda_gather as cg
from sourmash_tpu_torch.ops import cuda_pairwise as cp
from sourmash_tpu_torch.ops import index_ops as tio

MAX = np.uint64(2**64 - 1)
CPU = torch.device("cpu")
B = 128


@pytest.fixture(autouse=True)
def _no_launches():
    "The CPU path takes the plain versions and never counts a launch."
    cg.reset_launch_counts()
    cp.reset_launch_counts()
    yield
    assert not any(cg.LAUNCHES.values()) and not any(cp.LAUNCHES.values())


def rand_set(rng, n, hi=2**64 - 1):
    return np.unique(rng.integers(0, hi, size=n, dtype=np.uint64))


def one_bucket(count, bucket, salt=0):
    "`count` distinct hashes of bucket `bucket` of B."
    return ((np.arange(count, dtype=np.uint64) + np.uint64(salt)) << np.uint64(32)) * np.uint64(
        B) + np.uint64(bucket)


def counts_case(case, seed=7):
    """(rows, queries): 24 rows sharing hashes with a block of queries; an
    empty query; 2^64-1 in a row and as a query's tail; "spills": a query
    loaded in the hundreds a bucket and rows crowding bucket 5 past d = 8;
    "full": 16 hashes of bucket 9 in query 0 (the block's depth, dq = 16)
    and in rows 6 and 7 (cnt = 8 there, the rest spilled)."""
    rng = np.random.default_rng(seed)
    pool = rand_set(rng, 2000)
    rows = [np.unique(np.r_[rand_set(rng, int(rng.integers(50, 300))),
                            rng.choice(pool, size=60, replace=False)]) for _ in range(24)]
    rows[2] = np.unique(np.r_[rows[2], MAX])
    queries = [np.unique(np.r_[rows[2][:40], rows[4][::2], rand_set(rng, 150), MAX]),
               np.zeros(0, dtype=np.uint64), rows[9][:30]]
    if case == "spills":
        crowd = one_bucket(11, 5)
        for i in (4, 5):
            rows[i] = np.unique(np.r_[rows[i], crowd])
        queries.append(np.unique(np.r_[pool, crowd, rand_set(rng, 20000)]))
    if case == "full":
        deep = one_bucket(16, 9, salt=3)
        q0 = queries[0]
        queries[0] = np.unique(np.r_[q0[(q0 & np.uint64(B - 1)) != 9], deep])
        rows[6] = np.unique(np.r_[rows[6], deep])
        rows[7] = np.unique(np.r_[rows[7], deep[5:]])
    return rows, queries


def jax_counts(Qhi, Qlo, Qcnt, bank):
    return np.asarray(jbk._counts_block_impl(
        *(jnp.asarray(x) for x in (Qhi, Qlo, Qcnt, bank.hi, bank.lo, bank.cnt))))


def torch_planes(*arrays):
    return [tbk.to_torch(np.asarray(a)) for a in arrays]


def oracle(qs, rows):
    return np.array([[len(np.intersect1d(q, m)) for m in rows] for q in qs], dtype=np.int64)


# -- counts_block: the join against _counts_block_impl ---------------------------


@pytest.mark.parametrize("pack", ["host", "device"])
@pytest.mark.parametrize("case", ["plain", "spills", "full"])
def test_counts_join_equals_jax(case, pack):
    rows, qs = counts_case(case)
    bank = jbk.pack_rows_bucketed(rows, B, device=False)
    assert bank.n_spilled >= 1 + (case != "plain")
    if pack == "host":
        Qhi, Qlo, Qcnt = jbk.pack_query_block(qs, B)
    else:
        Qhi, Qlo, Qcnt = (np.asarray(x) for x in jbk.pack_query_block_device(qs, B)[:3])
    if case == "full":
        assert pack == "host" or Qhi.shape[1] == 16
        assert int(Qcnt[0, 9]) == 16 and int(bank.cnt[6, 9]) == int(bank.cnt[7, 9]) == 8
    want = jax_counts(Qhi, Qlo, Qcnt, bank)
    tq = torch_planes(Qhi, Qlo, Qcnt)
    ts = torch_planes(bank.hi, bank.lo, bank.cnt)
    got = cg.counts_block(*tq, *ts)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(cg.counts_block_plain(*tq, *ts).numpy(), want)
    assert not want[1].any() and want[0].any()
    counts = want[:, : len(rows)].astype(np.int64)
    for i, q in enumerate(qs):
        tbk._spill_counts_qvm(q, tbk.pack_rows_bucketed(rows, B), counts[i])
    assert np.array_equal(counts, oracle(qs, rows))


@pytest.mark.parametrize("case", ["plain", "spills"])
def test_counts_join_from_raw_equals_jax(case):
    """A host-streamed chunk: its raw limb rows packed on the device, then
    joined, as JAX's _counts_block_from_raw packs and counts them."""
    rows, qs = counts_case(case, seed=9)
    chunk = tbk.pack_rows_bucketed(rows, B)
    Hi, Lo = tio._raw_limbs(rows, chunk.hi.shape[0])
    Qhi, Qlo, Qcnt, _dq, _raw = tbk.pack_query_block_device(qs, B, device=CPU)
    want = np.asarray(jbk._counts_block_from_raw(
        jnp.asarray(tbk.to_numpy_u32(Qhi)), jnp.asarray(tbk.to_numpy_u32(Qlo)),
        jnp.asarray(Qcnt.numpy()), jnp.asarray(Hi), jnp.asarray(Lo), B, chunk.d))
    got = tbk._counts_block_from_raw(Qhi, Qlo, Qcnt, *torch_planes(Hi, Lo), B, chunk.d)
    assert np.array_equal(got.numpy(), want)
    chunk.raw = (Hi, Lo)
    assert np.array_equal(tbk.counts_block_dispatch(Qhi, Qlo, Qcnt, chunk).numpy(), want)


def test_counts_join_of_an_empty_block():
    "A block of empty queries counts nothing, against any rows."
    rows, _qs = counts_case("spills")
    empty = [np.zeros(0, dtype=np.uint64), np.array([MAX])]
    Qhi, Qlo, Qcnt, dq, _raw = tbk.pack_query_block_device(empty, B, device=CPU)
    assert dq == 8 and not Qcnt.any()
    bank = tbk.pack_rows_bucketed(rows, B, device=CPU)
    got = cg.counts_block(Qhi, Qlo, Qcnt, bank.hi, bank.lo, bank.cnt)
    assert got.shape == (2, bank.hi.shape[0]) and not got.any()
    assert not cg.block_entries(Qcnt, dq).any()


# -- products_block: the join against _products_block_impl ---------------------------


def weighted_case(seed, depth):
    """(rows, abunds, queries, qabunds), all at B = 128: 2^64-1 (a valid
    hash here) in rows 2 and 5 and in query 1; `depth` hashes of bucket 5
    in row 0 and in query 0 (most of them in row 1 too); zero abundances
    in row 3 and query 2."""
    rng = np.random.default_rng(seed)
    pool = rand_set(rng, 600, 2**64 // 1000)
    rows = [np.unique(np.r_[rand_set(rng, int(rng.integers(30, 120))),
                            rng.choice(pool, size=40, replace=False)]) for _ in range(12)]
    deep = one_bucket(depth, 5)
    rows[0] = np.unique(np.r_[rows[0], deep])
    rows[1] = np.unique(np.r_[rows[1], deep[3:]])
    for i in (2, 5):
        rows[i] = np.unique(np.r_[rows[i], MAX])
    queries = [np.unique(np.r_[rng.choice(pool, size=50, replace=False), deep[1:]]),
               np.unique(np.r_[rows[2][:20], rows[5][-10:], MAX]),
               np.unique(np.r_[rows[3], rows[7][::3]]),
               np.zeros(0, dtype=np.uint64)]
    ab = [rng.integers(1, 1000, size=len(m)).astype(np.int64) for m in rows]
    qab = [rng.integers(1, 1000, size=len(m)).astype(np.int64) for m in queries]
    ab[3][::2] = 0
    qab[2][1::2] = 0
    return rows, ab, queries, qab


def jax_products(Q, S):
    return np.asarray(jbk._products_block_impl(*(jnp.asarray(x) for x in (*Q, *S))))


@pytest.mark.parametrize("queries", ["own rows", "a query pack"])
@pytest.mark.parametrize("depth", [20, 8])
def test_products_join_equals_jax(depth, queries):
    rows, ab, qs, qab = weighted_case(100 + depth, depth)
    S = tbk._pack_weighted(rows, ab)[:4]
    Q = (tuple(x[:5] for x in S) if queries == "own rows"
         else tbk._pack_weighted(qs, qab)[:4])
    assert tbk._pack_weighted(qs, qab)[4] == tbk._pack_weighted(rows, ab)[4] == B
    assert S[0].shape[1] >= depth
    want = jax_products(Q, S)
    tq, ts = torch_planes(*Q), torch_planes(*S)
    got = cg.products_block(*tq, *ts)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(cg.products_block_plain(*tq, *ts).numpy(), want)
    assert want.any()


# -- the tile plan ------------------------------------------------------------------


@pytest.fixture
def capacities(monkeypatch):
    "A fixed shared-memory capacity: 1,600 query entries a tile."
    monkeypatch.setattr(cg, "block_join_capacity", lambda weighted, device: 1600)


def test_block_plan_takes_the_widest_tile_that_fits(capacities):
    plan = cg.block_join_plan(np.full(256, 100), False, CPU)
    assert plan.tile_log2 == 4 and plan.global_tiles == 0 and plan.cap == 1600
    assert plan.meta[:, 0].tolist() == [1600] * 16 and (plan.meta[:, 1] == -1).all()
    assert all(t.numel() == 0 for t in plan.scratch)
    plan = cg.block_join_plan(np.full(256, 150), False, CPU)
    assert plan.tile_log2 == 3 and plan.meta[:, 0].tolist() == [1200] * 32
    plan = cg.block_join_plan(np.full(256, 150), False, CPU, target=700)
    assert plan.tile_log2 == 2 and plan.meta[:, 0].tolist() == [600] * 64
    # an empty block: the widest tiles, each empty
    plan = cg.block_join_plan(np.zeros(256, dtype=np.int64), True, CPU)
    assert plan.tile_log2 == 4 and not plan.meta[:, 0].any() and plan.cap == 0


def test_block_plan_sends_an_overloaded_bucket_to_global_memory(capacities):
    entries = np.full(128, 50, dtype=np.int64)
    entries[37] = 5000
    plan = cg.block_join_plan(entries, True, CPU)
    assert plan.tile_log2 == 4 and plan.global_tiles == 1
    hot = int(plan.meta[:, 0].argmax())
    n = 5000 + 15 * 50
    assert hot == 37 >> 4 and plan.meta[hot].tolist() == [n, 0, 0]
    assert (plan.meta[torch.arange(8) != hot, 1] == -1).all()
    key, head, nxt, row, ab = plan.scratch
    assert key.numel() == head.numel() == cp.table_slots(n)
    assert nxt.numel() == row.numel() == ab.numel() == n and plan.cap == 800
    # two overloaded buckets side by side: tiles narrow until each has its own
    entries[38] = 3000
    plan = cg.block_join_plan(entries, False, CPU)
    assert plan.tile_log2 == 1 and plan.global_tiles == 2
    assert plan.meta[18].tolist() == [5050, 0, 0]
    assert plan.meta[19].tolist() == [3050, 5050, cp.table_slots(5050)]


def test_block_plan_from_host_loads_equals_the_plan_from_qcnt(capacities):
    """The block's host bucket loads (multigather's plan, no readback) give
    the entries, and so the plan, that its packed occupancy gives."""
    _rows, qs = counts_case("spills")
    loads = tbk.query_block_loads(qs, B)
    Qhi, _Qlo, Qcnt, dq, _raw = tbk.pack_query_block_device(qs, B, device=CPU, loads=loads)
    assert dq == tbk.pack_query_block_device(qs, B, device=CPU)[3]
    assert np.array_equal(loads, Qcnt.numpy())
    entries = cg.block_entries(Qcnt, dq)
    assert np.array_equal(loads.sum(axis=0), entries) and entries.max() > 1600 // 16
    host, packed = (cg.block_join_plan(e, False, CPU) for e in (loads.sum(axis=0), entries))
    assert host.tile_log2 == packed.tile_log2 < 4
    assert torch.equal(host.meta, packed.meta) and host.cap == packed.cap


# -- the wrappers' input checks ------------------------------------------------------


def _weighted_planes():
    rows, ab, _qs, _qab = weighted_case(5, 9)
    return torch_planes(*tbk._pack_weighted(rows, ab)[:4])


BAD = {
    "Qlo narrower": lambda Q, S: ((Q[0], Q[1][:, :, :64].contiguous(), *Q[2:]), S),
    "Qcnt short a row": lambda Q, S: ((*Q[:-1], Q[-1][:-1]), S),
    "Scnt short a row": lambda Q, S: (Q, (*S[:-1], S[-1][:-1])),
    "Scnt as int32": lambda Q, S: (Q, (*S[:-1], S[-1].to(torch.int32))),
    "Qhi as int64": lambda Q, S: ((Q[0].to(torch.int64), *Q[1:]), S),
    "Shi on the wrong B": lambda Q, S: (Q, (S[0][:, :, :64].contiguous(), *S[1:])),
}


@pytest.mark.parametrize("case", list(BAD))
def test_block_join_wrappers_reject_bad_planes(case):
    hi, lo, av, cnt = _weighted_planes()
    Q, S = BAD[case]((hi[:4], lo[:4], av[:4], cnt[:4]), (hi, lo, av, cnt))
    with pytest.raises(TypeError):
        cg.products_block(*Q, *S)
    Qc = (Q[0], Q[1], Q[3].to(torch.int32))
    with pytest.raises(TypeError):
        cg.counts_block(*Qc, S[0], S[1], S[3])
