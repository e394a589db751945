"""`compare`'s library level on the CPU: the port's all-pairs count and
abundance-product matrices and the four `compare_serial*` matrices against
`sourmash_tpu`'s, from the same inputs made with numpy, with no tolerance.

The JAX package runs on the CPU (its XLA loops, which the port replaces by
the joins `counts_block` for the counts and `products_block` (X6) for the
products, and by the sorted engine, X7); the port runs the kernels' plain versions
(`device="cpu"`). Every matrix is also held against `np.intersect1d` or a
numpy merge join.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sourmash_tpu import MinHash, SourmashSignature
from sourmash_tpu import compare as jcompare
from sourmash_tpu.ops import bucketed as jbk
from sourmash_tpu.ops import intersect as jis

import sourmash_tpu_torch
from sourmash_tpu_torch import compare as tcompare
from sourmash_tpu_torch.ops import bucketed as tbk
from sourmash_tpu_torch.ops import cuda_gather as cg
from sourmash_tpu_torch.ops import intersect as tis
from sourmash_tpu_torch.ops import u64

MAX_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def overlapping_rows(n, size, rng):
    "n sorted distinct u64 rows of up to `size` hashes, neighbours sharing half."
    rows = [np.unique(rng.integers(0, 2**64 // 1000, size=int(rng.integers(max(1, size // 2),
                                                                              size + 1)),
                                   dtype=np.uint64)) for _ in range(n)]
    for i in range(1, n, 2):
        rows[i] = np.unique(np.concatenate([rows[i], rows[i - 1][::2]]))
    return rows


def oracle_counts(rows):
    return np.array([[len(np.intersect1d(a, b)) for b in rows] for a in rows], dtype=np.int64)


def oracle_products(rows, abunds):
    n = len(rows)
    out = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(n):
            _common, ia, ib = np.intersect1d(rows[i], rows[j], return_indices=True)
            out[i, j] = int(np.sum(abunds[i][ia] * abunds[j][ib]))
    return out


def spill_rows(rng):
    """Rows with 2^64-1 in two of them and a value spilled by BOTH rows 0
    and 1: 9 hashes in one bucket of B = 128 (d = 8), sharing the largest."""
    rows = overlapping_rows(9, 400, rng)
    rows[2] = np.unique(np.concatenate([rows[2], [MAX_U64]]))
    rows[5] = np.unique(np.concatenate([rows[5], [MAX_U64]]))
    shared = (np.arange(9, dtype=np.uint64) << np.uint64(32)) * np.uint64(128) + np.uint64(7)
    rows[0] = np.unique(np.concatenate([rows[0], shared]))
    rows[1] = np.unique(np.concatenate([rows[1], shared]))
    return rows


# -- the bucketed all-pairs counts (counts_block) ----------------------------


@pytest.mark.parametrize("n_rows,size", [(10, 200), (33, 700), (8, 5)])
def test_pairwise_counts_bucketed_matches_jax(n_rows, size):
    rows = overlapping_rows(n_rows, size, np.random.default_rng(n_rows * 1000 + size))
    got = tbk.pairwise_counts_bucketed(rows, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, jbk.pairwise_counts_bucketed(rows))
    assert np.array_equal(got, oracle_counts(rows))


@pytest.mark.parametrize("block", [16, 3])
def test_pairwise_counts_with_spills_and_max(block):
    "Spills, a value spilled by both rows of a pair, and 2^64-1 in two rows."
    rows = spill_rows(np.random.default_rng(3))
    bank = tbk.pack_rows_device(rows, 128, device="cpu")
    assert bank.n_spilled > 0
    assert set(bank.spills[0]) & set(bank.spills[1]), "no value spilled by both rows"
    assert [MAX_U64] == list(bank.spills[2]) == list(bank.spills[5])
    got = tbk.pairwise_counts_bucketed(rows, block=block, device="cpu")
    assert np.array_equal(got, oracle_counts(rows))
    # the JAX package at the same B, through its own helpers
    jbank = jbk.pack_rows_bucketed(rows, 128)
    outs = [jbk._counts_block(jbank.hi[i : i + 8], jbank.lo[i : i + 8], jbank.cnt[i : i + 8],
                              jbank.hi, jbank.lo, jbank.cnt)
            for i in range(0, jbank.hi.shape[0], 8)]
    want = np.asarray(jnp.concatenate(outs, axis=0))[:9, :9].astype(np.int64)
    jbk._pairwise_spill_correction(want, rows, jbank)
    # the port at the same B
    bank = tbk.pack_rows_bucketed(rows, 128, device="cpu")
    Qcnt = bank.cnt.to(torch.int32)
    out = torch.cat([tbk._counts_block_impl(bank.hi[i : i + 8], bank.lo[i : i + 8],
                                            Qcnt[i : i + 8], bank.hi, bank.lo, bank.cnt, plan)
                     for i, plan in cg.row_block_plans(bank.cnt, bank.d, 8, False)])
    out = out[:9, :9].numpy().astype(np.int64)
    tbk._pairwise_spill_correction(out, rows, bank)
    assert np.array_equal(out, want)
    assert np.array_equal(out, oracle_counts(rows))


@pytest.mark.parametrize("pack", ["device", "host"])
def test_bank_columns_meet_counts_block_order(pack):
    """A bank's planes, used as `counts_block`'s query block, have every
    column ascending in unsigned (hi, lo) order with PAD last: the device
    pack's stable sort by bucket and the host pack both give it."""
    rows = spill_rows(np.random.default_rng(5))
    B = 128
    bank = (tbk.pack_rows_device(rows, B, device="cpu") if pack == "device"
            else tbk.pack_rows_bucketed(rows, B, device="cpu"))
    assert cg._columns_ascending(bank.hi, bank.lo)
    # PAD is last: no valid slot past a PAD slot
    pad = (bank.hi == -1) & (bank.lo == -1)
    slots = torch.arange(bank.d)[None, :, None]
    assert bool((pad == (slots >= bank.cnt.to(torch.int64)[:, None, :])).all())


def test_block_route_reads_no_column_order(monkeypatch):
    """The all-pairs counts' block route checks no column order (the join
    needs none): its row blocks come from `row_block_plans`, whose plans
    are None on the CPU."""
    calls = []
    ascending = cg._columns_ascending
    monkeypatch.setattr(cg, "_columns_ascending", lambda *a: calls.append(1) or ascending(*a))
    rows = overlapping_rows(40, 300, np.random.default_rng(11))
    got = tbk.pairwise_counts_bucketed(rows, block=4, device="cpu")
    assert not calls
    assert np.array_equal(got, oracle_counts(rows))
    cnt = torch.zeros((40, 128), dtype=torch.uint8)
    assert cg.row_block_plans(cnt, 8, 16, False) == [(0, None), (16, None), (32, None)]


def test_counts_block_takes_a_bank_out_of_order():
    """A bank with two valid slots of a column swapped, as the query block,
    gives JAX's counts: the join needs no column order."""
    rows = overlapping_rows(8, 300, np.random.default_rng(12))
    bank = tbk.pack_rows_device(rows, 128, device="cpu")
    hi, lo = bank.hi.clone(), bank.lo.clone()
    b = int(torch.nonzero(bank.cnt[0] >= 2)[0])  # two distinct hashes, swapped
    hi[0, 0, b], hi[0, 1, b] = bank.hi[0, 1, b], bank.hi[0, 0, b]
    lo[0, 0, b], lo[0, 1, b] = bank.lo[0, 1, b], bank.lo[0, 0, b]
    assert not cg._columns_ascending(hi, lo)
    Qcnt = bank.cnt[:4].to(torch.int32)
    got = cg.counts_block(hi[:4], lo[:4], Qcnt, bank.hi, bank.lo, bank.cnt)
    u32 = [tbk.to_numpy_u32(x) for x in (hi[:4], lo[:4], bank.hi, bank.lo)]
    want = np.asarray(jbk._counts_block_impl(
        jnp.asarray(u32[0]), jnp.asarray(u32[1]), jnp.asarray(Qcnt.numpy()),
        jnp.asarray(u32[2]), jnp.asarray(u32[3]), jnp.asarray(bank.cnt.numpy())))
    assert np.array_equal(got.numpy(), want) and want[0, 0] == len(rows[0])


# -- the sorted engine (X7) and the host wrappers ------------------------------


def test_sorted_pairwise_counts_matches_jax():
    rows = overlapping_rows(20, 500, np.random.default_rng(21))
    rows[3] = np.unique(np.concatenate([rows[3], [MAX_U64]]))
    rows[4] = np.unique(np.concatenate([rows[4], [MAX_U64]]))
    H, lens = jis.pack_sketches(rows, pad_rows=True)
    want = np.asarray(jis._pairwise_counts(jnp.asarray(H), jnp.asarray(lens)))
    got = tis._pairwise_counts(u64.from_numpy(H), torch.from_numpy(lens))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got[:20, :20], oracle_counts(rows))


def test_sorted_query_vs_many_counts_matches_jax():
    rng = np.random.default_rng(22)
    rows = overlapping_rows(12, 400, rng)
    q = np.unique(np.concatenate([rows[2], rows[7][::3], [MAX_U64]]))
    rows[7] = np.unique(np.concatenate([rows[7], [MAX_U64]]))
    H, lens = jis.pack_sketches(rows, pad_rows=True)
    qp, q_len = jis.pack_query(q)
    want = np.asarray(jis._query_vs_many_counts(jnp.asarray(qp), jnp.asarray(q_len),
                                                jnp.asarray(H), jnp.asarray(lens)))
    got = tis._query_vs_many_counts(u64.from_numpy(qp), q_len, u64.from_numpy(H),
                                    torch.from_numpy(lens)).numpy()
    assert np.array_equal(got, want)
    assert got[:12].tolist() == [len(np.intersect1d(q, m)) for m in rows]


# (n rows, hashes a row): n * total below and above _HOST_WORK_CUTOFF
SIDES = {"host joins": (10, 300), "sorted engine": (70, 600)}


@pytest.mark.parametrize("side", list(SIDES))
def test_pairwise_intersection_counts_matches_jax(side):
    n, size = SIDES[side]
    rows = overlapping_rows(n, size, np.random.default_rng(n))
    work = n * sum(len(m) for m in rows)
    assert (work < tis._HOST_WORK_CUTOFF) == (side == "host joins")
    assert tis._HOST_WORK_CUTOFF == jis._HOST_WORK_CUTOFF
    got = tis.pairwise_intersection_counts(rows, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, jis.pairwise_intersection_counts(rows))
    assert np.array_equal(got, oracle_counts(rows))


@pytest.mark.parametrize("side", ["host joins", "sorted engine"])
def test_query_intersection_counts_matches_jax(side):
    rng = np.random.default_rng(31)
    n = 10 if side == "host joins" else 400
    rows = overlapping_rows(n, 600 if side == "host joins" else 5000, rng)
    q = np.unique(np.concatenate([rows[1], rows[n - 1][::2]]))
    total = len(q) * n + sum(len(m) for m in rows)
    assert (total < tis._HOST_WORK_CUTOFF) == (side == "host joins")
    got = tis.query_intersection_counts(q, rows, device="cpu")
    assert np.array_equal(got, jis.query_intersection_counts(q, rows))
    assert got.tolist() == [len(np.intersect1d(q, m)) for m in rows]


# -- the abundance products (products_block, X6) ------------------------------


def weighted_rows(rng, n=9):
    """Rows with abundances: 2^64-1 in two rows (a valid hash here) and
    rows 0 and 1 sharing 11 hashes of one bucket of B = 128 (a depth of 11
    or more, past 8)."""
    rows = overlapping_rows(n, 120, rng)
    rows[2] = np.unique(np.concatenate([rows[2], [MAX_U64]]))
    rows[5] = np.unique(np.concatenate([rows[5], [MAX_U64]]))
    deep = (np.arange(11, dtype=np.uint64) << np.uint64(32)) * np.uint64(128) + np.uint64(5)
    rows[0] = np.unique(np.concatenate([rows[0], deep]))
    rows[1] = np.unique(np.concatenate([rows[1], deep[2:]]))
    abunds = [rng.integers(1, 1000, size=len(m)).astype(np.int64) for m in rows]
    return rows, abunds


def test_pack_weighted_matches_jax():
    rows, abunds = weighted_rows(np.random.default_rng(41))
    got = tbk._pack_weighted(rows, abunds)
    want = jbk._pack_weighted(rows, abunds)
    assert got[4] == want[4] == 128
    assert got[0].shape[1] > 8, "no bucket deeper than 8"
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_products_block_plain_matches_jax():
    rows, abunds = weighted_rows(np.random.default_rng(42))
    hi, lo, av, cnt, _B = tbk._pack_weighted(rows, abunds)
    want = np.asarray(jbk._products_block_impl(
        jnp.asarray(hi[:4]), jnp.asarray(lo[:4]), jnp.asarray(av[:4]), jnp.asarray(cnt[:4]),
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(av), jnp.asarray(cnt)))
    t = [tbk.to_torch(x) for x in (hi, lo, av, cnt)]
    got = cg.products_block_plain(t[0][:4], t[1][:4], t[2][:4], t[3][:4], *t)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(cg.products_block(t[0][:4], t[1][:4], t[2][:4], t[3][:4], *t).numpy(),
                          want)
    assert np.array_equal(got.numpy()[:, : len(rows)], oracle_products(rows, abunds)[:4])


@pytest.mark.parametrize("block", [None, 5])
def test_pairwise_weighted_products_matches_jax(block):
    rows, abunds = weighted_rows(np.random.default_rng(43), n=12)
    got = tbk.pairwise_weighted_products(rows, abunds, block=block, device="cpu")
    want = np.asarray(jbk.pairwise_weighted_products(rows, abunds))
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, oracle_products(rows, abunds))


def _weighted_planes():
    rows, abunds = weighted_rows(np.random.default_rng(44))
    return [tbk.to_torch(x) for x in tbk._pack_weighted(rows, abunds)[:4]]


def test_products_block_takes_a_valid_prefix_out_of_order():
    """Two valid slots of a query column swapped, and a non-zero value past
    a column's valid prefix, give JAX's products: the join needs no order
    and reads no slot past an occupancy."""
    hi, lo, av, cnt = _weighted_planes()
    r, b = (int(x) for x in torch.nonzero(cnt >= 2)[0])
    hi2, lo2, av2 = hi.clone(), lo.clone(), av.clone()
    for new, old in ((hi2, hi), (lo2, lo), (av2, av)):
        new[r, 0, b], new[r, 1, b] = old[r, 1, b], old[r, 0, b]
    r1, b1 = (int(x) for x in torch.nonzero(cnt == 1)[0])
    hi2[r1, 1, b1] = 7
    got = cg.products_block(hi2, lo2, av2, cnt, hi, lo, av, cnt)
    u32 = [tbk.to_numpy_u32(x) for x in (hi2, lo2, hi, lo)]
    want = np.asarray(jbk._products_block_impl(
        jnp.asarray(u32[0]), jnp.asarray(u32[1]), jnp.asarray(av2.numpy()),
        jnp.asarray(cnt.numpy()), jnp.asarray(u32[2]), jnp.asarray(u32[3]),
        jnp.asarray(av.numpy()), jnp.asarray(cnt.numpy())))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), cg.products_block(hi, lo, av, cnt, hi, lo, av, cnt).numpy())


def test_products_block_rejects_mismatched_planes():
    hi, lo, av, cnt = _weighted_planes()
    with pytest.raises(TypeError, match="do not match"):
        cg.products_block(hi, lo, av[:, :-1].contiguous(), cnt, hi, lo, av, cnt)
    with pytest.raises(TypeError, match="Qcnt"):
        cg.products_block(hi, lo, av, cnt[:-1], hi, lo, av, cnt)
    with pytest.raises(TypeError, match="uint8"):
        cg.products_block(hi, lo, av, cnt.to(torch.int32), hi, lo, av, cnt)
    with pytest.raises(TypeError, match="do not match"):
        cg.products_block(hi, lo, av, cnt, hi[:, :, :64].contiguous(), lo, av, cnt)


# -- the compare_serial* matrices ----------------------------------------------


def _sig_pair(rows, abunds, i, track):
    "The same sketch as a sourmash_tpu and a sourmash_tpu_torch signature."
    mh = MinHash(0, 31, scaled=1000, track_abundance=track)
    if track:
        mh.set_abundances(dict(zip(rows[i].tolist(), abunds[i].tolist())))
    else:
        mh.add_many(rows[i])
    params = dict(ksize=31, moltype="DNA", num=0, scaled=1000, seed=42, track_abundance=track)
    tsig = sourmash_tpu_torch.signature_from_arrays(params, rows[i], abunds[i] if track else None,
                                                    name=f"s{i}")
    return SourmashSignature(mh, name=f"s{i}"), tsig


MODES = {
    "jaccard": ("compare_serial", dict(ignore_abundance=True)),
    "angular": ("compare_serial", dict(ignore_abundance=False)),
    "containment": ("compare_serial_containment", {}),
    "max containment": ("compare_serial_max_containment", {}),
    "avg containment": ("compare_serial_avg_containment", {}),
}


# (mode, return_ani); with return_ani, angular takes the Jaccard path
SERIAL = [(m, ani) for m in MODES for ani in (False, True) if not (m == "angular" and ani)]


@pytest.mark.parametrize("mode,ani", SERIAL, ids=[f"{m}-{'ani' if a else 'values'}"
                                                 for m, a in SERIAL])
@pytest.mark.parametrize("side", ["host joins", "sorted engine"])
def test_compare_serial_matrices_match_jax(side, mode, ani, monkeypatch):
    """Every matrix of both packages equal under np.array_equal: the counts
    and products are exact and the scalar formulas the same."""
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    n, size = (10, 300) if side == "host joins" else (56, 900)
    rng = np.random.default_rng(n + len(mode))
    rows = overlapping_rows(n, size, rng)
    work = n * sum(len(m) for m in rows)
    assert (work < tis._HOST_WORK_CUTOFF) == (side == "host joins")
    abunds = [rng.integers(1, 50, size=len(m)).astype(np.int64) for m in rows]
    track = mode == "angular"
    pairs = [_sig_pair(rows, abunds, i, track) for i in range(n)]
    fn, kw = MODES[mode]
    kw = dict(kw, return_ani=ani)
    want = getattr(jcompare, fn)([j for j, _t in pairs], **kw)
    got = getattr(tcompare, fn)([t for _j, t in pairs], **kw)
    assert np.array_equal(got, want)
    assert got.shape == (n, n) and np.isfinite(got).all()
