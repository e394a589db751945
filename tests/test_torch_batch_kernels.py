"""The batch forms of the gather kernels against the JAX package, on the CPU.

The same seeded inputs go through `sourmash_tpu` (JAX on the CPU) and
through `sourmash_tpu_torch`, whose kernels run their plain PyTorch
versions on CPU tensors, and are compared exactly: the query block pack,
the `counts_block` join (X3b) against `_counts_block_impl`; `membership_bits_batch` (X4b) against
`_membership_bits_packed_batch`; `round_dec_batch` (X5b) and the batched
round scan against `_schedule_scan_batch` and the per-query scan; and the
bank-level `counts_for_banks_batch` against JAX's and against per-query
`counts_for_banks`, on resident and streamed banks with subject spills,
2^64-1 tails and an empty query. A block past the f32-exact range of the
JAX pad correction is held to np.intersect1d.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sourmash_tpu.index import flat as jflat
from sourmash_tpu.ops import bucketed as jbk
from sourmash_tpu.ops import index_ops as jio
from sourmash_tpu_torch.index import flat as tflat
from sourmash_tpu_torch.ops import bucketed as tbk
from sourmash_tpu_torch.ops import cuda_gather as cg
from sourmash_tpu_torch.ops import index_ops as tio

MAX = np.uint64(2**64 - 1)
CPU = torch.device("cpu")


def rand_set(rng, n, hi=2**64 - 1):
    return np.unique(rng.integers(0, hi, size=n, dtype=np.uint64))


def make_block(case, seed=3):
    """(rows, queries, B): rows sharing hashes with a block of queries that
    holds a query loaded in the hundreds per bucket beside small ones, an
    empty query, 2^64-1 in rows and queries, and (case "spills") rows
    crowding one bucket past d = 8."""
    rng = np.random.default_rng(seed)
    pool = rand_set(rng, 3000)
    rows = [np.unique(np.concatenate([rand_set(rng, int(rng.integers(50, 400))),
                                      rng.choice(pool, size=80, replace=False)]))
            for _ in range(21)]
    rows[2] = np.unique(np.concatenate([rows[2], [MAX]]))
    B = 128
    if case == "spills":
        crowd = (np.arange(11, dtype=np.uint64) << np.uint64(40)) | np.uint64(5)
        for i in (4, 5):
            rows[i] = np.unique(np.concatenate([rows[i], crowd]))
        pool = np.unique(np.concatenate([pool, crowd]))
    queries = [
        np.unique(np.concatenate([rows[2][:40], rows[4], rand_set(rng, 200), [MAX]])),
        np.zeros(0, dtype=np.uint64),
        np.unique(np.concatenate([pool, rand_set(rng, 20000)])),  # dq in the hundreds
        rows[9][:30],
    ]
    return rows, queries, B


def oracle(qs, rows):
    return np.array([[len(np.intersect1d(q, m)) for m in rows] for q in qs], dtype=np.int64)


def planes(*arrays):
    "numpy u32/u8/i32 planes as CPU torch tensors (u32 as int32 bit patterns)."
    return [tbk.to_torch(np.asarray(a)) for a in arrays]


def exact_corr(Qcnt, Scnt, dq, d):
    "The PAD==PAD hits in int64: sum_b (dq - Qcnt[q, b]) * (d - Scnt[s, b])."
    return (dq - Qcnt.astype(np.int64)) @ (d - Scnt.astype(np.int64)).T


@pytest.mark.parametrize("case", ["plain", "spills"])
def test_block_packs_match_jax(case):
    """pack_query_block_device gives the JAX device planes, and JAX's host
    pack_query_block's planes cut to its depth (the host pads to a power
    of two), with every column ascending."""
    _rows, qs, B = make_block(case)
    want = jbk.pack_query_block(qs, B)
    jhi, jlo, jcnt, jdq, _raw = jbk.pack_query_block_device(qs, B)
    thi, tlo, tcnt, tdq, _raw = tbk.pack_query_block_device(qs, B, device=CPU)
    assert jdq == tdq and jdq < want[0].shape[1]  # a multiple of 8, not a power of two
    got = (tbk.to_numpy_u32(thi), tbk.to_numpy_u32(tlo), tcnt.numpy())
    assert np.array_equal(np.asarray(jhi), got[0]) and np.array_equal(np.asarray(jlo), got[1])
    assert np.array_equal(np.asarray(jcnt), got[2]) and np.array_equal(want[2], got[2])
    for host, dev in zip(want[:2], got[:2]):
        assert np.array_equal(host[:, :tdq], dev) and (host[:, tdq:] == 0xFFFFFFFF).all()
    assert cg._columns_ascending(thi, tlo)


@pytest.mark.parametrize("pack", ["host", "device"])
@pytest.mark.parametrize("case", ["plain", "spills"])
def test_counts_block_plain_equals_jax(case, pack):
    """counts_block's join equals JAX's _counts_block_impl (its raw matches
    minus the PAD==PAD correction), and so does the port's
    _counts_block_impl; each query's counts equal counts_rows' raw matches
    minus the exact PAD==PAD count and, past the spills, np.intersect1d."""
    rows, qs, B = make_block(case)
    bank = jbk.pack_rows_bucketed(rows, B, device=False)
    if case == "spills":
        assert bank.n_spilled > 0
    if pack == "host":
        Qhi, Qlo, Qcnt = jbk.pack_query_block(qs, B)
    else:
        Qhi, Qlo, Qcnt = (np.asarray(x) for x in jbk.pack_query_block_device(qs, B)[:3])
    dq = Qhi.shape[1]
    want = np.asarray(jbk._counts_block_impl(
        *(jnp.asarray(x) for x in (Qhi, Qlo, Qcnt, bank.hi, bank.lo, bank.cnt))))
    tq = planes(Qhi, Qlo, Qcnt)
    ts = planes(bank.hi, bank.lo, bank.cnt)
    got = cg.counts_block(*tq, *ts)
    assert got.dtype == torch.int32 and got.shape == (len(qs), bank.hi.shape[0])
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tbk._counts_block_impl(*tq, *ts).numpy(), want)
    corr = exact_corr(Qcnt, bank.cnt, dq, bank.d)
    for i in range(len(qs)):
        one = cg.counts_rows(tq[0][i], tq[1][i], ts[0], ts[1]).numpy().astype(np.int64)
        assert np.array_equal(one - corr[i], got[i].numpy())
    counts = got.numpy()[:, : len(rows)].astype(np.int64)
    for i, q in enumerate(qs):
        tbk._spill_counts_qvm(q, tbk.pack_rows_bucketed(rows, B), counts[i])
    assert np.array_equal(counts, oracle(qs, rows))
    assert counts[0].any() and counts[2].any() and not counts[1].any()


def test_counts_block_refuses_bad_inputs():
    "Wrong dtype or shape raise TypeError."
    rows, qs, B = make_block("plain")
    bank = tbk.pack_rows_bucketed(rows, B, device=CPU)
    Qhi, Qlo, Qcnt = tbk.pack_query_block_device(qs, B, device=CPU)[:3]
    S = (bank.hi, bank.lo, bank.cnt)
    with pytest.raises(TypeError):
        cg.counts_block(Qhi[0], Qlo[0], Qcnt, *S)
    with pytest.raises(TypeError):
        cg.counts_block(Qhi.to(torch.int64), Qlo, Qcnt, *S)
    with pytest.raises(TypeError):
        cg.counts_block(Qhi[:, :, :64].contiguous(), Qlo[:, :, :64].contiguous(), Qcnt, *S)
    with pytest.raises(TypeError):
        cg.counts_block(Qhi, Qlo, Qcnt.to(torch.uint8), *S)
    with pytest.raises(TypeError):
        cg.counts_block(Qhi, Qlo, Qcnt[:-1], *S)
    with pytest.raises(TypeError):
        cg.counts_block(Qhi, Qlo, Qcnt, bank.hi, bank.lo, bank.cnt.to(torch.int32))


def test_counts_block_takes_columns_out_of_order():
    """The join needs no column order: a query column with two valid slots
    swapped gives JAX's counts (the JAX function needs none either)."""
    rows, qs, B = make_block("plain")
    bank = jbk.pack_rows_bucketed(rows, B, device=False)
    Qhi, Qlo, Qcnt = (np.asarray(x).copy() for x in jbk.pack_query_block_device(qs, B)[:3])
    b = int(np.flatnonzero(Qcnt[0] >= 2)[0])
    for x in (Qhi, Qlo):
        x[0, [0, 1], b] = x[0, [1, 0], b]
    want = np.asarray(jbk._counts_block_impl(
        *(jnp.asarray(x) for x in (Qhi, Qlo, Qcnt, bank.hi, bank.lo, bank.cnt))))
    got = cg.counts_block(*planes(Qhi, Qlo, Qcnt), *planes(bank.hi, bank.lo, bank.cnt))
    assert not cg._columns_ascending(*planes(Qhi, Qlo))
    assert np.array_equal(got.numpy(), want) and want[0].any()


def _membership_batch_inputs(case):
    """A chunk, a block whose depth dqm exceeds each query's own (as in
    `_membership_rows_device_batch`), per-query selections padded with row
    0, slot maps and their inverses."""
    rows, qs, B = make_block(case)
    cores = [q[:-1] if len(q) and q[-1] == MAX else q for q in qs]
    bank = jbk.pack_rows_bucketed(rows, B, device=False)
    Qhi, Qlo, Qcnt, dq, raw = tbk.pack_query_block_device(cores, B, device=CPU)
    dqm = dq + 16  # a shared depth the block undershoots: repacked, not sliced
    Qhi, Qlo, Qcnt = tbk._device_pack(raw[0], raw[1], B, dqm, torch.int32)
    W = -(-max(len(q) for q in qs) // 32)
    smaps = np.full((len(qs), W * 32), dqm * B, dtype=np.int32)
    for j, core in enumerate(cores):
        if len(core):
            smaps[j] = tbk.query_slot_map(core, B, dqm, W * 32)
    sel = np.zeros((len(qs), 7), dtype=np.int64)
    sel[0, :5] = [2, 4, 5, 0, 2]
    sel[2, :7] = [1, 3, 4, 5, 7, 9, 20]
    sel[3, :2] = [9, 2]
    return bank, (Qhi, Qlo, Qcnt), smaps, sel, dqm, W


@pytest.mark.parametrize("case", ["plain", "spills"])
def test_membership_bits_batch_plain_equals_jax(case):
    """membership_bits_batch equals JAX's _membership_bits_packed_batch on a
    block with an empty query, padded selections, repeated rows, a depth
    above every query's own and buckets holding 8 slots; each query's
    words equal membership_bits of that query."""
    bank, (Qhi, Qlo, Qcnt), smaps, sel, dqm, W = _membership_batch_inputs(case)
    if case == "spills":
        assert (bank.cnt == 8).any()
    want = np.asarray(jbk._membership_bits_packed_batch(
        jnp.asarray(tbk.to_numpy_u32(Qhi)), jnp.asarray(tbk.to_numpy_u32(Qlo)),
        jnp.asarray(bank.hi), jnp.asarray(bank.lo), jnp.asarray(bank.cnt),
        jnp.asarray(sel.astype(np.int32)), jnp.asarray(smaps)))
    tmaps = torch.from_numpy(smaps)
    inv = tbk.inverse_slot_map(tmaps, dqm * bank.B)
    assert inv.shape == (len(sel), dqm * bank.B) and inv.is_contiguous()
    S = planes(bank.hi, bank.lo, bank.cnt)
    got = cg.membership_bits_batch(Qhi, Qlo, Qcnt, *S, torch.from_numpy(sel), tmaps, inv)
    assert got.shape == (len(sel), sel.shape[1], W)
    assert np.array_equal(want, tbk.to_numpy_u32(got))
    assert got[0].any() and got[2].any() and not got[1].any()
    for q in range(len(sel)):
        one = cg.membership_bits(Qhi[q], Qlo[q], Qcnt[q], *S, torch.from_numpy(sel[q]),
                                 tmaps[q], inv[q])
        assert torch.equal(one, got[q])
        assert torch.equal(tbk.inverse_slot_map(tmaps[q], dqm * bank.B), inv[q])


def _membership_edge_case(case):
    """(rows, queries, sel, B) of one edge of membership_bits_batch: query
    hashes sharing hi limbs but not lo limbs in one bucket's column; a query
    crowded into two buckets (columns of ~600 slots); a selection repeating
    rows; a query whose W's last word is part padding, with rows holding
    its last hashes."""
    rng = np.random.default_rng(41)
    B = 128
    base = [rand_set(rng, 3000), rand_set(rng, 800)]
    if case == "shared_hi":
        his = rng.integers(0, 2**32, size=6, dtype=np.uint64)
        los = rng.integers(0, 2**25, size=(6, 40), dtype=np.uint64) << np.uint64(7) | np.uint64(9)
        special = np.unique((his[:, None] << np.uint64(32)) | los)
        qs = [np.unique(np.concatenate([base[0], special])), base[1]]
        rows = [special[::3], special[1::4], base[0][:100], np.unique(np.concatenate(
            [special[:20], base[1][:50]]))]
    elif case == "crowded":
        crowd = np.unique(rng.integers(0, 2**57, size=1200, dtype=np.uint64) << np.uint64(7)
                          | rng.choice(np.array([3, 77], dtype=np.uint64), size=1200))
        qs = [np.unique(np.concatenate([base[0][:500], crowd])), crowd[::5]]
        rows = [np.unique(np.concatenate([crowd[i::9][:8], base[0][i * 50 : i * 50 + 60]]))
                for i in range(5)]
    elif case == "repeated_rows":
        qs = base
        rows = [np.unique(np.concatenate([base[0][i::7][:60], base[1][i::9][:20],
                                          rand_set(rng, 40)])) for i in range(6)]
    else:  # tail_word
        q = base[0][: 32 * 50 + 13]
        qs = [q, base[1]]
        rows = [np.unique(np.concatenate([q[-3:], rand_set(rng, 30)])), q[-40:-1], q[::11],
                base[1][:77]]
    n = 6
    sel = np.stack([rng.integers(0, len(rows), size=n) for _ in qs]).astype(np.int64)
    if case == "repeated_rows":
        sel[0] = [4, 4, 1, 4, 0, 1]
        sel[1] = [2, 2, 2, 2, 2, 2]
    if case == "tail_word":
        sel[0, :3] = [0, 1, 2]
    return rows, qs, sel, B


@pytest.mark.parametrize("case", ["shared_hi", "crowded", "repeated_rows", "tail_word"])
def test_membership_bits_batch_edges_equal_jax(case):
    """membership_bits_batch equals JAX's _membership_bits_packed_batch (and
    the per-query membership_bits) on each edge of `_membership_edge_case`,
    and the edge is what the case says it is."""
    rows, qs, sel, B = _membership_edge_case(case)
    bank = jbk.pack_rows_bucketed(rows, B, device=False)
    Qhi, Qlo, Qcnt, dq, _raw = tbk.pack_query_block_device(qs, B, device=CPU)
    W = -(-max(len(q) for q in qs) // 32)
    smaps = np.stack([tbk.query_slot_map(q, B, dq, W * 32) for q in qs])
    want = np.asarray(jbk._membership_bits_packed_batch(
        jnp.asarray(tbk.to_numpy_u32(Qhi)), jnp.asarray(tbk.to_numpy_u32(Qlo)),
        jnp.asarray(bank.hi), jnp.asarray(bank.lo), jnp.asarray(bank.cnt),
        jnp.asarray(sel.astype(np.int32)), jnp.asarray(smaps)))
    tmaps = torch.from_numpy(smaps)
    inv = tbk.inverse_slot_map(tmaps, dq * B)
    S = planes(bank.hi, bank.lo, bank.cnt)
    got = cg.membership_bits_batch(Qhi, Qlo, Qcnt, *S, torch.from_numpy(sel), tmaps, inv)
    assert np.array_equal(want, tbk.to_numpy_u32(got)) and got.any()
    for q in range(len(qs)):
        assert torch.equal(got[q], cg.membership_bits(Qhi[q], Qlo[q], Qcnt[q], *S,
                                                      torch.from_numpy(sel[q]), tmaps[q], inv[q]))
    bits = np.unpackbits(tbk.to_numpy_u32(got).view(np.uint8), axis=-1, bitorder="little")
    for q, x in np.ndindex(sel.shape):  # bit j: query hash j is in the row
        shared = np.isin(qs[q], rows[sel[q, x]])
        j = np.flatnonzero(bits[q, x])
        assert (j < len(qs[q])).all() and shared[j].all()
        assert len(j) == shared.sum() or bank.n_spilled  # spilled hashes are the host's
    if case == "shared_hi":
        hi = qs[0] >> np.uint64(32)
        assert len(np.unique(hi)) < len(hi) - 200 and bits[0].any()
    elif case == "crowded":
        assert int(Qcnt.max()) >= 400 and bits[1].any()
    elif case == "repeated_rows":
        assert torch.equal(got[0, 0], got[0, 1]) and torch.equal(got[0, 0], got[0, 3])
        assert (got[1] == got[1, 0]).all() and got[1, 0].any()
    else:
        assert 0 < W * 32 - len(qs[0]) < 32
        last = bits[0, 0, (W - 1) * 32 :]
        assert last[len(qs[0]) - (W - 1) * 32 - 1] and not last[len(qs[0]) - (W - 1) * 32 :].any()


def test_membership_bits_batch_refuses_bad_inputs():
    """Wrong dtypes or shapes raise TypeError, a selection outside the
    chunk's rows IndexError, as they did before the table."""
    bank, (Qhi, Qlo, Qcnt), smaps, sel, dqm, W = _membership_batch_inputs("plain")
    tmaps = torch.from_numpy(smaps)
    inv = tbk.inverse_slot_map(tmaps, dqm * bank.B)
    S = planes(bank.hi, bank.lo, bank.cnt)
    tsel = torch.from_numpy(sel)
    good = [Qhi, Qlo, Qcnt, *S, tsel, tmaps, inv]
    bad = [
        (0, Qhi.to(torch.int64)), (2, Qcnt.to(torch.uint8)), (5, S[2].to(torch.int32)),
        (6, tsel.to(torch.int32)), (8, inv[:, :-1].contiguous()), (7, tmaps[:, :-5].contiguous()),
        (2, Qcnt[:-1]), (6, tsel[0]), (0, Qhi[:, :, :64].contiguous()),
    ]
    for at, x in bad:
        args = list(good)
        args[at] = x
        with pytest.raises(TypeError):
            cg.membership_bits_batch(*args)
    for rowsel in (len(bank.cnt), -len(bank.cnt) - 1):
        out = tsel.clone()
        out[2, 3] = rowsel
        with pytest.raises(IndexError):
            cg.membership_bits_batch(Qhi, Qlo, Qcnt, *S, out, tmaps, inv)


@pytest.mark.parametrize("dq, B, W", [(0, 128, 1), (200, 4096, 18750), (3, 128, 18750),
                                      (1, 1, 1)])
def test_membership_table_groups(dq, B, W):
    """The kernel's per-query table holds every entry at most 2/5 full: its
    entries are at most the valid slots (dq * B) and the bits (32 W)."""
    groups = cg.membership_table_groups(dq, B, W)
    entries = min(dq * B, 32 * W)
    assert 5 * entries <= 2 * 4 * groups and (groups == 1 or 2 * 4 * (groups - 1) < 5 * entries)


def test_round_dec_batch_and_scan_batch_match_jax():
    """round_dec_batch equals JAX's popcount decrement and per-query
    round_dec; the batched scan equals JAX's _schedule_scan_batch with and
    without keys, and the port's per-query _schedule_scan."""
    rng = np.random.default_rng(17)
    Q, k, W = 3, 40, 12
    bits = rng.random((Q, k, W * 32)) < 0.2
    bits[0, 7] = bits[0, 3]  # ties
    bits[2] = False  # a query with nothing left
    M = np.asarray(jbk.pack_bits_u32(jnp.asarray(bits)))
    R = rng.integers(0, 2**32, size=(Q, W), dtype=np.uint64).astype(np.uint32)
    got = cg.round_dec_batch(*planes(M, R))
    want = np.stack([np.asarray(jflat._dec_counts(jnp.asarray(M[q])[:, None, :],
                                                  jnp.asarray(R[q])[None, :])) for q in range(Q)])
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())
    for q in range(Q):
        assert torch.equal(cg.round_dec(*planes(M[q], R[q])), got[q])

    counts = bits.sum(2).astype(np.int32)
    alive = np.full((Q, W), 0xFFFFFFFF, dtype=np.uint32)
    alive[1, :3] = 0
    thresh = np.array([3, 2, 1], dtype=np.int32)
    keys = np.stack([rng.permutation(k) for _ in range(Q)]).astype(np.int64)
    for kq in (None, keys):
        jcarry, (jb, jc) = jflat._schedule_scan_batch(
            jnp.asarray(M), jnp.asarray(alive), jnp.asarray(counts), jnp.asarray(thresh), 20,
            None if kq is None else jnp.asarray(kq))
        tk = None if kq is None else torch.from_numpy(kq)
        tcarry, (tb, tc) = tflat._schedule_scan_batch(
            *planes(M, alive), torch.from_numpy(counts), torch.from_numpy(thresh), 20, tk)
        assert np.asarray(jb).tolist() == tb.tolist()
        assert np.asarray(jc).tolist() == tc.tolist()
        assert np.array_equal(np.asarray(jcarry[0]), tbk.to_numpy_u32(tcarry[0]))
        assert np.array_equal(np.asarray(jcarry[1]), tcarry[1].numpy())
        for q in range(Q):
            (a1, c1), (b1, n1) = tflat._schedule_scan(
                *planes(M[q]), (tbk.to_torch(alive[q]), torch.from_numpy(counts[q])),
                int(thresh[q]), 20, None if tk is None else tk[q])
            assert b1.tolist() == tb[q].tolist() and n1.tolist() == tc[q].tolist()
            assert torch.equal(a1, tcarry[0][q]) and torch.equal(c1, tcarry[1][q])
        assert (tb[0] >= 0).sum() > 3 and (tb[2] < 0).all()


def _bank_rows(seed=21):
    """Rows of several length classes: one with 32 hashes in one bucket and
    2^64-1 (spills), an empty row; queries of each kind in one block."""
    rng = np.random.default_rng(seed)
    sizes = [50, 400, 3, 1000, 256, 0, 2500, 700, 120]
    rows = [rand_set(rng, s) for s in sizes]
    rows[1] = np.unique(np.concatenate(
        [rows[1], np.arange(1, 33, dtype=np.uint64) * np.uint64(1 << 20), [MAX]]))
    qs = [
        np.unique(np.concatenate([rows[0][:20], rows[1][:300], rows[3][100:600], rows[6][::3],
                                  rand_set(rng, 5000), [MAX]])),
        np.zeros(0, dtype=np.uint64),
        rows[1],
        np.unique(np.concatenate([rows[7], rows[8][:50], rand_set(rng, 300)])),
        rows[6][1::2],
    ]
    return rows, qs


@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_counts_for_banks_batch_matches_jax(route, monkeypatch):
    """counts_for_banks_batch equals JAX's, the port's per-query
    counts_for_banks and np.intersect1d, on both bank routes, in blocks
    that split the queries unevenly."""
    rows, qs = _bank_rows()
    if route == "streamed":
        monkeypatch.setenv("SOURMASH_TPU_HBM_BUDGET_BYTES", "1")
        monkeypatch.setenv(tio.BUDGET_ENV, "1")
    jbanks = jio.build_banks(rows)
    tbanks = tio.build_banks(rows, CPU)
    assert len(tbanks) > 1
    assert all(b.resident for b in tbanks) == (route == "resident")
    assert any(c.n_spilled for b in tbanks for c in b.chunks)
    n = len(rows)
    want = jio.counts_for_banks_batch(jbanks, qs, n, block=2)
    got = tio.counts_for_banks_batch(tbanks, qs, n, block=2)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, oracle(qs, rows))
    assert np.array_equal(got, np.stack([tio.counts_for_banks(tbanks, q, n) for q in qs]))
    assert np.array_equal(tio.counts_for_banks_batch(tbanks, qs, n, block=8), got)


def test_counts_block_pad_correction_exact_past_f32():
    """A block whose first query holds 8,000 hashes in one bucket (dq =
    8,000 at B = 512) puts d times its PAD slots past 2^24, where the JAX
    f32 PAD correction rounds (as
    test_torch_bucketed.py::test_pad_correction_exact_past_f32 shows): the
    port's join reads only valid slots, and every count of the block
    equals np.intersect1d."""
    rng = np.random.default_rng(0)
    B = 512
    one = np.unique(rng.integers(0, 2**55, size=8000, dtype=np.uint64) << np.uint64(9))
    q = np.unique(np.concatenate([one, rand_set(rng, 1500)]))
    rows = [np.unique(np.concatenate([rand_set(rng, int(rng.integers(900, 1200))),
                                      rng.choice(q, size=int(rng.integers(0, 60)), replace=False)]))
            for _ in range(6)]
    qs = [q, q[::7], rows[2][:100]]
    bank = tbk.pack_rows_bucketed(rows, B, device=CPU)
    Qhi, Qlo, Qcnt, dq, _raw = tbk.pack_query_block_device(qs, B, device=CPU)
    assert bank.B == B and dq >= 8000
    assert bank.d * (dq * B - len(q)) >= 2**24 and bank.d * dq * B < 2**31
    got = tbk._counts_block_impl(Qhi, Qlo, Qcnt, bank.hi, bank.lo, bank.cnt)
    counts = got.numpy()[:, : len(rows)].astype(np.int64)
    assert bank.n_spilled  # rows holding dozens of the crowded bucket's hashes
    for i, qi in enumerate(qs):
        tbk._spill_counts_qvm(qi, bank, counts[i])
    assert np.array_equal(counts, oracle(qs, rows))
