"""The port's bucketed counts engine against the JAX package, on the CPU.

The same seeded inputs go through `sourmash_tpu` (JAX on the CPU; T1,
`tools/exp_pallas_counts.py:_counts_rows_pallas`, in interpret mode) and
through `sourmash_tpu_torch`, whose kernels run their plain PyTorch
versions on CPU tensors. Everything here is integer work and is compared
exactly: packed planes, spills, raw and final counts, cutoff counts,
membership words, round decrements and round scans, and the bank-level
counts on the resident and the streamed route. A torture test holds the
counts against np.intersect1d. Numpy emulations of the CUDA kernels'
algorithms (the counts kernel's binary search of each slot in its bucket's
ascending query column; the membership kernel's row-driven search) are held
to the JAX functions; hypothesis checks that the query packs give the
ascending columns the counts kernel needs.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sourmash_tpu.index import flat as jflat
from sourmash_tpu.ops import bucketed as jbk
from sourmash_tpu.ops import index_ops as jio
from sourmash_tpu.ops import intersect as jix
from sourmash_tpu_torch.index import flat as tflat
from sourmash_tpu_torch.ops import bucketed as tbk
from sourmash_tpu_torch.ops import cuda_gather as cg
from sourmash_tpu_torch.ops import index_ops as tio
from sourmash_tpu_torch.ops import intersect as tix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX = np.uint64(2**64 - 1)
CPU = torch.device("cpu")


def _t1():
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_counts", os.path.join(REPO, "tools", "exp_pallas_counts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._counts_rows_pallas


def rand_set(rng, n, lo=0, hi=2**64 - 1):
    return np.unique(rng.integers(lo, hi, size=n, dtype=np.uint64))


def overlapping_rows(rng, n_rows, size, shared_frac=0.3):
    "Rows sharing a common pool, so intersections are nonzero."
    pool = rand_set(rng, int(size * n_rows * 0.4))
    rows = []
    for _ in range(n_rows):
        pick = rng.choice(pool, size=int(size * shared_frac), replace=False)
        rows.append(np.unique(np.concatenate([rand_set(rng, size), pick])))
    return rows


def make_case(name, seed=7):
    """(rows, query, B) of one adversarial case (the cases of
    tests/test_bucketed.py). Hashes span the whole u64 range, so about
    half are >= 2^63."""
    rng = np.random.default_rng(seed)
    if name == "exact":
        rows = overlapping_rows(rng, 23, 400)
        q = np.unique(np.concatenate([rows[3][:200], rand_set(rng, 300)]))
        return rows, q, jbk.choose_buckets(512)
    if name == "spills":  # Poisson(3.1) load at B=128: many buckets over d=8
        rows = overlapping_rows(rng, 17, 400)
        return rows, np.unique(np.concatenate([rows[5][:150], rand_set(rng, 200)])), 128
    if name == "max_u64":
        a = np.unique(np.array([1, 5, MAX, 2**63], dtype=np.uint64))
        b = np.unique(np.array([5, MAX, 7], dtype=np.uint64))
        return [a, b, rand_set(rng, 50)], a, 128
    if name == "empty":
        rows = [rand_set(rng, 100), np.zeros(0, dtype=np.uint64), rand_set(rng, 50)]
        return rows, rows[0], 128
    if name == "huge_query":  # query loads in the hundreds per bucket (dq > 256)
        rows = [rand_set(rng, 45) for _ in range(40)]
        q = np.unique(np.concatenate(rows[:5] + [rand_set(rng, 80000)]))
        return rows, q, jbk.choose_buckets(45)
    raise KeyError(name)


CASES = ["exact", "spills", "max_u64", "empty", "huge_query"]


def oracle(q, rows, cuts=None):
    if cuts is None:
        return [len(np.intersect1d(q, m)) for m in rows]
    return [len(np.intersect1d(q[q <= c], m[m <= c])) for c, m in zip(cuts, rows)]


def planes(*arrays):
    "numpy u32/u8/i32 planes as CPU torch tensors (u32 as int32 bit patterns)."
    return [tbk.to_torch(np.asarray(a)) for a in arrays]


def assert_same_bank(jax_bank, port_bank):
    assert np.array_equal(np.asarray(jax_bank.hi), tbk.to_numpy_u32(port_bank.hi))
    assert np.array_equal(np.asarray(jax_bank.lo), tbk.to_numpy_u32(port_bank.lo))
    cnt = port_bank.cnt.numpy() if torch.is_tensor(port_bank.cnt) else port_bank.cnt
    assert np.array_equal(np.asarray(jax_bank.cnt), cnt)
    assert port_bank.n_spilled == jax_bank.n_spilled
    assert len(port_bank.spills) == len(jax_bank.spills)
    for a, b in zip(jax_bank.spills, port_bank.spills):
        assert np.array_equal(a, b)
    assert (port_bank.n, port_bank.d, port_bank.B) == (jax_bank.n, jax_bank.d, jax_bank.B)


@pytest.mark.parametrize("case", CASES)
def test_host_native_and_device_packs_match_jax(case):
    rows, _q, B = make_case(case)
    want = jbk.pack_rows_bucketed(rows, B, device=False)
    assert_same_bank(want, tbk.pack_rows_bucketed(rows, B))
    assert_same_bank(want, tbk._pack_rows_numpy(rows, B))
    assert_same_bank(want, tbk.pack_rows_device(rows, B, device=CPU))
    assert_same_bank(want, tbk.pack_rows_bucketed(rows, B, device=CPU))
    if case == "spills":
        assert want.n_spilled > 0


@pytest.mark.parametrize("B", [128, 512, 2048])
def test_query_packs_match_jax(B):
    rng = np.random.default_rng(9)
    q = np.unique(np.concatenate([rand_set(rng, 20000), [MAX]]))
    jhi, jlo, jcnt, jdq, jtail = jbk.pack_query_bucketed(q, B, device=False)
    thi, tlo, tcnt, tdq, ttail = tbk.pack_query_bucketed(q, B)
    assert (jdq, jtail) == (tdq, ttail)
    for a, b in ((jhi, thi), (jlo, tlo), (jcnt, tcnt)):
        assert np.array_equal(a, b)
    Jhi, Jlo, Jcnt, Jdq, _ = jbk.pack_query_block_device([q], B)
    Thi, Tlo, Tcnt, Tdq, _ = tbk.pack_query_block_device([q], B, device=CPU)
    assert Jdq == Tdq
    assert np.array_equal(np.asarray(Jhi), tbk.to_numpy_u32(Thi))
    assert np.array_equal(np.asarray(Jlo), tbk.to_numpy_u32(Tlo))
    assert np.array_equal(np.asarray(Jcnt), Tcnt.numpy())


@pytest.mark.parametrize("case,B,dq_extra", [("spills", 128, 0), ("exact", 256, 8), ("max_u64", 128, 0)])
def test_counts_rows_plain_equals_t1_interpret(case, B, dq_extra):
    """T1's raw contract, PAD==PAD hits included, exactly: the query planes
    get `dq_extra` more PAD rows to vary dq."""
    rows, q, _ = make_case(case)
    bank = jbk.pack_rows_bucketed(rows, B, device=False)
    qhi, qlo, _qcnt, dq, _tail = jbk.pack_query_bucketed(q, B, device=False)
    pad = np.full((dq_extra, B), 0xFFFFFFFF, dtype=np.uint32)
    qhi, qlo = np.concatenate([qhi, pad]), np.concatenate([qlo, pad])
    dq += dq_extra
    n, d = bank.hi.shape[0], bank.hi.shape[1]
    gb = B // 128
    want = _t1()(
        jnp.asarray(qhi.reshape(dq * gb, 128)), jnp.asarray(qlo.reshape(dq * gb, 128)),
        jnp.asarray(bank.hi.reshape(n, d * gb, 128)), jnp.asarray(bank.lo.reshape(n, d * gb, 128)),
        d=d, dq=dq, gb=gb, interpret=True,
    )
    got = cg.counts_rows(*planes(qhi, qlo, bank.hi, bank.lo))
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())
    assert int(got.sum()) > 0


@pytest.mark.parametrize("case", CASES)
def test_counts_and_cutoff_counts_match_jax(case):
    rows, q, B = make_case(case)
    jbank = jbk.pack_rows_bucketed(rows, B)
    tbank = tbk.pack_rows_bucketed(rows, B, device=CPU)
    # the device counts before spills, padding rows included
    jq = jbk.pack_query_bucketed(q, B)
    tq = tbk.pack_query_bucketed(q, B, CPU)
    want_raw = np.asarray(jbk._counts_qvm(jq[0], jq[1], jq[2], jbank.hi, jbank.lo, jbank.cnt))
    assert np.array_equal(want_raw, tbk.query_counts_device(tbank, tq).numpy())

    got = tbk.query_counts_bucketed(q, tbank)
    assert got.tolist() == jbk.query_counts_bucketed(q, jbank).tolist() == oracle(q, rows)

    rng = np.random.default_rng(3)
    pool = np.array([2**61, 2**62, 2**63, 2**63 + 2**62, int(MAX), 2**60, 0], dtype=np.uint64)
    cuts = rng.choice(pool, size=len(rows))
    got = tbk.query_cutoff_counts_bucketed(q, tbank, cuts)
    want = jbk.query_cutoff_counts_bucketed(q, jbank, cuts)
    assert got.tolist() == want.tolist() == oracle(q, rows, cuts)


def test_counts_rows_cutoff_is_unsigned():
    "A cut >= 2^63 keeps every hash below it, whatever its sign bit."
    q = np.array([5, 2**63 - 1, 2**63, 2**63 + 5, 2**64 - 2], dtype=np.uint64)
    bank = tbk.pack_rows_bucketed([q] * 4, 128, device=CPU)
    cuts = np.array([2**63 - 1, 2**63, 2**64 - 3, 4], dtype=np.uint64)
    assert tbk.query_cutoff_counts_bucketed(q, bank, cuts).tolist() == [2, 3, 4, 0]


def _pairs(hi, lo):
    "u64 values of u32 (hi, lo) limb planes."
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


def _lower_bound(col, v):
    """The counts kernel's branch-free lower bound: the first position of
    the ascending column whose pair is >= each value of v, with steps that
    depend on len(col) alone."""
    n = len(col)
    base = np.zeros(np.shape(v), dtype=np.int64)
    if n == 0:
        return base
    while n > 1:
        half = n >> 1
        base = np.where(col[base + half] < v, base + half, base)
        n -= half
    return base + (col[base] < v)


def _search_counts(qhi, qlo, Shi, Slo, cuts=None):
    """The counts kernel's algorithm in numpy, per bucket: a PAD slot takes
    the bucket's PAD run (the column's length past the lower bound of PAD),
    counted only under the cut 2^64-1; any other slot value v <= the row's
    cut takes the walk along the equal pairs from its lower bound."""
    q64 = _pairs(qhi, qlo)  # [dq, B]
    s64 = _pairs(Shi, Slo)  # [rows, d, B]
    dq, B = q64.shape
    cut = np.full((s64.shape[0], 1), MAX) if cuts is None else np.asarray(cuts, np.uint64)[:, None]
    out = np.zeros(s64.shape[0], dtype=np.int64)
    for b in range(B):
        col = q64[:, b]
        pad_run = dq - int(_lower_bound(col, np.array([MAX]))[0])
        v = s64[:, :, b]
        p = _lower_bound(col, v)
        run = np.zeros(v.shape, dtype=np.int64)
        alive = p < dq
        while alive.any():
            alive &= col[np.minimum(p, max(dq - 1, 0))] == v
            run += alive
            p += 1
            alive &= p < dq
        out += np.where(v == MAX, pad_run * (cut == MAX), run * (v <= cut)).sum(axis=1)
    return out


def _hi_limb_ones(rng, n):
    "n distinct hashes whose hi limb is 0xFFFFFFFF (2^64-1, the PAD pair, excluded)."
    lo = np.unique(rng.integers(0, 2**32 - 1, size=n, dtype=np.uint64))
    return (np.uint64(0xFFFFFFFF) << np.uint64(32)) | lo


@pytest.mark.parametrize("case,B,dq_extra", [
    ("spills", 128, 0), ("exact", 256, 8), ("max_u64", 128, 3), ("huge_query", 128, 0)])
def test_counts_search_equals_t1_interpret_and_plain(case, B, dq_extra):
    """The counts kernel's search (lower bound, equal run, PAD run, unsigned
    cut) against T1 in interpret mode and the plain version, raw counts,
    PAD==PAD hits included; with cuts against the plain version and, less
    the pad correction, the JAX cutoff accumulator. The packs hold spills,
    the 2^64-1 tail, hashes whose hi limb is 0xFFFFFFFF and `dq_extra`
    more PAD rows; the huge query's columns run to hundreds of slots."""
    rows, q, _ = make_case(case)
    rng = np.random.default_rng(17)
    ones = _hi_limb_ones(rng, 40)
    rows = [np.unique(np.concatenate([r, ones[i % 3 :: 3]])) for i, r in enumerate(rows)]
    q = np.unique(np.concatenate([q, ones[::2], [MAX]]))
    bank = jbk.pack_rows_bucketed(rows, B, device=False)
    qhi, qlo, qcnt, dq, tail = jbk.pack_query_bucketed(q, B, device=False)
    assert tail == MAX
    pad = np.full((dq_extra, B), 0xFFFFFFFF, dtype=np.uint32)
    qhi, qlo = np.concatenate([qhi, pad]), np.concatenate([qlo, pad])
    dq += dq_extra
    n, d = bank.hi.shape[0], bank.hi.shape[1]
    gb = B // 128
    want = np.asarray(_t1()(
        jnp.asarray(qhi.reshape(dq * gb, 128)), jnp.asarray(qlo.reshape(dq * gb, 128)),
        jnp.asarray(bank.hi.reshape(n, d * gb, 128)), jnp.asarray(bank.lo.reshape(n, d * gb, 128)),
        d=d, dq=dq, gb=gb, interpret=True))
    search = _search_counts(qhi, qlo, bank.hi, bank.lo)
    assert np.array_equal(search, want)
    tq = planes(qhi, qlo)
    ts = planes(bank.hi, bank.lo)
    assert np.array_equal(cg.counts_rows_plain(*tq, *ts).numpy(), want)
    assert np.array_equal(cg.counts_rows(*tq, *ts).numpy(), want)
    assert int(want.sum()) > 0

    pool = np.array([2**63 - 1, 2**63, 2**64 - 2, int(MAX), int(ones[5]), 0, 2**62],
                    dtype=np.uint64)
    cuts = rng.choice(pool, size=n)
    cut_planes = planes((cuts >> np.uint64(32)).astype(np.uint32),
                        (cuts & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    got = cg.counts_rows_plain(*tq, *ts, *cut_planes).numpy()
    assert np.array_equal(_search_counts(qhi, qlo, bank.hi, bank.lo, cuts), got)
    npad_q = (dq - qcnt.astype(np.int64))[None, :]
    corr = ((d - bank.cnt.astype(np.int64)) * npad_q).sum(axis=1)
    jcut = np.asarray(jbk._counts_qvm_cutoff_impl(
        jnp.asarray(qhi), jnp.asarray(qlo), jnp.asarray(qcnt), jnp.asarray(bank.hi),
        jnp.asarray(bank.lo), jnp.asarray(bank.cnt), *(jnp.asarray(np.asarray(c)) for c in (
            (cuts >> np.uint64(32)).astype(np.uint32), (cuts & np.uint64(0xFFFFFFFF)).astype(np.uint32)))))
    assert np.array_equal(got - np.where(cuts == MAX, corr, 0), jcut)


def test_counts_search_counts_repeated_query_pairs():
    """A column may repeat a pair (the plain version counts each copy): the
    walk along the equal run gives the plain version's count."""
    rng = np.random.default_rng(8)
    B, dq = 128, 12
    col = np.sort(rng.integers(0, 2**64 - 1, size=(dq, B), dtype=np.uint64), axis=0)
    col[3:6] = col[3]  # three copies of slot 3's pair in every column
    col[-2:] = MAX
    S = np.full((8, 8, B), MAX, dtype=np.uint64)
    S[:, 0] = col[3]
    S[:, 1] = col[7]
    S[2:, 2] = col[0] + np.uint64(1)  # a miss
    hi, lo = (col >> np.uint64(32)).astype(np.uint32), (col & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    Shi, Slo = (S >> np.uint64(32)).astype(np.uint32), (S & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = cg.counts_rows(*planes(hi, lo, Shi, Slo)).numpy()
    assert np.array_equal(_search_counts(hi, lo, Shi, Slo), want)
    assert want[0] == B * (3 + 1 + 6 * 2)


def _columns_ascending_np(hi, lo):
    v = _pairs(hi, lo)
    return bool((v[1:] >= v[:-1]).all())


def test_query_packs_give_ascending_columns():
    "pack_query_bucketed and pack_query_block_device (CPU): every column ascending, PAD last."
    from hypothesis import given, settings, strategies as st

    u64 = st.integers(min_value=0, max_value=2**64 - 1)
    hi_ones = st.integers(min_value=0, max_value=2**32 - 1).map(lambda x: (0xFFFFFFFF << 32) | x)

    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.one_of(u64, hi_ones, st.just(2**64 - 1)), max_size=600),
           st.sampled_from([128, 256]))
    def check(values, B):
        q = np.unique(np.array(values, dtype=np.uint64))
        for hi, lo, cnt, dq in (tbk.pack_query_bucketed(q, B)[:4],
                                _block_pack(q, B)):
            assert _columns_ascending_np(hi, lo)
            v = _pairs(hi, lo)
            pad = v == MAX
            # PAD only after a column's qcnt valid slots, and every slot past them PAD
            assert np.array_equal(pad, np.arange(dq)[:, None] >= np.asarray(cnt)[None, :])
            cg._check_query_order(*planes(hi, lo))

    check()


def _block_pack(q, B):
    Qhi, Qlo, Qcnt, dq, _raw = tbk.pack_query_block_device([q], B, device=CPU)
    return tbk.to_numpy_u32(Qhi[0]), tbk.to_numpy_u32(Qlo[0]), Qcnt[0].numpy(), dq


@pytest.mark.parametrize("swap", ["hi", "lo", "pad"])
def test_counts_rows_refuses_a_column_out_of_order(swap):
    """counts_rows raises TypeError (not ValueError, which gather's prefetch
    would take for "no matches") on a query column that is not ascending:
    two slots swapped by their hi limbs, by their lo limbs alone, or a PAD
    before a valid slot. The plain version stays general."""
    rows, q, B = make_case("exact")
    bank = tbk.pack_rows_bucketed(rows, B, device=CPU)
    qhi, qlo, qcnt, _dq, _tail = tbk.pack_query_bucketed(q, B)
    b = int(np.argmax(qcnt))
    assert qcnt[b] >= 2
    qhi, qlo = qhi.copy(), qlo.copy()
    if swap == "hi":
        qhi[[0, 1], b] = qhi[[1, 0], b]
        qlo[[0, 1], b] = qlo[[1, 0], b]
    elif swap == "lo":
        qhi[1, b] = qhi[0, b]
        qlo[[0, 1], b] = np.sort(qlo[[0, 1], b])[::-1]
    else:
        qhi[0, b] = qlo[0, b] = 0xFFFFFFFF
    tq = planes(qhi, qlo)
    assert not _columns_ascending_np(qhi, qlo)
    with pytest.raises(TypeError, match="not ascending"):
        cg.counts_rows(*tq, bank.hi, bank.lo)
    with pytest.raises(TypeError, match="not ascending"):
        cg.counts_rows(*tq, bank.hi, bank.lo, *planes(np.zeros(bank.hi.shape[0], np.uint32),
                                                      np.zeros(bank.hi.shape[0], np.uint32)))
    assert cg.counts_rows_plain(*tq, bank.hi, bank.lo).shape == (bank.hi.shape[0],)
    if swap == "hi":
        # planes that pass are recorded on qhi; an in-place edit is checked anew
        ok = planes(*tbk.pack_query_bucketed(q, B)[:2])
        cg.counts_rows(*ok, bank.hi, bank.lo)
        ok[0][[0, 1], b] = ok[0][[1, 0], b].clone()
        with pytest.raises(TypeError, match="not ascending"):
            cg.counts_rows(*ok, bank.hi, bank.lo)


def _membership_inputs(case):
    rows, q, B = make_case(case)
    bank = jbk.pack_rows_bucketed(rows, B, device=False)
    core = q[:-1] if q[-1] == MAX else q
    qhi, qlo, qcnt, dq, _ = jbk.pack_query_bucketed(core, B, device=False)
    W = -(-len(q) // 32)
    return rows, q, bank, (qhi, qlo, qcnt, dq), W, core


def _row_driven_bits(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, inv, W):
    """The membership kernel's algorithm in numpy: each valid slot of a
    selected row searched in the first qcnt[b] sorted slots of its bucket's
    query column, a hit mapped through inv to its bit."""
    q64 = (qhi.astype(np.uint64) << np.uint64(32)) | qlo.astype(np.uint64)  # [dq, B]
    out = np.zeros((len(sel), W), dtype=np.uint32)
    for r, s in enumerate(sel):
        for b in np.flatnonzero(Scnt[s]):
            col = q64[: qcnt[b], b]
            for k2 in range(Scnt[s, b]):
                h = (np.uint64(Shi[s, k2, b]) << np.uint64(32)) | np.uint64(Slo[s, k2, b])
                at = int(np.searchsorted(col, h))
                if at < len(col) and col[at] == h and inv[at * len(qcnt) + b] >= 0:
                    j = int(inv[at * len(qcnt) + b])
                    out[r, j >> 5] |= np.uint32(1 << (j & 31))
    return out


@pytest.mark.parametrize("slot_map", ["sorted", "identity"])
@pytest.mark.parametrize("case", ["exact", "spills", "max_u64"])
def test_membership_bits_plain_and_slot_map_match_jax(case, slot_map):
    """membership_bits with its query occupancy and inverse slot map, on the
    sorted-query index map of the device route and the identity map of
    membership_matrix (PAD positions included), against the JAX function;
    the row-driven search of the kernel gives the same words. The cases
    hold a query with 2^64-1 and a bank with spills."""
    rows, q, bank, (qhi, qlo, qcnt, dq), W, core = _membership_inputs(case)
    B = bank.B
    if slot_map == "sorted":
        jmap = jbk.query_slot_map(core, B, dq, W * 32)
        tmap = tbk.query_slot_map(core, B, dq, W * 32)
        assert np.array_equal(jmap, tmap)
    else:
        jmap = tmap = np.arange(dq * B, dtype=np.int32)
        W = dq * B // 32
    inv = tbk.inverse_slot_map(torch.from_numpy(tmap), dq * B)
    sel = np.array([i for i in (2, 0, 1, 1) if i < len(rows)], dtype=np.int64)
    want = jbk._membership_bits_packed(
        jnp.asarray(qhi), jnp.asarray(qlo), jnp.asarray(bank.hi[sel]),
        jnp.asarray(bank.lo[sel]), jnp.asarray(bank.cnt[sel]), jnp.asarray(jmap))
    got = cg.membership_bits(*planes(qhi, qlo, qcnt, bank.hi, bank.lo, bank.cnt),
                             torch.from_numpy(sel), torch.from_numpy(tmap), inv)
    assert np.array_equal(np.asarray(want), tbk.to_numpy_u32(got))
    assert got.any()
    row_driven = _row_driven_bits(qhi, qlo, qcnt, bank.hi, bank.lo, bank.cnt, sel,
                                  inv.numpy(), W)
    assert np.array_equal(row_driven, tbk.to_numpy_u32(got))


@pytest.mark.parametrize("case", ["exact", "spills", "max_u64", "huge_query"])
def test_inverse_slot_map_matches_jax_slot_map(case):
    """inverse_slot_map inverts the JAX query_slot_map: each query hash's
    position maps back to its index, every other position (PAD slots, and
    none for the word padding and the 2^64-1 tail) to -1."""
    _rows, q, bank, (_qhi, _qlo, qcnt, dq), W, core = _membership_inputs(case)
    B = bank.B
    jmap = jbk.query_slot_map(core, B, dq, W * 32)
    inv = tbk.inverse_slot_map(torch.from_numpy(jmap), dq * B).numpy()
    assert inv.shape == (dq * B,) and inv.dtype == np.int32
    assert np.array_equal(inv[jmap[: len(core)]], np.arange(len(core)))
    assert int((inv >= 0).sum()) == len(core) == int(qcnt.sum())
    slot = np.arange(dq * B) // B
    assert np.array_equal(inv >= 0, slot < qcnt[np.arange(dq * B) % B])


@pytest.mark.parametrize("case", ["exact", "spills"])
def test_membership_matrix_matches_jax_words(case):
    """membership_matrix: the port's words are the JAX bool matrix packed
    with pack_bits_u32, spill bits included."""
    rows, q, B = make_case(case)
    ids = [1, 4, 7]
    jM, jqp = jbk.membership_matrix(q, jbk.pack_rows_bucketed(rows, B), ids)
    want = np.asarray(jbk.pack_bits_u32(jM)).reshape(len(ids), -1)
    tM, tqp = tbk.membership_matrix(q, tbk.pack_rows_bucketed(rows, B, device=CPU), ids)
    assert np.array_equal(want, tbk.to_numpy_u32(tM))
    assert np.array_equal(tbk.pack_bits_u32(tbk.unpack_bits_u32(tM)), tM)


def test_round_dec_plain_and_union_match_jax():
    rng = np.random.default_rng(11)
    M = rng.integers(0, 2**32, size=(37, 70), dtype=np.uint64).astype(np.uint32)
    M[3] = 0xFFFFFFFF
    R = rng.integers(0, 2**32, size=70, dtype=np.uint64).astype(np.uint32)
    want = jflat._dec_counts(jnp.asarray(M)[:, None, :], jnp.asarray(R)[None, :])
    got = cg.round_dec(*planes(M, R))
    assert got.dtype == torch.int32 and np.array_equal(np.asarray(want), got.numpy())
    sel = rng.random(37) < 0.4
    want = jflat._union_rows(jnp.asarray(M)[:, None, :], jnp.asarray(sel))
    got = tflat._union_rows(tbk.to_torch(M), torch.from_numpy(sel))
    assert np.array_equal(np.asarray(want)[0], tbk.to_numpy_u32(got))
    assert np.array_equal(np.asarray(jbk.popcount_u32(jnp.asarray(M))),
                          tbk.popcount_u32(tbk.to_torch(M)).numpy())


@pytest.mark.parametrize("keyed", [False, True])
def test_schedule_scan_matches_jax(keyed):
    """The torch round loop against JAX's lax.scan: the same winners,
    counts, alive words and final counts, with and without keys (ties are
    planted so the tie rule matters)."""
    rng = np.random.default_rng(5)
    k, W = 40, 12
    bits = rng.random((k, W * 32)) < 0.2
    bits[7] = bits[3]  # an exact tie between rows 3 and 7
    M = np.asarray(jbk.pack_bits_u32(jnp.asarray(bits)))
    counts = bits.sum(1).astype(np.int32)
    alive = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    keys = rng.permutation(k).astype(np.int64) if keyed else None
    jcarry, (jb, jc) = jflat._schedule_scan(
        jnp.asarray(M), (jnp.asarray(alive), jnp.asarray(counts)), np.int32(3), 20,
        None if keys is None else jnp.asarray(keys))
    tcarry, (tb, tc) = tflat._schedule_scan(
        tbk.to_torch(M), (tbk.to_torch(alive), torch.from_numpy(counts)), 3, 20,
        None if keys is None else torch.from_numpy(keys))
    assert np.asarray(jb).tolist() == tb.tolist()
    assert np.asarray(jc).tolist() == tc.tolist()
    assert np.array_equal(np.asarray(jcarry[0]), tbk.to_numpy_u32(tcarry[0]))
    assert np.array_equal(np.asarray(jcarry[1]), tcarry[1].numpy())
    assert (np.asarray(jb) >= 0).sum() > 3


def test_counts_torture_against_intersect1d():
    "Many random banks and queries: counts_for_banks == np.intersect1d."
    rng = np.random.default_rng(1234)
    for trial in range(12):
        n = int(rng.integers(1, 30))
        hi = 2**64 - 1 if trial % 2 else 2**40
        rows = [rand_set(rng, int(rng.integers(0, 900)), hi=hi) for _ in range(n)]
        if trial % 3 == 0:
            rows[0] = np.unique(np.concatenate([rows[0], [MAX]]))
        q = np.unique(np.concatenate(
            [rows[i][: int(rng.integers(0, len(rows[i]) + 1))] for i in range(n)]
            + [rand_set(rng, int(rng.integers(0, 3000)), hi=hi),
               np.array([MAX] if trial % 4 == 0 else [], dtype=np.uint64)]))
        banks = tio.build_banks(rows, CPU)
        assert tio.counts_for_banks(banks, q, n).tolist() == oracle(q, rows), trial


def _collection(seed=21):
    rng = np.random.default_rng(seed)
    sizes = [50, 400, 3, 1000, 256, 0, 2500, 700, 120]
    rows = [rand_set(rng, s) for s in sizes]
    rows[1] = np.unique(np.concatenate(
        [rows[1], np.arange(1, 33, dtype=np.uint64) * np.uint64(1 << 20), [MAX]]))
    q = np.unique(np.concatenate([rows[0][:20], rows[1][:300], rows[3][100:600], rows[6][::3],
                                  rand_set(rng, 5000), [MAX]]))
    return rows, q


@pytest.mark.parametrize("route", ["resident", "streamed"])
def test_counts_for_banks_matches_jax(route, monkeypatch):
    rows, q = _collection()
    if route == "streamed":
        monkeypatch.setenv("SOURMASH_TPU_HBM_BUDGET_BYTES", "1")
        monkeypatch.setenv(tio.BUDGET_ENV, "1")
    jbanks = jio.build_banks(rows)
    tbanks = tio.build_banks(rows, CPU)
    assert len(tbanks) > 1
    assert all(b.resident for b in tbanks) == (route == "resident")
    assert tio.planned_banks_resident(rows, CPU) == jio.planned_banks_resident(rows) == (
        route == "resident")
    if route == "streamed":
        assert all(c.raw is not None for b in tbanks for c in b.chunks if c.n)
    n = len(rows)
    want = jio.counts_for_banks(jbanks, q, n)
    assert tio.counts_for_banks(tbanks, q, n).tolist() == want.tolist() == oracle(q, rows)
    cuts = np.random.default_rng(2).choice(
        np.array([2**62, 2**63 + 7, int(MAX), 2**64 - 2], dtype=np.uint64), size=n)
    want = jio.cutoff_counts_for_banks(jbanks, q, cuts, n)
    got = tio.cutoff_counts_for_banks(tbanks, q, cuts, n)
    assert got.tolist() == want.tolist() == oracle(q, rows, cuts)


def test_membership_for_banks_matches_jax():
    rows, q = _collection()
    ids = [1, 3, 6, 7]
    jout = jio.membership_for_banks(jio.build_banks(rows), q, ids)
    tout = tio.membership_for_banks(tio.build_banks(rows, CPU), q, ids)
    assert len(jout) == len(tout)
    for (_jb, jqp, jids, jM), (_tb, tqp, tids, tM) in zip(jout, tout):
        assert np.array_equal(jids, tids)
        assert np.array_equal(jqp[0], tqp[0]) and jqp[3] == tqp[3]
        words = np.asarray(jbk.pack_bits_u32(jM)).reshape(jM.shape[0], -1)[: len(tids)]
        assert np.array_equal(words, tbk.to_numpy_u32(tM))


@pytest.mark.parametrize("engine", ["bucketed", "sorted"])
def test_query_vs_many_cutoff_counts_engines(engine, monkeypatch):
    rows, q = _collection()
    rng = np.random.default_rng(4)
    cuts = rng.choice(np.array([2**61, 2**63, 2**63 + 2**62, int(MAX)], dtype=np.uint64), size=len(rows))
    monkeypatch.setenv("SOURMASH_TPU_ENGINE", engine)
    want = jix.query_vs_many_cutoff_counts(q, rows, cuts)
    run = tix._bucketed_cutoff_counts if engine == "bucketed" else tix._sorted_cutoff_counts
    got = run(q, rows, cuts, CPU)
    for a, b in zip(want, got):
        assert np.asarray(a).tolist() == b.tolist()
    assert got[0].tolist() == oracle(q, rows, cuts)
    # the public entry point picks by device: the sorted engine on the CPU
    public = tix.query_vs_many_cutoff_counts(q, rows, cuts, device=CPU)
    for a, b in zip(want, public):
        assert np.asarray(a).tolist() == b.tolist()


def test_pad_correction_exact_past_f32():
    """A query with 8,000 of its hashes in one bucket (dq = 8192 at B = 512)
    and 1,500 spread over the rest puts d * (dq * B - nq) at ~3.3e7, past
    2^24. The port's int64 pad correction keeps every count equal to
    np.intersect1d. The JAX package's f32 matmul rounds there: its counts
    are off by a few units (-1 among them), the one expected divergence
    between the packages. (With every hash in the one bucket the f32 sum
    stays exact, each product being a multiple of dq; the spread hashes
    make the PAD counts odd.) Below 2^24 the two packages still agree."""
    rng = np.random.default_rng(0)
    B = 512
    one = np.unique(rng.integers(0, 2**55, size=8000, dtype=np.uint64) << np.uint64(9))
    q = np.unique(np.concatenate([one, rand_set(rng, 1500)]))
    rows = [np.unique(np.concatenate([rand_set(rng, int(rng.integers(900, 1200))),
                                      rng.choice(q, size=int(rng.integers(0, 60)), replace=False)]))
            for _ in range(6)]
    jbank = jbk.pack_rows_bucketed(rows, B, device=False)
    tbank = tbk.pack_rows_bucketed(rows, B, device=CPU)
    _hi, _lo, qcnt, dq, _tail = tbk.pack_query_bucketed(q, B)
    assert jbank.B == B and dq == 8192
    assert jbank.hi.shape[1] * (dq * B - len(q)) >= 2**24
    assert jbank.hi.shape[1] * dq * B < 2**31
    want = oracle(q, rows)
    assert tbk.query_counts_bucketed(q, tbank).tolist() == want
    ref = jbk.query_counts_bucketed(q, jbank).tolist()
    assert ref != want and max(abs(a - b) for a, b in zip(ref, want)) <= 8

    small = q[::7]  # d * PAD slots below 2^24: the reference is exact again
    assert (tbk.query_counts_bucketed(small, tbank).tolist()
            == jbk.query_counts_bucketed(small, jbank).tolist() == oracle(small, rows))
