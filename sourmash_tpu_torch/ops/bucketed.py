"""Bucketed dense-compare engine for set intersection: the port of
`sourmash_tpu/ops/bucketed.py`, as far as gather, find and compare need it
(compare's all-pairs counts and abundance products at the end).

MurmurHash values are uniform, so bucketing by the low log2(B) bits spreads
a sketch of l hashes over B = next_pow2(l_max * 0.4) buckets with
Poisson(<= 2.5) occupancy. A sketch becomes two u32 limb planes hi, lo
[d = 8, B] (bucket dimension last), and intersection counting becomes a
dense equality compare between planes: the hand-written `counts_rows`
kernel (`ops/cuda_gather.py`, T1); a block of queries [bq, dq, B] is a
hash join of its valid slots against a chunk's (`counts_block`, X3b), and
compare's all-pairs matrices are hash joins of a bank's valid slots
(`ops/cuda_pairwise.py`).

Exactness is kept by construction, as in the JAX package:

- slots past a bucket's occupancy hold PAD = 2**64-1 in both limbs. For
  one query, PAD==PAD hits are counted by `counts_rows` and subtracted
  exactly by the pad-count correction `corr[s] = sum_b npad_s[b] *
  npad_q[b]`, summed in int64, so counts are exact while the kernel's
  int32 accumulator is (d * dq * B < 2^31); the block joins read only
  valid slots and need no correction. The JAX package sums it as a
  float32 matmul, which rounds once d times the query's PAD slots (dq * B
  minus its hashes) reaches 2^24: the port is right there and the
  reference is not;
- a real hash equal to PAD (only at scaled=1) and any element past the
  d-th slot of a full bucket go to host spill lists at pack time and are
  joined exactly on the host;
- queries pack with dq at least their largest bucket load, so the query
  side never spills.

Torch form of a plane: `hi`, `lo` are int32 bit patterns of the u32 limbs
(PAD is -1), `cnt` is uint8 for subject banks and int32 for query planes;
host mins stay numpy uint64. Every ordered comparison of limbs flips the
sign bit first. Host-streamed chunks keep numpy uint32/uint8 planes and the
raw limb rows, which are uploaded and packed on the device per pass.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import cuda_gather, cuda_pairwise

MAX_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_D = 8  # subject slots per bucket
_PAD32 = -1  # 0xFFFFFFFF as an int32 bit pattern


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def choose_buckets(max_len: int) -> int:
    """Bucket count (power of two) for rows up to max_len hashes: max mean
    load <= 2.5, putting Poisson spill past d=8 at ~1e-3 per bucket."""
    return _next_pow2(max(128, -(-max_len * 2 // 5)))


def _pad_rows(n: int) -> int:
    "Row padding: powers of two up to 2048, then multiples of 2048."
    if n <= 2048:
        return _next_pow2(max(8, n))
    return -(-n // 2048) * 2048


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    "A numpy uint32 (or uint8/int32) plane as a torch tensor of int32 bit patterns."
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants writable memory
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def to_numpy_u32(t) -> np.ndarray:
    "A torch int32 plane (or numpy uint32 plane) as numpy uint32."
    if torch.is_tensor(t):
        t = t.cpu().numpy()
    return t.view(np.uint32) if t.dtype == np.int32 else t


class BucketedRows:
    """A packed bank: hi/lo [n, d, B] planes (bucket dim last), per-row
    per-bucket occupancy counts [n, B] u8, and host-side exact spill lists
    (sorted u64 per row; almost always empty). Device chunks hold torch
    tensors; host-streamed chunks numpy planes plus `raw` limb rows."""

    __slots__ = ("hi", "lo", "cnt", "spills", "n", "d", "B", "n_spilled", "raw")

    def __init__(self, hi, lo, cnt, spills, n, d, B, n_spilled, raw=None):
        self.hi = hi
        self.lo = lo
        self.cnt = cnt
        self.spills = spills
        self.n = n
        self.d = d
        self.B = B
        self.n_spilled = n_spilled
        # host-streamed chunks keep the raw padded limb rows (Hi, Lo
        # [rows, L] u32): a counting pass uploads them (~6x fewer bytes
        # than the planes) and packs on the device before counting
        self.raw = raw

    @property
    def resident(self) -> bool:
        return torch.is_tensor(self.hi)


def _bucketize(m: np.ndarray, B: int):
    """Split one sorted distinct u64 array into (bucket ids, sorted bucket
    ids, within-bucket slots, stable order). Within a bucket, slots are in
    ascending hash order."""
    b = (m & np.uint64(B - 1)).astype(np.int64)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    if len(bs):
        change = np.flatnonzero(np.diff(bs)) + 1
        starts = np.concatenate([[0], change])
        sizes = np.diff(np.concatenate([starts, [len(bs)]]))
        slot = np.arange(len(bs)) - np.repeat(starts, sizes)
    else:
        slot = np.zeros(0, dtype=np.int64)
    return b, bs, slot, order


def _concat_rows(mins_list):
    "(vals u64, offs i64[n+1]) of a list of sorted u64 arrays."
    n = len(mins_list)
    lens = np.fromiter((len(m) for m in mins_list), dtype=np.int64, count=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    vals = (
        np.concatenate([np.asarray(m, dtype=np.uint64) for m in mins_list])
        if n > 1
        else np.asarray(mins_list[0], dtype=np.uint64)
    )
    return vals, offs


def _spill_list(rows, sp_rows, sp_vals):
    "Per-row spill arrays from the (row, value) pairs, ascending by row."
    empty = np.zeros(0, dtype=np.uint64)
    spill_list = [empty] * rows
    if len(sp_vals):
        starts = np.concatenate([[0], np.flatnonzero(np.diff(sp_rows)) + 1, [len(sp_vals)]])
        for a, b in zip(starts[:-1], starts[1:]):
            spill_list[int(sp_rows[a])] = sp_vals[a:b].copy()
    return spill_list


def _to_device(hi, lo, cnt, device):
    if device is None:
        return hi, lo, cnt
    return to_torch(hi, device), to_torch(lo, device), to_torch(cnt, device)


def _pack_rows_native(mins_list, n, rows, B, d, device):
    """Thread-parallel C++ pack (native/pack.cpp): one O(N) pass per row
    across a thread pool. Value-identical to the numpy path; None for rows
    that hold no hash at all (the numpy path packs those)."""
    from .. import native

    vals, offs = _concat_rows(mins_list)
    if offs[-1] == 0:
        return None
    hi, lo, cnt, spill_rows, spill_vals = native.pack_rows(vals, offs, n, rows, B, d)
    hi, lo, cnt = _to_device(hi, lo, cnt, device)
    return BucketedRows(
        hi, lo, cnt, _spill_list(rows, spill_rows, spill_vals), n, d, B, int(len(spill_vals))
    )


def pack_rows_bucketed(mins_list, B: int, d: int = _D, device=None) -> BucketedRows:
    """Pack sorted distinct u64 hash arrays into bucketed u32 planes: the
    native pack, or the numpy pack for rows without any hash. Rows are
    padded to `_pad_rows(n)`; padding rows are all PAD (occupancy 0). With
    `device`, the planes are uploaded as torch tensors; else numpy."""
    n = len(mins_list)
    if n:
        packed = _pack_rows_native(mins_list, n, _pad_rows(n), B, d, device)
        if packed is not None:
            return packed
    return _pack_rows_numpy(mins_list, B, d, device)


def _pack_rows_numpy(mins_list, B: int, d: int = _D, device=None) -> BucketedRows:
    """The numpy pack, value-identical to the native one: one stable argsort
    of (row, bucket) keys over the concatenated hashes, then three
    fancy-index stores."""
    n = len(mins_list)
    rows = _pad_rows(n)
    hi = np.full((rows, d, B), 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full((rows, d, B), 0xFFFFFFFF, dtype=np.uint32)
    cnt = np.zeros((rows, B), dtype=np.uint8)
    spills = {}
    n_spilled = 0
    lens = np.fromiter((len(m) for m in mins_list), dtype=np.int64, count=n)
    if int(lens.sum()):
        vals, _ = _concat_rows(mins_list)
        row = np.repeat(np.arange(n, dtype=np.int64), lens)
        # PAD collision guard: 2**64-1 can be a real hash only at scaled=1
        ismax = vals == MAX_U64
        if ismax.any():
            for i in np.unique(row[ismax]):
                spills[int(i)] = np.array([MAX_U64], dtype=np.uint64)
                n_spilled += 1
            vals, row = vals[~ismax], row[~ismax]
        b = (vals & np.uint64(B - 1)).astype(np.int64)
        key = row * B + b
        order = np.argsort(key, kind="stable")  # within (row, bucket): asc hash
        ks, vs, ro, bo = key[order], vals[order], row[order], b[order]
        N2 = len(ks)
        if N2:
            pos = np.arange(N2, dtype=np.int64)
            is_start = np.empty(N2, dtype=bool)
            is_start[0] = True
            np.not_equal(ks[1:], ks[:-1], out=is_start[1:])
            starts = np.flatnonzero(is_start)
            slot = pos - np.maximum.accumulate(np.where(is_start, pos, 0))
            keep = slot < d
            hi[ro[keep], slot[keep], bo[keep]] = (vs[keep] >> np.uint64(32)).astype(np.uint32)
            lo[ro[keep], slot[keep], bo[keep]] = (vs[keep] & np.uint64(0xFFFFFFFF)).astype(
                np.uint32
            )
            sizes = np.diff(np.concatenate([starts, [N2]]))
            cnt.reshape(-1)[ks[starts]] = np.minimum(sizes, d).astype(np.uint8)
            if not keep.all():
                sp_vals, sp_rows = vs[~keep], ro[~keep]
                n_spilled += len(sp_vals)
                for i in np.unique(sp_rows):
                    both = sp_vals[sp_rows == i]
                    prev = spills.get(int(i))
                    if prev is not None:
                        both = np.concatenate([both, prev])
                    spills[int(i)] = np.sort(both)
    empty = np.zeros(0, dtype=np.uint64)
    spill_list = [spills.get(i, empty) for i in range(rows)]
    hi, lo, cnt = _to_device(hi, lo, cnt, device)
    return BucketedRows(hi, lo, cnt, spill_list, n, d, B, n_spilled)


def _device_pack(Hi, Lo, B: int, d: int, cnt_dtype):
    """Pack [rows, L] int32 limb rows (each row sorted ascending, PAD past
    its true length) into planes [rows, d, B] and occupancy [rows, B] on
    their device: a stable sort by bucket id keeps ascending-hash slot
    order, slot = position - bucket start, and overflow (slot >= d) lands
    in a dump slot that is cut off (those elements live in the host spill
    lists). Value-identical to the host pack."""
    rows, L = Hi.shape
    valid = ~((Hi == _PAD32) & (Lo == _PAD32))
    b = torch.where(valid, Lo & (B - 1), B)
    b_s, order = torch.sort(b, dim=1, stable=True)
    hi_s = Hi.gather(1, order)
    lo_s = Lo.gather(1, order)
    edges = torch.arange(B + 1, dtype=b_s.dtype, device=b_s.device).expand(rows, B + 1)
    starts = torch.searchsorted(b_s, edges.contiguous())  # [rows, B+1] int64
    pos = torch.arange(L, device=Hi.device)[None, :]
    slot = pos - starts.gather(1, b_s.long().clamp(0, B))
    cnt = torch.clamp(starts[:, 1:] - starts[:, :-1], max=d).to(cnt_dtype)
    ok = (b_s < B) & (slot < d)
    # flat position in the [rows, d, B] planes; overflow goes to one dump
    # element past the end, cut off after the scatter
    row_base = torch.arange(rows, device=Hi.device)[:, None] * (d * B)
    flat = torch.where(ok, row_base + slot * B + b_s, rows * d * B).reshape(-1)
    Phi = torch.full((rows * d * B + 1,), _PAD32, dtype=torch.int32, device=Hi.device)
    Plo = torch.full((rows * d * B + 1,), _PAD32, dtype=torch.int32, device=Hi.device)
    Phi.scatter_(0, flat, hi_s.reshape(-1))
    Plo.scatter_(0, flat, lo_s.reshape(-1))
    return Phi[:-1].view(rows, d, B), Plo[:-1].view(rows, d, B), cnt


def _device_pack_kernel(Hi, Lo, B: int, d: int):
    "Bank form of `_device_pack`: uint8 occupancy."
    return _device_pack(Hi, Lo, B, d, torch.uint8)


def query_raw_limbs(qs, device):
    """PAD-padded [bq, L] (hi, lo) int32 limb rows for a query block on
    `device`: the one upload shared by every per-bank device pack. A
    2^64-1 tail becomes PAD (excluded from planes, as in the host pack)."""
    L = _next_pow2(max(128, max((len(q) for q in qs), default=1)))
    Hi = np.full((len(qs), L), 0xFFFFFFFF, dtype=np.uint32)
    Lo = np.full((len(qs), L), 0xFFFFFFFF, dtype=np.uint32)
    for i, q in enumerate(qs):
        q = np.asarray(q, dtype=np.uint64)
        if len(q) and q[-1] == MAX_U64:
            q = q[:-1]
        Hi[i, : len(q)] = (q >> np.uint64(32)).astype(np.uint32)
        Lo[i, : len(q)] = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return to_torch(Hi, device), to_torch(Lo, device)


def query_block_loads(qs, B: int) -> np.ndarray:
    """[bq, B] int64 host array: each query's hashes in each of B buckets
    (a 2^64-1 tail left out, as the packs leave it out of the planes)."""
    loads = np.zeros((len(qs), B), dtype=np.int64)
    for i, q in enumerate(qs):
        q = np.asarray(q, dtype=np.uint64)
        if len(q) and q[-1] == MAX_U64:
            q = q[:-1]
        if len(q):
            loads[i] = np.bincount((q & np.uint64(B - 1)).astype(np.int64), minlength=B)
    return loads


def pack_query_block_device(qs, B: int, raw=None, device=None, loads=None):
    """Pack a query block into [bq, dq, B] planes on the device from shared
    raw limb rows (uploaded once, reused across every bank's B). dq is the
    largest bucket load rounded up to a multiple of 8; `loads`, if given,
    is the block's `query_block_loads` at B. Returns (Qhi, Qlo, Qcnt [bq,
    B] int32, dq, raw)."""
    if raw is None:
        raw = query_raw_limbs(qs, device)
    Hi, Lo = raw
    if loads is None:
        loads = query_block_loads(qs, B)
    max_load = max(8, int(loads.max(initial=0)))
    dq = max(8, -(-max_load // 8) * 8)
    Qhi, Qlo, Qcnt = _device_pack(Hi, Lo, B, dq, torch.int32)
    return Qhi, Qlo, Qcnt, dq, raw


def pack_rows_device(mins_list, B: int, d: int = _D, device=None) -> BucketedRows | None:
    """BucketedRows with planes packed on `device` from uploaded raw limb
    rows (see `_device_pack`); spill state comes from the native
    spills-only pass. None when the rows hold no hash at all."""
    from .. import native

    n = len(mins_list)
    if not n:
        return None
    rows = _pad_rows(n)
    vals, offs = _concat_rows(mins_list)
    if not int(offs[-1]):
        return None
    L = max(128, -(-int(np.diff(offs).max()) // 128) * 128)
    _cnt_host, sp_rows, sp_vals = native.pack_spills(vals, offs, n, rows, B, d)
    Hi, Lo = native.split_limbs(vals, offs, n, rows, L)
    phi, plo, pcnt = _device_pack_kernel(to_torch(Hi, device), to_torch(Lo, device), B, d)
    return BucketedRows(
        phi, plo, pcnt, _spill_list(rows, sp_rows, sp_vals), n, d, B, int(len(sp_vals))
    )


def pack_query_bucketed(q: np.ndarray, B: int, device=None):
    """Pack one sorted distinct u64 query into [dq, B] planes with
    dq = next_pow2(max bucket load), so the query never spills. Returns
    (hi, lo, cnt [B] int32, dq, tail), tail being the (rare) hash equal to
    PAD, which stays out of the planes. Numpy uint32 planes without
    `device`, torch int32 bit patterns on it."""
    q = np.asarray(q, dtype=np.uint64)
    tail = None
    if len(q) and q[-1] == MAX_U64:
        tail = MAX_U64
        q = q[:-1]
    if len(q):
        _b, bs, slot, order = _bucketize(q, B)
        dq = _next_pow2(max(8, int(slot.max()) + 1))
    else:
        dq = 8
    hi = np.full((dq, B), 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full((dq, B), 0xFFFFFFFF, dtype=np.uint32)
    # int32: a metagenome query against a small-B bank loads hundreds of
    # hashes per bucket
    cnt = np.zeros(B, dtype=np.int32)
    if len(q):
        qs = q[order]
        hi[slot, bs] = (qs >> np.uint64(32)).astype(np.uint32)
        lo[slot, bs] = (qs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        np.add.at(cnt, bs.astype(np.int64), 1)
    if device is not None:
        hi, lo, cnt = to_torch(hi, device), to_torch(lo, device), to_torch(cnt, device)
    return hi, lo, cnt, dq, tail


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    "SWAR population count of int32 bit patterns, in int64 (torch has no popcount)."
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    "[..., B] bool -> [..., B/32] int32 bit patterns (bit j = lane 32*w + j)."
    shape = bits.shape
    w = bits.reshape(shape[:-1] + (shape[-1] // 32, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (w << shifts).sum(dim=-1)
    return (v - ((v >> 31) << 32)).to(torch.int32)  # as an int32 bit pattern


def unpack_bits_u32(words: torch.Tensor) -> torch.Tensor:
    "[..., W] int32 bit patterns -> [..., 32*W] bool (bit j of word w = lane 32*w + j)."
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,)).bool()


# -- counts ------------------------------------------------------------------


def _pad_correction(qcnt, Scnt, dq: int, d: int):
    """[ns] int32 PAD==PAD hits: sum_b (d - Scnt) * (dq - qcnt), an
    elementwise int32 [ns, B] product summed in int64 (torch has no integer
    matmul on CUDA). Exact while d * dq * B < 2^31, the limit under which
    the raw int32 accumulator of `counts_rows` is exact: every product and
    row sum then fits in int32. (The JAX package sums in f32, exact only
    while d times the query's PAD slots stays below 2^24: the one place the
    two packages may differ.)"""
    npad_q = (dq - qcnt).to(torch.int32)  # [B]
    npad_s = d - Scnt.to(torch.int32)  # [ns, B]
    return (npad_s * npad_q).sum(dim=1, dtype=torch.int64).to(torch.int32)


def _counts_qvm_impl(qhi, qlo, qcnt, Shi, Slo, Scnt):
    """[dq, B] query planes vs [ns, d, B] subject planes -> [ns] int32 exact
    stored-element intersection counts: the raw counts of `counts_rows`
    (T1) minus the PAD==PAD correction."""
    acc = cuda_gather.counts_rows(qhi, qlo, Shi, Slo)
    return acc - _pad_correction(qcnt, Scnt, qhi.shape[0], Shi.shape[1])


def _counts_block_impl(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, plan=None):
    """[bq, dq, B] query planes vs [ns, d, B] subjects -> [bq, ns] int32
    exact stored-element counts: the `counts_block` join (X3b) of the
    block's valid slots against the rows', on `plan`'s tiles if given."""
    return cuda_gather.counts_block(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, plan)


def _counts_block_from_raw(Qhi, Qlo, Qcnt, Hi, Lo, B: int, d: int, plan=None):
    """Block counts against a host-streamed chunk: pack its uploaded raw
    limb rows into planes on the device, count, and drop the planes."""
    Shi, Slo, Scnt = _device_pack_kernel(Hi, Lo, B, d)
    return _counts_block_impl(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, plan)


def counts_block_dispatch(Qhi, Qlo, Qcnt, chunk: BucketedRows, plan=None):
    """[bq, padded rows] device counts of one query block against one chunk
    (no spill correction, no readback), on `plan`'s tiles if given (one
    plan serves every chunk of a bank). Host-streamed chunks upload their
    raw limb rows and pack on the device, as `query_counts_device` does."""
    if not chunk.resident:
        if chunk.raw is not None:
            Hi, Lo = (to_torch(x, Qhi.device) for x in chunk.raw)
            return _counts_block_from_raw(Qhi, Qlo, Qcnt, Hi, Lo, chunk.B, chunk.d, plan)
        planes = _to_device(chunk.hi, chunk.lo, chunk.cnt, Qhi.device)
        return _counts_block_impl(Qhi, Qlo, Qcnt, *planes, plan)
    return _counts_block_impl(Qhi, Qlo, Qcnt, chunk.hi, chunk.lo, chunk.cnt, plan)


def _counts_qvm_cutoff_impl(qhi, qlo, qcnt, Shi, Slo, Scnt, cut_hi, cut_lo):
    """Query vs many with a per-subject u64 cutoff on the matched value: a
    hit counts iff equal and value <= cut[s]. PAD==PAD hits pass the cutoff
    only when cut == 2**64-1; the correction is masked accordingly."""
    acc = cuda_gather.counts_rows(qhi, qlo, Shi, Slo, cut_hi, cut_lo)
    corr = _pad_correction(qcnt, Scnt, qhi.shape[0], Shi.shape[1])
    pad_passes = (cut_hi == _PAD32) & (cut_lo == _PAD32)
    return acc - torch.where(pad_passes, corr, 0)


def _counts_bank_fused(qhi, qlo, qcnt, *planes):
    """All of one bank's chunks vs one query: one `counts_rows` launch per
    chunk, concatenated. planes = (hi, lo, cnt) per chunk."""
    outs = [
        _counts_qvm_impl(qhi, qlo, qcnt, planes[i], planes[i + 1], planes[i + 2])
        for i in range(0, len(planes), 3)
    ]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _cutoff_counts_bank_fused(qhi, qlo, qcnt, *planes):
    "Per-chunk cutoff counts of one bank, concatenated (5-tuple planes)."
    outs = [
        _counts_qvm_cutoff_impl(qhi, qlo, qcnt, *planes[i : i + 5])
        for i in range(0, len(planes), 5)
    ]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _spill_counts_qvm(q_full: np.ndarray, bank: BucketedRows, counts, cutoffs=None):
    """Add the exact contribution of subject-side spilled hashes:
    counts[i] += |spill_i ∩ q| (optionally filtered by cutoff[i]). The
    query's own 2**64-1 tail (never in the planes) is covered here too,
    since it can only match a subject spill."""
    if not bank.n_spilled or not len(q_full):
        return
    rows = [i for i in range(bank.n) if len(bank.spills[i])]
    sp_vals = np.concatenate([bank.spills[i] for i in rows])
    sp_rows = np.repeat(np.asarray(rows, dtype=np.int64), [len(bank.spills[i]) for i in rows])
    idx = np.searchsorted(q_full, sp_vals)
    idx_c = np.minimum(idx, len(q_full) - 1)
    hit = q_full[idx_c] == sp_vals
    if cutoffs is not None:
        hit &= sp_vals <= np.asarray(cutoffs, dtype=np.uint64)[sp_rows]
    np.add.at(counts, sp_rows[hit], 1)


def _counts_from_raw(qhi, qlo, qcnt, Hi, Lo, B: int, d: int):
    """Counts against a host-streamed chunk: pack its uploaded raw limb
    rows into planes on the device, count, and drop the planes."""
    Shi, Slo, Scnt = _device_pack_kernel(Hi, Lo, B, d)
    return _counts_qvm_impl(qhi, qlo, qcnt, Shi, Slo, Scnt)


def query_counts_device(bank: BucketedRows, q_packed):
    """[padded rows] device counts of one chunk (no spill correction, no
    readback), so callers can fan out many chunks and read back once.
    Host-streamed chunks upload their raw limb rows and pack on the device."""
    qhi, qlo, qcnt, _dq, _tail = q_packed
    if not bank.resident:
        if bank.raw is not None:
            Hi, Lo = (to_torch(x, qhi.device) for x in bank.raw)
            return _counts_from_raw(qhi, qlo, qcnt, Hi, Lo, bank.B, bank.d)
        planes = _to_device(bank.hi, bank.lo, bank.cnt, qhi.device)
        return _counts_qvm_impl(qhi, qlo, qcnt, *planes)
    return _counts_qvm_impl(qhi, qlo, qcnt, bank.hi, bank.lo, bank.cnt)


_CUT_PLANES_CACHE: dict = {}


def _cut_planes(bank: BucketedRows, cutoffs, device=None):
    """Device (hi, lo) int32 planes of per-row u64 cutoffs (padding rows
    get 0), cached per (chunk, cutoff set): repeated finds at the same
    query scaled would upload identical vectors otherwise."""
    cut = np.zeros(bank.cnt.shape[0], dtype=np.uint64)
    cut[: bank.n] = cutoffs
    device = bank.hi.device if bank.resident else device
    key = (id(bank), str(device), hashlib.md5(cut.tobytes()).digest())
    hit = _CUT_PLANES_CACHE.get(key)
    if hit is not None:
        return hit
    planes = (
        to_torch((cut >> np.uint64(32)).astype(np.uint32), device),
        to_torch((cut & np.uint64(0xFFFFFFFF)).astype(np.uint32), device),
    )
    if len(_CUT_PLANES_CACHE) >= 64:
        _CUT_PLANES_CACHE.pop(next(iter(_CUT_PLANES_CACHE)))
    _CUT_PLANES_CACHE[key] = planes
    return planes


def query_cutoff_counts_device(bank: BucketedRows, cutoffs, q_packed):
    "Device form of query_cutoff_counts_bucketed (stored-element counts only)."
    qhi, qlo, qcnt, _dq, _tail = q_packed
    cut_hi, cut_lo = _cut_planes(bank, cutoffs, qhi.device)
    if bank.resident:
        planes = (bank.hi, bank.lo, bank.cnt)
    elif bank.raw is not None:
        Hi, Lo = (to_torch(x, qhi.device) for x in bank.raw)
        planes = _device_pack_kernel(Hi, Lo, bank.B, bank.d)
    else:
        planes = _to_device(bank.hi, bank.lo, bank.cnt, qhi.device)
    return _counts_qvm_cutoff_impl(qhi, qlo, qcnt, *planes, cut_hi, cut_lo)


def _bank_device(bank: BucketedRows, device=None):
    if bank.resident:
        return bank.hi.device
    from . import resolve_device

    return resolve_device(device)


def query_counts_bucketed(q_full: np.ndarray, bank: BucketedRows, q_packed=None, device=None):
    """Sorted query u64 array vs a packed bank -> [n] exact int64 counts.

    q_packed: optional reuse of pack_query_bucketed(q_full, bank.B, device)."""
    if q_packed is None:
        q_packed = pack_query_bucketed(q_full, bank.B, _bank_device(bank, device))
    out = query_counts_device(bank, q_packed).cpu().numpy()
    counts = out[: bank.n].astype(np.int64)
    _spill_counts_qvm(q_full, bank, counts)
    return counts


def query_cutoff_counts_bucketed(
    q_full: np.ndarray, bank: BucketedRows, cutoffs, q_packed=None, device=None
):
    """Query vs bank with per-subject u64 value cutoffs (pairwise
    downsample). Returns [n] exact shared counts of {h : h <= cut[i]}."""
    if q_packed is None:
        q_packed = pack_query_bucketed(q_full, bank.B, _bank_device(bank, device))
    out = query_cutoff_counts_device(bank, cutoffs, q_packed).cpu().numpy()
    counts = out[: bank.n].astype(np.int64)
    _spill_counts_qvm(q_full, bank, counts, cutoffs=cutoffs)
    return counts


# -- membership --------------------------------------------------------------


def _membership_rows(qhi, qlo, Shi, Slo, Scnt):
    """Which query slots are present in each subject row? [dq, B] query
    planes vs [nm, d, B] subjects -> [nm, dq, B] bool. Subject slots past
    the occupancy are masked (a query PAD slot equals a subject PAD slot,
    and here the answer is bits, not counts)."""
    qh = qhi[None]  # [1, dq, B]
    ql = qlo[None]
    m = torch.zeros((Shi.shape[0],) + tuple(qhi.shape), dtype=torch.bool, device=qhi.device)
    for k2 in range(Shi.shape[1]):
        valid = (Scnt > k2)[:, None, :]  # [nm, 1, B]
        m |= (Shi[:, k2, None, :] == qh) & (Slo[:, k2, None, :] == ql) & valid
    return m


def _membership_bits_packed(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, slotmap, inv):
    """Rows `sel` of one chunk's planes -> packed membership words [nm, W]
    int32 in sorted-query index space (the `membership_bits` kernel):
    bit j of word w == (query hash 32w+j) in the row. slotmap [W*32] int32
    maps query index j -> flat slot position slot*B + bucket, dq*B for
    none (padding past len(q), and the 2^64-1 tail); inv is its inverse
    (`inverse_slot_map`) and qcnt [B] the query's bucket occupancy."""
    return cuda_gather.membership_bits(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, slotmap, inv)


def _membership_bits_packed_batch(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, slotmaps, inv):
    """`_membership_bits_packed` for a block of queries against per-query
    row selections `sel [bq, cap]` of ONE chunk's planes: [bq, cap, W]
    int32 words (the `membership_bits_batch` kernel). Qcnt [bq, B] is each
    query's occupancy, slotmaps [bq, W*32] its slot map and inv [bq, dq*B]
    the inverses (`inverse_slot_map`); empty (padding) queries give zero
    words, padded selections the words of the row they name."""
    return cuda_gather.membership_bits_batch(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, slotmaps, inv)


def query_slot_map(q_core: np.ndarray, B: int, dq: int, n_positions: int):
    """Flat slot position (slot*B + bucket) of each sorted query hash,
    padded with the dummy position dq*B out to n_positions (covers the
    word-padding tail and an excluded 2^64-1 hash)."""
    slotmap = np.full(n_positions, dq * B, dtype=np.int32)
    if len(q_core):
        _b, bs, slot, order = _bucketize(q_core, B)
        slotmap[order] = (slot * B + bs).astype(np.int32)
    return slotmap


def inverse_slot_map(slotmap: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[..., n_slots] int32 on slotmap's device: for each slot map along
    the last axis, the query index j whose flat slot position slotmap[j]
    is each position, -1 where none is. Positions >= n_slots (the dummy
    dq*B) go to a dump element that is cut off."""
    lead = tuple(slotmap.shape[:-1])
    inv = torch.full(lead + (n_slots + 1,), -1, dtype=torch.int32, device=slotmap.device)
    index = torch.arange(slotmap.shape[-1], dtype=torch.int32, device=slotmap.device)
    inv.scatter_(-1, slotmap.long().clamp(max=n_slots), index.expand(slotmap.shape))
    return inv[..., :-1].contiguous()


def membership_matrix(q_full: np.ndarray, bank: BucketedRows, row_ids, q_packed=None):
    """Membership of the query's bucketed slots in selected (resident) bank
    rows: returns (M [len(row_ids), dq*B/32] int32 words, q_packed), where
    bit j of word w of row r is set iff flat query slot 32w+j (slot*B +
    bucket) holds a hash present in bank row row_ids[r]. The words are
    `pack_bits_u32` of `_membership_rows`' [dq, B] bools, computed by the
    `membership_bits` kernel over every slot position; spilled subject
    hashes are OR-ed in on the host via the query slot map. q_packed is the
    host pack_query_bucketed(q_full, bank.B)."""
    if q_packed is None:
        q_packed = pack_query_bucketed(q_full, bank.B)
    qhi, qlo, qcnt, dq, _tail = q_packed
    device = bank.hi.device
    ids = np.asarray(row_ids, dtype=np.int64)
    # the identity map is its own inverse; its PAD positions get no bit
    identity = torch.arange(dq * bank.B, dtype=torch.int32, device=device)
    M = _membership_bits_packed(
        to_torch(qhi, device), to_torch(qlo, device), to_torch(qcnt, device), bank.hi,
        bank.lo, bank.cnt, torch.from_numpy(ids).to(device), identity, identity,
    )
    spill_bits = {r: bank.spills[i] for r, i in enumerate(ids) if len(bank.spills[i])}
    if spill_bits:
        # slot map over the plane-representable query (2**64-1 excluded at
        # pack time; the caller handles that single hash exactly)
        q_core = q_full[q_full != MAX_U64]
        flat = query_slot_map(q_core, bank.B, dq, len(q_core))
        rows, words, masks = [], [], []
        for r, sp in spill_bits.items():
            idx = np.searchsorted(q_core, sp)
            idx_c = np.minimum(idx, max(len(q_core) - 1, 0))
            for pos in flat[idx_c[q_core[idx_c] == sp]] if len(q_core) else ():
                rows.append(r)
                words.append(int(pos) >> 5)
                masks.append(1 << (int(pos) & 31))
        if rows:
            M = M.cpu().numpy().view(np.uint32).copy()
            np.bitwise_or.at(M, (np.asarray(rows), np.asarray(words)),
                             np.asarray(masks, dtype=np.uint32))
            M = to_torch(M, device)
    return M, q_packed


# -- all pairs (compare) -------------------------------------------------------


def pairwise_counts_bucketed(mins_list, block=None, device=None):
    """All-pairs exact intersection-count matrix [n, n] int64 by bucketed
    dense compare of a bank packed on the device from raw limb rows, read
    back once, then the host spill correction. With block=None (the
    default) one `pairwise_counts` launch joins the bank's valid slots
    bucket by bucket. An integer `block` keeps the JAX package's design:
    the bank's own rows as the query block (dq = d = 8) of `counts_block`
    (X3b), `block` rows a launch, each launch's tiles planned from one
    readback of the bank's occupancy."""
    from . import resolve_device

    n = len(mins_list)
    if not n:
        return np.zeros((0, 0), dtype=np.int64)
    device = resolve_device(device)
    B = choose_buckets(max((len(m) for m in mins_list), default=0))
    bank = pack_rows_device(mins_list, B, device=device)
    if bank is None:
        bank = pack_rows_bucketed(mins_list, B, device=device)
    if block is None:
        out = cuda_pairwise.pairwise_counts(bank.hi, bank.lo, bank.cnt)
    else:
        Qcnt = bank.cnt.to(torch.int32)
        out = torch.cat([
            _counts_block_impl(bank.hi[i : i + block], bank.lo[i : i + block],
                               Qcnt[i : i + block], bank.hi, bank.lo, bank.cnt, plan)
            for i, plan in cuda_gather.row_block_plans(bank.cnt, bank.d, block, False)
        ])
    out = out[:n, :n].cpu().numpy().astype(np.int64)
    _pairwise_spill_correction(out, mins_list, bank)
    return out


def _pairwise_spill_correction(out, mins_list, bank: BucketedRows) -> None:
    """Exact all-pairs spill correction, in place. For pair (i, j):

        true = stored∩stored + |sp_i ∩ m_j| + |sp_j ∩ m_i| − |sp_i ∩ sp_j|

    (the cross-term is counted once from each side). Every spilled value is
    joined against one value-sorted table of ALL (value, row) pairs, so the
    cost scales with the spill count, not with n^2."""
    if not bank.n_spilled:
        return
    n = len(mins_list)
    sp_rows_list = [i for i in range(n) if len(bank.spills[i])]
    sp_vals = np.concatenate([bank.spills[i] for i in sp_rows_list])
    sp_rows = np.repeat(
        np.asarray(sp_rows_list, dtype=np.int64),
        [len(bank.spills[i]) for i in sp_rows_list],
    )
    # the value-sorted (value, row) table over the distinct spilled values
    # only: each row is sorted, so membership is one searchsorted a row
    uniq = np.unique(sp_vals)
    cols_parts, rows_parts = [], []
    for j in range(n):
        mj = np.asarray(mins_list[j], dtype=np.uint64)
        if not len(mj):
            continue
        idx = np.searchsorted(mj, uniq)
        np.minimum(idx, len(mj) - 1, out=idx)
        cols = np.flatnonzero(mj[idx] == uniq)
        if len(cols):
            cols_parts.append(cols)
            rows_parts.append(np.full(len(cols), j, dtype=np.int64))
    if not cols_parts:
        return
    Cv = np.concatenate(cols_parts)
    Rv = np.concatenate(rows_parts)
    order = np.argsort(Cv, kind="stable")
    Cv, R = Cv[order], Rv[order]
    kcol = np.searchsorted(uniq, sp_vals)
    lo = np.searchsorted(Cv, kcol, side="left")
    hi_b = np.searchsorted(Cv, kcol, side="right")
    # every (spill k, matching row j) pair at once
    spans = hi_b - lo
    if spans.sum():
        is_ = np.repeat(sp_rows, spans)
        js = R[
            np.repeat(lo, spans)
            + (np.arange(int(spans.sum())) - np.repeat(np.cumsum(spans) - spans, spans))
        ]
        np.add.at(out, (is_, js), 1)
        off = js != is_
        np.add.at(out, (js[off], is_[off]), 1)
    # a value spilled by BOTH rows of a pair was counted from each side;
    # remove the double count once per ordered pair
    sp_order = np.argsort(sp_vals, kind="stable")
    sv, sr = sp_vals[sp_order], sp_rows[sp_order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sv)) + 1])
    ends = np.concatenate([starts[1:], [len(sv)]])
    for a, b in zip(starts, ends):
        if b - a < 2:
            continue
        grp = sr[a:b]
        for x in range(len(grp)):
            for y in range(len(grp)):
                if x != y:
                    out[grp[x], grp[y]] -= 1


# -- abundance-weighted products (angular similarity) --------------------------


def _pack_weighted(mins_list, abunds_list):
    """Occupancy-validity packing of (hash, abundance) rows, on the host:
    the slot depth d is the largest bucket load (at least 8), so nothing
    spills and every value (2**64-1 included) is representable; empty
    slots hold zeros. Returns numpy (hi, lo, av, cnt, B)."""
    n = len(mins_list)
    B = choose_buckets(max((len(m) for m in mins_list), default=0))
    lens = np.fromiter((len(m) for m in mins_list), dtype=np.int64, count=n)
    N = int(lens.sum())

    if N:
        vals = np.concatenate([np.asarray(m, np.uint64) for m in mins_list])
        ab = np.concatenate([np.asarray(a, np.int64) for a in abunds_list])
        row = np.repeat(np.arange(n, dtype=np.int64), lens)
        b = (vals & np.uint64(B - 1)).astype(np.int64)
        key = row * B + b
        order = np.argsort(key, kind="stable")
        ks, vs, avs = key[order], vals[order], ab[order]
        pos = np.arange(len(ks), dtype=np.int64)
        is_start = np.empty(len(ks), dtype=bool)
        is_start[0] = True
        np.not_equal(ks[1:], ks[:-1], out=is_start[1:])
        slot = pos - np.maximum.accumulate(np.where(is_start, pos, 0))
        d = max(8, int(slot.max()) + 1)
    else:
        d = 8

    rows = _pad_rows(n)
    hi = np.zeros((rows, d, B), dtype=np.uint32)
    lo = np.zeros((rows, d, B), dtype=np.uint32)
    av = np.zeros((rows, d, B), dtype=np.int32)
    cnt = np.zeros((rows, B), dtype=np.uint8)
    if N:
        ro = row[order]
        bo = b[order]
        hi[ro, slot, bo] = (vs >> np.uint64(32)).astype(np.uint32)
        lo[ro, slot, bo] = (vs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        av[ro, slot, bo] = avs.astype(np.int32)
        starts = np.flatnonzero(is_start)
        sizes = np.diff(np.concatenate([starts, [len(ks)]]))
        assert sizes.max() <= 255
        cnt.reshape(-1)[ks[starts]] = sizes.astype(np.uint8)
    return hi, lo, av, cnt, B


def pairwise_weighted_products(mins_list, abunds_list, block=None, device=None):
    """All-pairs exact [n, n] int64 matrix of sum(a_i(h) * a_j(h)) over
    each pair's shared hashes, the hot term of abundance-weighted (angular)
    similarity, on the host pack `_pack_weighted`, uploaded once. With
    block=None (the default) one `pairwise_products` launch joins the
    planes' valid slots bucket by bucket; an integer `block` keeps the JAX
    package's design, `block` query rows a `products_block` launch (X6, the
    port of `sourmash_tpu`'s `_products_block_impl`). Integer accumulation
    is exact and independent of order, so the result equals the host's f64
    merge-join sum whenever it fits 2**53 (callers guard)."""
    from . import resolve_device

    n = len(mins_list)
    if not n:
        return np.zeros((0, 0), dtype=np.int64)
    device = resolve_device(device)
    hi, lo, av, cnt, _B = _pack_weighted(mins_list, abunds_list)
    hi, lo, av, cnt = (to_torch(x, device) for x in (hi, lo, av, cnt))
    if block is None:
        out = cuda_pairwise.pairwise_products(hi, lo, av, cnt)
    else:
        out = torch.cat([
            cuda_gather.products_block(hi[i : i + block], lo[i : i + block], av[i : i + block],
                                       cnt[i : i + block], hi, lo, av, cnt, plan)
            for i, plan in cuda_gather.row_block_plans(cnt, hi.shape[1], block, True)
        ])
    return out[:n, :n].cpu().numpy()
