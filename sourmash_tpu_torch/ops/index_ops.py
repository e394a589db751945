"""Flat device-resident index query ops: the port of
`sourmash_tpu/ops/index_ops.py` (banks, counts, cutoff counts, membership).

The collection's sketches live on the device as bucketed u32 hi/lo planes
(`ops/bucketed.py`), grouped into banks by sketch-length class and split
into row chunks. A counter query is one `counts_rows` launch per chunk;
the chunks' counts are concatenated on the device and read back once. A
block of queries (multigather) is one `counts_block` launch per chunk.
Collections whose planes exceed the device-memory budget stay on the host
and stream to the device per query pass, a few chunks at a time.

`save_banks` / `load_banks` keep a collection's packed planes on disk, in
the JAX package's layout byte for byte (`b{bi}c{ci}_{hi,lo,cnt}.npy` with
u32 hi/lo and u8 occupancy planes, `_spills.npz` and `banks.json`), so a
revindex directory written by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from . import cuda_gather
from .bucketed import (
    _D,
    BucketedRows,
    _cut_planes,
    _cutoff_counts_bank_fused,
    _counts_bank_fused,
    _pad_rows,
    _spill_counts_qvm,
    choose_buckets,
    counts_block_dispatch,
    membership_matrix,
    pack_query_block_device,
    pack_query_bucketed,
    pack_rows_bucketed,
    pack_rows_device,
    query_block_loads,
    query_counts_device,
    query_cutoff_counts_device,
    to_numpy_u32,
    to_torch,
)

_CHUNK_ROWS = 8192  # max rows per packed chunk
# host-streamed banks: at most this many chunks' uploaded planes in flight
_STREAM_WINDOW = 4
BUDGET_ENV = "SOURMASH_TORCH_GPU_BUDGET_BYTES"


class Bank:
    """One length-class bank: a list of bucketed row chunks, the dataset
    ids (host) each chunk's rows belong to, and the device it counts on."""

    __slots__ = ("chunks", "ids", "B", "device")

    def __init__(self, chunks, ids, B, device):
        self.chunks = chunks  # list of BucketedRows
        self.ids = ids  # list of int32 arrays, one per chunk
        self.B = B
        self.device = device

    @property
    def resident(self) -> bool:
        return all(c.resident for c in self.chunks)


def _budget_bytes(device) -> int:
    """Plane bytes the device may hold: SOURMASH_TORCH_GPU_BUDGET_BYTES, else
    half of the CUDA device's free memory, else (on the CPU) 12e9."""
    env = os.environ.get(BUDGET_ENV)
    if env:
        return int(float(env))
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return free // 2
    return int(12e9)


def _planned_chunk_bytes(n_rows: int, B: int) -> int:
    "Exact plane bytes of a chunk of n_rows: hi + lo (u32) + cnt (u8)."
    rows = _pad_rows(n_rows)
    return rows * _D * B * 4 * 2 + rows * B


def _length_class_buckets(mins_list) -> dict[int, list[int]]:
    "Dataset indices grouped by power-of-two padded-length class (>=128)."
    buckets: dict[int, list[int]] = {}
    for i, m in enumerate(mins_list):
        L = 1 << max(7, int(max(1, len(m)) - 1).bit_length())
        buckets.setdefault(L, []).append(i)
    return buckets


def _planned_bytes(buckets) -> int:
    "Total plane bytes build_banks would allocate for these length classes."
    planned = 0
    for L, idxs in sorted(buckets.items()):
        B = choose_buckets(L)
        for s in range(0, len(idxs), _CHUNK_ROWS):
            planned += _planned_chunk_bytes(len(idxs[s : s + _CHUNK_ROWS]), B)
    return planned


def planned_banks_resident(mins_list, device) -> bool:
    "Would build_banks keep this collection's planes on `device`?"
    return _planned_bytes(_length_class_buckets(mins_list)) <= _budget_bytes(device)


def _raw_limbs(part_mins, rows):
    """PAD-padded [rows, L] (hi, lo) u32 limb rows of a host-streamed chunk
    (uploaded and packed on the device per pass), or None for rows that
    hold no hash."""
    from .. import native

    lens = np.fromiter((len(m) for m in part_mins), dtype=np.int64)
    if not len(lens) or not int(lens.sum()):
        return None
    L = max(128, -(-int(lens.max()) // 128) * 128)
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    vals = (
        np.concatenate([np.asarray(m, dtype=np.uint64) for m in part_mins])
        if len(part_mins) > 1
        else np.asarray(part_mins[0], dtype=np.uint64)
    )
    return native.split_limbs(vals, offs, len(part_mins), rows, L)


def build_banks(mins_list, device=None, *, resident=None) -> list[Bank]:
    """Group per-dataset sorted hash arrays by padded length class and pack
    each class into bucketed-plane chunks of at most _CHUNK_ROWS rows.

    The budget decision is made up front from the planned plane sizes
    unless `resident` makes it (False: a host pack, as a revindex build
    that writes the planes to disk asks for). When the collection fits,
    each chunk uploads its raw limb rows and is packed on the device
    (`pack_rows_device`); beyond the budget, planes are packed on the host
    and stream to the device per query pass."""
    from . import resolve_device

    device = resolve_device(device)
    buckets = _length_class_buckets(mins_list)
    if resident is None:
        resident = _planned_bytes(buckets) <= _budget_bytes(device)
    banks = []
    for L, idxs in sorted(buckets.items()):
        B = choose_buckets(L)
        chunks, ids = [], []
        for s in range(0, len(idxs), _CHUNK_ROWS):
            part = idxs[s : s + _CHUNK_ROWS]
            part_mins = [mins_list[i] for i in part]
            if resident:
                c = pack_rows_device(part_mins, B, device=device)
                if c is None:  # rows without a hash: nothing to upload raw
                    c = pack_rows_bucketed(part_mins, B, device=device)
            else:
                c = pack_rows_bucketed(part_mins, B)
                c.raw = _raw_limbs(part_mins, c.hi.shape[0])
            chunks.append(c)
            ids.append(np.asarray(part, dtype=np.int32))
        banks.append(Bank(chunks, ids, B, device))
    return banks


def save_banks(banks, dirpath) -> None:
    """Persist packed banks: per-chunk hi/lo/cnt planes as .npy plus a
    banks.json manifest (B, dataset ids, spills), so loading skips the
    pack. Device chunks are read back; the planes are written as u32 hi/lo
    and u8 occupancy whatever the chunk holds."""
    os.makedirs(dirpath, exist_ok=True)
    meta = {"banks": []}
    for bi, bank in enumerate(banks):
        bmeta = {"B": bank.B, "chunks": []}
        for ci, (chunk, ids) in enumerate(zip(bank.chunks, bank.ids)):
            tag = f"b{bi}c{ci}"
            cnt = chunk.cnt.cpu().numpy() if torch.is_tensor(chunk.cnt) else chunk.cnt
            np.save(os.path.join(dirpath, f"{tag}_hi.npy"), to_numpy_u32(chunk.hi))
            np.save(os.path.join(dirpath, f"{tag}_lo.npy"), to_numpy_u32(chunk.lo))
            np.save(os.path.join(dirpath, f"{tag}_cnt.npy"), np.asarray(cnt, dtype=np.uint8))
            spill_rows = [i for i, sp in enumerate(chunk.spills) if len(sp)]
            if spill_rows:
                np.savez(
                    os.path.join(dirpath, f"{tag}_spills.npz"),
                    rows=np.asarray(spill_rows, dtype=np.int64),
                    lens=np.asarray([len(chunk.spills[i]) for i in spill_rows], dtype=np.int64),
                    vals=np.concatenate([chunk.spills[i] for i in spill_rows]),
                )
            bmeta["chunks"].append(
                {
                    "tag": tag,
                    "n": chunk.n,
                    "d": chunk.d,
                    "ids": [int(i) for i in ids],
                    "spilled": bool(spill_rows),
                }
            )
        meta["banks"].append(bmeta)
    with open(os.path.join(dirpath, "banks.json"), "w") as fp:
        json.dump(meta, fp)


def load_banks(dirpath, device=None) -> list[Bank]:
    """Load banks saved by save_banks as host-streamed chunks: the planes
    stay mmapped and stream to `device` per query pass (chunks without raw
    limb rows, so the planes themselves go up). A collection that fits the
    budget never comes here: FlatIndex packs its raw mins on the device."""
    from . import resolve_device

    device = resolve_device(device)
    with open(os.path.join(dirpath, "banks.json")) as fp:
        meta = json.load(fp)
    banks = []
    for bmeta in meta["banks"]:
        chunks, ids = [], []
        for cm in bmeta["chunks"]:
            tag = cm["tag"]
            hi, lo, cnt = (np.load(os.path.join(dirpath, f"{tag}_{p}.npy"), mmap_mode="r")
                           for p in ("hi", "lo", "cnt"))
            rows = hi.shape[0]
            spills = [np.zeros(0, dtype=np.uint64)] * rows
            n_spilled = 0
            if cm.get("spilled"):
                z = np.load(os.path.join(dirpath, f"{tag}_spills.npz"))
                off = 0
                for r, ln in zip(z["rows"], z["lens"]):
                    spills[int(r)] = z["vals"][off : off + int(ln)]
                    off += int(ln)
                    n_spilled += int(ln)
            chunks.append(BucketedRows(hi, lo, cnt, spills, cm["n"], cm["d"], bmeta["B"],
                                       n_spilled, raw=None))
            ids.append(np.asarray(cm["ids"], dtype=np.int32))
        banks.append(Bank(chunks, ids, bmeta["B"], device))
    return banks


def _drain_chunk_counts(segs, q, counts, spill_cutoffs=None):
    """Read every segment's device counts back in one transfer (device-side
    concatenation), then apply the exact host-side spill corrections.
    segs: [(device counts, [(chunk, ids), ...])]; a segment holds the
    counts of one or more chunks back to back."""
    if not segs:
        return
    if len(segs) == 1:
        host = segs[0][0].cpu().numpy()
        offs = [0]
    else:
        host = torch.cat([s[0] for s in segs]).cpu().numpy()
        offs = np.cumsum([0] + [int(s[0].shape[0]) for s in segs[:-1]])
    for (_out, chunk_ids), off in zip(segs, offs):
        for chunk, ids in chunk_ids:
            c = host[off : off + len(ids)].astype(np.int64)
            cuts = None if spill_cutoffs is None else spill_cutoffs[ids]
            _spill_counts_qvm(q, chunk, c, cutoffs=cuts)
            counts[ids] = c
            off += chunk.hi.shape[0]  # chunks are padded to their row count


def counts_for_banks(banks, query_mins: np.ndarray, n_datasets: int) -> np.ndarray:
    "Per-dataset overlap counts of the sorted query with every bank row."
    counts = np.zeros(n_datasets, dtype=np.int64)
    if not len(query_mins):
        return counts
    q = np.asarray(query_mins, dtype=np.uint64)
    segs = []
    for bank in banks:
        q_packed = _cached_query_pack(q, bank.B, bank.device)
        if bank.resident:
            planes = [p for c in bank.chunks for p in (c.hi, c.lo, c.cnt)]
            fused = _counts_bank_fused(q_packed[0], q_packed[1], q_packed[2], *planes)
            segs.append((fused, list(zip(bank.chunks, bank.ids))))
        else:
            # streamed: drain every _STREAM_WINDOW chunks so at most that
            # many chunks' uploaded planes are on the device
            for chunk, ids in zip(bank.chunks, bank.ids):
                segs.append((query_counts_device(chunk, q_packed), [(chunk, ids)]))
                if len(segs) >= _STREAM_WINDOW:
                    _drain_chunk_counts(segs, q, counts)
                    segs = []
    _drain_chunk_counts(segs, q, counts)
    return counts


def counts_for_banks_batch(banks, queries, n_datasets: int, block: int = 8) -> np.ndarray:
    """Overlap counts of many sorted queries with every bank row:
    [len(queries), n_datasets] int64. One `counts_block` launch per (bank
    chunk, block of `block` queries), so the bank planes are read once per
    query block, not once per query. Each block uploads its raw limb rows
    once and packs them on the device for every bank's B; the join's
    tiles are planned from the block's host bucket loads, once per bank,
    with no readback; resident banks read back once per block and bank,
    streamed banks every _STREAM_WINDOW chunks."""
    qs = [np.asarray(q, dtype=np.uint64) for q in queries]
    out = np.zeros((len(qs), n_datasets), dtype=np.int64)
    for b0 in range(0, len(qs), block):
        sub = qs[b0 : b0 + block]
        raw = None
        for bank in banks:
            loads = query_block_loads(sub, bank.B)
            Qhi, Qlo, Qcnt, _dq, raw = pack_query_block_device(sub, bank.B, raw, bank.device,
                                                                loads)
            plan = (cuda_gather.block_join_plan(loads.sum(axis=0), False, Qhi.device)
                    if Qhi.device.type == "cuda" else None)
            pairs = list(zip(bank.chunks, bank.ids))
            window = len(pairs) if bank.resident else _STREAM_WINDOW
            for g0 in range(0, len(pairs), window):
                parts = [(counts_block_dispatch(Qhi, Qlo, Qcnt, chunk, plan), chunk, ids)
                         for chunk, ids in pairs[g0 : g0 + window]]
                host = torch.cat([p[0] for p in parts], dim=1).cpu().numpy()
                off = 0
                for dev, chunk, ids in parts:
                    for qi, q in enumerate(sub):
                        c = host[qi, off : off + len(ids)].astype(np.int64)
                        _spill_counts_qvm(q, chunk, c)
                        out[b0 + qi, ids] = c
                    off += dev.shape[1]
    return out


# small LRU of packed query planes on the device: prefetch, counter build
# and recounts of a gather all pack the same query
_QPACK_CACHE: dict = {}
_QRAW_CACHE: dict = {}  # (md5(q), device) -> device raw limb rows, shared across Bs


def _cached_query_pack(q: np.ndarray, B: int, device):
    """Query planes for a bank of B buckets on `device`. Large (metagenome)
    queries upload their raw limbs once and pack on the device per B
    (dq a multiple of 8); smaller ones pack on the host (dq a power of
    two)."""
    md5 = hashlib.md5(q.tobytes()).hexdigest()
    key = (md5, B, str(device))
    hit = _QPACK_CACHE.get(key)
    if hit is not None:
        return hit
    if len(q) >= (1 << 14):
        from .bucketed import MAX_U64

        rkey = (md5, str(device))
        raw = _QRAW_CACHE.get(rkey)
        Qhi, Qlo, Qcnt, dq, raw = pack_query_block_device([q], B, raw, device)
        if len(_QRAW_CACHE) >= 4 and rkey not in _QRAW_CACHE:
            _QRAW_CACHE.pop(next(iter(_QRAW_CACHE)))
        _QRAW_CACHE[rkey] = raw
        tail = MAX_U64 if len(q) and q[-1] == MAX_U64 else None
        packed = (Qhi[0], Qlo[0], Qcnt[0], dq, tail)
    else:
        packed = pack_query_bucketed(q, B, device)
    if len(_QPACK_CACHE) >= 8:
        _QPACK_CACHE.pop(next(iter(_QPACK_CACHE)))
    _QPACK_CACHE[key] = packed
    return packed


def cutoff_counts_for_banks(
    banks, query_mins: np.ndarray, cutoffs: np.ndarray, n_datasets: int
) -> np.ndarray:
    """Per-dataset overlap counts with per-dataset u64 value cutoffs
    (pairwise-downsample semantics: hit iff equal and value <= cut[i])."""
    counts = np.zeros(n_datasets, dtype=np.int64)
    if not len(query_mins):
        return counts
    q = np.asarray(query_mins, dtype=np.uint64)
    segs = []
    for bank in banks:
        q_packed = _cached_query_pack(q, bank.B, bank.device)
        if bank.resident:
            planes = []
            for chunk, ids in zip(bank.chunks, bank.ids):
                hi_c, lo_c = _cut_planes(chunk, cutoffs[ids])
                planes.extend([chunk.hi, chunk.lo, chunk.cnt, hi_c, lo_c])
            fused = _cutoff_counts_bank_fused(q_packed[0], q_packed[1], q_packed[2], *planes)
            segs.append((fused, list(zip(bank.chunks, bank.ids))))
        else:
            for chunk, ids in zip(bank.chunks, bank.ids):
                segs.append(
                    (query_cutoff_counts_device(chunk, cutoffs[ids], q_packed), [(chunk, ids)])
                )
                if len(segs) >= _STREAM_WINDOW:
                    _drain_chunk_counts(segs, q, counts, spill_cutoffs=cutoffs)
                    segs = []
    _drain_chunk_counts(segs, q, counts, spill_cutoffs=cutoffs)
    return counts


def membership_for_banks(banks, query_mins: np.ndarray, dataset_ids):
    """Membership of the query's bucketed slots in the given datasets, per
    resident bank chunk (datasets may span banks with different B).

    Returns a list of (bank, q_packed_host, sel_ids [k], M [k, dq*B/32]
    int32 device words) covering every requested dataset id. q_packed is
    host numpy so callers can build hash<->slot maps without a readback."""
    q = np.asarray(query_mins, dtype=np.uint64)
    want = set(int(i) for i in dataset_ids)
    out = []
    for bank in banks:
        q_packed = None
        for chunk, ids in zip(bank.chunks, bank.ids):
            sel = [r for r, i in enumerate(ids) if int(i) in want]
            if not sel:
                continue
            if q_packed is None:
                q_packed = pack_query_bucketed(q, bank.B)
            if not chunk.resident:
                chunk = BucketedRows(
                    *(to_torch(x, bank.device) for x in (chunk.hi, chunk.lo, chunk.cnt)),
                    chunk.spills, chunk.n, chunk.d, chunk.B, chunk.n_spilled,
                )
            M, _ = membership_matrix(q, chunk, sel, q_packed=q_packed)
            out.append((bank, q_packed, ids[np.asarray(sel)], M))
    return out
