"""Multi-device distribution: device meshes and sharded bucketed-index queries.

The port of `sourmash_tpu/parallel/__init__.py` (X8). The JAX package runs
its sharded programs as `jax.shard_map`s over a `jax.sharding.Mesh`, one
process driving every device. The port keeps that single-controller
shape: a `Mesh` is a [n_data][n_shards] grid of torch devices, shard-local
work runs on each shard's device (its launches on that device's current
stream), and the collectives (psum, pmax, psum-OR) are small explicit
tensor moves and reductions (`parallel/collectives.py`). A mesh may name
one device more than once, so one card, or the CPU, runs 4 or 8 real
shards through the code that several cards run.

- the flat index's bucketed planes [m, d, B] split by rows across the
  'shards' axis (shard s holds rows [s * per, (s + 1) * per));
- query batches, planes [bq, dq, B] with an `alive` slot mask, split
  across the 'data' axis (`torch.tensor_split`: bq need not divide);
- the shard-local compare of the counter, the gather round and the
  membership builder is the hand-written `shard_match` kernel (X8,
  `ops/cuda_gather.py`, `csrc/parallel.cu`); the greedy rounds' decrements
  over membership words are `round_dec` (X5) and `round_dec_batch` (X5b);
- the sharded sketch runs the K2 path on each data block.

Inputs may be numpy arrays (u32 planes as `pack_shard_planes` and
`pack_query_batch` give them) or torch tensors (int32 bit patterns).
Results come back on the mesh's first device; the gather scans return
their carry as per-device lists, which the next chunk of rounds takes
back without moving the matrix again. A round reads nothing back to the
host.

Counting is exact at any scale: the shard packer sizes the bucket slot
depth to the worst observed bucket load (no spills) and carries slot
validity in occupancy counts rather than a PAD sentinel, so the all-ones
hash 2**64-1 is a legal value.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.bucketed import (
    MAX_U64,
    choose_buckets,
    pack_bits_u32,
    to_torch,
    unpack_bits_u32,
)
from ..ops.cuda_gather import round_dec, round_dec_batch, shard_match
from .collectives import broadcast, pmax, por, psum_placed

__all__ = [
    "MAX_U64", "Blocks", "Mesh", "get_mesh", "pack_shard_planes", "pack_query_batch",
    "shard_rows", "split_data", "make_sharded_counter", "make_sharded_gather_round",
    "make_sharded_membership_builder", "make_sharded_gather_rounds",
    "make_sharded_gather_program", "make_sharded_bitset_scan",
    "make_data_parallel_schedule_scan", "make_sharded_sketch",
]

_KEY_ID = 0x7FFFFFFF  # the bitset scan's winner key: (count << 32) | (_KEY_ID - global id)


class Mesh:
    """A (data, shards) grid of torch devices: `devices[i][s]` runs shard s
    of data block i. A device may appear more than once."""

    axis_names = ("data", "shards")

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "shards": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        "The device that collects every function's results."
        return self.devices[0][0]

    def __repr__(self):
        return f"Mesh(data={self.shape['data']}, shards={self.shape['shards']}, {self.devices})"


class Blocks:
    """A tensor split over a mesh: `grid[i][s]` is the block on
    `mesh.devices[i][s]`, axis 0 split across 'data' and axis 1 across
    'shards' (the membership matrix [bq, m, dq, B/32])."""

    def __init__(self, grid):
        self.grid = grid

    def full(self, device=None) -> torch.Tensor:
        "The whole tensor on `device` (default: the first block's)."
        device = self.grid[0][0].device if device is None else device
        return torch.cat([torch.cat([b.to(device) for b in row], dim=1) for row in self.grid])


def get_mesh(n_data: int = 1, n_shards: int | None = None, devices=None) -> Mesh:
    """A (data, shards) mesh over `devices` (default: every visible CUDA
    device; without one this raises: pass e.g. [torch.device("cpu")] * 4)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("get_mesh: torch sees no CUDA device; pass devices= "
                               "(e.g. [torch.device('cpu')] * 4) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"a mesh runs on cuda or cpu devices, not {d}")
    n_dev = len(devices)
    if n_shards is None:
        n_shards = n_dev // n_data
    if n_data < 1 or n_shards < 1 or n_data * n_shards != n_dev:
        raise ValueError(f"a ({n_data} x {n_shards}) mesh needs that many devices, not {n_dev}")
    return Mesh([devices[i * n_shards : (i + 1) * n_shards] for i in range(n_data)])


def pack_shard_planes(mins_list, n_shards: int, B: int | None = None):
    """Pack per-dataset sorted hash arrays into bucketed u32 planes whose
    row count divides n_shards (shard k owns rows [k*per, (k+1)*per)).

    EXACT by construction: the slot depth d is sized to the maximum bucket
    load over the whole collection, so nothing spills; slot validity is
    carried in per-row occupancy counts (`cnt`) instead of a PAD sentinel,
    so the all-ones hash value 2**64-1 is representable like any other.

    Returns (hi [m, d, B] u32, lo, cnt [m, B] u8, B): padding rows have
    occupancy 0 everywhere and can never match."""
    if B is None:
        B = choose_buckets(max((len(m) for m in mins_list), default=0))

    n = len(mins_list)
    lens = np.fromiter((len(m) for m in mins_list), dtype=np.int64, count=n)
    N = int(lens.sum())
    per = -(-max(n, 1) // n_shards)
    m_rows = per * n_shards

    if N:
        vals = np.concatenate([np.asarray(m, dtype=np.uint64) for m in mins_list])
        row = np.repeat(np.arange(n, dtype=np.int64), lens)
        b = (vals & np.uint64(B - 1)).astype(np.int64)
        key = row * B + b
        order = np.argsort(key, kind="stable")  # within (row, bucket): ascending hash
        ks, vs = key[order], vals[order]
        pos = np.arange(len(ks), dtype=np.int64)
        is_start = np.empty(len(ks), dtype=bool)
        is_start[0] = True
        np.not_equal(ks[1:], ks[:-1], out=is_start[1:])
        slot = pos - np.maximum.accumulate(np.where(is_start, pos, 0))
        d = max(8, int(slot.max()) + 1)
    else:
        d = 8

    hi = np.zeros((m_rows, d, B), dtype=np.uint32)
    lo = np.zeros((m_rows, d, B), dtype=np.uint32)
    cnt = np.zeros((m_rows, B), dtype=np.uint8)
    if N:
        ro = np.repeat(np.arange(n, dtype=np.int64), lens)[order]
        bo = b[order]
        hi[ro, slot, bo] = (vs >> np.uint64(32)).astype(np.uint32)
        lo[ro, slot, bo] = (vs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        starts = np.flatnonzero(is_start)
        sizes = np.diff(np.concatenate([starts, [len(ks)]]))
        assert sizes.max() <= 255, "bucket load exceeds u8 occupancy"
        cnt.reshape(-1)[ks[starts]] = sizes.astype(np.uint8)
    return hi, lo, cnt, B


def pack_query_batch(queries, B: int):
    """Pack a batch of sorted u64 queries into shared-shape planes.

    Returns (qhi [bq, dq, B] u32, qlo, alive [bq, dq, B] bool) with dq the
    max bucket load over the batch. Slot validity comes from per-bucket
    occupancy (not a PAD sentinel), so 2**64-1 is a legal query hash;
    `alive` marks occupied slots and is the mutable query state during
    gather rounds."""
    bq = len(queries)
    per_q = []
    dq = 8
    for q in queries:
        q = np.asarray(q, dtype=np.uint64)
        b = (q & np.uint64(B - 1)).astype(np.int64)
        order = np.argsort(b, kind="stable")
        bs = b[order]
        cnt = np.bincount(bs, minlength=B).astype(np.int64)
        slot = np.arange(len(bs)) - np.repeat(
            np.cumsum(np.concatenate([[0], cnt[:-1]])), cnt
        ) if len(bs) else np.zeros(0, np.int64)
        per_q.append((q[order], bs, slot, cnt))
        if len(bs):
            dq = max(dq, int(cnt.max()))

    qhi = np.zeros((bq, dq, B), dtype=np.uint32)
    qlo = np.zeros((bq, dq, B), dtype=np.uint32)
    alive = np.zeros((bq, dq, B), dtype=bool)
    for i, (qs, bs, slot, cnt) in enumerate(per_q):
        qhi[i, slot, bs] = (qs >> np.uint64(32)).astype(np.uint32)
        qlo[i, slot, bs] = (qs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        alive[i, slot, bs] = True
    return qhi, qlo, alive


# -- placement -----------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    "A torch tensor of x: numpy u32 planes as int32 bit patterns, other arrays as they are."
    if torch.is_tensor(x):
        return x
    return to_torch(np.asarray(x))


def _on(device):
    "The CUDA device context of `device` (launches go to its current stream)."
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _split(x: torch.Tensor, n: int, dim: int = 0, even: bool = False) -> list:
    if even and x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split evenly over {n} shards")
    return [p.contiguous() for p in torch.tensor_split(x, n, dim=dim)]


def _cat(parts, device) -> torch.Tensor:
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def shard_rows(mesh: Mesh, x) -> list:
    """x [m, ...] split by rows across the mesh's 'shards' axis (m a
    multiple of its size), block s on `mesh.devices[0][s]`."""
    devs = mesh.devices[0]
    return [p.to(d, non_blocking=True)
            for p, d in zip(_split(_tensor(x), len(devs), even=True), devs)]


def split_data(mesh: Mesh, x) -> list:
    """x [Q, ...] split across the mesh's 'data' axis (any Q: the first
    blocks take one more), block i on `mesh.devices[i][0]`."""
    devs = [row[0] for row in mesh.devices]
    return [p.to(d, non_blocking=True) for p, d in zip(_split(_tensor(x), len(devs)), devs)]


def _parts(x, place) -> list:
    "x as already placed parts (a list) or placed now by `place`."
    return list(x) if isinstance(x, (list, tuple)) else place(x)


def _plane_grid(mesh: Mesh, Shi, Slo, Scnt) -> tuple:
    """(grid[i][s] = shard s's (hi, lo, cnt) rows on mesh.devices[i][s],
    rows a shard)."""
    n = mesh.shape["shards"]
    blocks = [_split(_tensor(t), n, even=True) for t in (Shi, Slo, Scnt)]
    grid = [[tuple(b[s].to(dev, non_blocking=True) for b in blocks) for s, dev in enumerate(row)]
            for row in mesh.devices]
    return grid, blocks[0][0].shape[0]


def _query_blocks(mesh: Mesh, *xs) -> list:
    "Each x [bq, ...] split across 'data': [(x blocks of data block i)], on the CPU or x's device."
    n = mesh.shape["data"]
    return list(zip(*[_split(_tensor(x), n) for x in xs]))


def _alive_words(alive: torch.Tensor) -> torch.Tensor:
    "[bq, dq, B] bool alive slots -> [bq, dq, B/32] int32 words."
    return pack_bits_u32(alive.to(torch.bool))


def _first_max(cnt: torch.Tensor) -> torch.Tensor:
    """[..., n] int32 counts -> [...] int64: the position of the largest,
    the lowest among ties (jnp.argmax's choice, on a unique score)."""
    ids = torch.arange(cnt.shape[-1], dtype=torch.int64, device=cnt.device)
    return torch.argmax((cnt.to(torch.int64) << 32) - ids, dim=-1)


# -- the sharded gather program --------------------------------------------------


def make_sharded_counter(mesh: Mesh, n_datasets: int):
    """The sharded counter query:

    (Shi [m,d,B], Slo, Scnt [m,B], qhi [bq,dq,B], qlo, alive) -> counts [bq, n_datasets]

    Subject planes split across 'shards' on the row axis, queries across
    'data'; each shard counts its rows with `shard_match`, and the shards'
    blocks are placed at their row offsets and summed (psum)."""

    def fn(Shi, Slo, Scnt, qhi, qlo, alive):
        grid, _per = _plane_grid(mesh, Shi, Slo, Scnt)
        out = []
        for i, (qh, ql, al) in enumerate(_query_blocks(mesh, qhi, qlo, alive)):
            A = _alive_words(al)
            parts = []
            for s, dev in enumerate(mesh.devices[i]):
                with _on(dev):
                    parts.append(shard_match(qh.to(dev), ql.to(dev), A.to(dev), *grid[i][s]))
            out.append(psum_placed(parts)[0][:, :n_datasets])
        return _cat(out, mesh.first)

    return fn


def make_sharded_gather_round(mesh: Mesh, n_datasets: int):
    """One full gather round over the mesh:

    (Shi, Slo, Scnt, qhi, qlo, alive, counts [bq, n_datasets], thresh [bq])
      -> (best [bq] int32, best_count [bq], new_counts, new_alive [bq, dq, B] bool)

    Per query: pick the best dataset (argmax; ties to the lowest id,
    matching Counter.most_common insertion order), take its membership
    bits over the live query slots (`shard_match` on the owner shard's row;
    the psum-OR combines), clear those slots from `alive`, and decrement
    every dataset's counter by its overlap with them (`shard_match`
    counts, placed and summed). A query whose best count is below
    max(thresh, 1) gives -1 and 0 and keeps its state."""

    def fn(Shi, Slo, Scnt, qhi, qlo, alive, counts, thresh):
        grid, per = _plane_grid(mesh, Shi, Slo, Scnt)
        res = []
        blocks = _query_blocks(mesh, qhi, qlo, alive, counts, thresh)
        for i, (qh, ql, al, cnt, th) in enumerate(blocks):
            A = _alive_words(al)
            bq, dq, B = qh.shape
            parts, state = [], []
            for s, dev in enumerate(mesh.devices[i]):
                hi, lo, sc = grid[i][s]
                c, Qh, Ql, Aw = cnt.to(dev), qh.to(dev), ql.to(dev), A.to(dev)
                best = _first_max(c)
                bc = c.gather(1, best[:, None])[:, 0]
                active = bc >= torch.clamp(th.to(dev), min=1)
                my0 = s * per
                owner = (best >= my0) & (best < my0 + per)
                ix = torch.clamp(best - my0, 0, per - 1)
                whi, wlo, wsc = hi.index_select(0, ix), lo.index_select(0, ix), sc.index_select(0, ix)
                with _on(dev):
                    m = [shard_match(Qh[q : q + 1], Ql[q : q + 1], Aw[q : q + 1],
                                     whi[q : q + 1], wlo[q : q + 1], wsc[q : q + 1],
                                     bits=True)[1][0, 0] for q in range(bq)]
                m = torch.stack(m) if m else Aw.new_zeros((0, dq, B // 32))
                parts.append(torch.where((owner & active)[:, None, None], m, 0))
                state.append((dev, c, best, bc, active, Qh, Ql))
            rms = por(parts)
            dec = []
            for s, (dev, _c, _b, _bc, _a, Qh, Ql) in enumerate(state):
                with _on(dev):
                    dec.append(shard_match(Qh, Ql, rms[s], *grid[i][s]))
            dec0 = psum_placed(dec)[0][:, :n_datasets]
            _dev, c, best, bc, active, _Qh, _Ql = state[0]
            res.append((
                torch.where(active, best, -1).to(torch.int32),
                torch.where(active, bc, 0),
                torch.where(active[:, None], torch.clamp(c - dec0, min=0), c),
                unpack_bits_u32(A.to(rms[0].device) & ~rms[0]),
            ))
        return tuple(_cat(col, mesh.first) for col in zip(*res))

    return fn


def make_sharded_membership_builder(mesh: Mesh, n_datasets: int):
    """Phase 1 of the fused gather: one dense pass over the sharded index
    extracts each shard's rows' intersections with each query as bitpacked
    membership words, and the initial counts.

    (Shi, Slo, Scnt, qhi, qlo, alive) ->
      (M: Blocks of [bq_i, per, dq, B/32] int32, data block i and shard s on
       mesh.devices[i][s]; counts [bq, n_datasets])

    Each shard's M is one preallocated buffer that `shard_match` fills in
    place, 4,096 rows a launch, so peak memory is the packed matrix."""

    def fn(Shi, Slo, Scnt, qhi, qlo, alive):
        grid, per = _plane_grid(mesh, Shi, Slo, Scnt)
        row_chunk = max(1, min(per, 4096))
        Mgrid, counts = [], []
        for i, (qh, ql, al) in enumerate(_query_blocks(mesh, qhi, qlo, alive)):
            A = _alive_words(al)
            bq, dq, B = qh.shape
            row, parts = [], []
            for s, dev in enumerate(mesh.devices[i]):
                hi, lo, sc = grid[i][s]
                Qh, Ql, Aw = qh.to(dev), ql.to(dev), A.to(dev)
                M = torch.empty((bq, per, dq, B // 32), dtype=torch.int32, device=dev)
                c = torch.zeros((bq, per), dtype=torch.int32, device=dev)
                with _on(dev):
                    for c0 in range(0, per, row_chunk):
                        c1 = min(c0 + row_chunk, per)
                        shard_match(Qh, Ql, Aw, hi[c0:c1], lo[c0:c1], sc[c0:c1], out=(c, M),
                                    row0=c0)
                row.append(M)
                parts.append(c)
            Mgrid.append(row)
            counts.append(psum_placed(parts)[0][:, :n_datasets])
        return Blocks(Mgrid), _cat(counts, mesh.first)

    return fn


def _m_blocks(mesh: Mesh, M) -> Blocks:
    "M [bq, m, dq, W] split across 'data' (axis 0) and 'shards' (axis 1), placed."
    if isinstance(M, Blocks):
        return M
    n = mesh.shape["shards"]
    return Blocks([[b.to(dev, non_blocking=True) for b, dev in zip(_split(blk, n, 1, even=True),
                                                                  row)]
                   for blk, row in zip(_split(_tensor(M), mesh.shape["data"]), mesh.devices)])


def make_sharded_gather_rounds(mesh: Mesh, n_datasets: int, max_rounds: int):
    """Phase 2 of the fused gather: `max_rounds` greedy rounds on the
    bitpacked membership matrix: argmax, the owner shard's M[best] & alive
    (psum-OR), alive &= ~removed, AND+popcount decrements (`round_dec_batch`
    on each shard's [bq, per, dq*B/32] words). The index planes are not an
    input.

    (M [bq, m, dq, B/32] (or the builder's Blocks), alive [bq, dq, B] bool,
     counts [bq, n_datasets], thresh [bq])
      -> (best [bq, max_rounds] int32, best_count [bq, max_rounds])"""

    def fn(M, alive, counts, thresh):
        M = _m_blocks(mesh, M)
        out_b, out_c = [], []
        for i, (al, cnt, th) in enumerate(_query_blocks(mesh, alive, counts, thresh)):
            blocks, devs = M.grid[i], mesh.devices[i]
            bq, per, dq, W = blocks[0].shape
            alp = [_alive_words(al).to(dev) for dev in devs]
            cns = [cnt.to(dev) for dev in devs]
            ths = [torch.clamp(th.to(dev), min=1) for dev in devs]
            qis = [torch.arange(bq, device=dev) for dev in devs]
            bests, bcs = [], []
            for _ in range(max_rounds):
                parts, state = [], []
                for s in range(len(devs)):
                    best = _first_max(cns[s])
                    bc = cns[s].gather(1, best[:, None])[:, 0]
                    active = bc >= ths[s]
                    my0 = s * per
                    owner = (best >= my0) & (best < my0 + per)
                    row = blocks[s][qis[s], torch.clamp(best - my0, 0, per - 1)]
                    parts.append(torch.where((owner & active)[:, None, None], row, 0) & alp[s])
                    state.append((best, bc, active))
                rms = por(parts)
                dec = []
                for s, dev in enumerate(devs):
                    with _on(dev):
                        dec.append(round_dec_batch(blocks[s].view(bq, per, dq * W),
                                                   rms[s].view(bq, dq * W)))
                decs = psum_placed(dec)
                for s, (_best, _bc, active) in enumerate(state):
                    d = decs[s][:, :n_datasets]
                    cns[s] = torch.where(active[:, None], torch.clamp(cns[s] - d, min=0), cns[s])
                    alp[s] = alp[s] & ~rms[s]
                best, bc, active = state[0]
                bests.append(torch.where(active, best, -1).to(torch.int32))
                bcs.append(torch.where(active, bc, 0))
            if bests:
                out_b.append(torch.stack(bests, dim=1))
                out_c.append(torch.stack(bcs, dim=1))
            else:
                out_b.append(torch.zeros((bq, 0), dtype=torch.int32, device=devs[0]))
                out_c.append(torch.zeros((bq, 0), dtype=torch.int32, device=devs[0]))
        return _cat(out_b, mesh.first), _cat(out_c, mesh.first)

    return fn


def make_sharded_gather_program(mesh: Mesh, n_datasets: int, max_rounds: int):
    """The end-to-end gather: the membership build and all greedy rounds
    (the index planes and the rounds' state are never needed together).

    (Shi, Slo, Scnt, qhi, qlo, alive, thresh)
      -> (best [bq, max_rounds] int32, best_count [bq, max_rounds])"""
    build = make_sharded_membership_builder(mesh, n_datasets)
    rounds = make_sharded_gather_rounds(mesh, n_datasets, max_rounds)

    def fn(Shi, Slo, Scnt, qhi, qlo, alive, thresh):
        M, counts = build(Shi, Slo, Scnt, qhi, qlo, alive)
        return rounds(M, alive, counts, thresh)

    return fn


# -- the product paths -------------------------------------------------------------


def make_sharded_bitset_scan(mesh: Mesh, length: int):
    """Greedy gather rounds over a flat [k, W] int32 membership matrix with
    rows split across the mesh's 'shards' axis (its first data row): the
    multi-device branch of `index.flat.DeviceGatherSchedule.compute`, so
    `sourmash gather` runs over every device.

    Bit j of word w in row r = (query hash 32w + j) in dataset r. Per
    round: each shard takes a local argmax, the shards agree on the winner
    by a max over the keys (count << 32) | (0x7FFFFFFF - global id), which
    breaks ties as the one-device argmax does (lowest id, so
    Counter.most_common's insertion order); the owner shard contributes
    the winner's live words (psum-OR), and every shard decrements its rows
    by AND+popcount (`round_dec`).

    Returns fn(M [k, W] or its shard_rows blocks, alive_p [W] (or one a
    shard), counts [k] (or shard_rows blocks), thresh int) ->
    ((alive_p a shard, counts a shard), (best [length] int32, best_count
    [length] int32)), the results on the first shard's device: the
    contract of `index.flat._schedule_scan`, chunk-drivable."""
    devs = mesh.devices[0]

    def fn(M, alive_p, counts, thresh):
        Ms = _parts(M, lambda x: shard_rows(mesh, x))
        cns = _parts(counts, lambda x: shard_rows(mesh, x))
        als = _parts(alive_p, lambda x: broadcast(_tensor(x), devs))
        per = Ms[0].shape[0]
        thresh = int(thresh)
        ids = [torch.arange(per, dtype=torch.int64, device=dev) for dev in devs]
        bests, bcs = [], []
        for _ in range(length):
            keys = []
            for s in range(len(devs)):
                lb = torch.argmax((cns[s].to(torch.int64) << 32) - ids[s]).view(1)
                lc = cns[s].gather(0, lb).to(torch.int64)
                keys.append((lc << 32) | (_KEY_ID - (s * per + lb)))
            gkeys = pmax(keys)
            parts, state = [], []
            for s in range(len(devs)):
                bc = (gkeys[s] >> 32).to(torch.int32)
                best = _KEY_ID - (gkeys[s] & _KEY_ID)
                active = bc >= thresh
                my0 = s * per
                owner = (best >= my0) & (best < my0 + per)
                row = Ms[s].index_select(0, torch.clamp(best - my0, 0, per - 1))[0]
                parts.append(torch.where(owner & active, row, 0) & als[s])
                state.append((best, bc, active))
            rms = por(parts)
            for s, dev in enumerate(devs):
                _best, _bc, active = state[s]
                with _on(dev):
                    dec = round_dec(Ms[s], rms[s])
                cns[s] = torch.where(active, torch.clamp(cns[s] - dec, min=0), cns[s])
                als[s] = als[s] & ~rms[s]
            best, bc, active = state[0]
            bests.append(torch.where(active, best, -1).to(torch.int32))
            bcs.append(torch.where(active, bc, 0))
        if not bests:
            bests = bcs = [torch.zeros(0, dtype=torch.int32, device=devs[0])]
        return (als, cns), (torch.cat(bests), torch.cat(bcs))

    return fn


def make_data_parallel_schedule_scan(mesh: Mesh, length: int):
    """Per-query gather round scans with the query axis split across the
    mesh's 'data' axis (multigather's data parallelism): each data block's
    queries scan independently on its device with the one-device
    `index.flat._schedule_scan_batch` (one `round_dec_batch` a round), no
    collectives. Same contract:

    (M [Q, k, W] int32, alive_p [Q, W], counts [Q, k], thresh [Q], keys
     [Q, k] int64 or None; each a tensor or its split_data blocks)
      -> ((alive_p blocks, counts blocks), (best [Q, length], best_count
          [Q, length]) on the first device)"""
    devs = [row[0] for row in mesh.devices]

    def fn(M, alive_p, counts, thresh, keys=None):
        from ..index.flat import _schedule_scan_batch

        def place(x):
            return _parts(x, lambda y: split_data(mesh, y))

        Ms, als, cns, ths = place(M), place(alive_p), place(counts), place(thresh)
        kss = [None] * len(devs) if keys is None else place(keys)
        out_a, out_c, bests, bcs = [], [], [], []
        for i, dev in enumerate(devs):
            if not Ms[i].shape[0]:
                out_a.append(als[i])
                out_c.append(cns[i])
                continue
            with _on(dev):
                (a, c), (b, bc) = _schedule_scan_batch(Ms[i], als[i], cns[i], ths[i], length,
                                                       kss[i])
            out_a.append(a)
            out_c.append(c)
            bests.append(b)
            bcs.append(bc)
        return (out_a, out_c), (_cat(bests, devs[0]), _cat(bcs, devs[0]))

    return fn


def make_sharded_sketch(mesh: Mesh, ksize: int, cap: int, seed: int = 42):
    """Data-parallel sketching: sequence rows split across 'data'; each
    data block runs the K2 path (`ops.sketch._dense_compact`) on its
    device, no collectives.

    Returns fn(seqs [B, S] uint8, max_hash) -> (survivors [B, cap] int64
    (u64 bit patterns, 2^64-1 = -1 padding, in window order), n_valid [B]
    int32), on the first device. A row with more than cap survivors keeps
    its first cap and reports the true n_valid."""
    from ..ops.sketch import _dense_compact

    devs = [row[0] for row in mesh.devices]

    def fn(seqs, max_hash):
        seqs = _tensor(seqs)
        if seqs.dtype != torch.uint8 or seqs.dim() != 2:
            raise TypeError("seqs must be a [B, S] uint8 array")
        mh = int(np.asarray(max_hash, dtype=np.uint64).reshape(-1)[0])
        outs, ns = [], []
        for part, dev in zip(_split(seqs, len(devs)), devs):
            if not part.shape[0]:
                continue
            with _on(dev):
                out, n = _dense_compact(part.to(dev), mh, ksize, seed, cap)
            outs.append(out)
            ns.append(n.to(torch.int32))
        if not outs:
            return (torch.zeros((0, cap), dtype=torch.int64, device=devs[0]),
                    torch.zeros(0, dtype=torch.int32, device=devs[0]))
        return _cat(outs, devs[0]), _cat(ns, devs[0])

    return fn
