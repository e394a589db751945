"""FlatIndex: device-resident flat index + device CounterGather.

The port of `sourmash_tpu/index/flat.py` for one device: the collection's
sketches live on the device as bucketed planes grouped into banks by
length (`ops/index_ops.py`); counter queries are `counts_rows` launches,
membership bitsets `membership_bits` launches, and every greedy gather
round an argmax, a removal and a `round_dec` launch on the device.
Results are identical to the host CounterGather (reference
`src/sourmash/index/__init__.py:777-909`) for uniform-scaled collections,
including Counter.most_common tie-breaking (the round scan breaks ties by
the lowest dataset id, which is insertion order).

For many queries against one collection (multigather), the counts come
from batched `counts_block` passes (`FlatIndex.warm_gather_counts`), and
the round schedules of a block of queries are built and scanned together
(`compute_schedules_batch`, `converge_schedules_batch`): membership words
by `membership_bits_batch`, one `round_dec_batch` launch per round of the
block.

Given more than one device, the schedules run sharded over them
(`sourmash_tpu_torch/parallel/`, one process driving every device): the
device list is the `devices` argument of `DeviceGatherSchedule.compute`,
`compute_schedules_batch` and `converge_schedules_batch`; without a list
of more than one, on any machine, the one-device path runs (no
measurement shows the sharded scan ahead of it yet). A sharded schedule
builds its membership words on the host: `compute` splits the full
matrix by rows across the devices and runs the sharded round scan (`make_sharded_bitset_scan`: a
local argmax a shard, the winner agreed by a max over keys, the owner's
row OR-ed in, `round_dec` on every shard), route "sharded host
membership"; `compute_schedules_batch` splits each block's queries across
the devices, each scanning its own (`make_data_parallel_schedule_scan`),
route "data-parallel host membership". The schedules equal the
one-device ones.

A FlatIndex saves as a disk revindex (`index/revindex.py`); one loaded
from a revindex directory holds its raw mins and the directory of its
packed planes. Its banks are built at first use: packed on the device from
the raw mins when they fit the device budget, else the mmapped disk planes
stream to the device per query pass.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from . import Index, IndexSearchResult, _check_select_parameters, select_signature
from ..minhash import _get_max_hash_for_scaled
from ..ops import cuda_gather
from ..ops.bucketed import pack_bits_u32, to_torch, unpack_bits_u32
from ..ops.index_ops import (
    build_banks,
    counts_for_banks,
    counts_for_banks_batch,
    load_banks,
    planned_banks_resident,
)
from ..search import calc_threshold_from_bp

SCHEDULE_CAP_ENV = "SOURMASH_TORCH_SCHEDULE_CAP"
DEV_MEMBERSHIP_ENV = "SOURMASH_TORCH_DEV_MEMBERSHIP"
NO_SCHEDULE_ENV = "SOURMASH_TORCH_NO_SCHEDULE"
_MAX_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _schedule_cap() -> int:
    return int(os.environ.get(SCHEDULE_CAP_ENV, "4096"))


def _pack_host_bits(bits: np.ndarray) -> np.ndarray:
    "[..., 32*W] bool -> [..., W] uint32 (bit j of word w = lane 32w + j)."
    shape = bits.shape[:-1] + (bits.shape[-1] // 32, 32)
    return (bits.reshape(shape).astype(np.uint32) << np.arange(32, dtype=np.uint32)).sum(
        -1, dtype=np.uint32
    )


class FlatIndex(Index):
    """In-memory flat index over a list of scaled signatures, with its
    planes on `device` (resolved at first use: CUDA unless the caller or
    SOURMASH_TORCH_DEVICE asks for the CPU).

    All signatures must share ksize/moltype/seed. The device banks hold the
    raw (undownsampled) mins; original signature objects are returned in
    results."""

    is_database = True

    def __init__(self, siglist=None, location=None, locations=None, device=None):
        self._signatures = list(siglist) if siglist else []
        self._location = location
        # optional per-signature locations (views over MultiIndex /
        # manifest collections record each signature's source file)
        self._locations = list(locations) if locations is not None else None
        if self._locations is not None:
            assert len(self._locations) == len(self._signatures)
        self._device = device
        self.counts_cache_hits = 0  # counts_for calls answered by warm_gather_counts
        self._reset()

    def _reset(self):
        self._banks = None  # lazy device row banks
        self._banks_dir = None  # on-disk packed planes (revindex v3); stale after an insert
        self._ds_mins = None
        self._scaled = None
        self._cuts_cache = None  # (q_scaled, cuts, subj_sizes)
        self._counts_cache = {}  # md5(query mins) -> counts, popped on a hit
        self._all_scaled = None  # lazy: every signature has nonzero scaled
        self._row_lut = None  # lazy: dataset id -> (bank, chunk, row)

    @property
    def location(self):
        return self._location

    def _location_for(self, i):
        "Result location of dataset i (per-signature when recorded)."
        if self._locations is not None:
            return self._locations[i]
        return self._location

    def signatures(self):
        return iter(self._signatures)

    def signatures_with_location(self):
        for i, ss in enumerate(self._signatures):
            yield ss, self._location_for(i)

    def __bool__(self):
        return bool(self._signatures)

    def __len__(self):
        return len(self._signatures)

    def insert(self, ss):
        self._signatures.append(ss)
        if self._locations is not None:
            self._locations.append(None)
        self._reset()

    def save(self, path):
        "Persist as a disk revindex directory (the on-disk form of this index)."
        from .revindex import save_revindex

        return save_revindex(self, path)

    @classmethod
    def load(cls, location):
        "Load a disk revindex directory back as a device-backed index."
        from .revindex import load_revindex

        return load_revindex(location)

    def _as_flat_view(self):
        "A FlatIndex is the device engine: no view indirection needed."
        return self

    def select(self, **kwargs):
        _check_select_parameters(**kwargs)
        # manifest semantics for containment (reference manifest.py:324)
        containment = kwargs.pop("containment", False)
        keep = [i for i, ss in enumerate(self._signatures) if select_signature(ss, **kwargs)]
        if containment or kwargs.get("scaled"):
            keep = [i for i in keep if self._signatures[i].minhash.scaled]
        locs = [self._locations[i] for i in keep] if self._locations is not None else None
        return FlatIndex(
            [self._signatures[i] for i in keep], self._location, locations=locs,
            device=self._device,
        )

    # -- device state ------------------------------------------------------

    def _build(self, resident=None):
        """Materialize the device banks from the raw (undownsampled) mins.

        Queries are downsampled before counting, and a downsampled query
        can only hit subject hashes below its own cutoff, so plain counts
        against raw banks equal counts against downsampled banks, while
        per-pair cutoff queries (find) still see every hash they may need
        when the collection's scaleds are heterogeneous.

        Mins preloaded from a disk revindex skip the signatures: they are
        packed on the device when they fit its budget, else the directory's
        packed planes (when it has them) are mmapped and stream per query
        pass. `resident=False` packs on the host (a revindex build that
        writes the planes to disk)."""
        if self._banks is not None:
            return
        from ..ops import resolve_device

        if self._ds_mins is not None and self._scaled is not None:
            self._device = resolve_device(self._device)
            if self._banks_dir is not None and not planned_banks_resident(
                self._ds_mins, self._device
            ):
                self._banks = load_banks(self._banks_dir, self._device)
            else:
                self._banks = build_banks(self._ds_mins, self._device, resident=resident)
            return
        scaleds = {ss.minhash.scaled for ss in self._signatures}
        if 0 in scaleds:
            raise ValueError("FlatIndex requires scaled signatures")
        self._device = resolve_device(self._device)
        mins_list = [ss.minhash.mins_array() for ss in self._signatures]
        self._banks = build_banks(mins_list, self._device, resident=resident)
        self._ds_mins = mins_list
        self._scaled = max(scaleds)

    def counts_for(self, query_mins: np.ndarray) -> np.ndarray:
        """Overlap counts of the (already downsampled) query with each
        dataset; a row that `warm_gather_counts` computed for these exact
        mins is handed out once."""
        if self._counts_cache:
            key = hashlib.md5(np.ascontiguousarray(query_mins).tobytes()).digest()
            hit = self._counts_cache.pop(key, None)
            if hit is not None:
                self.counts_cache_hits += 1
                return hit.copy()
        self._build()
        return counts_for_banks(self._banks, query_mins, n_datasets=len(self._signatures))

    def warm_gather_counts(self, query_mhs, block: int | None = None) -> None:
        """Compute the counter_gather overlap counts of many queries in
        batched passes (`counts_for_banks_batch`: the bank planes are read
        once per block of queries) into a pop-on-hit cache, which the next
        `counter_gather` of each query takes. The cache key is the md5 of
        exactly the mins FlatCounterGather counts: the query's, below the
        cutoff of max(query scaled, collection scaled)."""
        self._build()
        qs = []
        for mh in query_mhs:
            if not mh.scaled:
                continue
            cutoff = np.uint64(_get_max_hash_for_scaled(max(mh.scaled, self._scaled)))
            q = mh.mins_array()
            qs.append(q[q <= cutoff])
        if not qs:
            return
        if block is None:
            # bounded by the query planes of a block: dq (estimated from the
            # mean load of the largest B) x B x 8 bytes a query, ~256 MiB
            B_max = max(b.B for b in self._banks)
            longest = max(max(len(q) for q in qs), 1)
            dq_est = max(8, 1 << int(np.ceil(np.log2(longest / B_max + 1))))
            block = int(max(1, min(64, (256 << 20) // (dq_est * B_max * 8))))
        rows = counts_for_banks_batch(self._banks, qs, len(self._signatures), block=block)
        for q, row in zip(qs, rows):
            self._counts_cache[hashlib.md5(np.ascontiguousarray(q).tobytes()).digest()] = row

    def _row_lookup(self):
        "Per-dataset (bank idx, chunk idx, row-in-chunk) int32 lookup arrays."
        if self._row_lut is None:
            self._build()
            n = len(self._signatures)
            b = np.full(n, -1, np.int32)
            c = np.full(n, -1, np.int32)
            r = np.full(n, -1, np.int32)
            for bi, bank in enumerate(self._banks):
                for ci, ids in enumerate(bank.ids):
                    ids = np.asarray(ids, dtype=np.int64)
                    b[ids] = bi
                    c[ids] = ci
                    r[ids] = np.arange(len(ids), dtype=np.int32)
            self._row_lut = (b, c, r)
        return self._row_lut

    # -- search protocol ---------------------------------------------------

    def find(self, search_fn, query, **kwargs):
        """Batched find against the cached device banks, with per-pair
        scaled cutoffs (`cutoff_counts_for_banks`)."""
        if not self._signatures:
            return
        query_mh = query.minhash
        if self._all_scaled is None:
            self._all_scaled = all(ss.minhash.scaled for ss in self._signatures)
        if not query_mh.scaled or not self._all_scaled:
            sal = list(self.signatures_with_location())
            yield from self._find_batched(search_fn, query, sal)
            return

        search_fn.check_is_compatible(query)
        self._build()
        from ..ops.index_ops import cutoff_counts_for_banks

        q_scaled = query_mh.scaled
        q_mins = query_mh.mins_array()
        n = len(self._signatures)
        if self._cuts_cache is None or self._cuts_cache[0] != q_scaled:
            cuts = np.zeros(n, dtype=np.uint64)
            for i, ss in enumerate(self._signatures):
                cuts[i] = _get_max_hash_for_scaled(max(q_scaled, ss.minhash.scaled))
            # subject size under the pairwise cutoff: only subjects coarser
            # than the query need the searchsorted
            subj_sizes = np.fromiter((len(m) for m in self._ds_mins), dtype=np.int64, count=n)
            for i in np.nonzero(
                [len(m) > 0 and m[-1] > cuts[i] for i, m in enumerate(self._ds_mins)]
            )[0]:
                subj_sizes[i] = np.searchsorted(self._ds_mins[i], cuts[i], side="right")
            self._cuts_cache = (q_scaled, cuts, subj_sizes)
        _, cuts, subj_sizes = self._cuts_cache
        shared = cutoff_counts_for_banks(self._banks, q_mins, cuts, n)
        q_sizes = np.searchsorted(q_mins, cuts, side="right")
        # a zero overlap can only score above a zero threshold
        idxs = range(n) if search_fn.passes(0.0) else np.nonzero(shared > 0)[0]
        for i in idxs:
            shared_size = int(shared[i])
            query_size = int(q_sizes[i])
            total_size = query_size + int(subj_sizes[i]) - shared_size
            score = search_fn.score_fn(query_size, shared_size, int(subj_sizes[i]), total_size)
            if search_fn.passes(score):
                if search_fn.collect(score, ss := self._signatures[i]):
                    yield IndexSearchResult(score, ss, self._location_for(i))

    def counter_gather(self, query, threshold_bp, **kwargs):
        "Build a device-backed CounterGather over matches to the query."
        if not hasattr(query, "update"):  # mutable signature
            query = query.to_frozen()
        with query.update() as prefetch_query:
            prefetch_query.minhash = prefetch_query.minhash.flatten()
        if not self:
            raise ValueError("no signatures to search")
        return FlatCounterGather(prefetch_query, self, threshold_bp)


class _MembershipGroup:
    """Per-chunk gather state for host-mode consume: M [k, dq*B/32] int32
    device words, the membership of the query's bucketed slots in k matched
    datasets, plus host maps from hash values to plane slots."""

    __slots__ = ("M", "ids", "qh", "qpos", "dq", "B")

    def __init__(self, M, ids, q_packed):
        self.M = M
        self.ids = ids
        hi, lo, _cnt, dq, _tail = q_packed
        vals = ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)).reshape(-1)
        pos = np.flatnonzero(vals != _MAX_U64)  # flat plane position -> hash
        qh = vals[pos]
        order = np.argsort(qh)
        self.qh = qh[order]  # sorted plane-resident query hashes
        self.qpos = pos[order]  # their flat plane positions
        self.dq = dq
        self.B = hi.shape[1]


def _dec_counts(M, R):
    """[k, W] membership words & [W] removed-mask words -> [k] int32
    decrements (AND + popcount): the `round_dec` kernel."""
    return cuda_gather.round_dec(M, R)


def _union_rows(M, sel):
    "[k, W] membership words, [k] bool filter -> [W] OR of the selected rows."
    return pack_bits_u32(unpack_bits_u32(M[sel]).any(dim=0))


def _schedule_scan(M, carry, thresh, length, keys=None):
    """`length` greedy rounds over a membership matrix, on its device.

    M [k, W] int32 words: bit j of word w in row r = (query hash 32w+j) in
    candidate r. carry = (alive [W] int32 words, counts [k] int32). Each
    round: argmax of the int64 score (count << 32) - key (max count, then
    the lowest key: a unique first max, whatever the row order; key is
    the row index when `keys` is None) -> remove the winner's live bits ->
    decrement every row by its overlap with them (`round_dec`) -> clamp at
    0. Returns (carry, (best row or -1 [length], count or 0 [length]))."""
    alive, cnt = carry
    if keys is None:
        keys = torch.arange(M.shape[0], dtype=torch.int64, device=M.device)
    bests, bcs = [], []
    for _ in range(length):
        best = torch.argmax((cnt.to(torch.int64) << 32) - keys)
        bc = cnt[best]
        active = bc >= thresh
        rm = torch.where(active, M[best], 0) & alive
        dec = _dec_counts(M, rm)
        cnt = torch.where(active, torch.clamp(cnt - dec, min=0), cnt)
        alive = alive & ~rm
        bests.append(torch.where(active, best, -1))
        bcs.append(torch.where(active, bc, 0))
    return (alive, cnt), (torch.stack(bests), torch.stack(bcs))


class FlatCounterGather:
    """Device CounterGather on a query-centric membership matrix.

    At construction, one counts pass over the index gives per-dataset
    overlap counts; matched datasets' intersections with the query are then
    extracted once as membership words. Every later gather round is small:
    peek = host argmax, consume = one AND+popcount pass over the words. The
    index planes are never re-scanned, unlike the reference's per-round
    Counter updates over stored intersections. Observable behaviour (peek,
    consume, signatures, union_found, Counter.most_common tie-breaking by
    insertion order == lowest dataset id) is identical.
    """

    def __init__(self, query, index: FlatIndex, threshold_bp):
        query_mh = query.minhash
        if not query_mh.scaled:
            raise ValueError("gather requires scaled signatures")

        self.orig_query_mh = query_mh.copy().flatten()
        index._build()
        self.index = index
        self.scaled = max(query_mh.scaled, index._scaled)

        # query downsampled to the common scaled for counting
        cutoff = np.uint64(_get_max_hash_for_scaled(self.scaled))
        q = self.orig_query_mh.mins_array()
        q = q[q <= cutoff]

        counts = index.counts_for(q)
        # the prefetch threshold: datasets below threshold_bp overlap with
        # the original query never enter the counter
        try:
            _, n_threshold_hashes = calc_threshold_from_bp(threshold_bp, self.scaled, len(q))
        except ValueError:
            counts = np.zeros_like(counts)
            n_threshold_hashes = None
        if n_threshold_hashes is not None:
            counts = np.where(counts >= max(n_threshold_hashes, 1), counts, 0)
        # host-CounterGather parity for md5-duplicate candidates: duplicates
        # collapse to ONE candidate holding the FIRST occurrence's counter
        # position but the LAST occurrence's signature object and location.
        # Later duplicates' counts are zeroed; result lookups remap first ->
        # last.
        self._remap = {}
        matched0 = np.nonzero(counts)[0]
        if len(matched0) > 1:
            first_by_md5 = {}
            for i in matched0:
                i = int(i)
                md5 = index._signatures[i].md5sum()
                first = first_by_md5.get(md5)
                if first is None:
                    first_by_md5[md5] = i
                else:
                    counts[i] = 0
                    self._remap[first] = i
        self.counts = counts.astype(np.int64)
        self.query_started = 0
        self._q_mins = q
        self._use_schedule = False
        self._coord = None  # DeviceGatherSchedule when scheduled
        self._coord_idx = 0

        # device membership groups (host-mode consume) are built lazily: a
        # scheduled gather never touches them
        self._groups = None
        self._max_ids = []  # datasets sharing the 2**64-1 hash with the query
        self._q_has_max = bool(len(q)) and q[-1] == _MAX_U64
        self._bitsets_cache = None  # (W, matched ids, M)
        # per-candidate host bitset rows, reused across capped reschedules
        self._bitset_rows = {}
        self._bitset_rows_W = None
        # device-membership caches: per-bank-B query planes + slot maps, and
        # the spill/tail patch
        self._dev_qpacks = {}
        self._dev_patch = None

    @property
    def device(self):
        return self.index._device

    def _get_groups(self):
        "Device membership groups for host-mode consume, built on demand."
        if self._groups is None:
            from ..ops.index_ops import membership_for_banks

            self._groups = []
            matched = np.nonzero(self.counts)[0]
            if len(matched):
                for _bank, q_packed, ids, M in membership_for_banks(
                    self.index._banks, self._q_mins, matched
                ):
                    self._groups.append(_MembershipGroup(M, ids, q_packed))
                if self._q_has_max:
                    for i in matched:
                        m = self.index._ds_mins[int(i)]
                        if len(m) and m[-1] == _MAX_U64:
                            self._max_ids.append(int(i))
        return self._groups

    def signatures(self):
        "Return all signatures with nonzero counters."
        for i, c in enumerate(self.counts):
            if c > 0:
                yield self.index._signatures[self._remap.get(i, i)]

    @property
    def union_found(self):
        """Union of all found hashes, intersected with the original query,
        from the host membership bitsets (sorted joins over the resident
        mins)."""
        found_mh = self.orig_query_mh.copy_and_clear()
        q = self._q_mins
        if len(q) and self.counts.any():
            matched, M = self._membership_bitsets(-(-len(q) // 32))
            if len(matched):
                words = np.bitwise_or.reduce(M, axis=0)  # [W]
                bits = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
                found_mh.add_many(q[bits.reshape(-1)[: len(q)]])
        return found_mh

    def downsample(self, scaled):
        if scaled > self.scaled:
            raise ValueError("FlatCounterGather cannot re-downsample after construction")
        return self.scaled

    # -- scheduled device gather -----------------------------------------

    def enable_device_schedule(self):
        """Precompute the whole greedy round sequence on the device instead
        of one peek/consume round-trip per match."""
        schedule_device_gather([self])

    def _membership_bitsets(self, W):
        """Matched datasets' intersections with the query as host bitsets:
        (matched ids [k], M [k, W] u32, bit j of word w in row r = (query
        hash 32w+j) in matched dataset r). Cached per (W, matched set)."""
        matched = np.nonzero(self.counts > 0)[0]
        hit = self._bitsets_cache
        if hit is not None and hit[0] == W and np.array_equal(hit[1], matched):
            return matched, hit[2]
        M = self._bitsets_for(W, matched)
        self._bitsets_cache = (W, matched, M)
        return matched, M

    def _membership_for_ids(self, W, ids):
        "Bitsets for an explicit candidate-id subset (the schedule cap)."
        ids = np.asarray(ids, dtype=np.int64)
        hit = self._bitsets_cache
        if hit is not None and hit[0] == W and np.array_equal(hit[1], ids):
            return hit[2]
        return self._bitsets_for(W, ids)

    def _bitsets_for(self, W, matched):
        if len(matched) > 8192:
            # one-shot full-collection requests would pin the whole matrix
            # in the row cache; the cache serves the capped reschedules
            return self._bitsets_compute(W, matched)
        if self._bitset_rows_W != W:
            self._bitset_rows = {}
            self._bitset_rows_W = W
        rows = self._bitset_rows
        missing = [int(i) for i in matched if int(i) not in rows]
        if missing:
            for i, row in zip(missing, self._bitsets_compute(W, np.asarray(missing))):
                rows[i] = row
        M = np.empty((len(matched), W), dtype=np.uint32)
        for r, i in enumerate(matched):
            M[r] = rows[int(i)]
        return M

    def _bitsets_compute(self, W, matched):
        "Host membership bitsets of `matched` by the native sorted join."
        from .. import native
        from ..ops.bucketed import _concat_rows

        k = len(matched)
        if not k:
            return np.zeros((0, W), dtype=np.uint32)
        vals, offs = _concat_rows([self.index._ds_mins[int(i)] for i in matched])
        return native.membership_bits(self._q_mins, vals, offs, k, W)

    def _device_membership_worthwhile(self, threshold_bp=0):
        """Device membership pays only past a size threshold: below it the
        host bitset build and one upload win. SOURMASH_TORCH_DEV_MEMBERSHIP
        =1 forces it, =0 disables it."""
        force = os.environ.get(DEV_MEMBERSHIP_ENV)
        if force is not None:
            return bool(int(force)) and self._device_membership_ok()
        if not self._device_membership_ok():
            return False
        k = int(np.count_nonzero(self.counts))
        cap = _schedule_cap()
        if cap:
            k = min(k, cap)
        W = -(-len(self._q_mins) // 32)
        return k * W * 4 >= (24 << 20)

    def _device_membership_ok(self):
        "Banks built and every chunk's planes resident on the device."
        banks = self.index._banks
        return bool(banks) and all(b.resident for b in banks)

    def _qpack_for_B(self, B, W):
        """Cached (query planes, occupancy, dq, slotmap, inverse slotmap) on
        the device for one bank bucket count."""
        hit = self._dev_qpacks.get((B, W))
        if hit is not None:
            return hit
        from ..ops.bucketed import inverse_slot_map, pack_query_bucketed, query_slot_map

        q = self._q_mins
        core = q[:-1] if self._q_has_max else q
        qhi, qlo, qcnt, dq, _tail = pack_query_bucketed(core, B, self.device)
        slotmap = torch.from_numpy(query_slot_map(core, B, dq, W * 32)).to(self.device)
        pack = (qhi, qlo, qcnt, dq, slotmap, inverse_slot_map(slotmap, dq * B))
        self._dev_qpacks[(B, W)] = pack
        return pack

    def _membership_patches(self, W):
        """Bits the planes cannot represent: subject spill-list hashes
        present in the query, and the 2^64-1 tail for datasets holding it.
        {dataset id: (word idx array, mask array)}."""
        if self._dev_patch is not None:
            return self._dev_patch
        q = self._q_mins
        if not self._q_has_max and not any(
            c.n_spilled for b in self.index._banks for c in b.chunks
        ):
            self._dev_patch = {}
            return self._dev_patch
        patch = {}

        def add_bit(ds, pos):
            w, b = divmod(int(pos), 32)
            words = patch.setdefault(int(ds), {})
            words[w] = words.get(w, 0) | (1 << b)

        lut_b, lut_c, lut_r = self.index._row_lookup()
        banks = self.index._banks
        for ds in range(len(lut_b)):
            bi = lut_b[ds]
            if bi < 0:
                continue
            chunk = banks[bi].chunks[lut_c[ds]]
            if not chunk.n_spilled:
                continue
            sp = chunk.spills[lut_r[ds]]
            if not len(sp):
                continue
            idx_c = np.minimum(np.searchsorted(q, sp), max(len(q) - 1, 0))
            for pos in idx_c[q[idx_c] == sp]:
                add_bit(ds, pos)
        if self._q_has_max:
            for ds in self._resolve_max_ids():
                add_bit(ds, len(q) - 1)
        self._dev_patch = {
            ds: (
                np.fromiter(words.keys(), dtype=np.int64, count=len(words)),
                np.fromiter(words.values(), dtype=np.uint32, count=len(words)),
            )
            for ds, words in patch.items()
        }
        return self._dev_patch

    def _resolve_max_ids(self):
        "Dataset ids whose sketch contains the 2^64-1 hash."
        return [
            i for i, m in enumerate(self.index._ds_mins or []) if len(m) and m[-1] == _MAX_U64
        ]

    def _membership_rows_device(self, ids, W):
        """Membership words (sorted-query index space) for an explicit
        candidate-id list, computed on the device from the resident bank
        planes by `membership_bits`, one launch per (bank, chunk) group.
        Returns (M [k, W] int32 in bank-grouped row order, row_src [k] host
        int64 mapping matrix row -> index into `ids`). Callers feed the
        keyed scan, which does not depend on row order. Spilled hashes and
        the 2^64-1 tail are patched in exactly."""
        ids = np.asarray(ids, dtype=np.int64)
        lut_b, lut_c, lut_r = self.index._row_lookup()
        banks = self.index._banks
        order = np.lexsort((lut_r[ids], lut_c[ids], lut_b[ids]))
        gb = lut_b[ids][order]
        gc = lut_c[ids][order]
        bounds = np.flatnonzero(np.diff(gb.astype(np.int64) << 32 | gc)) + 1
        pieces = []
        for a, e in zip(np.concatenate([[0], bounds]), np.concatenate([bounds, [len(ids)]])):
            bank = banks[int(gb[a])]
            chunk = bank.chunks[int(gc[a])]
            qhi, qlo, qcnt, _dq, slotmap, inv = self._qpack_for_B(bank.B, W)
            sel = torch.from_numpy(lut_r[ids[order[a:e]]].astype(np.int64)).to(self.device)
            pieces.append(cuda_gather.membership_bits(
                qhi, qlo, qcnt, chunk.hi, chunk.lo, chunk.cnt, sel, slotmap, inv))
        M = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        row_src = order.astype(np.int64)
        patches = self._membership_patches(W)
        if patches:
            rws, cws, msks = [], [], []
            for r, src in enumerate(row_src):
                p = patches.get(int(ids[src]))
                if p is not None:
                    rws.extend([r] * len(p[0]))
                    cws.extend(p[0].tolist())
                    msks.extend(p[1].tolist())
            if rws:
                ri = torch.tensor(rws, dtype=torch.int64, device=self.device)
                wi = torch.tensor(cws, dtype=torch.int64, device=self.device)
                mk = to_torch(np.asarray(msks, dtype=np.uint32), self.device)
                M[ri, wi] = M[ri, wi] | mk
        return M, row_src

    def _recount(self, cur_query_mh, threshold_bp=0):
        """Refresh counter state against the CURRENT query: counts[i] =
        |dataset_i ∩ current query|, masked by the initial prefetch cut and
        the live threshold (a candidate below the round threshold can never
        win a future round)."""
        scaled = max(self.scaled, cur_query_mh.scaled)
        mins = cur_query_mh.downsample(scaled=scaled).mins_array()
        fresh = self.index.counts_for(mins)
        counts = np.where(self.counts > 0, fresh, 0).astype(np.int64)
        if threshold_bp:
            try:
                _, n_th = calc_threshold_from_bp(threshold_bp, scaled, max(len(mins), 1))
            except ValueError:
                n_th = None
            if n_th is not None:
                counts = np.where(counts >= max(n_th, 1), counts, 0)
        self.counts = counts
        self._groups = None  # stale: rebuilt over the surviving candidates
        self._bitsets_cache = None

    def _fallback_recount(self, cur_query_mh, threshold_bp=0):
        "Leave scheduled mode with exact counter state (host rounds next)."
        self._use_schedule = False
        self._coord = None
        self._recount(cur_query_mh, threshold_bp)

    def _peek_scheduled(self, cur_query_mh, threshold_bp):
        coord = self._coord
        if not coord.ready:
            coord.compute(threshold_bp)
        cur = coord.current()
        if cur is None:
            if coord.truncated:
                # candidate-capped schedule exhausted with excluded
                # candidates possibly above threshold: recount and build a
                # fresh capped schedule, or after 8 of them take exact host
                # rounds
                from ..search import GatherRoundRestart

                if coord._sched and coord.reschedules < 8:
                    coord.reschedule(cur_query_mh, threshold_bp)
                else:
                    coord.fallback(cur_query_mh, threshold_bp)
                raise GatherRoundRestart
            return []
        owner_idx, best, match_size = cur
        if owner_idx != self._coord_idx:
            return []  # another database owns this round

        scaled = max(self.scaled, cur_query_mh.scaled)
        cur_query_mh = cur_query_mh.downsample(scaled=scaled)
        if not cur_query_mh:
            return []
        if cur_query_mh.contained_by(self.orig_query_mh, downsample=True) < 1:
            raise ValueError("current query not a subset of original query")

        try:
            threshold, n_threshold_hashes = calc_threshold_from_bp(
                threshold_bp, scaled, len(cur_query_mh)
            )
        except ValueError:
            return []

        if match_size < n_threshold_hashes:
            return []

        match = self.index._signatures[self._remap.get(best, best)]
        match_mh = match.minhash.downsample(scaled=scaled).flatten()
        intersect_mh = cur_query_mh & match_mh
        if len(intersect_mh) != match_size:
            # the schedule disagrees with live counter state: drop every
            # counter back to exact host rounds and restart the round
            from ..logging import notify
            from ..search import GatherRoundRestart

            notify(
                "WARNING: scheduled device gather diverged at round "
                f"{coord.pos} (planned overlap {match_size}, actual "
                f"{len(intersect_mh)}); falling back to host gather rounds."
            )
            coord.fallback(cur_query_mh, threshold_bp)
            raise GatherRoundRestart

        cont = cur_query_mh.contained_by(match.minhash, downsample=True)
        assert cont
        assert cont >= threshold

        return (
            IndexSearchResult(cont, match, self.index._location_for(self._remap.get(best, best))),
            intersect_mh,
        )

    def peek(self, cur_query_mh, *, threshold_bp=0):
        "Get the next best match without mutating counters."
        self.query_started = 1

        if self._use_schedule:
            return self._peek_scheduled(cur_query_mh, threshold_bp)

        if not self.counts.any():
            return []

        scaled = max(self.scaled, cur_query_mh.scaled)
        cur_query_mh = cur_query_mh.downsample(scaled=scaled)

        if not cur_query_mh:
            return []

        if cur_query_mh.contained_by(self.orig_query_mh, downsample=True) < 1:
            raise ValueError("current query not a subset of original query")

        try:
            threshold, n_threshold_hashes = calc_threshold_from_bp(
                threshold_bp, scaled, len(cur_query_mh)
            )
        except ValueError:
            return []

        best = int(np.argmax(self.counts))
        match_size = int(self.counts[best])
        if match_size == 0 or match_size < n_threshold_hashes:
            return []

        match = self.index._signatures[self._remap.get(best, best)]

        cont = cur_query_mh.contained_by(match.minhash, downsample=True)
        assert cont
        assert cont >= threshold

        match_mh = match.minhash.downsample(scaled=scaled).flatten()
        intersect_mh = cur_query_mh & match_mh

        return (
            IndexSearchResult(cont, match, self.index._location_for(self._remap.get(best, best))),
            intersect_mh,
        )

    def consume(self, intersect_mh):
        """Decrement all dataset counters by their overlap with
        intersect_mh: one AND+popcount pass (`round_dec`) over the
        membership words per chunk group, no index re-scan."""
        self.query_started = 1
        if self._use_schedule:
            # scheduled rounds already applied every removal; the
            # coordinator advances once all counters have consumed
            self._coord.note_consume()
            return
        if not intersect_mh:
            return
        active = self.counts > 0
        n_active = int(active.sum())
        if not n_active:
            return
        # an intersect at a coarser scaled needs no downsample: its mins
        # already sit below this counter's cutoff
        if intersect_mh.scaled >= self.scaled:
            mins = intersect_mh.mins_array()
        else:
            mins = intersect_mh.downsample(scaled=self.scaled).mins_array()
        if self._groups is None and n_active <= 256:
            # few candidates: direct sorted joins on the host
            dec = np.zeros_like(self.counts)
            for i in np.nonzero(active)[0]:
                ds = self.index._ds_mins[int(i)]
                if len(ds) and len(mins):
                    idx = np.minimum(np.searchsorted(ds, mins), len(ds) - 1)
                    dec[i] = int(np.count_nonzero(ds[idx] == mins))
            self.counts = np.where(active, np.maximum(self.counts - dec, 0), self.counts)
            return
        if self._groups is None and n_active > 8192:
            # huge candidate sets: one counts pass over the whole index
            # costs less than extracting membership groups
            dec = self.index.counts_for(mins).astype(self.counts.dtype)
            self.counts = np.where(active, np.maximum(self.counts - dec, 0), self.counts)
            return
        dec = np.zeros_like(self.counts)
        for g in self._get_groups():
            flat = np.zeros(0, np.int64)
            if len(g.qh):
                idx_c = np.minimum(np.searchsorted(g.qh, mins), len(g.qh) - 1)
                flat = g.qpos[idx_c[g.qh[idx_c] == mins]]
            R = np.zeros(g.dq * g.B, dtype=bool)
            R[flat] = True
            Rp = to_torch(_pack_host_bits(R), g.M.device)
            d = _dec_counts(g.M, Rp).cpu().numpy()
            dec[g.ids] += d[: len(g.ids)]
        if self._max_ids and len(mins) and mins[-1] == _MAX_U64:
            for i in self._max_ids:
                dec[i] += 1
        self.counts = np.where(active, self.counts - dec, self.counts)
        np.maximum(self.counts, 0, out=self.counts)


def _mesh_devices(devices=None):
    """The devices of a sharded schedule, or None for the one-device path:
    `devices` when the caller names more than one. The one-device path
    stays the default on a machine with several cards: no measurement
    shows the sharded scan ahead of it yet."""
    devices = [torch.device(d) for d in devices or ()]
    return devices if len(devices) > 1 else None


class DeviceGatherSchedule:
    """Coordinator for the device-scheduled gather over one or more
    FlatCounterGather counters sharing the same query and scaled.

    Every counter's matched-dataset membership words (over the shared
    query's element indices) concatenate counter-major into one [k, W]
    matrix; one scan replays every greedy round: argmax, winner-bit
    removal, AND+popcount decrements. The global argmax over the
    concatenated rows reproduces the cross-database selection of
    GatherDatabases._select_best exactly: score ties go to the
    earliest-listed database, in-database ties to the lowest dataset id.
    """

    def __init__(self, counters):
        self.counters = list(counters)
        self._sched = None  # [(counter_idx, dataset_id, count)]
        self.pos = 0
        self._consumed = 0
        self.ready = False
        # candidate-cap state: with a huge matched set only the top-C
        # candidates by initial count enter the scan, and `truncated` marks
        # that exhausting the schedule must fall back to exact host rounds
        self._cap_bound = None  # best EXCLUDED candidate's initial count
        self._cap_guard = False  # bound could still pass the threshold
        self.truncated = False
        self.reschedules = 0  # capped (re)scheduling rounds so far
        self._alive_mins = None  # current-query mins after a reschedule
        # device rows of the host-built matrix, reused across reschedules
        self._dev_rows = {}  # (counter_idx, dataset_id) -> row in _dev_mat
        self._dev_mat = None  # [n_cached, W] int32 on the device
        self._dev_W = None
        self.route = None  # "device membership", "host membership" or "sharded host membership"
        self.devices = None  # compute's device list, kept for its reschedules

    def current(self):
        "The (counter_idx, dataset_id, count) of the current round, or None."
        if self._sched is None or self.pos >= len(self._sched):
            return None
        return self._sched[self.pos]

    def note_consume(self):
        "Advance one round once every participating counter has consumed."
        self._consumed += 1
        if self._consumed >= len(self.counters):
            self._consumed = 0
            self.pos += 1

    def fallback(self, cur_query_mh, threshold_bp=0):
        "Drop every counter back to exact host peek/consume rounds."
        self.ready = True
        self.truncated = False
        self._sched = []
        for c in self.counters:
            c._fallback_recount(cur_query_mh, threshold_bp)

    def reschedule(self, cur_query_mh, threshold_bp):
        """Iterative capped scheduling: recount every counter against the
        current query (consumed clusters collapse, so the true remaining
        candidates rise into the top-C) and rebuild the schedule on the
        next peek."""
        self.reschedules += 1
        scaled = self.counters[0].scaled
        for c in self.counters:
            c._recount(cur_query_mh, threshold_bp)
        self._alive_mins = cur_query_mh.downsample(
            scaled=max(scaled, cur_query_mh.scaled)
        ).mins_array()
        self.ready = False
        self.truncated = False
        self._sched = None
        self.pos = 0
        self._consumed = 0

    def _build_inputs(self, threshold_bp, dev_cached=None, build_mats=True):
        """The scan inputs for this coordinator's query: (rows
        [(counter_idx, dataset_id)], counts [k] int32, alive [W] uint32,
        thresh, new_keys, M_new). Host bitsets are built only for
        `new_keys` (rows not in `dev_cached`; all rows when it is None).
        None when the query or match set is empty or the threshold is
        unattainable.

        Above SOURMASH_TORCH_SCHEDULE_CAP matched candidates (default
        4096), only the top-cap candidates by initial count enter the scan,
        and `_cap_bound` records the best excluded candidate's count: a
        round whose winner count does not strictly exceed it cannot be
        trusted, so the schedule truncates there."""
        c0 = self.counters[0]
        q = c0._q_mins
        scaled = c0.scaled
        if not len(q):
            return None
        try:
            _, n_th = calc_threshold_from_bp(threshold_bp, scaled, len(q))
        except ValueError:
            return None
        thresh = int(max(n_th, 1))

        W = -(-len(q) // 32)
        per_counter_ids, all_counts = [], []
        for c in self.counters:
            assert c.scaled == scaled, "schedule requires uniform scaled"
            ids = np.nonzero(c.counts > 0)[0]
            per_counter_ids.append(ids)
            all_counts.append(c.counts[ids])
        k_total = sum(len(ids) for ids in per_counter_ids)
        if not k_total:
            return None
        counts_all = np.concatenate(all_counts).astype(np.int64)

        cap = _schedule_cap()
        self._cap_bound = None
        self._cap_guard = False
        keep_mask = None
        if cap and k_total > cap:
            order = np.argsort(-counts_all, kind="stable")
            self._cap_bound = int(counts_all[order[cap]])
            self._cap_guard = self._cap_bound >= thresh
            keep_mask = np.zeros(k_total, dtype=bool)
            keep_mask[order[:cap]] = True

        rows, mats, new_keys, counts = [], [], [], []
        off = 0
        for ci, (c, ids) in enumerate(zip(self.counters, per_counter_ids)):
            if keep_mask is not None:
                ids = ids[keep_mask[off : off + len(ids)]]
            off += len(per_counter_ids[ci])
            if not len(ids):
                continue
            rows.extend((ci, int(i)) for i in ids)
            counts.append(c.counts[ids])
            if not build_mats:
                continue
            if dev_cached is None:
                need = ids
            else:  # host-build only rows not already on the device
                need = np.asarray([i for i in ids if (ci, int(i)) not in dev_cached], dtype=ids.dtype)
            if len(need):
                mats.append(c._membership_for_ids(W, need))
                new_keys.extend((ci, int(i)) for i in need)
        if not rows:
            return None
        if mats:
            M_new = np.concatenate(mats, axis=0) if len(mats) > 1 else mats[0]
        else:
            M_new = np.zeros((0, W), dtype=np.uint32)
        counts = np.concatenate(counts).astype(np.int32)

        alive = np.zeros(W * 32, dtype=bool)
        if self._alive_mins is not None:
            # rescheduled mid-gather: only the current query's hashes are
            # live (the bitsets stay indexed by the original q)
            idx = np.minimum(np.searchsorted(q, self._alive_mins), max(len(q) - 1, 0))
            hit = q[idx] == self._alive_mins if len(q) else idx < 0
            alive[idx[hit]] = True
        else:
            alive[: len(q)] = True
        return rows, counts, _pack_host_bits(alive), thresh, new_keys, M_new

    def compute(self, threshold_bp, devices=None):
        """Build the membership matrix and run the round scan, reading the
        winners back once per chunk of rounds. On one device (the
        counters'), the matrix comes from the bank planes on the device or
        from host bitsets; on more than one (a `devices` list the caller
        gives; by default the one device), the host-built matrix in row
        order is split by rows across them and the sharded scan (`parallel.make_sharded_bitset_scan`)
        runs its rounds. A given `devices` is kept for later computes (the
        capped reschedules)."""
        self.ready = True
        if devices is not None:
            self.devices = devices
        devices = _mesh_devices(self.devices)
        multi = devices is not None
        # single-counter resident-bank case: membership words are computed
        # on the device from the bank planes, with no host build and no
        # matrix upload; the host build with its row cache serves the rest
        dev_membership = (not multi and len(self.counters) == 1
                          and self.counters[0]._device_membership_worthwhile(threshold_bp))
        self.route = ("sharded host membership" if multi
                      else "device membership" if dev_membership else "host membership")
        device = self.counters[0].device
        q0 = self.counters[0]._q_mins
        W0 = -(-len(q0) // 32) if len(q0) else 0
        if self._dev_W != W0:
            self._dev_rows, self._dev_mat, self._dev_W = {}, None, W0
        built = self._build_inputs(
            threshold_bp,
            dev_cached=None if (multi or dev_membership) else self._dev_rows,
            build_mats=not dev_membership,
        )
        if built is None:
            self._sched = []
            return
        rows, counts, alive_p, thresh, new_keys, M_new = built

        k = len(rows)
        # fewer rounds per readback when the candidate set is huge: each
        # round costs O(k * W) whether or not the gather is already done
        chunk = int(min(k, 64 if k > 4096 else 256))
        row_map = None
        if multi:
            from ..parallel import get_mesh, make_sharded_bitset_scan, shard_rows

            # the full matrix in row order, padded with zero rows to a
            # multiple of the shard count; M and counts go to the shards once
            mesh = get_mesh(1, len(devices), devices=devices)
            k_pad = -(-k // len(devices)) * len(devices)
            M = np.zeros((k_pad, M_new.shape[1]), dtype=np.uint32)
            M[:k] = M_new
            counts_p = np.zeros(k_pad, dtype=np.int32)
            counts_p[:k] = counts
            scan = make_sharded_bitset_scan(mesh, chunk)
            Ms = shard_rows(mesh, to_torch(M))
            carry = (to_torch(alive_p), shard_rows(mesh, torch.from_numpy(counts_p)))

            def run(c):
                return scan(Ms, c[0], c[1], thresh)
        elif dev_membership:
            alive = to_torch(alive_p, device)
            Mj, row_src = self.counters[0]._membership_rows_device(
                np.asarray([ds for _ci, ds in rows], dtype=np.int64), alive_p.shape[0]
            )
            # grouped-order matrix: counts and keys follow row_src; the keyed
            # scan restores (counter, ascending id) tie-breaking
            carry = (alive, torch.from_numpy(counts[row_src]).to(device))
            keys = torch.from_numpy(row_src).to(device)
            row_map = row_src

            def run(c):
                return _schedule_scan(Mj, c, thresh, chunk, keys)
        else:
            # upload only rows the device has not seen; reschedules re-rank
            # mostly-overlapping candidate sets
            if len(new_keys):
                Mn = to_torch(M_new, device)
                base = 0 if self._dev_mat is None else self._dev_mat.shape[0]
                self._dev_mat = Mn if self._dev_mat is None else torch.cat([self._dev_mat, Mn])
                for j, kk in enumerate(new_keys):
                    self._dev_rows[kk] = base + j
            idxs = np.fromiter((self._dev_rows[kk] for kk in rows), dtype=np.int64, count=k)
            if len(self._dev_rows) == k and np.array_equal(idxs, np.arange(k)):
                Mj = self._dev_mat  # first compute: already in row order
            else:
                Mj = self._dev_mat.index_select(0, torch.from_numpy(idxs).to(device))
            carry = (to_torch(alive_p, device), torch.from_numpy(counts).to(device))

            def run(c):
                return _schedule_scan(Mj, c, thresh, chunk)

        schedule = []
        while True:
            carry, (bests, bcs) = run(carry)
            b_np, c_np = bests.cpu().numpy(), bcs.cpu().numpy()
            done = False
            for b, c in zip(b_np, c_np):
                if b < 0:
                    done = True
                    break
                if self._cap_guard and int(c) <= self._cap_bound:
                    # a round at or below the best excluded candidate's
                    # initial count is no longer provably correct
                    done = True
                    break
                ci, ds = rows[int(row_map[int(b)]) if row_map is not None else int(b)]
                schedule.append((ci, ds, int(c)))
            if done or len(schedule) >= k:
                break
        # with a guard bound, any end of the capped schedule may leave
        # excluded candidates above the threshold: exhausting it falls back
        # to exact host rounds
        self.truncated = bool(self._cap_guard)
        self._sched = schedule


def _membership_rows_device_batch(counters, ids_list, W, bq: int = 32):
    """Membership words of many single-counter queries over ONE FlatIndex
    with resident banks, on the device: (M [Q, K, W] int32 in bank-grouped
    row order, K the same for every query, and row_srcs, per query a host
    int64 [K] mapping matrix row -> position in ids_list[q], -1 for
    padding rows). One `membership_bits_batch` launch per (chunk, block of
    bq queries). A chunk contributes as many rows as its largest
    per-query selection; shorter selections are padded with row 0, whose
    words the -1 row_src disregards. Spilled hashes and 2^64-1 tails are
    patched in exactly, query by query."""
    from ..ops.bucketed import (
        _membership_bits_packed_batch,
        inverse_slot_map,
        pack_query_block_device,
        query_slot_map,
    )

    index = counters[0].index
    device = counters[0].device
    lut_b, lut_c, lut_r = index._row_lookup()
    banks = index._banks
    Q = len(counters)

    # per (bank, chunk): per query (rows in the chunk, positions in ids)
    sel_by_chunk: dict = {}
    for qi, ids in enumerate(ids_list):
        ids = np.asarray(ids, dtype=np.int64)
        if not len(ids):
            continue
        gb, gc = lut_b[ids], lut_c[ids]
        order = np.lexsort((lut_r[ids], gc, gb))
        gbs, gcs = gb[order], gc[order]
        bounds = np.flatnonzero(np.diff(gbs.astype(np.int64) << 32 | gcs)) + 1
        for a, e in zip(np.concatenate([[0], bounds]), np.concatenate([bounds, [len(ids)]])):
            pos = order[a:e]
            sel_by_chunk.setdefault((int(gbs[a]), int(gcs[a])), {})[qi] = (lut_r[ids[pos]], pos)

    cores = [c._q_mins[:-1] if c._q_has_max else c._q_mins for c in counters]
    layout = [(key, max(len(v[0]) for v in sel_by_chunk[key].values()))
              for key in sorted(sel_by_chunk)]
    K = sum(width for _key, width in layout)
    row_srcs = [np.full(K, -1, dtype=np.int64) for _ in range(Q)]
    blocks = []
    for q0 in range(0, Q, bq):
        qs = range(q0, min(q0 + bq, Q))
        block_cores = [cores[qi] for qi in qs]
        raw = None
        packs = {}
        pieces = []
        base = 0
        for (bank_i, chunk_i), width in layout:
            if bank_i not in packs:
                # each block at its own depth: the words do not depend on it
                B = banks[bank_i].B
                Qhi, Qlo, Qcnt, dq, raw = pack_query_block_device(block_cores, B, raw, device)
                smaps = np.full((len(qs), W * 32), dq * B, dtype=np.int32)
                for j, core in enumerate(block_cores):
                    if len(core):
                        smaps[j] = query_slot_map(core, B, dq, W * 32)
                smaps = torch.from_numpy(smaps).to(device)
                packs[bank_i] = (Qhi, Qlo, Qcnt, smaps, inverse_slot_map(smaps, dq * B))
            chunk = banks[bank_i].chunks[chunk_i]
            slots = sel_by_chunk[(bank_i, chunk_i)]
            sel = np.zeros((len(qs), width), dtype=np.int64)
            for j, qi in enumerate(qs):
                got = slots.get(qi)
                if got is not None:
                    rows_sel, pos = got
                    sel[j, : len(rows_sel)] = rows_sel
                    row_srcs[qi][base : base + len(pos)] = pos
            Qhi, Qlo, Qcnt, smaps, inv = packs[bank_i]
            pieces.append(_membership_bits_packed_batch(
                Qhi, Qlo, Qcnt, chunk.hi, chunk.lo, chunk.cnt,
                torch.from_numpy(sel).to(device), smaps, inv))
            base += width
        blocks.append(torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0])
    M = torch.cat(blocks) if len(blocks) > 1 else blocks[0]

    qws, rws, cws, msks = [], [], [], []
    for qi, ids in enumerate(ids_list):
        patches = counters[qi]._membership_patches(W)
        if not patches:
            continue
        for r, src in enumerate(row_srcs[qi]):
            p = patches.get(int(ids[src])) if src >= 0 else None
            if p is not None:
                qws.extend([qi] * len(p[0]))
                rws.extend([r] * len(p[0]))
                cws.extend(p[0].tolist())
                msks.extend(p[1].tolist())
    if qws:
        at = tuple(torch.tensor(x, dtype=torch.int64, device=device) for x in (qws, rws, cws))
        M[at] = M[at] | to_torch(np.asarray(msks, dtype=np.uint32), device)
    return M, row_srcs


def _schedule_scan_batch(M, alive, counts, thresh, length, keys=None):
    """`_schedule_scan` for a block of independent queries: M [Q, k, W]
    int32 words, alive [Q, W], counts [Q, k], thresh [Q] (and keys [Q, k]
    int64, else the row index). Each round is one argmax per query and one
    `round_dec_batch` launch for the whole block. Returns ((alive, counts),
    (best row or -1 [Q, length], count or 0 [Q, length]))."""
    Q, k, _W = M.shape
    if keys is None:
        keys = torch.arange(k, dtype=torch.int64, device=M.device).expand(Q, k)
    qi = torch.arange(Q, device=M.device)
    cnt = counts
    bests, bcs = [], []
    for _ in range(length):
        best = torch.argmax((cnt.to(torch.int64) << 32) - keys, dim=1)
        bc = cnt[qi, best]
        active = bc >= thresh
        rm = torch.where(active[:, None], M[qi, best], 0) & alive
        dec = cuda_gather.round_dec_batch(M, rm)
        cnt = torch.where(active[:, None], torch.clamp(cnt - dec, min=0), cnt)
        alive = alive & ~rm
        bests.append(torch.where(active, best, -1))
        bcs.append(torch.where(active, bc, 0))
    return (alive, cnt), (torch.stack(bests, dim=1), torch.stack(bcs, dim=1))


def compute_schedules_batch(coords, threshold_bp, block: int = 64, extend=False, devices=None):
    """Compute many coordinators' round schedules in blocks of `block`
    queries: each block pads its queries' matrices to one [Q, k, W] (k
    rounded up to 1,024, W to 128; padding rows have count 0 and key 2^40,
    so they never win) and scans them together. On one device, a block of
    several single-counter queries over one index whose candidates are
    worth the device membership builds every matrix with
    `membership_bits_batch`; any other block uploads host matrices. On
    more than one (a `devices` list the caller gives; by default the one
    device), every block takes host matrices and its queries split across the devices, each scanning its
    own (`parallel.make_data_parallel_schedule_scan`). Each coordinator
    ends with the schedule its own compute() would build; with `extend`,
    the rounds are appended to the schedule it has."""
    coords = list(coords)
    devices = _mesh_devices(devices)
    multi = devices is not None
    pending = []
    for coord in coords:
        coord.ready = True
        if not extend:
            coord._sched = []
        dev_ok = not multi and len(coord.counters) == 1 and (
            coord.counters[0]._device_membership_worthwhile(threshold_bp))
        built = coord._build_inputs(threshold_bp, build_mats=not dev_ok)
        if built is not None:
            pending.append((coord, built, dev_ok))

    for b0 in range(0, len(pending), block):
        sub = pending[b0 : b0 + block]
        Q = len(sub)
        device = sub[0][0].counters[0].device
        Wmax = -(-max(b[2].shape[0] for _c, b, _d in sub) // 128) * 128
        on_device = Q > 1 and all(d for _c, _b, d in sub) and (
            len({id(c.counters[0].index) for c, _b, _d in sub}) == 1)
        if on_device:
            M, row_srcs = _membership_rows_device_batch(
                [c.counters[0] for c, _b, _d in sub],
                [np.asarray([ds for _ci, ds in b[0]], dtype=np.int64) for _c, b, _d in sub],
                Wmax)
            mats = None
            K = M.shape[1]
        else:
            mats = []
            for coord, (rows, _counts, alive_p, _th, _nk, Mq), dev_ok in sub:
                if dev_ok:
                    Mq = coord.counters[0]._membership_for_ids(
                        alive_p.shape[0], np.asarray([ds for _ci, ds in rows], dtype=np.int64))
                mats.append(Mq)
            row_srcs = [np.arange(len(b[0]), dtype=np.int64) for _c, b, _d in sub]
            K = max(m.shape[0] for m in mats)
        kmax = -(-K // 1024) * 1024

        Ab = np.zeros((Q, Wmax), dtype=np.uint32)
        Cb = np.zeros((Q, kmax), dtype=np.int32)
        Tb = np.ones(Q, dtype=np.int32)
        Kb = np.full((Q, kmax), 1 << 40, dtype=np.int64)
        route = ("data-parallel host membership" if multi
                 else "device membership" if on_device else "host membership")
        for qi, (coord, (_rows, counts, alive_p, thresh, _nk, _M), _d) in enumerate(sub):
            src = row_srcs[qi]
            real = src >= 0
            Cb[qi, : len(src)][real] = counts[src[real]]
            Kb[qi, : len(src)][real] = src[real]
            Ab[qi, : alive_p.shape[0]] = alive_p
            Tb[qi] = thresh
            coord.route = route
        if on_device:
            Mj = torch.nn.functional.pad(M, (0, 0, 0, kmax - K))
        else:
            Mb = np.zeros((Q, kmax, Wmax), dtype=np.uint32)
            for qi, Mq in enumerate(mats):
                Mb[qi, : Mq.shape[0], : Mq.shape[1]] = Mq
        chunk = int(min(kmax, 64 if kmax > 4096 else 256))
        if multi:
            from ..parallel import get_mesh, make_data_parallel_schedule_scan, split_data

            # the block's queries split across the devices (Q need not
            # divide), each block placed once
            mesh = get_mesh(min(len(devices), Q), 1, devices=devices[: min(len(devices), Q)])
            scan = make_data_parallel_schedule_scan(mesh, chunk)
            Mj, Tj, Kj = (split_data(mesh, x) for x in (to_torch(Mb), Tb, Kb))
            carry = (split_data(mesh, to_torch(Ab)), split_data(mesh, Cb))

            def run(c):
                return scan(Mj, c[0], c[1], Tj, Kj)
        else:
            if not on_device:
                Mj = to_torch(Mb, device)
            carry = (to_torch(Ab, device), torch.from_numpy(Cb).to(device))
            Tj = torch.from_numpy(Tb).to(device)
            Kj = torch.from_numpy(Kb).to(device)

            def run(c):
                return _schedule_scan_batch(Mj, *c, Tj, chunk, Kj)

        scheds = [[] for _ in range(Q)]
        open_q = np.ones(Q, dtype=bool)
        rounds_done = 0
        while open_q.any() and rounds_done < kmax:
            carry, (bests, bcs) = run(carry)
            b_np, c_np = bests.cpu().numpy(), bcs.cpu().numpy()
            for qi in np.nonzero(open_q)[0]:
                coord, rows = sub[qi][0], sub[qi][1][0]
                for b, c in zip(b_np[qi], c_np[qi]):
                    if b < 0 or (coord._cap_guard and int(c) <= coord._cap_bound):
                        open_q[qi] = False
                        break
                    ci, ds = rows[int(row_srcs[qi][int(b)])]
                    scheds[qi].append((ci, ds, int(c)))
                else:
                    if len(scheds[qi]) >= len(rows):
                        open_q[qi] = False
            rounds_done += chunk
        for qi, (coord, _built, _d) in enumerate(sub):
            coord.truncated = bool(coord._cap_guard)
            coord._sched = list(coord._sched) + scheds[qi] if extend else scheds[qi]


def converge_schedules_batch(coords, threshold_bp, block: int | None = None, devices=None):
    """compute_schedules_batch, then the capped reschedules of every
    truncated single-counter coordinator in batches: per iteration, one
    `counts_for_banks_batch` pass recounts all of them against what is
    left of their queries, and their schedules are extended in place, so a
    replay never restarts. At most 16 iterations; a coordinator that gains
    no round stops there and falls back to host rounds at exhaustion.
    `devices`: as compute_schedules_batch's."""
    live = [c for c in coords if c is not None]
    if block is None:
        # the block's stacked [Q, k, W] scan matrix stays ~256 MiB
        cap = _schedule_cap()
        k_est = w_est = 1
        for c in live:
            c0 = c.counters[0]
            k = int(np.count_nonzero(c0.counts))
            k_est = max(k_est, min(k, cap) if cap else k)
            w_est = max(w_est, -(-len(c0._q_mins) // 32))
        block = int(max(4, min(64, (256 << 20) // max(k_est * w_est * 4, 1))))
        block = 1 << (block.bit_length() - 1)
    compute_schedules_batch(live, threshold_bp, block, devices=devices)
    stalled: set = set()
    for _ in range(16):
        pending = [c for c in live
                   if c.truncated and len(c.counters) == 1 and id(c) not in stalled]
        if not pending:
            break
        progress = {id(c): len(c._sched) for c in pending}
        # what is left of each query after its rounds so far (a round removes
        # its winner's hashes, so the union of the winners is what went)
        alive_list = []
        for coord in pending:
            c0 = coord.counters[0]
            won = [c0.index._ds_mins[ds] for _ci, ds, _cnt in coord._sched]
            alive_list.append(np.setdiff1d(c0._q_mins, np.concatenate(won)) if won
                              else c0._q_mins)
        groups = {}
        for coord, alive in zip(pending, alive_list):
            groups.setdefault(id(coord.counters[0].index), []).append((coord, alive))
        fresh = {}
        for grp in groups.values():
            idx = grp[0][0].counters[0].index
            rows = counts_for_banks_batch(idx._banks, [a for _c, a in grp], len(idx._signatures))
            for (coord, _a), row in zip(grp, rows):
                fresh[id(coord)] = row
        for coord, alive in zip(pending, alive_list):
            c0 = coord.counters[0]
            counts = np.where(c0.counts > 0, fresh[id(coord)], 0).astype(np.int64)
            if threshold_bp:
                try:
                    _, n_th = calc_threshold_from_bp(threshold_bp, c0.scaled, max(len(alive), 1))
                except ValueError:
                    n_th = None
                if n_th is not None:
                    counts = np.where(counts >= max(n_th, 1), counts, 0)
            c0.counts = counts
            c0._groups = None
            c0._bitsets_cache = None
            coord.reschedules += 1
            coord._alive_mins = alive
            coord.truncated = False
        compute_schedules_batch(pending, threshold_bp, block, extend=True, devices=devices)
        for c in pending:
            if len(c._sched) == progress[id(c)]:
                stalled.add(id(c))


def schedule_device_gather(counters):
    """Put a group of FlatCounterGather counters (one per database, same
    query, uniform scaled) under one device-round schedule. Returns the
    coordinator, or None if the group is ineligible (mixed counter types
    or scaleds), and callers then keep the host peek/consume path.
    SOURMASH_TORCH_NO_SCHEDULE=1 forces host rounds."""
    if os.environ.get(NO_SCHEDULE_ENV):
        return None
    if not counters:
        return None
    if not all(isinstance(c, FlatCounterGather) for c in counters):
        return None
    if len({c.scaled for c in counters}) != 1:
        return None
    q0 = counters[0]._q_mins
    if not all(np.array_equal(c._q_mins, q0) for c in counters[1:]):
        return None
    coord = DeviceGatherSchedule(counters)
    for i, c in enumerate(counters):
        c._use_schedule = True
        c._coord = coord
        c._coord_idx = i
    return coord
