"""A dry run of the multi-device layer on an n-device (data x shards) mesh.

The counterpart of `__graft_entry__.dryrun_multichip`: on tiny,
deliberately adversarial inputs it runs the sharded sketch, the shard
packs, the sharded counter, one gather round and the fused gather
program, then `sourmash gather`'s sharded schedule over two databases and
multigather's data-parallel schedules, and raises AssertionError on any
difference from a host reference or from the one-device schedule.

    python -m sourmash_tpu_torch.parallel.dryrun [N]

runs it on N devices (default 8): every visible CUDA device, repeated as
often as N needs (a mesh may name a device more than once).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import (
    get_mesh,
    make_sharded_counter,
    make_sharded_gather_program,
    make_sharded_gather_round,
    make_sharded_sketch,
    pack_query_batch,
    pack_shard_planes,
)

_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _check(ok, *what):
    if not ok:
        raise AssertionError(what)


def _devices(n_devices: int, devices):
    if devices is not None:
        return [torch.device(d) for d in devices][:n_devices]
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: torch sees no CUDA device; pass devices=")
    visible = torch.cuda.device_count()
    return [torch.device("cuda", i % visible) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Build an n_devices mesh (2 x n/2 when n is even, else 1 x n) and run
    one full sharded gather step on it, checked; returns what it ran."""
    from ..minhash import MinHash
    from ..ops.encodings import dna_hashes
    from ..signature import SourmashSignature

    devices = _devices(n_devices, devices)
    _check(len(devices) == n_devices, "devices", len(devices), n_devices)
    n_data = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_shards = n_devices // n_data
    mesh = get_mesh(n_data, n_shards, devices=devices)
    first = mesh.first

    # 11 datasets (not divisible by the shard count: padded rows and an
    # uneven last shard) of uneven sizes; dataset 0 overloads one bucket
    # far past 8 slots and carries 2**64-1
    rng = np.random.default_rng(0)
    n_datasets = 11
    sizes = [64, 64, 64, 64, 64, 64, 64, 64, 5, 200, 64]
    mins_list = [np.sort(rng.choice(np.arange(1, 100000, dtype=np.uint64), size=sz,
                                    replace=False)) for sz in sizes]
    overload = np.arange(1, 33, dtype=np.uint64) * np.uint64(1 << 20)
    mins_list[0] = np.unique(np.concatenate([mins_list[0], overload, [_MAX]]))
    Shi, Slo, Scnt, n_buckets = pack_shard_planes(mins_list, n_shards)

    # a query row per data block and one more; query 0 shares the
    # overloaded bucket and 2**64-1, query 1 matches nothing
    bq = n_data * 2
    queries = [np.unique(np.concatenate([mins_list[(b + i) % n_datasets][:32] for i in range(3)]))
               for b in range(bq)]
    queries[0] = np.unique(np.concatenate([queries[0], overload[:16], [_MAX]]))
    queries[1] = np.arange(200001, 200033, dtype=np.uint64)
    q_len = np.array([len(q) for q in queries], dtype=np.int64)
    qhi, qlo, alive = pack_query_batch(queries, n_buckets)

    # the data-parallel sketch against the host hashes
    ksize = 21
    seqs = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(bq, 512 + ksize - 1))
    max_hash = (1 << 64) // 10
    out, n_valid = make_sharded_sketch(mesh, ksize, cap=256)(seqs, max_hash)
    out, n_valid = out.cpu().numpy().view(np.uint64), n_valid.cpu().numpy()
    for b in range(bq):
        hh, vv = dna_hashes(seqs[b], ksize, 42)
        expect = hh[vv & (hh <= np.uint64(max_hash))]
        _check(n_valid[b] == len(expect), "sketch count", b, n_valid[b], len(expect))
        _check(np.array_equal(out[b, : len(expect)], expect), "sketch hashes", b)

    counts = make_sharded_counter(mesh, n_datasets)(Shi, Slo, Scnt, qhi, qlo, alive)
    counts_np = counts.cpu().numpy()
    for b in range(bq):
        for d in range(n_datasets):
            want = len(np.intersect1d(queries[b], mins_list[d]))
            _check(counts_np[b, d] == want, "counts", b, d, counts_np[b, d], want)

    # one gather round; the last query's threshold is unreachable, a no-op
    thresh = np.ones(bq, dtype=np.int32)
    thresh[bq - 1] = 10**6
    round_fn = make_sharded_gather_round(mesh, n_datasets)
    best, _bc, new_counts, new_alive = round_fn(Shi, Slo, Scnt, qhi, qlo, alive, counts, thresh)
    best_np, new_counts_np = best.cpu().numpy(), new_counts.cpu().numpy()
    new_alive_np = new_alive.cpu().numpy()
    for b in range(bq):
        d = int(best_np[b])
        if counts_np[b].max() < thresh[b]:
            _check(d == -1, "inactive round picked", b, d)
            _check(np.array_equal(new_counts_np[b], counts_np[b]), "inactive counts", b)
            _check(int(new_alive_np[b].sum()) == q_len[b], "inactive alive", b)
            continue
        _check(d == int(np.argmax(counts_np[b])), "best", b, d)
        _check(new_counts_np[b, d] == 0, "winner not consumed", b)
        _check(int(new_alive_np[b].sum()) == q_len[b] - counts_np[b, d], "alive", b)

    # the fused program against the single round iterated
    max_rounds = 3
    p_best, _p_bc = make_sharded_gather_program(mesh, n_datasets, max_rounds)(
        Shi, Slo, Scnt, qhi, qlo, alive, thresh)
    p_best = p_best.cpu().numpy()
    al, cnt = alive, counts
    for r in range(max_rounds):
        b_r, _c, cnt, al = round_fn(Shi, Slo, Scnt, qhi, qlo, al, cnt, thresh)
        _check(np.array_equal(b_r.cpu().numpy(), p_best[:, r]), "fused round", r, p_best)

    rounds, batch_rounds = _schedules(mins_list, queries, devices, n_devices, MinHash,
                                      SourmashSignature)
    return dict(mesh=(n_data, n_shards), devices=[str(d) for d in devices], buckets=n_buckets,
                depth=Shi.shape[1], rounds=rounds, batch_rounds=batch_rounds,
                result_device=str(first))


def _schedules(mins_list, queries, devices, n_devices, MinHash, SourmashSignature):
    """`sourmash gather`'s schedule over two databases on the mesh's devices
    against the host rounds and the one-device schedule, and multigather's
    data-parallel schedules against each query's one-device compute()."""
    from ..index.flat import FlatIndex, compute_schedules_batch, schedule_device_gather
    from ..search import GatherDatabases

    def sig(m, name):
        mh = MinHash(0, 31, scaled=1)
        mh.add_many(m)
        return SourmashSignature(mh, name=name)

    sigs = [sig(m, f"g{i}") for i, m in enumerate(mins_list)]
    query = sig(queries[0], "meta")
    dev = devices[0]

    def run(mode):
        counters = [FlatIndex(sigs[:6], device=dev).counter_gather(query, threshold_bp=0),
                    FlatIndex(sigs[6:], device=dev).counter_gather(query, threshold_bp=0)]
        if mode != "host":
            coord = schedule_device_gather(counters)
            _check(coord is not None, "no schedule")
            coord.compute(0, devices=devices if mode == "sharded" else [dev])
            _check((coord.route == "sharded host membership") == (mode == "sharded"), coord.route)
        rows = [(r.match.name, r.intersect_bp)
                for r in GatherDatabases(query, counters, threshold_bp=0)]
        return rows, None if mode == "host" else list(coord._sched)

    sharded, sched = run("sharded")
    one, one_sched = run("one")
    host, _ = run("host")
    _check(sharded == host == one and sched == one_sched, "gather", sharded, host, one)
    _check(bool(sharded), "gather found nothing")

    index = FlatIndex(sigs, device=dev)
    multi = [sig(queries[b % len(queries)], f"s{b}") for b in range(max(3, n_devices + 1))]

    def coords():
        return [schedule_device_gather([index.counter_gather(q, threshold_bp=0)]) for q in multi]

    individual = []
    for coord in coords():
        coord.compute(0, devices=[dev])
        individual.append(list(coord._sched))
    batch = coords()
    compute_schedules_batch(batch, 0, block=4, devices=devices)
    for got, want in zip(batch, individual):
        _check(got._sched == want, "batch", got._sched, want)
        _check(not want or got.route == "data-parallel host membership", "batch", got.route)
    n_batch = sum(len(c._sched) for c in batch)
    _check(n_batch > 0, "no batch rounds")
    return len(sharded), n_batch


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    facts = dryrun_multichip(n)
    print(f"dryrun_multichip OK: {facts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
