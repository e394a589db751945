"""The multi-device layer (X8) against the JAX package, on the CPU.

`tests/conftest.py` gives JAX 8 virtual CPU devices, so its sharded
programs run as its own tests run them; the port runs the same programs on
meshes of CPU devices (a device may repeat), its kernels on their plain
PyTorch versions. The same seeded inputs go through both and the integers
are compared exactly: the shard packs byte for byte; `shard_match_plain`
against `_local_counts` and the membership builder; the counter, the
gather round, the builder, the rounds and the fused program on (1, 8),
(2, 4) and (4, 2) meshes; the sharded bitset scan and the data-parallel
scan (with shard counts that do not divide the rows or the queries, a tie
across a shard boundary, 2^64-1 and thresholds that stop early); the
sharded sketch; `DeviceGatherSchedule.compute` and
`compute_schedules_batch` on four CPU devices against the JAX package's
(sharded under the conftest) and the port's one-device schedules; and
the port's dry run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import sourmash_tpu
import sourmash_tpu_torch
from sourmash_tpu import parallel as jpar
from sourmash_tpu.index import flat as jflat
from sourmash_tpu_torch import parallel as tpar
from sourmash_tpu_torch.index import flat as tflat
from sourmash_tpu_torch.ops import cuda_gather as cg
from sourmash_tpu_torch.parallel import collectives, dryrun

MAX = np.uint64(2**64 - 1)
CPU = torch.device("cpu")
MESHES = [(1, 8), (2, 4), (4, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module: the plain versions' many small ops
    a round would otherwise spin their thread pool against the other test
    workers' threads on a busy machine (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpus(n):
    return [CPU] * n


def u32(t):
    "A port result (int32 bit patterns) as numpy uint32."
    a = t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def adversarial():
    """11 datasets (no shard count of 2, 4 or 8 divides it) of uneven
    loads: dataset 0 overloads one bucket past 8 slots and holds 2^64-1,
    dataset 7 equals dataset 1 (a tie across a shard boundary on every
    mesh); 8 queries: one on the overloaded bucket with 2^64-1, one that
    matches nothing, one where datasets 1 and 7 tie for the best."""
    rng = np.random.default_rng(0)
    sizes = [64, 64, 64, 64, 64, 64, 64, 64, 5, 200, 64]
    mins = [np.sort(rng.choice(np.arange(1, 100000, dtype=np.uint64), size=s, replace=False))
            for s in sizes]
    overload = np.arange(1, 33, dtype=np.uint64) * np.uint64(1 << 20)
    mins[0] = np.unique(np.concatenate([mins[0], overload, [MAX]]))
    mins[7] = mins[1].copy()
    queries = [np.unique(np.concatenate([mins[(b + i) % 11][:32] for i in range(3)]))
               for b in range(8)]
    queries[0] = np.unique(np.concatenate([queries[0], overload[:16], [MAX]]))
    queries[1] = np.arange(200001, 200033, dtype=np.uint64)
    queries[2] = np.unique(np.concatenate([mins[1], mins[3][:20], mins[9][:40]]))
    thresh = np.ones(8, dtype=np.int32)
    thresh[7] = 10**6  # unreachable: the round is a no-op
    thresh[5] = 30  # stops after its first rounds
    return mins, queries, thresh


@pytest.fixture(scope="module")
def world():
    mins, queries, thresh = adversarial()
    out = {}
    for n_shards in (2, 4, 8):
        out[n_shards] = jpar.pack_shard_planes(mins, n_shards)
    B = out[8][3]
    qhi, qlo, alive = jpar.pack_query_batch(queries, B)
    return dict(mins=mins, queries=queries, thresh=thresh, planes=out,
                qhi=qhi, qlo=qlo, alive=alive, B=B)


def jax_mesh(n_data, n_shards):
    return JaxMesh(np.asarray(jax.devices()[: n_data * n_shards]).reshape(n_data, n_shards),
                   ("data", "shards"))


# -- the packs ---------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,B", [(1, None), (3, None), (8, None), (4, 64)])
def test_pack_shard_planes_byte_for_byte(world, n_shards, B):
    want = jpar.pack_shard_planes(world["mins"], n_shards, B)
    got = tpar.pack_shard_planes(world["mins"], n_shards, B)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[0].shape[1] > 8  # the overloaded bucket sets the depth


def test_pack_query_batch_byte_for_byte(world):
    for qs in (world["queries"], world["queries"][1:2], []):
        want = jpar.pack_query_batch(qs, world["B"])
        got = tpar.pack_query_batch(qs, world["B"])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


# -- shard_match --------------------------------------------------------------------


def test_shard_match_plain_equals_local_counts_and_builder(world):
    Shi, Slo, Scnt, _B = world["planes"][8]
    qhi, qlo, alive = world["qhi"], world["qlo"], world["alive"]
    # holes in the alive mask
    alive = alive & (np.random.default_rng(1).random(alive.shape) < 0.8)
    want = np.stack([np.asarray(jpar._local_counts(
        jnp.asarray(Shi), jnp.asarray(Slo), jnp.asarray(Scnt), jnp.asarray(qhi[q]),
        jnp.asarray(qlo[q]), jnp.asarray(alive[q]))) for q in range(len(qhi))])
    jM, jcounts = jpar.make_sharded_membership_builder(jax_mesh(1, 1), Shi.shape[0])(
        *map(jnp.asarray, (Shi, Slo, Scnt, qhi, qlo, alive)))
    A = tpar._alive_words(torch.from_numpy(alive))
    args = (tpar._tensor(qhi), tpar._tensor(qlo), A, tpar._tensor(Shi), tpar._tensor(Slo),
            torch.from_numpy(Scnt))
    counts = cg.shard_match_plain(*args)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    counts2, M = cg.shard_match(*args, bits=True)  # the wrapper on CPU tensors
    np.testing.assert_array_equal(counts2.numpy(), want)
    np.testing.assert_array_equal(u32(M), np.asarray(jM))
    assert cg.LAUNCHES["shard_match"] == 0
    # in place, at a row offset, into buffers of more rows
    R = Shi.shape[0]
    cbuf = torch.full((len(qhi), R + 5), 7, dtype=torch.int32)
    Mbuf = torch.zeros((len(qhi), R + 5) + tuple(M.shape[2:]), dtype=torch.int32)
    cg.shard_match(*args, out=(cbuf, Mbuf), row0=3)
    np.testing.assert_array_equal(cbuf[:, 3 : 3 + R].numpy(), want)
    assert (cbuf[:, :3] == 7).all() and (cbuf[:, 3 + R :] == 7).all()
    np.testing.assert_array_equal(u32(Mbuf[:, 3 : 3 + R]), np.asarray(jM))


def test_shard_match_checks_its_inputs(world):
    Shi, Slo, Scnt, B = world["planes"][4]
    qhi, qlo = tpar._tensor(world["qhi"]), tpar._tensor(world["qlo"])
    A = tpar._alive_words(torch.from_numpy(world["alive"]))
    S = (tpar._tensor(Shi), tpar._tensor(Slo), torch.from_numpy(Scnt))
    with pytest.raises(TypeError):
        cg.shard_match(qhi.long(), qlo, A, *S)
    with pytest.raises(TypeError):
        cg.shard_match(qhi, qlo, A[:, :, :-1].contiguous(), *S)
    with pytest.raises(TypeError):
        cg.shard_match(qhi, qlo, A, S[0], S[1], S[2].to(torch.int32))
    with pytest.raises(TypeError):
        cg.shard_match(qhi[:, :, :16].contiguous(), qlo[:, :, :16].contiguous(),
                       A[:, :, :0].contiguous(), S[0][:, :, :16].contiguous(),
                       S[1][:, :, :16].contiguous(), S[2][:, :16].contiguous())
    with pytest.raises(TypeError):
        cg.shard_match(qhi, qlo, A, *S, out=(torch.zeros((qhi.shape[0], 2), dtype=torch.int32),
                                             None))


# -- shard_match's table sizes and phase 2's edge planes ------------------------------


@pytest.mark.parametrize("shape,entries,entry_bytes", [
    ((2, 199, 4096), 512, 2),  # the fused program's chunk: tables of 8 MiB
    ((1, 199, 4096), 512, 2),  # the gather round's winner
    ((4, 40, 256), 64, 2),  # phase 2's edge planes
    ((2, 300, 4096), 512, 4),  # a line past one block's staging
    ((1, 254, 32), 512, 2),
    ((1, 255, 32), 512, 4),
    ((40, 1, 64), 16, 2),
    ((65537, 1, 32), 16, 2),  # past the queries of one launch
    ((1, 8192, 128), 16384, 4),  # one range of slots at its largest
    ((1, 8193, 128), 8192, 4),  # two ranges of 4,097 slots
    ((2, 11300, 128), 16384, 4),  # a metagenome against small sketches: two ranges of 5,650
    ((1, 8, 1 << 20), 16, 2),  # a line of B/32 words past one block's staging
])
def test_shard_match_table_bytes(shape, entries, entry_bytes):
    """The tables' scratch from the shapes alone: a table of each query
    and bucket of the least power of two (>= 16) of entries above 1.5 slots
    of a range of at most SHARD_MATCH_RANGE_SLOTS, of 2 bytes an entry
    below 255 slots, else 4; no shape the parent kernel took is refused."""
    bq, dq, B = shape
    assert cg.shard_match_table_bytes(bq, dq, B) == bq * B * entries * entry_bytes
    ranges = -(-dq // cg.SHARD_MATCH_RANGE_SLOTS)
    slots = -(-dq // ranges)
    assert 2 * entries > 3 * slots and (entries == 16 or entries <= 3 * slots)
    assert entries * entry_bytes <= 65536  # one table fits a build block


@pytest.mark.parametrize("make,past", [
    ("shard_match_stage_inputs", lambda bq, dq, W, stage, rng_: dq * W > stage),
    ("shard_match_deep_inputs", lambda bq, dq, W, stage, rng_: dq > rng_),
    ("shard_match_wide_inputs", lambda bq, dq, W, stage, rng_: W > stage),
    ("shard_match_many_inputs", lambda bq, dq, W, stage, rng_: bq > 65535),
], ids=["stages of slots", "ranges of slots", "stages of words", "two launches"])
def test_shard_match_inputs_past_one_launch(make, past):
    """chip_smoke's planes past one launch's sizes (staged lines of slots
    and of words, tables in ranges of slots, queries in two launches) pass
    their limit, and the plain version's counts on them equal the alive
    query values found among each row's occupied values."""
    import chip_smoke

    device = chip_smoke.GATHER_DEVICE
    chip_smoke.GATHER_DEVICE = "cpu"
    try:
        args = getattr(chip_smoke, make)(np.random.default_rng(20261016))
    finally:
        chip_smoke.GATHER_DEVICE = device
    Qhi, Qlo, A, Shi, Slo, Scnt = args
    bq, dq, B = Qhi.shape
    assert past(bq, dq, B // 32, chip_smoke.SHARD_MATCH_STAGE_WORDS, cg.SHARD_MATCH_RANGE_SLOTS)
    qv = (u32(Qhi).astype(np.uint64) << np.uint64(32)) | u32(Qlo)
    alive = tpar.unpack_bits_u32(A).numpy()
    sv = (u32(Shi).astype(np.uint64) << np.uint64(32)) | u32(Slo)
    occupied = np.arange(sv.shape[1])[None, :, None] < Scnt.numpy()[:, None, :]
    qidx = np.nonzero(alive)[0]
    want = np.stack([np.bincount(qidx[np.isin(qv[alive], sv[r][occupied[r]])], minlength=bq)
                     for r in range(sv.shape[0])], axis=1)
    got = cg.shard_match(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.fixture(scope="module")
def edge_planes():
    """chip_smoke's phase 2 edge planes for shard_match, on the CPU."""
    import chip_smoke

    device = chip_smoke.GATHER_DEVICE
    chip_smoke.GATHER_DEVICE = "cpu"
    try:
        args = chip_smoke.shard_match_edge_inputs(np.random.default_rng(20261016))
    finally:
        chip_smoke.GATHER_DEVICE = device
    Qhi, Qlo, A, Shi, Slo, Scnt = args
    planes = dict(qhi=u32(Qhi), qlo=u32(Qlo), alive=tpar.unpack_bits_u32(A).numpy(),
                  Shi=u32(Shi), Slo=u32(Slo), Scnt=Scnt.numpy())
    jM, jcounts = jpar.make_sharded_membership_builder(jax_mesh(1, 1), Shi.shape[0])(
        *(jnp.asarray(planes[k]) for k in ("Shi", "Slo", "Scnt", "qhi", "qlo", "alive")))
    return dict(args=args, planes=planes, jM=np.asarray(jM), jcounts=np.asarray(jcounts),
                plain=cg.shard_match_plain(*args, bits=True))


def _multiplicity(p):
    "[bq, rows, dq, B]: the occupied slots of each row's bucket equal to each query slot."
    qv = (p["qhi"].astype(np.uint64) << np.uint64(32)) | p["qlo"]
    sv = (p["Shi"].astype(np.uint64) << np.uint64(32)) | p["Slo"]
    occupied = np.arange(sv.shape[1])[None, :, None] < p["Scnt"][:, None, :]
    return sum((sv[None, :, k, None, :] == qv[:, None]) & occupied[None, :, k, None, :]
               for k in range(sv.shape[1])).astype(np.int64)


def test_shard_match_edge_planes_are_the_edges(edge_planes):
    p = edge_planes["planes"]
    counts = edge_planes["plain"][0].numpy()
    dq = p["qhi"].shape[1]
    # query 0's bucket 77 sets dq, every slot alive: the table's sized capacity
    assert p["alive"][0, :, 77].sum() == dq
    assert counts[1].sum() == 0 and counts[3].sum() == 0 and not p["alive"][3].any()
    assert counts[0].sum() and counts[2].sum()
    # a value alive in queries 0 and 2 both, matched in a row
    qv = (p["qhi"].astype(np.uint64) << np.uint64(32)) | p["qlo"]
    both = np.intersect1d(qv[0][p["alive"][0]], qv[2][p["alive"][2]])
    assert len(both) and np.isin(both, p["Shi"].astype(np.uint64) << np.uint64(32)
                                 | p["Slo"]).any()
    assert (_multiplicity(p) > 1).any()  # a value repeated in a row's bucket


@pytest.mark.parametrize("q", range(4))
def test_shard_match_plain_on_edge_planes_equals_jax(edge_planes, q):
    """shard_match_plain against build_chunk (the membership builder) and
    _local_counts on each edge query. _local_counts counts a value that a
    row repeats in a bucket once a copy; the builder, the plain version
    and the kernel count each matched query slot once."""
    p = edge_planes["planes"]
    counts, M = edge_planes["plain"]
    np.testing.assert_array_equal(u32(M[q]), edge_planes["jM"][q])
    np.testing.assert_array_equal(counts[q].numpy(), edge_planes["jcounts"][q])
    local = np.asarray(jpar._local_counts(*(jnp.asarray(p[k]) for k in ("Shi", "Slo", "Scnt")),
                                          jnp.asarray(p["qhi"][q]), jnp.asarray(p["qlo"][q]),
                                          jnp.asarray(p["alive"][q])))
    mult = _multiplicity(p)[q] * p["alive"][q][None]
    np.testing.assert_array_equal(local, mult.sum(axis=(1, 2)))
    np.testing.assert_array_equal(counts[q].numpy(), (mult > 0).sum(axis=(1, 2)))


@pytest.mark.parametrize("form", ["in place", "winner", "decrement"])
def test_shard_match_edge_forms(edge_planes, form):
    """The builder's in-place form, the gather round's 1 x 1 winner and its
    decrement (alive = the winners' words), as phase 2 holds the kernel
    on the card, through the wrapper's CPU path against the whole call."""
    Qhi, Qlo, A, Shi, Slo, Scnt = edge_planes["args"]
    counts, M = edge_planes["plain"]
    rows = Shi.shape[0]
    if form == "in place":
        cbuf = torch.full((Qhi.shape[0], rows + 3), 7, dtype=torch.int32)
        Mbuf = torch.full((Qhi.shape[0], rows + 3) + tuple(M.shape[2:]), 7, dtype=torch.int32)
        for a, b in ((0, 6), (6, rows)):
            cg.shard_match(Qhi, Qlo, A, Shi[a:b], Slo[a:b], Scnt[a:b], out=(cbuf, Mbuf),
                           row0=a + 3)
        assert torch.equal(cbuf[:, 3:], counts) and torch.equal(Mbuf[:, 3:], M)
        assert (cbuf[:, :3] == 7).all() and (Mbuf[:, :3] == 7).all()
        return
    best = torch.argmax(counts, dim=1).tolist()
    if form == "winner":
        for q, r in enumerate(best):
            c1, m1 = cg.shard_match(Qhi[q : q + 1], Qlo[q : q + 1], A[q : q + 1],
                                    Shi[r : r + 1], Slo[r : r + 1], Scnt[r : r + 1], bits=True)
            assert torch.equal(c1, counts[q : q + 1, r : r + 1])
            assert torch.equal(m1, M[q : q + 1, r : r + 1])
        return
    removed = torch.stack([M[q, r] for q, r in enumerate(best)])
    dec = cg.shard_match(Qhi, Qlo, removed, Shi, Slo, Scnt)
    # each query's winner loses all its matches; the decrement is the overlap
    assert [int(dec[q, r]) for q, r in enumerate(best)] == [int(counts[q, r])
                                                           for q, r in enumerate(best)]
    bits = tpar.unpack_bits_u32(M) & tpar.unpack_bits_u32(removed)[:, None]
    assert torch.equal(dec, bits.sum(dim=(2, 3), dtype=torch.int32))


# -- the sharded gather program ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_programs(world):
    "Each mesh's JAX counter, round, builder and rounds, run once on the world's inputs."
    n = len(world["mins"])
    out = {}
    for nd, ns in MESHES:
        mesh = jax_mesh(nd, ns)
        Shi, Slo, Scnt, _B = world["planes"][ns]
        planes = tuple(map(jnp.asarray, (Shi, Slo, Scnt)))
        q = tuple(map(jnp.asarray, (world["qhi"], world["qlo"], world["alive"])))
        counts = jpar.make_sharded_counter(mesh, n)(*planes, *q)
        rnd = jpar.make_sharded_gather_round(mesh, n)(*planes, *q, counts,
                                                      jnp.asarray(world["thresh"]))
        M, c2 = jpar.make_sharded_membership_builder(mesh, n)(*planes, *q)
        rounds = jpar.make_sharded_gather_rounds(mesh, n, 5)(M, q[2], c2,
                                                             jnp.asarray(world["thresh"]))
        out[(nd, ns)] = dict(counts=np.asarray(counts), round=[np.asarray(x) for x in rnd],
                             M=np.asarray(M), counts2=np.asarray(c2),
                             rounds=[np.asarray(x) for x in rounds])
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_counter_round_builder_and_rounds_equal_jax(world, jax_programs, shape):
    nd, ns = shape
    want = jax_programs[shape]
    mesh = tpar.get_mesh(nd, ns, devices=cpus(nd * ns))
    assert mesh.shape == {"data": nd, "shards": ns}
    n = len(world["mins"])
    Shi, Slo, Scnt, _B = world["planes"][ns]
    q = (world["qhi"], world["qlo"], world["alive"])

    counts = tpar.make_sharded_counter(mesh, n)(Shi, Slo, Scnt, *q)
    np.testing.assert_array_equal(counts.numpy(), want["counts"])
    for b, qq in enumerate(world["queries"]):
        for d, m in enumerate(world["mins"]):
            assert counts[b, d] == len(np.intersect1d(qq, m))

    best, bc, new_counts, new_alive = tpar.make_sharded_gather_round(mesh, n)(
        Shi, Slo, Scnt, *q, counts, world["thresh"])
    for got, w in zip((best, bc, new_counts, new_alive), want["round"]):
        np.testing.assert_array_equal(got.numpy(), w)
    assert best[2] == 1 and best[7] == -1 and best[1] == -1  # the tie: the lowest id

    M, counts2 = tpar.make_sharded_membership_builder(mesh, n)(Shi, Slo, Scnt, *q)
    assert len(M.grid) == nd and all(len(row) == ns for row in M.grid)
    np.testing.assert_array_equal(u32(M.full()), want["M"])
    np.testing.assert_array_equal(counts2.numpy(), want["counts2"])

    thresh = world["thresh"]
    rounds = tpar.make_sharded_gather_rounds(mesh, n, 5)
    for got, w in zip(rounds(M, q[2], counts2, thresh), want["rounds"]):
        np.testing.assert_array_equal(got.numpy(), w)
    # the full matrix, split here, and the fused program give the same
    for got, w in zip(rounds(torch.from_numpy(want["M"].view(np.int32).copy()), q[2], counts2, thresh),
                      want["rounds"]):
        np.testing.assert_array_equal(got.numpy(), w)
    prog = tpar.make_sharded_gather_program(mesh, n, 5)
    for got, w in zip(prog(Shi, Slo, Scnt, *q, thresh), want["rounds"]):
        np.testing.assert_array_equal(got.numpy(), w)


def test_data_blocks_need_not_divide_the_queries(world, jax_programs):
    "Three data blocks over 8 queries: the same counts and rounds as JAX's (1, 8) mesh."
    n = len(world["mins"])
    Shi, Slo, Scnt, _B = world["planes"][2]
    q = (world["qhi"], world["qlo"], world["alive"])
    mesh = tpar.get_mesh(3, 2, devices=cpus(6))
    want = jax_programs[(4, 2)]
    np.testing.assert_array_equal(
        tpar.make_sharded_counter(mesh, n)(Shi, Slo, Scnt, *q).numpy(), want["counts"])
    got = tpar.make_sharded_gather_program(mesh, n, 5)(Shi, Slo, Scnt, *q, world["thresh"])
    for g, w in zip(got, want["rounds"]):
        np.testing.assert_array_equal(g.numpy(), w)


# -- the product scans -------------------------------------------------------------------


def bitset_case(k, W=6, seed=5):
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 2**32, size=(k, W), dtype=np.uint64).astype(np.uint32)
    M[3] = M[k - 2]  # an exact tie across shards
    counts = np.unpackbits(M.view(np.uint8), axis=1).sum(1).astype(np.int32)
    return M, np.full(W, 0xFFFFFFFF, dtype=np.uint32), counts


@pytest.mark.parametrize("k,n_shards,thresh,length", [
    (24, 8, 3, 30), (27, 4, 3, 30), (27, 8, 40, 30), (13, 2, 1, 5)])
def test_sharded_bitset_scan_equals_jax(k, n_shards, thresh, length):
    M, alive, counts = bitset_case(k)
    k_pad = -(-k // n_shards) * n_shards
    Mp = np.concatenate([M, np.zeros((k_pad - k, M.shape[1]), np.uint32)])
    cp = np.concatenate([counts, np.zeros(k_pad - k, np.int32)])
    (ja, jc), (jb, jbc) = jpar.make_sharded_bitset_scan(
        JaxMesh(np.asarray(jax.devices()[:n_shards]), ("shards",)), length)(
        jnp.asarray(Mp), jnp.asarray(alive), jnp.asarray(cp), jnp.int32(thresh))
    _c1, (b1, c1) = jflat._schedule_scan(jnp.asarray(M), (jnp.asarray(alive), jnp.asarray(counts)),
                                         np.int32(thresh), length)
    np.testing.assert_array_equal(np.asarray(jb), np.asarray(b1))

    mesh = tpar.get_mesh(1, n_shards, devices=cpus(n_shards))
    scan = tpar.make_sharded_bitset_scan(mesh, length)
    (als, cns), (b, bc) = scan(Mp, alive, cp, thresh)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jbc))
    np.testing.assert_array_equal(u32(als[0]), np.asarray(ja))
    np.testing.assert_array_equal(torch.cat(cns).numpy(), np.asarray(jc))
    if thresh > 30:
        assert (b.numpy() == -1).any()  # the threshold stopped the scan
    # chunk-driven: the carry of a first chunk drives the second
    half = tpar.make_sharded_bitset_scan(mesh, length // 2)
    Ms = tpar.shard_rows(mesh, Mp)
    carry, (b_a, _c) = half(Ms, alive, tpar.shard_rows(mesh, cp), thresh)
    carry, (b_b, _c) = half(Ms, *carry, thresh)
    np.testing.assert_array_equal(torch.cat([b_a, b_b]).numpy(),
                                  np.asarray(jb)[: 2 * (length // 2)])


@pytest.mark.parametrize("n_data", [1, 3, 8])
def test_data_parallel_scan_equals_jax(n_data):
    rng = np.random.default_rng(7)
    Q, k, W, length = 8, 20, 4, 12
    M = rng.integers(0, 2**32, size=(Q, k, W), dtype=np.uint64).astype(np.uint32)
    M[:, 5] = M[:, 17]
    alive = np.full((Q, W), 0xFFFFFFFF, dtype=np.uint32)
    counts = np.unpackbits(M.view(np.uint8), axis=2).sum(2).astype(np.int32)
    thresh = rng.integers(1, 40, size=Q).astype(np.int32)
    (ja, jc), (jb, jbc) = jpar.make_data_parallel_schedule_scan(
        JaxMesh(np.asarray(jax.devices()[:8]), ("data",)), length)(
        *map(jnp.asarray, (M, alive, counts, thresh)))
    mesh = tpar.get_mesh(n_data, 1, devices=cpus(n_data))
    (als, cns), (b, bc) = tpar.make_data_parallel_schedule_scan(mesh, length)(
        M, alive, counts, thresh)
    assert len(als) == n_data
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jbc))
    np.testing.assert_array_equal(u32(torch.cat(als)), np.asarray(ja))
    np.testing.assert_array_equal(torch.cat(cns).numpy(), np.asarray(jc))


def test_sharded_sketch_equals_jax():
    rng = np.random.default_rng(11)
    ksize, B, S = 21, 6, 300 + 21 - 1
    seqs = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=(B, S),
                      p=[0.24, 0.24, 0.24, 0.24, 0.04])
    max_hash = np.uint64((1 << 64) // 10)
    jout, jn = jpar.make_sharded_sketch(jax_mesh(2, 1), ksize, cap=64)(
        jnp.asarray(seqs), jnp.asarray(max_hash))
    for nd in (2, 4):
        out, n = tpar.make_sharded_sketch(tpar.get_mesh(nd, 1, devices=cpus(nd)), ksize, 64)(
            seqs, max_hash)
        assert out.dtype == torch.int64 and n.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy().view(np.uint64), np.asarray(jout))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert (np.asarray(jout) == MAX).any()  # padded rows


# -- the flat index's multi-device branches ------------------------------------------------


def schedule_world(seed=21, n=40):
    """n sketches in clades (near relatives, so rounds choose between them)
    and three queries built from parts of them."""
    rng = np.random.default_rng(seed)
    space = 1 << 40
    mins = []
    while len(mins) < n:
        core = np.unique(rng.integers(0, space, size=300, dtype=np.uint64))
        for _ in range(int(rng.integers(1, 6))):
            keep = core[rng.random(len(core)) < rng.uniform(0.5, 0.95)]
            mins.append(np.unique(np.concatenate(
                [keep, rng.integers(0, space, size=int(rng.integers(10, 80)), dtype=np.uint64)])))
    mins = mins[:n]
    mins[n - 3] = mins[4].copy()  # a tie
    queries = []
    for _ in range(3):
        parts = [m[rng.random(len(m)) < rng.uniform(0.4, 1.0)]
                 for m in (mins[i] for i in rng.choice(n, size=8, replace=False))]
        queries.append(np.unique(np.concatenate(
            parts + [mins[4], rng.integers(0, space, size=100, dtype=np.uint64)])))
    return mins, queries


def sig(pkg, m, name):
    mh = pkg.MinHash(0, 31, scaled=1)
    mh.add_many(m)
    return pkg.SourmashSignature(mh, name=name)


@pytest.fixture(scope="module")
def sched_world():
    mins, queries = schedule_world()
    return dict(
        mins=mins, queries=queries,
        t=([sig(sourmash_tpu_torch, m, f"g{i}") for i, m in enumerate(mins)],
           [sig(sourmash_tpu_torch, q, f"q{i}") for i, q in enumerate(queries)]),
        j=([sig(sourmash_tpu, m, f"g{i}") for i, m in enumerate(mins)],
           [sig(sourmash_tpu, q, f"q{i}") for i, q in enumerate(queries)]))


def coordinator(pkg_flat, sigs, query, split=None, device=None):
    kw = {} if device is None else dict(device=device)
    parts = [sigs] if split is None else [sigs[:split], sigs[split:]]
    counters = [pkg_flat.FlatIndex(p, "db", **kw).counter_gather(query, 0) for p in parts]
    return pkg_flat.schedule_device_gather(counters)


@pytest.mark.parametrize("split", [None, 17])
def test_device_gather_schedule_sharded_equals_one_device_and_jax(sched_world, split):
    tsigs, tqs = sched_world["t"]
    jsigs, jqs = sched_world["j"]
    for qi in range(len(tqs)):
        jc = coordinator(jflat, jsigs, jqs[qi], split)
        jc.compute(0)
        assert len(jax.devices()) > 1  # JAX took its sharded scan
        one = coordinator(tflat, tsigs, tqs[qi], split, CPU)
        one.compute(0)
        assert one.route != "sharded host membership"
        for n in (4, 3):
            sh = coordinator(tflat, tsigs, tqs[qi], split, CPU)
            sh.compute(0, devices=cpus(n))
            assert sh.route == "sharded host membership"
            assert sh._sched == one._sched == jc._sched
            assert len(sh._sched) > 3
        if split is not None:  # rounds drawn from both databases
            assert {ci for ci, _ds, _c in one._sched} == {0, 1}


def test_compute_schedules_batch_data_parallel_equals_one_device_and_jax(sched_world):
    tsigs, tqs = sched_world["t"]
    jsigs, jqs = sched_world["j"]
    jindex, tindex = jflat.FlatIndex(jsigs, "db"), tflat.FlatIndex(tsigs, "db", device=CPU)
    queries = [0, 1, 2, 1, 0]  # 5 queries: no device count below divides them

    def coords(flat, index, qs):
        return [flat.schedule_device_gather([index.counter_gather(qs[i], 0)]) for i in queries]

    jb = coords(jflat, jindex, jqs)
    jflat.compute_schedules_batch(jb, 0, block=4)
    one = coords(tflat, tindex, tqs)
    tflat.compute_schedules_batch(one, 0, block=4)
    for n in (4, 3):
        dp = coords(tflat, tindex, tqs)
        tflat.compute_schedules_batch(dp, 0, block=4, devices=cpus(n))
        for a, b, c in zip(dp, one, jb):
            assert a.route == "data-parallel host membership"
            assert a._sched == b._sched == c._sched
    assert sum(len(c._sched) for c in one) > 10
    # converge passes the devices through
    conv = coords(tflat, tindex, tqs)
    tflat.converge_schedules_batch(conv, 0, devices=cpus(2))
    assert [c._sched for c in conv] == [c._sched for c in one]


def test_one_device_list_keeps_the_one_device_path(sched_world, monkeypatch):
    tsigs, tqs = sched_world["t"]
    c = coordinator(tflat, tsigs, tqs[0], None, CPU)
    c.compute(0, devices=[CPU])
    assert c.route in ("host membership", "device membership")
    # no list, or a list of one: the one-device path, however many cards are visible
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tflat._mesh_devices() is None and tflat._mesh_devices([CPU]) is None
    c = coordinator(tflat, tsigs, tqs[0], None, CPU)
    c.compute(0)
    assert c.route in ("host membership", "device membership")
    assert tflat._mesh_devices(cpus(2)) == cpus(2)


# -- meshes, collectives, the dry run ---------------------------------------------------


def test_get_mesh_rules(monkeypatch):
    mesh = tpar.get_mesh(2, devices=cpus(8))
    assert mesh.shape == {"data": 2, "shards": 4} and mesh.first == CPU
    with pytest.raises(ValueError):
        tpar.get_mesh(3, 2, devices=cpus(4))
    with pytest.raises(ValueError):
        tpar.get_mesh(1, devices=["meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.get_mesh()


def test_collectives():
    parts = [torch.tensor([[1, 2], [3, 4]]), torch.tensor([[5, 6], [7, 8]])]
    full = collectives.psum_placed(parts)
    assert len(full) == 2 and full[0].tolist() == [[1, 2, 5, 6], [3, 4, 7, 8]]
    assert collectives.pmax([torch.tensor([3, 9]), torch.tensor([5, 1])])[1].tolist() == [5, 9]
    assert collectives.por([torch.tensor([1, 4], dtype=torch.int32),
                            torch.tensor([2, -2**31], dtype=torch.int32)])[0].tolist() == \
        [3, 4 - 2**31]


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun(n):
    facts = dryrun.dryrun_multichip(n, devices=cpus(n))
    assert facts["mesh"] == ((2, n // 2))
    assert facts["rounds"] > 0 and facts["batch_rounds"] > 0
