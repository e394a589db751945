"""compare's all-pairs joins on the CPU: the plain versions of
`pairwise_counts` and `pairwise_products` (`ops/cuda_pairwise.py`) against
`sourmash_tpu`'s `_counts_block_impl` and `_products_block_impl` over every
row of the same packs, the two routes of `pairwise_counts_bucketed` and
`pairwise_weighted_products` (the join, `block=None`, and the block
kernels) against each other and the JAX package, the wrappers' input
checks and the join's tile plan, all with no tolerance. Inputs are made
with numpy from a seed; the JAX package runs on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sourmash_tpu.ops import bucketed as jbk

from sourmash_tpu_torch.ops import bucketed as tbk
from sourmash_tpu_torch.ops import cuda_pairwise as cp

MAX_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def overlapping_rows(n, size, rng):
    "n sorted distinct u64 rows of up to `size` hashes, neighbours sharing half."
    rows = [np.unique(rng.integers(0, 2**64 // 1000, size=int(rng.integers(max(1, size // 2),
                                                                              size + 1)),
                                   dtype=np.uint64)) for _ in range(n)]
    for i in range(1, n, 2):
        rows[i] = np.unique(np.concatenate([rows[i], rows[i - 1][::2]]))
    return rows


def one_bucket(count, bucket, B):
    "`count` distinct hashes of bucket `bucket` of B."
    return (np.arange(count, dtype=np.uint64) << np.uint64(32)) * np.uint64(B) + np.uint64(bucket)


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


def spill_rows(n, size, seed):
    """overlapping_rows with 2^64-1 in rows 2 and n - 1 and 9 hashes of one
    bucket in rows 0 and 1 (past the bank's 8 slots: forced spills)."""
    rows = overlapping_rows(n, size, np.random.default_rng(seed))
    B = tbk.choose_buckets(max(len(m) for m in rows) + 9)
    for i in (2, n - 1):
        rows[i] = np.unique(np.concatenate([rows[i], [MAX_U64]]))
    for i in (0, 1):
        rows[i] = np.unique(np.concatenate([rows[i], one_bucket(9, 7, B)]))
    return rows


def weighted_rows(seed, n=10, depth=20):
    """Rows with abundances: 2^64-1 (a valid hash in the weighted planes)
    in rows 2 and 5, and `depth` hashes of one bucket of B = 128 in row 0,
    most of them in row 1 too (a bucket `depth` deep)."""
    rng = np.random.default_rng(seed)
    rows = overlapping_rows(n, 120, rng)
    rows[2] = np.unique(np.concatenate([rows[2], [MAX_U64]]))
    rows[5] = np.unique(np.concatenate([rows[5], [MAX_U64]]))
    deep = one_bucket(depth, 5, 128)
    rows[0] = np.unique(np.concatenate([rows[0], deep]))
    rows[1] = np.unique(np.concatenate([rows[1], deep[3:]]))
    abunds = [rng.integers(1, 1000, size=len(m)).astype(np.int64) for m in rows]
    return rows, abunds


@pytest.fixture(autouse=True)
def _no_launches():
    "The CPU path takes the plain versions and never counts a launch."
    cp.reset_launch_counts()
    yield
    assert not any(cp.LAUNCHES.values())


# -- the plain versions against the JAX package ---------------------------------


@pytest.mark.parametrize("n_rows,size", [(10, 200), (33, 700), (8, 5)])
def test_pairwise_counts_plain_matches_jax(n_rows, size):
    """Every row of one pack as the query block of `_counts_block_impl`
    (PAD correction included) equals the join's stored-element counts."""
    rows = spill_rows(n_rows, size, n_rows * 1000 + size)
    B = tbk.choose_buckets(max(len(m) for m in rows))
    jbank = jbk.pack_rows_bucketed(rows, B)
    assert jbank.n_spilled >= 2 + 2  # 2^64-1 twice, and row 0's and row 1's ninth hash
    want = np.asarray(jbk._counts_block_impl(jbank.hi, jbank.lo, jbank.cnt,
                                             jbank.hi, jbank.lo, jbank.cnt))
    bank = tbk.pack_rows_bucketed(rows, B, device="cpu")
    got = cp.pairwise_counts(bank.hi, bank.lo, bank.cnt)
    assert got.dtype == torch.int32 and got.shape == (bank.hi.shape[0],) * 2
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(cp.pairwise_counts_plain(bank.hi, bank.lo, bank.cnt).numpy(), want)
    # and with the spills joined on the host, the exact counts
    full = got[:n_rows, :n_rows].numpy().astype(np.int64)
    tbk._pairwise_spill_correction(full, rows, bank)
    assert np.array_equal(full, oracle_counts(rows))


@pytest.mark.parametrize("depth", [20, 8])
def test_pairwise_products_plain_matches_jax(depth):
    rows, abunds = weighted_rows(50 + depth, depth=depth)
    hi, lo, av, cnt, _B = tbk._pack_weighted(rows, abunds)
    assert hi.shape[1] >= depth
    planes = [jnp.asarray(x) for x in (hi, lo, av, cnt)]
    want = np.asarray(jbk._products_block_impl(*planes, *planes))
    t = [tbk.to_torch(x) for x in (hi, lo, av, cnt)]
    got = cp.pairwise_products(*t)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(cp.pairwise_products_plain(*t).numpy(), want)
    assert np.array_equal(got.numpy()[: len(rows), : len(rows)], oracle_products(rows, abunds))


def test_joins_of_an_overloaded_bucket_and_an_empty_sketch():
    """37 sketches (not a multiple of the row padding), one empty, the
    others sharing 8 hashes of one bucket: the kernel's global-memory case
    at a small size, in the plain versions."""
    rng = np.random.default_rng(61)
    rows = [np.unique(np.r_[rng.integers(0, 2**64 - 1, size=int(rng.integers(20, 40)),
                                         dtype=np.uint64), one_bucket(8, 3, 128)])
            for _ in range(37)]
    rows[4] = np.zeros(0, dtype=np.uint64)
    abunds = [rng.integers(1, 2**19, size=len(m)).astype(np.int64) for m in rows]
    bank = tbk.pack_rows_device(rows, 128, device="cpu")
    counts = cp.pairwise_counts(bank.hi, bank.lo, bank.cnt)[:37, :37].numpy().astype(np.int64)
    tbk._pairwise_spill_correction(counts, rows, bank)
    assert np.array_equal(counts, oracle_counts(rows))
    assert counts[4].sum() == 0
    t = [tbk.to_torch(x) for x in tbk._pack_weighted(rows, abunds)[:4]]
    assert np.array_equal(cp.pairwise_products(*t)[:37, :37].numpy(), oracle_products(rows, abunds))


# -- the two routes of the all-pairs functions -----------------------------------


@pytest.mark.parametrize("block", [16, 3])
def test_pairwise_counts_bucketed_join_equals_block_route(block):
    rows = spill_rows(20, 300, 70 + block)
    join = tbk.pairwise_counts_bucketed(rows, device="cpu")
    blocks = tbk.pairwise_counts_bucketed(rows, block=block, device="cpu")
    assert join.dtype == blocks.dtype == np.int64
    assert np.array_equal(join, blocks)
    assert np.array_equal(join, jbk.pairwise_counts_bucketed(rows))
    assert np.array_equal(join, oracle_counts(rows))


@pytest.mark.parametrize("block", [8, 5])
def test_pairwise_weighted_products_join_equals_block_route(block):
    rows, abunds = weighted_rows(80 + block, n=12)
    join = tbk.pairwise_weighted_products(rows, abunds, device="cpu")
    blocks = tbk.pairwise_weighted_products(rows, abunds, block=block, device="cpu")
    assert join.dtype == blocks.dtype == np.int64
    assert np.array_equal(join, blocks)
    assert np.array_equal(join, np.asarray(jbk.pairwise_weighted_products(rows, abunds)))
    assert np.array_equal(join, oracle_products(rows, abunds))


# -- the wrappers' input checks ------------------------------------------------------


def _planes():
    rows, abunds = weighted_rows(90, n=6, depth=9)
    return [tbk.to_torch(x) for x in tbk._pack_weighted(rows, abunds)[:4]]


BAD = {
    "lo narrower": lambda hi, lo, av, cnt: (hi, lo[:, :, :64].contiguous(), av, cnt),
    "av shallower": lambda hi, lo, av, cnt: (hi, lo, av[:, :-1].contiguous(), cnt),
    "cnt short a row": lambda hi, lo, av, cnt: (hi, lo, av, cnt[:-1]),
    "cnt as int32": lambda hi, lo, av, cnt: (hi, lo, av, cnt.to(torch.int32)),
    "hi as int64": lambda hi, lo, av, cnt: (hi.to(torch.int64), lo, av, cnt),
    "av as int64": lambda hi, lo, av, cnt: (hi, lo, av.to(torch.int64), cnt),
}


@pytest.mark.parametrize("case", list(BAD))
def test_join_wrappers_reject_bad_planes(case):
    hi, lo, av, cnt = BAD[case](*_planes())
    with pytest.raises(TypeError):
        cp.pairwise_products(hi, lo, av, cnt)
    if "av" not in case:
        with pytest.raises(TypeError):
            cp.pairwise_counts(hi, lo, cnt)


# -- the tile plan -------------------------------------------------------------------


def test_join_tiles_take_the_widest_tile_that_fits():
    entries = np.full(256, 100, dtype=np.int64)
    lg, tiles = cp.join_tiles(entries, 1600, 3000)
    assert lg == 4 and tiles.tolist() == [1600] * 16
    lg, tiles = cp.join_tiles(entries, 1000, 3000)
    assert lg == 3 and tiles.tolist() == [800] * 32
    # every bucket over the target alone: as wide as one block holds
    lg, tiles = cp.join_tiles(entries, 99, 500)
    assert lg == 2 and tiles.tolist() == [400] * 64
    lg, tiles = cp.join_tiles(entries, 99, 99)
    assert lg == 0 and len(tiles) == 256


def test_join_tiles_keep_two_tiles_at_least():
    "The kernel's empty mark is a value of a bucket outside the tile."
    assert cp.join_tiles(np.full(16, 10, dtype=np.int64), 1000, 2000)[0] == 3
    assert cp.join_tiles(np.full(2, 10, dtype=np.int64), 1000, 2000)[0] == 0
    with pytest.raises(TypeError, match="at least 2 buckets"):
        cp.join_tiles(np.full(1, 10, dtype=np.int64), 1000, 2000)


def test_join_tiles_leave_an_overloaded_bucket_out_of_the_width():
    """A bucket past shared memory does not narrow the other tiles: its own
    tile goes to global memory whatever the width."""
    entries = np.full(128, 50, dtype=np.int64)
    entries[37] = 5000
    lg, tiles = cp.join_tiles(entries, 900, 2000)
    assert lg == 4
    assert int(tiles.argmax()) == 37 >> 4 and int(tiles.max()) == 5000 + 15 * 50
    assert int(np.sort(tiles)[-2]) == 800
    # a bucket over the target but inside shared memory keeps its tile there
    entries[37] = 1500
    lg, tiles = cp.join_tiles(entries, 900, 2000)
    assert lg == 3 and int(tiles.max()) == 1500 + 7 * 50
    entries[37] = 1990
    lg, tiles = cp.join_tiles(entries, 900, 2000)
    assert lg == 0 and int(tiles.max()) == 1990
