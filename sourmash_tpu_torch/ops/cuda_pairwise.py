"""compare's all-pairs kernels: CUDA wrappers, launch counters and plain
PyTorch versions (see `csrc/pairwise.cu` for the design).

- `pairwise_counts` (X3b at compare's shape: `sourmash_tpu/ops/bucketed.py:
  _counts_block_impl` with every row of a bank as the query block):
  `[rows, rows]` int32, the number of values that the valid slots of each
  pair of rows share, from the bank planes `hi/lo [rows, d, B]` (PAD past
  each occupancy) and their occupancy `cnt [rows, B]` uint8.
- `pairwise_products` (X6: `_products_block_impl` over all rows):
  `[rows, rows]` int64, the sum of `av_i * av_j` over the values each pair
  of rows shares, on `_pack_weighted`'s planes `hi/lo/av [rows, d, B]`
  (zeros past each occupancy, any depth, 2^64-1 a valid hash).

Slot k of bucket b of row r is valid iff k < min(cnt[r, b], d), whatever
it holds. Preconditions of both, as `pack_rows_device`,
`pack_rows_bucketed` and `_pack_weighted` give them: the valid slots of a
row hold distinct values, and a value sits in bucket value & (B - 1). One
kernel launch computes a whole matrix: each tile of adjacent buckets is a
hash join of its valid slots (`join_plan` sizes the tiles from the
occupancy), the launch fills the upper triangle and the wrapper mirrors
it.

Limbs are int32 bit patterns of u32 values. Each wrapper checks its
inputs (a wrong dtype, shape or device raises TypeError), allocates its
output and scratch, launches on the current CUDA stream and counts the
launch in `LAUNCHES`. A CPU tensor goes to the plain version beside the
wrapper; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_gather import _check

# kernel launches since the last reset_launch_counts(); only `launch_join`
# adds to them, the plain versions never do
LAUNCHES = {"pairwise_counts": 0, "pairwise_products": 0}
_MAX_TILE_LOG2 = 4  # at most 16 adjacent buckets a tile: a 64-byte run of each slot plane


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_join(hi, lo, av, cnt):
    dev = hi.device if torch.is_tensor(hi) else None
    _check("hi", hi, torch.int32, 3)
    _check("lo", lo, torch.int32, 3, dev)
    if av is not None:
        _check("av", av, torch.int32, 3, dev)
    _check("cnt", cnt, torch.uint8, 2, dev)
    if lo.shape != hi.shape or (av is not None and av.shape != hi.shape):
        raise TypeError(f"planes {tuple(hi.shape)}, {tuple(lo.shape)} do not match")
    if tuple(cnt.shape) != (hi.shape[0], hi.shape[2]):
        raise TypeError(f"cnt is {tuple(cnt.shape)}, not [rows, B] of {tuple(hi.shape)}")


def _mirror(upper: torch.Tensor) -> torch.Tensor:
    "The symmetric matrix of an upper triangle (diagonal included): U + U^T - diag."
    full = upper + upper.T
    full.diagonal().copy_(upper.diagonal())
    return full


# -- the tile plan --------------------------------------------------------------


def join_tiles(entries: np.ndarray, target: int, cap: int) -> tuple:
    """(tile_log2, per-tile entries) for per-bucket entry counts `entries`
    [B]: the widest tile of at most 2^_MAX_TILE_LOG2 adjacent buckets (and
    at most half of B) in which every tile holds `target` entries or
    fewer, except a tile with a bucket over `target` (no width brings it
    under), which may hold up to `cap` (what one block holds in shared
    memory), and a tile with one bucket over `cap`, which goes to global
    memory at any width (two such buckets make two tiles: each is one
    block's table in global memory)."""
    over_target = entries > target
    over_cap = entries > cap
    any_hot = bool(over_target.any())
    for lg in range(_MAX_TILE_LOG2, -1, -1):
        width = 1 << lg
        if len(entries) % width or 2 * width > len(entries):
            continue
        tiles = entries.reshape(-1, width).sum(axis=1)
        if lg == 0 or int(tiles.max()) <= target:
            return lg, tiles
        if not any_hot:  # no bucket over the target: no tile is excepted
            continue
        hot = over_target.reshape(-1, width).any(axis=1)
        lost = over_cap.reshape(-1, width).sum(axis=1) == 1
        if bool(((tiles <= target) | (hot & (tiles <= cap)) | lost).all()):
            return lg, tiles
    raise TypeError(f"the join takes a power of two of at least 2 buckets, not {len(entries)}")


def table_slots(n):
    "Hash-table slots for a tile of n entries (a load of at most 2/3), as the kernel sizes them."
    return n + n // 2 + 1


class JoinPlan:
    """One launch's tiles: 2^tile_log2 buckets a tile; for the all-pairs
    joins the occupancy transposed, `cnt_t` [B, rows] (a tile's
    occupancies in one run of bytes), else None;
    `meta` [tiles, 3] int64 on the device (a tile's entries, its entry
    offset in the global scratch or -1 for shared memory, its table
    offset); `cap` the entries a block holds in shared memory; the global
    scratch (table values and heads, entry links, rows and abundances) of
    the `global_tiles` tiles past that."""

    __slots__ = ("cnt_t", "tile_log2", "meta", "cap", "scratch", "global_tiles")

    def __init__(self, cnt_t, tile_log2, meta, cap, scratch, global_tiles):
        self.cnt_t = cnt_t
        self.tile_log2 = tile_log2
        self.meta = meta
        self.cap = cap
        self.scratch = scratch
        self.global_tiles = global_tiles


_capacity_cache: dict = {}


def library_capacity(lib: str, fn: str, device, *args) -> int:
    """The tile capacity that entry `fn(*args, int* cap)` of kernel library
    `lib` reports for `device`, asked once and cached."""
    from . import _build

    key = (lib, fn, torch.device(device).index, *args)
    if key not in _capacity_cache:
        cap = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = getattr(_build.load(lib), fn)(*args, ctypes.addressof(cap))
        if rc != 0:
            raise RuntimeError(f"{fn} failed: CUDA error {rc}")
        _capacity_cache[key] = cap.value
    return _capacity_cache[key]


def join_capacity(weighted: bool, device, blocks: int = 1) -> int:
    """The entries of one tile that shared memory holds when `blocks`
    blocks of the join share an SM of `device` (1: one block alone)."""
    return library_capacity("pairwise", "pw_join_capacity", device, int(weighted), blocks)


def tile_plan(entries: np.ndarray, weighted: bool, device, cap: int, target: int,
              cnt_t=None) -> JoinPlan:
    """The tiles of one join launch on `device` from the per-bucket
    entries [B] of the side its tables hold (host integers): the tile
    width from `join_tiles` at `target` entries a tile, `cap` the most one
    block holds in shared memory; a tile past that works in a global
    scratch allocated here. `cnt_t` is kept for the all-pairs joins, which
    read the occupancy transposed."""
    lg, tiles = join_tiles(np.asarray(entries, dtype=np.int64), min(target, cap), cap)
    in_global = tiles > cap
    if int(tiles.max(initial=0)) >= 2**31 // 2:
        raise TypeError(f"a tile of {int(tiles.max())} entries is out of the kernel's range")
    sizes = np.where(in_global, tiles, 0)
    slots = np.where(in_global, table_slots(tiles), 0)
    meta = np.stack([tiles, np.where(in_global, np.cumsum(sizes) - sizes, -1),
                     np.cumsum(slots) - slots], axis=1).astype(np.int64)
    dev = torch.device(device)
    n_entries, n_slots = int(sizes.sum()), int(slots.sum())
    scratch = (torch.empty(n_slots, dtype=torch.int64, device=dev),
               torch.empty(n_slots, dtype=torch.int32, device=dev),
               *(torch.empty(n_entries, dtype=torch.int32, device=dev) for _ in range(2)),
               torch.empty(n_entries if weighted else 0, dtype=torch.int32, device=dev))
    return JoinPlan(cnt_t, lg, torch.from_numpy(meta).to(dev),
                    int(tiles[~in_global].max(initial=0)), scratch, int(in_global.sum()))


def join_plan(cnt, d: int, weighted: bool, target=None) -> JoinPlan:
    """The tiles of one all-pairs join launch over occupancy `cnt [rows, B]`
    at depth d: each bucket's entries (its valid slots over all rows, read
    back from cnt) through `tile_plan`, at `target` entries a tile
    (default: what each of two blocks on an SM holds)."""
    cap = join_capacity(weighted, cnt.device)
    if target is None:
        target = join_capacity(weighted, cnt.device, blocks=2)
    cnt_t = cnt.T.contiguous()
    entries = cnt_t.clamp(max=min(d, 255)).sum(dim=1, dtype=torch.int64).cpu().numpy()
    return tile_plan(entries, weighted, cnt.device, cap, target, cnt_t)


def plan_args(plan: JoinPlan) -> tuple:
    """The kernels' tile arguments of `plan`: tile_log2, meta, the global
    scratch (an empty array as a null pointer) and cap."""
    return (plan.tile_log2, plan.meta.data_ptr(),
            *(t.data_ptr() if t.numel() else None for t in plan.scratch), plan.cap)


def launch_join(plan: JoinPlan, hi, lo, av, out) -> None:
    """Launch the join kernel once on `plan`'s tiles (and occupancy): out
    [rows, rows] (int32; int64 with abundances av) += each pair's
    upper-triangle cell."""
    from . import _build

    rows, d, B = hi.shape
    weighted = av is not None
    _build.launch(
        "pairwise", "pw_join", hi.device, hi.data_ptr(), lo.data_ptr(),
        av.data_ptr() if weighted else None, plan.cnt_t.data_ptr(), rows, d, B,
        *plan_args(plan), out.data_ptr(),
    )
    LAUNCHES["pairwise_products" if weighted else "pairwise_counts"] += 1


# -- the wrappers -----------------------------------------------------------------


def pairwise_counts(hi, lo, cnt):
    """[rows, rows] int32: for every pair of rows, how many values their
    valid slots (k < cnt) share; the diagonal is each row's valid slots.

    Preconditions: a row's valid slots hold distinct values, and a value
    sits in bucket value & (B - 1) (the kernel's hash tables take a value
    of another bucket as their empty mark)."""
    _check_join(hi, lo, None, cnt)
    if hi.device.type == "cpu":
        return pairwise_counts_plain(hi, lo, cnt)
    rows = hi.shape[0]
    out = torch.zeros((rows, rows), dtype=torch.int32, device=hi.device)
    launch_join(join_plan(cnt, hi.shape[1], False), hi, lo, None, out)
    return _mirror(out)


def pairwise_products(hi, lo, av, cnt):
    """[rows, rows] int64: for every pair of rows, the sum of av_i * av_j
    over the values their valid slots (k < cnt) share.

    Preconditions: those of `pairwise_counts`."""
    _check_join(hi, lo, av, cnt)
    if hi.device.type == "cpu":
        return pairwise_products_plain(hi, lo, av, cnt)
    rows = hi.shape[0]
    out = torch.zeros((rows, rows), dtype=torch.int64, device=hi.device)
    launch_join(join_plan(cnt, hi.shape[1], True), hi, lo, av, out)
    return _mirror(out)


# -- the plain versions -------------------------------------------------------------


def _join_plain(hi, lo, av, cnt):
    """The upper triangle of the join, in torch: gather the valid slots,
    sort them by value (rows ascending in a run: the gather is row-major
    and the sort stable), find the runs, expand each entry into its pairs
    with the entries of its run up to itself and add them into [rows,
    rows] with index_put_(accumulate=True). Precondition as the kernel's."""
    rows, d, B = hi.shape
    dev = hi.device
    valid = torch.arange(d, device=dev)[None, :, None] < cnt.to(torch.int64)[:, None, :]
    vals = ((hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF))[valid]
    row = torch.arange(rows, device=dev)[:, None, None].expand(rows, d, B)[valid]
    vals, order = torch.sort(vals, stable=True)
    row = row[order]
    _uniq, runs = torch.unique_consecutive(vals, return_counts=True)
    start = torch.repeat_interleave(torch.cumsum(runs, 0) - runs, runs)  # each entry's run start
    pos = torch.arange(len(vals), device=dev)
    npairs = pos - start + 1  # entry i pairs with run entries start..i
    first = torch.cumsum(npairs, 0) - npairs
    i = torch.repeat_interleave(pos, npairs)
    j = torch.repeat_interleave(start, npairs) + (
        torch.arange(int(npairs.sum()), device=dev) - torch.repeat_interleave(first, npairs))
    if av is None:
        out = torch.zeros((rows, rows), dtype=torch.int32, device=dev)
        add = torch.ones(len(i), dtype=torch.int32, device=dev)
    else:
        out = torch.zeros((rows, rows), dtype=torch.int64, device=dev)
        ab = av.to(torch.int64)[valid][order]
        add = ab[i] * ab[j]
    out.index_put_((row[j], row[i]), add, accumulate=True)
    return out


def pairwise_counts_plain(hi, lo, cnt):
    "Plain PyTorch version of `pairwise_counts` (sort, runs, pair expansion)."
    _check_join(hi, lo, None, cnt)
    return _mirror(_join_plain(hi, lo, None, cnt))


def pairwise_products_plain(hi, lo, av, cnt):
    "Plain PyTorch version of `pairwise_products` (sort, runs, pair expansion)."
    _check_join(hi, lo, av, cnt)
    return _mirror(_join_plain(hi, lo, av, cnt))
