"""The gather kernels: CUDA wrappers, launch counters and plain PyTorch
versions. Counterpart of the bucketed counts, membership and round-step
code of `sourmash_tpu` (see `csrc/gather.cu` for what each replaces).

- `counts_rows` (replaces T1, `tools/exp_pallas_counts.py:
  _counts_rows_pallas`): raw limb-pair matches of query planes
  `qhi/qlo [dq, B]` against subject planes `Shi/Slo [rows, 8, B]`, PAD==PAD
  hits included, optionally only where the query pair is <= a per-row cut
  `cut_hi/cut_lo [rows]` (unsigned). `[rows]` int32. Each bucket's query
  column must be ascending in unsigned (hi, lo) order (the kernel
  binary-searches it), as both query packs give it.
- `membership_bits` (X4, `ops/bucketed.py:_membership_bits_packed`):
  `[nm, W]` int32 membership words of rows `sel [nm]` of one chunk's planes
  over the query hashes of `slotmap [W * 32]`; the kernel walks the rows'
  valid slots and needs the query's occupancy `qcnt [B]` and the inverse
  slot map `inv [dq * B]` (`bucketed.inverse_slot_map`).
- `round_dec` (X5, `index/flat.py:_dec_counts`): `[k]` int32
  `sum_w popc(M[r, w] & rm[w])`.

Their batch forms, for a block of queries against one collection
(multigather):

- `counts_block` (X3b, `ops/bucketed.py:_counts_block_impl`): `[bq, rows]`
  int32 exact stored-element counts of each query of `Qhi/Qlo [bq, dq, B]`
  (occupancy `Qcnt [bq, B]` int32) against each row of `Shi/Slo [rows, d,
  B]` (occupancy `Scnt [rows, B]` uint8): a hash join of the block's valid
  slots against the rows' per tile of adjacent buckets
  (`csrc/block_join.cu`), planned from the block's per-bucket loads
  (`block_join_plan`).
- `membership_bits_batch` (X4b, `ops/bucketed.py:
  _membership_bits_packed_batch`): `membership_bits` for each query, with
  per-query occupancy `Qcnt [bq, B]`, selections `sel [bq, cap]`, slot
  maps `slotmaps [bq, W * 32]` and inverse maps `inv [bq, dq * B]`;
  `[bq, cap, W]` int32. The kernel builds a hash table of each query's
  valid slots (value -> bit, from `inv`) in a scratch buffer and probes it
  once for each valid slot of the selected rows.
- `round_dec_batch` (X5b, the decrement of `index/flat.py:
  _schedule_scan_batch`): `[Q, k]` int32 `sum_w popc(M[q, r, w] & rm[q, w])`.

`compare`'s block route launches `counts_block` with a bank's own rows as
the query block, and for abundance-weighted similarity:

- `products_block` (X6, `sourmash_tpu/ops/bucketed.py:
  _products_block_impl`): `[bq, ns]` int64 sums of `Qav * Sav` over the
  hashes query q and row s share, on `_pack_weighted`'s planes: zeros past
  each bucket's occupancy (`Qcnt`, `Scnt` uint8), any depth, and 2^64-1 a
  valid hash; the same join, weighted.

The joins need no column order. Their precondition, as every pack gives
it: a valid value sits in bucket value & (B - 1).

The sharded gather program (`sourmash_tpu_torch/parallel/`) has one kernel
of its own (`csrc/parallel.cu`):

- `shard_match` (X8, `sourmash_tpu/parallel/__init__.py:_local_counts`
  and `build_chunk`): `[bq, rows]` int32 counts, and optionally the match
  words `[bq, rows, dq, B/32]` int32, of each query of `Qhi/Qlo [bq, dq,
  B]` with alive words `[bq, dq, B/32]` against each row of `Shi/Slo
  [rows, d, B]` (occupancy `Scnt [rows, B]` uint8): bit j of word w at
  (q, r, s) is set when the query slot (s, 32w + j) is alive and equals
  one of the row's occupied slots in that bucket. The kernel builds a hash
  table of each query's alive slots a bucket, then looks each occupied
  row slot up in it (`shard_match_table_bytes` sizes the tables' scratch
  from the shapes).

Limbs and words are int32 bit patterns of u32 values (PAD = -1). Each
wrapper checks its inputs (a wrong dtype, shape or layout raises
TypeError, so no caller's ValueError handling can swallow it), allocates
its output, launches on the current CUDA stream and counts the launch in
`LAUNCHES`. A CPU tensor goes to the plain version beside the wrapper; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

# kernel launches since the last reset_launch_counts(); only the CUDA
# wrappers add to them, the plain versions never do
LAUNCHES = {"counts_rows": 0, "membership_bits": 0, "round_dec": 0,
            "counts_block": 0, "membership_bits_batch": 0, "round_dec_batch": 0,
            "products_block": 0, "shard_match": 0}
_D = 8  # subject slots per bucket, as the CUDA kernels are built
_INT32_MIN = -(1 << 31)


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t, dtype, ndim: int, device=None):
    if not torch.is_tensor(t) or t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected a {ndim}-d {dtype} tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if device is not None and t.device != device:
        raise TypeError(f"{name} is on {t.device}, not {device}")
    if not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous")


def _flip(x: torch.Tensor) -> torch.Tensor:
    "Unsigned order of int32 bit patterns as signed order."
    return x ^ _INT32_MIN


def _launch(fn_name: str, device, *args):
    from . import _build

    _build.launch("gather", fn_name, device, *args)


# -- counts_rows: T1 ---------------------------------------------------------


def _check_counts(qhi, qlo, Shi, Slo, cut_hi, cut_lo):
    dev = qhi.device if torch.is_tensor(qhi) else None
    _check("qhi", qhi, torch.int32, 2)
    _check("qlo", qlo, torch.int32, 2, dev)
    _check("Shi", Shi, torch.int32, 3, dev)
    _check("Slo", Slo, torch.int32, 3, dev)
    if qhi.shape != qlo.shape or Shi.shape != Slo.shape or Shi.shape[2] != qhi.shape[1]:
        raise TypeError(f"planes {tuple(qhi.shape)} vs {tuple(Shi.shape)} do not match")
    if (cut_hi is None) != (cut_lo is None):
        raise TypeError("give both cut_hi and cut_lo, or neither")
    if cut_hi is not None:
        _check("cut_hi", cut_hi, torch.int32, 1, dev)
        _check("cut_lo", cut_lo, torch.int32, 1, dev)
        if cut_hi.shape[0] != Shi.shape[0] or cut_lo.shape[0] != Shi.shape[0]:
            raise TypeError("one cut per subject row")


def _columns_ascending(qhi, qlo) -> bool:
    "Is every column of the [..., dq, B] query planes ascending in unsigned (hi, lo) order?"
    h0, h1 = _flip(qhi[..., :-1, :]), _flip(qhi[..., 1:, :])
    ok = (h0 < h1) | ((h0 == h1) & (_flip(qlo[..., :-1, :]) <= _flip(qlo[..., 1:, :])))
    return bool(ok.all())


def _order_stamp(qhi, qlo) -> tuple:
    "The planes' addresses and version counters."
    return (qhi.data_ptr(), qlo.data_ptr(), qhi._version, qlo._version)


def _check_query_order(qhi, qlo):
    """Raise TypeError unless every query column is ascending, PAD last.
    The check reads the planes back once; a pass is recorded on `qhi` with
    the planes' addresses and version counters, so the same unmodified
    planes (a cached query pack, launched against every chunk) are not
    read again."""
    stamp = _order_stamp(qhi, qlo)
    if getattr(qhi, "_ascending_at", None) == stamp:
        return
    if not _columns_ascending(qhi, qlo):
        raise TypeError("counts_rows: a query column is not ascending in unsigned (hi, lo) "
                        "order, PAD last")
    qhi._ascending_at = stamp


def counts_rows(qhi, qlo, Shi, Slo, cut_hi=None, cut_lo=None):
    """Raw per-row count of query limb pairs equal to a subject slot's,
    PAD==PAD included; with cuts, only query pairs <= the row's cut.
    Returns [rows] int32.

    Precondition: each bucket's query column `qhi/qlo[:, b]` is ascending
    in unsigned (hi, lo) order, so PAD (0xFFFFFFFF, 0xFFFFFFFF) comes last;
    `pack_query_bucketed` and `pack_query_block_device` give this (the
    2^64-1 tail stays out of the planes). A column out of order raises
    TypeError, on CPU tensors too. The subject planes need no order."""
    _check_counts(qhi, qlo, Shi, Slo, cut_hi, cut_lo)
    _check_query_order(qhi, qlo)
    if qhi.device.type == "cpu":
        return counts_rows_plain(qhi, qlo, Shi, Slo, cut_hi, cut_lo)
    rows, d, B = Shi.shape
    if d != _D:
        raise TypeError(f"the counts kernel takes {_D} subject slots, not {d}")
    out = torch.zeros(rows, dtype=torch.int32, device=qhi.device)
    cut = (cut_hi.data_ptr(), cut_lo.data_ptr()) if cut_hi is not None else (None, None)
    _launch(
        "gm_counts_rows", qhi.device, qhi.data_ptr(), qlo.data_ptr(), qhi.shape[0], B,
        Shi.data_ptr(), Slo.data_ptr(), rows, *cut, out.data_ptr(),
    )
    LAUNCHES["counts_rows"] += 1
    return out


def counts_rows_plain(qhi, qlo, Shi, Slo, cut_hi=None, cut_lo=None):
    """Plain PyTorch version of `counts_rows`: the d-loop broadcast compare
    of `_counts_qvm_impl` (`_counts_qvm_cutoff_impl` with cuts)."""
    _check_counts(qhi, qlo, Shi, Slo, cut_hi, cut_lo)
    qh = qhi[None]  # [1, dq, B]
    ql = qlo[None]
    le = None
    if cut_hi is not None:
        chi = cut_hi[:, None, None]
        clo = cut_lo[:, None, None]
        le = (_flip(qh) < _flip(chi)) | ((qh == chi) & (_flip(ql) <= _flip(clo)))
    acc = torch.zeros(Shi.shape[0], dtype=torch.int32, device=Shi.device)
    for k2 in range(Shi.shape[1]):
        eq = (Shi[:, k2, None, :] == qh) & (Slo[:, k2, None, :] == ql)
        if le is not None:
            eq &= le
        acc += eq.sum(dim=(1, 2), dtype=torch.int32)
    return acc


# -- membership_bits: X4 -----------------------------------------------------


def _check_membership(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, slotmap, inv):
    dev = qhi.device if torch.is_tensor(qhi) else None
    _check("qhi", qhi, torch.int32, 2)
    _check("qlo", qlo, torch.int32, 2, dev)
    _check("qcnt", qcnt, torch.int32, 1, dev)
    _check("Shi", Shi, torch.int32, 3, dev)
    _check("Slo", Slo, torch.int32, 3, dev)
    _check("Scnt", Scnt, torch.uint8, 2, dev)
    _check("sel", sel, torch.int64, 1, dev)
    _check("slotmap", slotmap, torch.int32, 1, dev)
    _check("inv", inv, torch.int32, 1, dev)
    dq, B = qhi.shape
    if qhi.shape != qlo.shape or Shi.shape != Slo.shape or Shi.shape[2] != B:
        raise TypeError(f"planes {tuple(qhi.shape)} vs {tuple(Shi.shape)} do not match")
    if tuple(Scnt.shape) != (Shi.shape[0], B) or slotmap.shape[0] % 32:
        raise TypeError("Scnt must be [rows, B] and slotmap a multiple of 32 long")
    if qcnt.shape[0] != B or inv.shape[0] != dq * B:
        raise TypeError("qcnt must be [B] and inv [dq * B]")


def membership_bits(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, slotmap, inv):
    """Membership words [nm, W] int32 of rows `sel` of one chunk's planes:
    bit j of word w is set when query hash 32w + j sits in a valid slot of
    the row's bucket (slotmap gives its flat slot position, or dq*B). qcnt
    is the query's per-bucket occupancy and inv the inverse of slotmap
    (`bucketed.inverse_slot_map`), which the kernel reads in its place."""
    _check_membership(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, slotmap, inv)
    if qhi.device.type == "cpu":
        return membership_bits_plain(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, slotmap, inv)
    rows, d, B = Shi.shape
    if d != _D:
        raise TypeError(f"the membership kernel takes {_D} subject slots, not {d}")
    if inv.shape[0] >= 2**31:
        raise TypeError(f"query planes of {inv.shape[0]} slots are out of the kernel's range")
    nm, W = sel.shape[0], slotmap.shape[0] // 32
    if nm and not (0 <= int(sel.min()) and int(sel.max()) < rows):
        raise IndexError(f"sel holds rows outside [0, {rows})")
    out = torch.empty((nm, W), dtype=torch.int32, device=qhi.device)
    _launch(
        "gm_membership_bits", qhi.device, qhi.data_ptr(), qlo.data_ptr(), qcnt.data_ptr(), B,
        Shi.data_ptr(), Slo.data_ptr(), Scnt.data_ptr(), sel.data_ptr(), nm,
        inv.data_ptr(), W, out.data_ptr(),
    )
    LAUNCHES["membership_bits"] += 1
    return out


def membership_bits_plain(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, slotmap, inv):
    """Plain PyTorch version of `membership_bits`, driven by the query as
    the JAX function is: `_membership_rows` over the selected rows, a take
    by slotmap (dq*B reads a zero column) and the bit pack. qcnt and inv
    are checked and not needed."""
    from .bucketed import _membership_rows, pack_bits_u32

    _check_membership(qhi, qlo, qcnt, Shi, Slo, Scnt, sel, slotmap, inv)
    m = _membership_rows(qhi, qlo, Shi[sel], Slo[sel], Scnt[sel])  # [nm, dq, B]
    flat = m.reshape(m.shape[0], -1)
    flat = torch.cat([flat, flat.new_zeros((flat.shape[0], 1))], dim=1)
    return pack_bits_u32(flat[:, slotmap.long()])


# -- round_dec: X5 -----------------------------------------------------------


def _check_round(M, rm):
    _check("M", M, torch.int32, 2)
    _check("rm", rm, torch.int32, 1, M.device)
    if rm.shape[0] != M.shape[1]:
        raise TypeError(f"rm has {rm.shape[0]} words, M rows {M.shape[1]}")


def round_dec(M, rm):
    "Per-row popcount of M [k, W] & rm [W]: [k] int32."
    _check_round(M, rm)
    if M.device.type == "cpu":
        return round_dec_plain(M, rm)
    k, W = M.shape
    out = torch.empty(k, dtype=torch.int32, device=M.device)
    _launch("gm_round_dec", M.device, M.data_ptr(), rm.data_ptr(), k, W, out.data_ptr())
    LAUNCHES["round_dec"] += 1
    return out


def round_dec_plain(M, rm):
    "Plain PyTorch version of `round_dec` (SWAR popcount in int64)."
    from .bucketed import popcount_u32

    _check_round(M, rm)
    return popcount_u32(M & rm[None]).sum(dim=1, dtype=torch.int32)


# -- the block joins: counts_block (X3b) and products_block (X6) ----------------


def block_entries(Qcnt, dq: int) -> np.ndarray:
    """[B] int64 host array: the valid slots of each bucket over a query
    block, from its occupancy Qcnt [bq, B] (read back once)."""
    return Qcnt.to(torch.int64).clamp(max=dq).sum(dim=0).cpu().numpy()


def block_join_capacity(weighted: bool, device) -> int:
    """The query entries of one tile that a block of the join holds in
    shared memory on `device`, beside its filter (one block an SM)."""
    from .cuda_pairwise import library_capacity

    return library_capacity("block_join", "bj_join_capacity", device, int(weighted))


def block_join_plan(entries, weighted: bool, device, target=None):
    """The tiles of one `counts_block` (or, weighted, `products_block`)
    launch on `device` from the query block's per-bucket valid slots
    `entries` [B] (host integers: `block_entries`, or the host's own loads,
    which need no readback): the widest tiles of at most `target` entries
    (default: what one block holds). One plan serves every chunk of a
    bank."""
    from . import cuda_pairwise

    cap = block_join_capacity(weighted, device)
    return cuda_pairwise.tile_plan(entries, weighted, device, cap,
                                   cap if target is None else target)


def row_block_plans(cnt, depth: int, block: int, weighted: bool) -> list:
    """[(i, plan)] for the blocks of `block` rows of a bank that serves as
    its own query block (compare's block routes), rows [i, i + block) a
    launch: one readback of the occupancy cnt [rows, B] for all of them;
    plans None on the CPU, where the plain versions need none."""
    starts = range(0, cnt.shape[0], block)
    if cnt.device.type == "cpu":
        return [(i, None) for i in starts]
    loads = np.minimum(cnt.cpu().numpy().astype(np.int64), depth)
    return [(i, block_join_plan(loads[i : i + block].sum(axis=0), weighted, cnt.device))
            for i in starts]


def launch_block_join(plan, Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt, out) -> None:
    """Launch the join kernel once on `plan`'s tiles: out [bq, rows] (int32;
    int64 with abundances Qav, Sav) += each (query, row) pair's count or
    sum of abundance products."""
    from . import _build
    from .cuda_pairwise import plan_args

    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    if plan.meta.shape[0] << plan.tile_log2 != B:
        raise TypeError(f"the plan's tiles cover {plan.meta.shape[0] << plan.tile_log2} "
                        f"buckets, not {B}")
    weighted = Qav is not None
    _build.launch(
        "block_join", "bj_join", Qhi.device, Qhi.data_ptr(), Qlo.data_ptr(),
        Qav.data_ptr() if weighted else None, Qcnt.data_ptr(), bq, dq, Shi.data_ptr(),
        Slo.data_ptr(), Sav.data_ptr() if weighted else None, Scnt.data_ptr(), rows, d, B,
        *plan_args(plan), out.data_ptr(),
    )
    LAUNCHES["products_block" if weighted else "counts_block"] += 1


def _block_join_plain(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt):
    """The join in torch: gather each side's valid slots (k < its bucket's
    occupancy) as int64 values with their owner (and abundance), sort the
    query side's, find each row slot's run of equal values by
    searchsorted, expand the runs into (query entry, row entry) pairs and
    add 1 (or qa * sa) into [bq, rows] with index_put_(accumulate=True)."""
    dev = Qhi.device

    def entries(hi, lo, cnt, av):
        n, depth, B = hi.shape
        valid = torch.arange(depth, device=dev)[None, :, None] < cnt.to(torch.int64)[:, None, :]
        vals = ((hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF))[valid]
        owner = torch.arange(n, device=dev)[:, None, None].expand(n, depth, B)[valid]
        return vals, owner, None if av is None else av.to(torch.int64)[valid]

    qv, qo, qa = entries(Qhi, Qlo, Qcnt, Qav)
    sv, so, sa = entries(Shi, Slo, Scnt, Sav)
    qv, order = torch.sort(qv)
    qo = qo[order]
    first = torch.searchsorted(qv, sv, side="left")
    spans = torch.searchsorted(qv, sv, side="right") - first
    total = int(spans.sum())
    s_idx = torch.repeat_interleave(torch.arange(len(sv), device=dev), spans)
    q_idx = torch.repeat_interleave(first, spans) + (
        torch.arange(total, device=dev) - torch.repeat_interleave(torch.cumsum(spans, 0) - spans,
                                                                  spans))
    if Qav is None:
        out = torch.zeros((Qhi.shape[0], Shi.shape[0]), dtype=torch.int32, device=dev)
        add = torch.ones(total, dtype=torch.int32, device=dev)
    else:
        out = torch.zeros((Qhi.shape[0], Shi.shape[0]), dtype=torch.int64, device=dev)
        add = qa[order][q_idx] * sa[s_idx]
    out.index_put_((qo[q_idx], so[s_idx]), add, accumulate=True)
    return out


def _check_counts_block(Qhi, Qlo, Qcnt, Shi, Slo, Scnt):
    dev = Qhi.device if torch.is_tensor(Qhi) else None
    _check("Qhi", Qhi, torch.int32, 3)
    _check("Qlo", Qlo, torch.int32, 3, dev)
    _check("Qcnt", Qcnt, torch.int32, 2, dev)
    _check("Shi", Shi, torch.int32, 3, dev)
    _check("Slo", Slo, torch.int32, 3, dev)
    _check("Scnt", Scnt, torch.uint8, 2, dev)
    bq, _dq, B = Qhi.shape
    if Qhi.shape != Qlo.shape or Shi.shape != Slo.shape or Shi.shape[2] != B:
        raise TypeError(f"planes {tuple(Qhi.shape)} vs {tuple(Shi.shape)} do not match")
    if tuple(Qcnt.shape) != (bq, B) or tuple(Scnt.shape) != (Shi.shape[0], B):
        raise TypeError("Qcnt must be [bq, B] and Scnt [rows, B]")


def counts_block(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, plan=None):
    """[bq, rows] int32: for each query q and row r, how many values the
    valid slots of q (k < Qcnt[q, b]) share with those of r (k <
    Scnt[r, b]), bucket by bucket: the exact stored-element counts, with
    no PAD correction. `plan`: the tiles (`block_join_plan`) from the
    block's per-bucket loads; made here from Qcnt, one readback, if not
    given.

    Precondition: a valid value sits in bucket value & (B - 1), as every
    pack gives it. The planes need no column order."""
    _check_counts_block(Qhi, Qlo, Qcnt, Shi, Slo, Scnt)
    if Qhi.device.type == "cpu":
        return counts_block_plain(Qhi, Qlo, Qcnt, Shi, Slo, Scnt)
    if plan is None:
        plan = block_join_plan(block_entries(Qcnt, Qhi.shape[1]), False, Qhi.device)
    out = torch.zeros((Qhi.shape[0], Shi.shape[0]), dtype=torch.int32, device=Qhi.device)
    launch_block_join(plan, Qhi, Qlo, None, Qcnt, Shi, Slo, None, Scnt, out)
    return out


def counts_block_plain(Qhi, Qlo, Qcnt, Shi, Slo, Scnt):
    "Plain PyTorch version of `counts_block` (sort, searchsorted, pair expansion)."
    _check_counts_block(Qhi, Qlo, Qcnt, Shi, Slo, Scnt)
    return _block_join_plain(Qhi, Qlo, None, Qcnt, Shi, Slo, None, Scnt)


# -- membership_bits_batch: X4b ----------------------------------------------


def _check_membership_batch(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, slotmaps, inv):
    dev = Qhi.device if torch.is_tensor(Qhi) else None
    _check("Qhi", Qhi, torch.int32, 3)
    _check("Qlo", Qlo, torch.int32, 3, dev)
    _check("Qcnt", Qcnt, torch.int32, 2, dev)
    _check("Shi", Shi, torch.int32, 3, dev)
    _check("Slo", Slo, torch.int32, 3, dev)
    _check("Scnt", Scnt, torch.uint8, 2, dev)
    _check("sel", sel, torch.int64, 2, dev)
    _check("slotmaps", slotmaps, torch.int32, 2, dev)
    _check("inv", inv, torch.int32, 2, dev)
    bq, dq, B = Qhi.shape
    if Qhi.shape != Qlo.shape or Shi.shape != Slo.shape or Shi.shape[2] != B:
        raise TypeError(f"planes {tuple(Qhi.shape)} vs {tuple(Shi.shape)} do not match")
    if tuple(Scnt.shape) != (Shi.shape[0], B) or slotmaps.shape[1] % 32:
        raise TypeError("Scnt must be [rows, B] and slotmaps a multiple of 32 long")
    if (tuple(Qcnt.shape) != (bq, B) or tuple(inv.shape) != (bq, dq * B)
            or sel.shape[0] != bq or slotmaps.shape[0] != bq):
        raise TypeError("Qcnt must be [bq, B], inv [bq, dq * B], sel and slotmaps [bq, ...]")


def membership_bits_batch(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, slotmaps, inv):
    """Membership words [bq, cap, W] int32: for each query q, the words of
    rows `sel[q]` of one chunk's planes over the query hashes of
    `slotmaps[q]` (`membership_bits` of query q). The kernel reads the
    per-query occupancy Qcnt and inverse slot maps inv in the slot maps'
    place; an entry of `sel` gives the words of the row it names, so a
    padded selection gives real words that the caller disregards."""
    _check_membership_batch(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, slotmaps, inv)
    if Qhi.device.type == "cpu":
        return membership_bits_batch_plain(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, slotmaps, inv)
    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    if d != _D:
        raise TypeError(f"the membership kernel takes {_D} subject slots, not {d}")
    if dq * B >= 2**31:
        raise TypeError(f"query planes of {dq * B} slots are out of the kernel's range")
    cap, W = sel.shape[1], slotmaps.shape[1] // 32
    if sel.numel() and not (0 <= int(sel.min()) and int(sel.max()) < rows):
        raise IndexError(f"sel holds rows outside [0, {rows})")
    groups = membership_table_groups(dq, B, W)
    if groups >= 2**29:
        raise TypeError(f"a table of {groups} groups is out of the kernel's range")
    out = torch.empty((bq, cap, W), dtype=torch.int32, device=Qhi.device)
    table = torch.empty(bq * (48 * groups + 4), dtype=torch.uint8, device=Qhi.device)
    _launch(
        "gm_membership_bits_batch", Qhi.device, Qhi.data_ptr(), Qlo.data_ptr(),
        Qcnt.data_ptr(), bq, dq, B, Shi.data_ptr(), Slo.data_ptr(), Scnt.data_ptr(),
        sel.data_ptr(), cap, inv.data_ptr(), W, table.data_ptr(), groups, out.data_ptr(),
    )
    LAUNCHES["membership_bits_batch"] += 1
    return out


def membership_table_groups(dq: int, B: int, W: int) -> int:
    """Groups of four keys in each query's table of `membership_bits_batch`:
    room for 5/2 entries a query hash, so a table is at most 2/5 full. A
    query's entries are at most its valid slots (dq * B) and its distinct
    bits (32 W)."""
    return max(1, -(-5 * min(32 * W, dq * B) // 8))


def membership_bits_batch_plain(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, slotmaps, inv):
    """Plain PyTorch version of `membership_bits_batch`: the plain
    `membership_bits` of each query, stacked (the JAX function's vmap)."""
    _check_membership_batch(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, slotmaps, inv)
    if not Qhi.shape[0]:
        return torch.zeros((0, sel.shape[1], slotmaps.shape[1] // 32), dtype=torch.int32,
                           device=Qhi.device)
    return torch.stack([
        membership_bits_plain(Qhi[q], Qlo[q], Qcnt[q], Shi, Slo, Scnt, sel[q], slotmaps[q],
                              inv[q])
        for q in range(Qhi.shape[0])
    ])


# -- round_dec_batch: X5b ----------------------------------------------------


def _check_round_batch(M, rm):
    _check("M", M, torch.int32, 3)
    _check("rm", rm, torch.int32, 2, M.device)
    if tuple(rm.shape) != (M.shape[0], M.shape[2]):
        raise TypeError(f"rm is {tuple(rm.shape)}, M {tuple(M.shape)}")


def round_dec_batch(M, rm):
    "Per-row popcount of M [Q, k, W] & rm [Q, W] of its query: [Q, k] int32."
    _check_round_batch(M, rm)
    if M.device.type == "cpu":
        return round_dec_batch_plain(M, rm)
    Q, k, W = M.shape
    out = torch.empty((Q, k), dtype=torch.int32, device=M.device)
    _launch("gm_round_dec_batch", M.device, M.data_ptr(), rm.data_ptr(), Q, k, W,
            out.data_ptr())
    LAUNCHES["round_dec_batch"] += 1
    return out


def round_dec_batch_plain(M, rm):
    "Plain PyTorch version of `round_dec_batch` (SWAR popcount in int64)."
    from .bucketed import popcount_u32

    _check_round_batch(M, rm)
    return popcount_u32(M & rm[:, None]).sum(dim=2, dtype=torch.int32)


# -- products_block: X6 -------------------------------------------------------


def _check_products(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt):
    dev = Qhi.device if torch.is_tensor(Qhi) else None
    _check("Qhi", Qhi, torch.int32, 3)
    _check("Qlo", Qlo, torch.int32, 3, dev)
    _check("Qav", Qav, torch.int32, 3, dev)
    _check("Qcnt", Qcnt, torch.uint8, 2, dev)
    _check("Shi", Shi, torch.int32, 3, dev)
    _check("Slo", Slo, torch.int32, 3, dev)
    _check("Sav", Sav, torch.int32, 3, dev)
    _check("Scnt", Scnt, torch.uint8, 2, dev)
    bq, dq, B = Qhi.shape
    if (Qlo.shape != Qhi.shape or Qav.shape != Qhi.shape or Slo.shape != Shi.shape
            or Sav.shape != Shi.shape or Shi.shape[2] != B):
        raise TypeError(f"planes {tuple(Qhi.shape)} vs {tuple(Shi.shape)} do not match")
    if tuple(Qcnt.shape) != (bq, B) or tuple(Scnt.shape) != (Shi.shape[0], B):
        raise TypeError("Qcnt must be [bq, B] and Scnt [rows, B]")


def products_block(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt, plan=None):
    """[bq, rows] int64: for each query q and row s, the sum of
    Qav[q, p, b] * Sav[s, k, b] over the valid slot pairs (p < Qcnt[q, b],
    k < Scnt[s, b]) that hold the same (hi, lo) pair: `counts_block`'s
    join, weighted. `plan`: as `counts_block`'s (weighted tiles).

    Precondition: a valid value sits in bucket value & (B - 1), as
    `_pack_weighted` gives it; no column order is needed."""
    _check_products(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt)
    if Qhi.device.type == "cpu":
        return products_block_plain(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt)
    if plan is None:
        plan = block_join_plan(block_entries(Qcnt, Qhi.shape[1]), True, Qhi.device)
    out = torch.zeros((Qhi.shape[0], Shi.shape[0]), dtype=torch.int64, device=Qhi.device)
    launch_block_join(plan, Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt, out)
    return out


def products_block_plain(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt):
    "Plain PyTorch version of `products_block` (sort, searchsorted, pair expansion)."
    _check_products(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt)
    return _block_join_plain(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt)


# -- shard_match: X8 -----------------------------------------------------------


def _check_shard_match(Qhi, Qlo, alive, Shi, Slo, Scnt, out, row0):
    dev = Qhi.device if torch.is_tensor(Qhi) else None
    _check("Qhi", Qhi, torch.int32, 3)
    _check("Qlo", Qlo, torch.int32, 3, dev)
    _check("alive", alive, torch.int32, 3, dev)
    _check("Shi", Shi, torch.int32, 3, dev)
    _check("Slo", Slo, torch.int32, 3, dev)
    _check("Scnt", Scnt, torch.uint8, 2, dev)
    bq, dq, B = Qhi.shape
    rows = Shi.shape[0]
    if B % 32:
        raise TypeError(f"shard_match takes a multiple of 32 buckets, not {B}")
    if Qlo.shape != Qhi.shape or Shi.shape != Slo.shape or Shi.shape[2] != B:
        raise TypeError(f"planes {tuple(Qhi.shape)} vs {tuple(Shi.shape)} do not match")
    if tuple(alive.shape) != (bq, dq, B // 32) or tuple(Scnt.shape) != (rows, B):
        raise TypeError("alive must be [bq, dq, B/32] and Scnt [rows, B]")
    if out is None:
        return
    counts, M = out
    _check("counts", counts, torch.int32, 2, dev)
    if counts.shape[0] != bq or not 0 <= row0 <= counts.shape[1] - rows:
        raise TypeError(f"counts {tuple(counts.shape)} cannot take rows [{row0}, {row0 + rows})")
    if M is not None:
        _check("M", M, torch.int32, 4, dev)
        if tuple(M.shape) != (bq, counts.shape[1], dq, B // 32):
            raise TypeError(f"M is {tuple(M.shape)}, not {(bq, counts.shape[1], dq, B // 32)}")


def _shard_match_out(bq, rows, dq, W, bits, device, out, row0):
    "(counts, M or None, counts' rows, row0): the caller's buffers or new ones."
    if out is not None:
        return out[0], out[1], out[0].shape[1], row0
    counts = torch.empty((bq, rows), dtype=torch.int32, device=device)
    M = torch.empty((bq, rows, dq, W), dtype=torch.int32, device=device) if bits else None
    return counts, M, rows, 0


SHARD_MATCH_RANGE_SLOTS = 8192  # query slots of a table (`csrc/parallel.cu`'s kRangeSlots)


def shard_match_table_bytes(bq: int, dq: int, B: int) -> int:
    """The scratch of shard_match's tables, from the shapes alone (no
    readback), as `csrc/parallel.cu`'s plan_for sizes it (the kernel
    refuses less): for each query and bucket, a table of the alive slots of
    a range of at most SHARD_MATCH_RANGE_SLOTS query slots (dq past it:
    ranges of equal size, the tables rebuilt for each), of the least power
    of two (>= 16) of entries above 1.5 slots (a load of at most 2/3), of 2
    bytes below 255 slots a range, else 4."""
    ranges = -(-dq // SHARD_MATCH_RANGE_SLOTS)
    slots = -(-dq // ranges)
    entries = 1 << max(4, (slots + slots // 2).bit_length())
    return bq * B * entries * (2 if slots < 255 else 4)


def shard_match(Qhi, Qlo, alive, Shi, Slo, Scnt, bits: bool = False, out=None, row0: int = 0):
    """The matches of each query of Qhi/Qlo [bq, dq, B] (alive words
    [bq, dq, B/32] int32, bit j of word w = bucket 32w + j) against each row
    of Shi/Slo [rows, d, B] with occupancy Scnt [rows, B] uint8: a query
    slot matches a row when it is alive and equals one of the row's
    occupied slots (k < Scnt) of its bucket, so every u64 value, 2^64-1
    included, is compared exactly.

    Returns counts [bq, rows] int32, the matched slots of each pair; with
    `bits`, (counts, M [bq, rows, dq, B/32] int32), M's bits the matched
    slots. With out=(counts [bq, R], M [bq, R, dq, B/32] or None), the
    results of the rows go to rows [row0, row0 + rows) of those buffers
    (overwritten) and out is returned.

    On CUDA a call is two launches, the alive slots' per-bucket tables
    (`shard_match_table_bytes` of scratch, from torch.empty) and the
    match, which writes every word of its rows once; two more for each
    further range of 8,192 query slots, and of 65,535 queries."""
    _check_shard_match(Qhi, Qlo, alive, Shi, Slo, Scnt, out, row0)
    if Qhi.device.type == "cpu":
        return shard_match_plain(Qhi, Qlo, alive, Shi, Slo, Scnt, bits, out, row0)
    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    want_bits = bits if out is None else out[1] is not None
    if max(bq, dq, B, rows, d, rows if out is None else out[0].shape[1]) >= 2**31:
        raise TypeError("shard_match: a size is out of the kernel's range")
    counts, M, out_rows, at = _shard_match_out(bq, rows, dq, B // 32, want_bits, Qhi.device,
                                               out, row0)
    if not (bq and dq and B and rows):
        counts[:, at : at + rows].zero_()
        if M is not None:
            M[:, at : at + rows].zero_()
    else:
        from . import _build

        nbytes = shard_match_table_bytes(bq, dq, B)
        table = torch.empty(nbytes // 4, dtype=torch.int32, device=Qhi.device)
        _build.launch(
            "parallel", "pm_shard_match", Qhi.device, Qhi.data_ptr(), Qlo.data_ptr(),
            alive.data_ptr(), bq, dq, B, Shi.data_ptr(), Slo.data_ptr(), Scnt.data_ptr(), rows,
            d, out_rows, at, table.data_ptr(), nbytes, counts.data_ptr(),
            None if M is None else M.data_ptr(),
        )
        LAUNCHES["shard_match"] += 1
    if out is not None:
        return out
    return (counts, M) if bits else counts


def shard_match_plain(Qhi, Qlo, alive, Shi, Slo, Scnt, bits: bool = False, out=None,
                      row0: int = 0):
    """Plain PyTorch version of `shard_match`: the d-loop broadcast compare
    of `_local_counts` / `build_chunk` over [bq, rows, dq, B] bools, the
    alive mask, a sum and the bit pack."""
    from .bucketed import pack_bits_u32, unpack_bits_u32

    _check_shard_match(Qhi, Qlo, alive, Shi, Slo, Scnt, out, row0)
    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    hit = torch.zeros((bq, rows, dq, B), dtype=torch.bool, device=Qhi.device)
    for k2 in range(d):
        hit |= ((Shi[None, :, k2, None, :] == Qhi[:, None])
                & (Slo[None, :, k2, None, :] == Qlo[:, None])
                & (Scnt[None, :, None, :] > k2))
    hit &= unpack_bits_u32(alive)[:, None]
    got_counts = hit.sum(dim=(2, 3), dtype=torch.int32)
    want_bits = bits if out is None else out[1] is not None
    got_M = pack_bits_u32(hit) if want_bits else None
    if out is None:
        return (got_counts, got_M) if bits else got_counts
    counts, M = out
    counts[:, row0 : row0 + rows] = got_counts
    if M is not None:
        M[:, row0 : row0 + rows] = got_M
    return out
