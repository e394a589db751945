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

- `counts_block` (X3b, `ops/bucketed.py:_counts_block_impl`): `counts_rows`
  for each query of `Qhi/Qlo [bq, dq, B]`, `[bq, rows]` int32; the kernel
  reads each subject slot once per sub-block of queries whose columns fit
  its shared memory (`counts_block_plan`).
- `membership_bits_batch` (X4b, `ops/bucketed.py:
  _membership_bits_packed_batch`): `membership_bits` for each query, with
  per-query occupancy `Qcnt [bq, B]`, selections `sel [bq, cap]`, slot
  maps `slotmaps [bq, W * 32]` and inverse maps `inv [bq, dq * B]`;
  `[bq, cap, W]` int32.
- `round_dec_batch` (X5b, the decrement of `index/flat.py:
  _schedule_scan_batch`): `[Q, k]` int32 `sum_w popc(M[q, r, w] & rm[q, w])`.

`compare` launches `counts_block` with a bank's own rows as the query block
(dq = d = 8), and for abundance-weighted similarity:

- `products_block` (X6, `sourmash_tpu/ops/bucketed.py:
  _products_block_impl`): `[bq, ns]` int64 sums of `Qav * Sav` over the
  hashes query q and row s share, on `_pack_weighted`'s planes: zeros past
  each bucket's occupancy (`Qcnt`, `Scnt` uint8), any depth, and 2^64-1 a
  valid hash. Each query column's valid prefix must be ascending in
  unsigned (hi, lo) order.

Limbs and words are int32 bit patterns of u32 values (PAD = -1). Each
wrapper checks its inputs (a wrong dtype, shape or layout raises
TypeError, so no caller's ValueError handling can swallow it), allocates
its output, launches on the current CUDA stream and counts the launch in
`LAUNCHES`. A CPU tensor goes to the plain version beside the wrapper; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

# kernel launches since the last reset_launch_counts(); only the CUDA
# wrappers add to them, the plain versions never do
LAUNCHES = {"counts_rows": 0, "membership_bits": 0, "round_dec": 0,
            "counts_block": 0, "membership_bits_batch": 0, "round_dec_batch": 0,
            "products_block": 0}
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


def _columns_ascending(qhi, qlo, qcnt=None) -> bool:
    """Is every column of the [..., dq, B] query planes ascending in
    unsigned (hi, lo) order (with the occupancy qcnt [..., B], every
    column's valid prefix, its first qcnt slots)?"""
    h0, h1 = _flip(qhi[..., :-1, :]), _flip(qhi[..., 1:, :])
    ok = (h0 < h1) | ((h0 == h1) & (_flip(qlo[..., :-1, :]) <= _flip(qlo[..., 1:, :])))
    if qcnt is not None:
        second = torch.arange(1, qhi.shape[-2], device=qhi.device)[:, None]  # slot p + 1
        ok |= second >= qcnt[..., None, :]
    return bool(ok.all())


def _order_stamp(qhi, qlo, qcnt=None) -> tuple:
    "The planes' addresses and version counters (and the occupancy's, if given)."
    planes = (qhi, qlo) if qcnt is None else (qhi, qlo, qcnt)
    return tuple(t.data_ptr() for t in planes) + tuple(t._version for t in planes)


def _check_query_order(qhi, qlo, name="counts_rows", qcnt=None):
    """Raise TypeError unless every query column is ascending, PAD last
    (with `qcnt`: unless each column's valid prefix is). The check reads
    the planes back once; a pass is recorded on `qhi` with the planes'
    addresses and version counters, so the same unmodified planes (a cached
    query pack, launched against every chunk) are not read again."""
    attr = "_ascending_at" if qcnt is None else "_prefix_ascending_at"
    stamp = _order_stamp(qhi, qlo, qcnt)
    if getattr(qhi, attr, None) == stamp:
        return
    if not _columns_ascending(qhi, qlo, qcnt):
        raise TypeError(f"{name}: a query column is not ascending in unsigned (hi, lo) "
                        + ("order, PAD last" if qcnt is None else "order in its valid prefix"))
    setattr(qhi, attr, stamp)


def query_row_blocks(hi, lo, block: int, cnt=None):
    """(i, hi[i : i + block], lo[i : i + block]) for i in steps of block:
    row blocks of query planes as `counts_block` (or, with the occupancy
    `cnt`, `products_block`) takes them. The order is checked once for the
    whole planes, and each block carries the pass, so the kernels' own
    check does not read every block back again."""
    _check_query_order(hi, lo, "counts_block" if cnt is None else "products_block", cnt)
    for i in range(0, hi.shape[0], block):
        bh, bl = hi[i : i + block], lo[i : i + block]
        if cnt is None:
            bh._ascending_at = _order_stamp(bh, bl)
        else:
            bh._prefix_ascending_at = _order_stamp(bh, bl, cnt[i : i + block])
        yield i, bh, bl


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


# -- counts_block: X3b -------------------------------------------------------


def _check_counts_block(Qhi, Qlo, Shi, Slo):
    dev = Qhi.device if torch.is_tensor(Qhi) else None
    _check("Qhi", Qhi, torch.int32, 3)
    _check("Qlo", Qlo, torch.int32, 3, dev)
    _check("Shi", Shi, torch.int32, 3, dev)
    _check("Slo", Slo, torch.int32, 3, dev)
    if Qhi.shape != Qlo.shape or Shi.shape != Slo.shape or Shi.shape[2] != Qhi.shape[2]:
        raise TypeError(f"planes {tuple(Qhi.shape)} vs {tuple(Shi.shape)} do not match")


def counts_block(Qhi, Qlo, Shi, Slo):
    """Raw count of each query's limb pairs equal to a subject slot's,
    PAD==PAD included: `counts_rows` for every query of the block at once.
    Returns [bq, rows] int32.

    Precondition: every query column `Qhi/Qlo[q, :, b]` is ascending in
    unsigned (hi, lo) order, PAD last, as `pack_query_block_device` gives
    it; a column out of order raises TypeError, on CPU tensors too."""
    _check_counts_block(Qhi, Qlo, Shi, Slo)
    _check_query_order(Qhi, Qlo, "counts_block")
    if Qhi.device.type == "cpu":
        return counts_block_plain(Qhi, Qlo, Shi, Slo)
    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    if d != _D:
        raise TypeError(f"the counts kernel takes {_D} subject slots, not {d}")
    out = torch.zeros((bq, rows), dtype=torch.int32, device=Qhi.device)
    _launch(
        "gm_counts_block", Qhi.device, Qhi.data_ptr(), Qlo.data_ptr(), bq, dq, B,
        Shi.data_ptr(), Slo.data_ptr(), rows, out.data_ptr(),
    )
    LAUNCHES["counts_block"] += 1
    return out


def counts_block_plan(bq: int, dq: int, device) -> int:
    """The queries of a block of bq whose columns `counts_block` stages in
    shared memory together at dq on `device` (each launch then reads the
    subject rows ceil(bq / that) times), or 0 where one query's columns do
    not fit and they are searched in global memory."""
    import ctypes

    from . import _build

    qsub = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.load("gather").gm_counts_block_plan(bq, dq, ctypes.addressof(qsub))
    if rc != 0:
        raise RuntimeError(f"gm_counts_block_plan failed: CUDA error {rc}")
    return qsub.value


def counts_block_plain(Qhi, Qlo, Shi, Slo):
    """Plain PyTorch version of `counts_block`: the d-loop broadcast compare
    of `_counts_block_impl`, the query block broadcast inside."""
    _check_counts_block(Qhi, Qlo, Shi, Slo)
    qh = Qhi[:, None]  # [bq, 1, dq, B]
    ql = Qlo[:, None]
    acc = torch.zeros((Qhi.shape[0], Shi.shape[0]), dtype=torch.int32, device=Shi.device)
    for k2 in range(Shi.shape[1]):
        eq = (Shi[None, :, k2, None, :] == qh) & (Slo[None, :, k2, None, :] == ql)
        acc += eq.sum(dim=(2, 3), dtype=torch.int32)
    return acc


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
    out = torch.empty((bq, cap, W), dtype=torch.int32, device=Qhi.device)
    _launch(
        "gm_membership_bits_batch", Qhi.device, Qhi.data_ptr(), Qlo.data_ptr(),
        Qcnt.data_ptr(), bq, dq, B, Shi.data_ptr(), Slo.data_ptr(), Scnt.data_ptr(),
        sel.data_ptr(), cap, inv.data_ptr(), W, out.data_ptr(),
    )
    LAUNCHES["membership_bits_batch"] += 1
    return out


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


def products_block(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt):
    """[bq, rows] int64: for each query q and row s, the sum of
    Qav[q, p, b] * Sav[s, k, b] over the valid slot pairs (p < Qcnt[q, b],
    k < Scnt[s, b]) that hold the same (hi, lo) pair.

    Precondition: the valid prefix of every query column is ascending in
    unsigned (hi, lo) order, as `_pack_weighted` gives it (the slots past
    it are zeros); out of order raises TypeError, on CPU tensors too. The
    subject planes need no order."""
    _check_products(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt)
    _check_query_order(Qhi, Qlo, "products_block", Qcnt)
    if Qhi.device.type == "cpu":
        return products_block_plain(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt)
    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    out = torch.zeros((bq, rows), dtype=torch.int64, device=Qhi.device)
    _launch(
        "gm_products_block", Qhi.device, Qhi.data_ptr(), Qlo.data_ptr(), Qav.data_ptr(),
        Qcnt.data_ptr(), bq, dq, B, Shi.data_ptr(), Slo.data_ptr(), Sav.data_ptr(),
        Scnt.data_ptr(), rows, d, out.data_ptr(),
    )
    LAUNCHES["products_block"] += 1
    return out


def products_block_plan(bq: int, dq: int, device) -> int:
    """The queries of a block of bq whose valid columns `products_block`
    stages in shared memory together at depth dq on `device` (each launch
    reads the subject rows ceil(bq / that) times); 0 where one query's do
    not fit (dq far past the 255 a uint8 occupancy can fill)."""
    import ctypes

    from . import _build

    qsub = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.load("gather").gm_products_block_plan(bq, dq, ctypes.addressof(qsub))
    if rc != 0:
        raise RuntimeError(f"gm_products_block_plan failed: CUDA error {rc}")
    return qsub.value


def products_block_plain(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt):
    """Plain PyTorch version of `products_block`: the d-loop broadcast of
    `_products_block_impl`, valid slots masked by occupancy, products in
    int64."""
    _check_products(Qhi, Qlo, Qav, Qcnt, Shi, Slo, Sav, Scnt)
    dq = Qhi.shape[1]
    acc = torch.zeros((Qhi.shape[0], Shi.shape[0]), dtype=torch.int64, device=Shi.device)
    qa64 = Qav.to(torch.int64)[:, None]  # [bq, 1, dq, B]
    slots = torch.arange(dq, device=Qhi.device)[None, :, None]
    qvalid = (Qcnt.to(torch.int64)[:, None, :] > slots)[:, None]  # [bq, 1, dq, B]
    scnt = Scnt.to(torch.int64)
    for k2 in range(Shi.shape[1]):
        svalid = (scnt > k2)[None, :, None, :]  # [1, ns, 1, B]
        eq = ((Shi[None, :, k2, None, :] == Qhi[:, None]) & (Slo[None, :, k2, None, :] == Qlo[:, None])
              & qvalid & svalid)
        prod = qa64 * Sav[None, :, k2, None, :].to(torch.int64)
        acc += torch.where(eq, prod, 0).sum(dim=(2, 3))
    return acc
