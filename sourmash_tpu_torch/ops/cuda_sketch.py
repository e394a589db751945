"""The sketch kernels: CUDA wrappers, launch counters and plain PyTorch
versions. Counterpart of `sourmash_tpu/ops/pallas_sketch.py`.

K1 `survivor_slots` (replaces `sketch_survivor_slots_pallas`), K2
`window_hashes` (replaces `window_hash_pairs_pallas`) and K3
`aa_window_hashes` (replaces `aa_window_hash_pairs_pallas`) are
hand-written CUDA C++ in `csrc/sketch.cu`. Each wrapper checks its input,
allocates the outputs with `torch.empty`, launches on the current CUDA
stream and counts the launch in `LAUNCHES`. A CPU tensor goes to the plain
version beside the wrapper, which computes the same function with torch ops
on any device; a CUDA tensor launches the kernel or raises.

Geometry: rows are `[B, S]` uint8, uppercased (for K3, amino-acid rows with
dayhoff/hp already remapped), with n = S - ksize + 1 windows. Windows are
grouped into R = ceil(n / 128) segments of 128 (K1's compaction unit); K2
and K3 write n_pad = 128 * R windows, and the ones past n read zero bytes
and are invalid. Hashes are int64 bit patterns of the unsigned values
(`ops/u64.py`); K1's slots are int32 bit patterns of the u32 halves, the
JAX function's layout.
"""

from __future__ import annotations

import torch

from . import u64
from .murmur import C1, C2, F1, F2

SEG = 128
_N1, _N2 = 0x52DCE729, 0x38495AB5

# kernel launches since the last reset_launch_counts(); only the CUDA
# wrappers add to them, the plain versions never do
LAUNCHES = {"survivor_slots": 0, "window_hashes": 0, "aa_window_hashes": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def geometry(S: int, ksize: int):
    "(n windows, R segments, n_pad windows) of a row of S bytes."
    n = S - ksize + 1
    R = -(-n // SEG)
    return n, R, R * SEG


def _check_rows(squ, ksize: int):
    if not torch.is_tensor(squ) or squ.dtype != torch.uint8 or squ.dim() != 2:
        raise TypeError("expected a [B, S] torch.uint8 tensor of sequence rows")
    if not squ.is_contiguous():
        raise ValueError("sequence rows must be contiguous")
    B, S = squ.shape
    if ksize < 1 or S < ksize:
        raise ValueError(f"rows of {S} bytes hold no window of ksize={ksize}")
    if B < 1 or B > 65535 or B * (S + SEG) >= 2**31:
        raise ValueError(f"batch [{B}, {S}] is out of the kernels' range")
    if squ.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {squ.device}")


def check_slots(slots: int):
    if not 1 <= slots <= SEG:
        raise ValueError(f"slots must be in [1, {SEG}], not {slots}")


def _launch(fn_name: str, squ, *args):
    from . import _build

    _build.launch("sketch", fn_name, squ.device, *args)


# -- K2: every window's canonical hash and validity -------------------------


def window_hashes(squ: torch.Tensor, *, ksize: int, seed: int = 42):
    """Canonical murmur hash and validity of every window of `squ`.

    Returns (hashes [B, n_pad] int64, valid [B, n_pad] uint8)."""
    _check_rows(squ, ksize)
    if squ.device.type == "cpu":
        return window_hashes_plain(squ, ksize=ksize, seed=seed)
    B, S = squ.shape
    _, _, n_pad = geometry(S, ksize)
    hashes = torch.empty((B, n_pad), dtype=torch.int64, device=squ.device)
    valid = torch.empty((B, n_pad), dtype=torch.uint8, device=squ.device)
    _launch(
        "sm_window_hashes", squ, squ.data_ptr(), B, S, n_pad, ksize,
        int(seed) & u64.MASK64, hashes.data_ptr(), valid.data_ptr(),
    )
    LAUNCHES["window_hashes"] += 1
    return hashes, valid


def murmur_words(word, L: int, seed: int, like: torch.Tensor):
    """MurmurHash3 x64_128 first word of L bytes given as little-endian
    64-bit words; word(i) is the int64 tensor of bytes [8i, 8i + 8) of
    every input (callers zero the bytes past L where murmur needs it)."""
    h1 = torch.full_like(like, u64.signed(seed), dtype=torch.int64)
    h2 = h1.clone()

    nblocks = L // 16
    for blk in range(nblocks):
        k1 = word(2 * blk)
        k2 = word(2 * blk + 1)
        k1 = u64.mul(u64.rotl(u64.mul(k1, C1), 31), C2)
        h1 = u64.rotl(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + _N1
        k2 = u64.mul(u64.rotl(u64.mul(k2, C2), 33), C1)
        h2 = u64.rotl(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + _N2

    t = L & 15
    if t > 8:
        h2 = h2 ^ u64.mul(u64.rotl(u64.mul(word(2 * nblocks + 1), C2), 33), C1)
    if t > 0:
        h1 = h1 ^ u64.mul(u64.rotl(u64.mul(word(2 * nblocks), C1), 31), C2)

    h1 = h1 ^ L
    h2 = h2 ^ L
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    return h1 + h2


def le64_words(col, L: int):
    """word(i) of `murmur_words` from byte columns: col(j) is the int64
    tensor holding byte j of every input; bytes past L are zero."""

    def word(i):
        acc = col(8 * i)
        for j in range(1, min(8, L - 8 * i)):
            acc = acc | (col(8 * i + j) << (8 * j))
        return acc

    return word


def _fmix64(k):
    k = k ^ u64.srl(k, 33)
    k = u64.mul(k, F1)
    k = k ^ u64.srl(k, 33)
    k = u64.mul(k, F2)
    return k ^ u64.srl(k, 33)


def canonical_columns(squ: torch.Tensor, ksize: int):
    """The canonical strand of every window of `squ`, as K1 and K2 pick it.

    Returns (ccol, valid): ccol(j) is the int64 [B, n_pad] tensor of byte
    j of every window's canonical strand, valid [B, n_pad] uint8 its
    validity. Invalid windows pick a strand from their raw bytes and the
    kernels' complement, as the kernels do."""
    B, S = squ.shape
    _, _, n_pad = geometry(S, ksize)
    x = torch.zeros((B, n_pad + ksize - 1), dtype=torch.int32, device=squ.device)
    x[:, :S] = squ
    # the kernels' complement: c ^ 4 if bit 1 of c is set, else c ^ 21
    comp = x ^ torch.where((x & 2) != 0, 4, 21).to(torch.int32)

    def fcol(j):
        return x[:, j : j + n_pad]

    def rcol(j):
        # byte j of the reverse complement of the window at i
        return comp[:, ksize - 1 - j : ksize - 1 - j + n_pad]

    use_fwd = torch.ones((B, n_pad), dtype=torch.bool, device=squ.device)
    for j in reversed(range(ksize)):
        f, r = fcol(j), rcol(j)
        use_fwd = (f < r) | ((f == r) & use_fwd)

    def ccol(j):
        return torch.where(use_fwd, fcol(j), rcol(j)).to(torch.int64)

    acgt = (x == 65) | (x == 67) | (x == 71) | (x == 84)
    cs = torch.nn.functional.pad(torch.cumsum(acgt.to(torch.int32), dim=1), (1, 0))
    valid = (cs[:, ksize : ksize + n_pad] - cs[:, :n_pad]) == ksize
    return ccol, valid.to(torch.uint8)


def window_hashes_plain(squ: torch.Tensor, *, ksize: int, seed: int = 42):
    "Plain PyTorch version of `window_hashes`, on squ's device."
    _check_rows(squ, ksize)
    ccol, valid = canonical_columns(squ, ksize)
    return murmur_words(le64_words(ccol, ksize), ksize, seed, valid), valid


# -- K3: every amino-acid window's hash and validity ------------------------


def aa_window_hashes(squ: torch.Tensor, *, ksize: int, seed: int = 42):
    """Murmur hash of every amino-acid window of `squ`, bytes as they are,
    and its validity (no zero byte in the window).

    Returns (hashes [B, n_pad] int64, valid [B, n_pad] uint8)."""
    _check_rows(squ, ksize)
    if squ.device.type == "cpu":
        return aa_window_hashes_plain(squ, ksize=ksize, seed=seed)
    B, S = squ.shape
    _, _, n_pad = geometry(S, ksize)
    hashes = torch.empty((B, n_pad), dtype=torch.int64, device=squ.device)
    valid = torch.empty((B, n_pad), dtype=torch.uint8, device=squ.device)
    _launch(
        "sm_aa_window_hashes", squ, squ.data_ptr(), B, S, n_pad, ksize,
        int(seed) & u64.MASK64, hashes.data_ptr(), valid.data_ptr(),
    )
    LAUNCHES["aa_window_hashes"] += 1
    return hashes, valid


def aa_window_hashes_plain(squ: torch.Tensor, *, ksize: int, seed: int = 42):
    "Plain PyTorch version of `aa_window_hashes`, on squ's device."
    _check_rows(squ, ksize)
    B, S = squ.shape
    _, _, n_pad = geometry(S, ksize)
    x = torch.zeros((B, n_pad + ksize - 1), dtype=torch.int64, device=squ.device)
    x[:, :S] = squ
    word = le64_words(lambda j: x[:, j : j + n_pad], ksize)
    hashes = murmur_words(word, ksize, seed, x[:, :n_pad])
    cs = torch.nn.functional.pad(torch.cumsum((x != 0).to(torch.int32), dim=1), (1, 0))
    valid = (cs[:, ksize : ksize + n_pad] - cs[:, :n_pad]) == ksize
    return hashes, valid.to(torch.uint8)


# -- K1: survivors under max_hash, compacted per 128-window segment --------


def survivor_slots(
    squ: torch.Tensor, max_hash: int, *, ksize: int, seed: int = 42, slots: int = 8,
    out=None,
):
    """Per 128-window segment, the first `slots` windows that are valid with
    hash <= max_hash (unsigned), in window order, and the TRUE count.

    Returns (slots_hi, slots_lo [B, R, slots] int32 bit patterns of the
    u32 halves, counts [B, R] int32); unused slots hold 0. A count above
    `slots` marks a truncated segment. `out`, three contiguous int32
    tensors of those shapes on squ's device, takes the outputs in place of
    new ones (the bare launch that `tools.profile_sketch_chain` times)."""
    _check_rows(squ, ksize)
    check_slots(slots)
    B, S = squ.shape
    n, R, _ = geometry(S, ksize)
    if out is not None:
        _check_slots_outputs(out, B, R, slots, squ.device)
    if squ.device.type == "cpu":
        res = survivor_slots_plain(squ, max_hash, ksize=ksize, seed=seed, slots=slots)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    hi, lo, counts = slots_outputs(B, R, slots, squ.device) if out is None else out
    _launch(
        "sm_survivor_slots", squ, squ.data_ptr(), B, S, n, R, ksize,
        int(seed) & u64.MASK64, int(max_hash) & u64.MASK64, slots,
        hi.data_ptr(), lo.data_ptr(), counts.data_ptr(),
    )
    LAUNCHES["survivor_slots"] += 1
    return hi, lo, counts


def slots_outputs(B: int, R: int, slots: int, device):
    "Empty (slots_hi, slots_lo, counts) for K1's outputs."
    return (
        torch.empty((B, R, slots), dtype=torch.int32, device=device),
        torch.empty((B, R, slots), dtype=torch.int32, device=device),
        torch.empty((B, R), dtype=torch.int32, device=device),
    )


def _check_slots_outputs(out, B: int, R: int, slots: int, device):
    shapes = ((B, R, slots), (B, R, slots), (B, R))
    if len(out) != 3 or any(
        not torch.is_tensor(t) or t.dtype != torch.int32 or tuple(t.shape) != shape
        or t.device != device or not t.is_contiguous()
        for t, shape in zip(out, shapes)
    ):
        raise TypeError(f"out must be contiguous int32 tensors of shapes {shapes} on {device}")


def survivor_slots_plain(
    squ: torch.Tensor, max_hash: int, *, ksize: int, seed: int = 42, slots: int = 8
):
    "Plain PyTorch version of `survivor_slots`, on squ's device."
    hashes, valid = window_hashes_plain(squ, ksize=ksize, seed=seed)
    return slots_from_hashes(hashes, valid, max_hash, slots=slots)


def slots_from_hashes(hashes: torch.Tensor, valid: torch.Tensor, max_hash: int, *, slots: int):
    """K1's threshold and per-segment compaction over K2's outputs (the
    second half of `survivor_slots_plain`)."""
    B, n_pad = hashes.shape
    R = n_pad // SEG
    keep = ((valid != 0) & u64.le(hashes, max_hash)).view(B, R, SEG)
    rank = torch.cumsum(keep.to(torch.int32), dim=-1, dtype=torch.int32)
    h = hashes.view(B, R, SEG)
    # exactly one window of a segment has rank j+1, so the sum is its hash
    vals = torch.stack(
        [torch.where(keep & (rank == j + 1), h, 0).sum(dim=-1) for j in range(slots)],
        dim=-1,
    )
    return u64.hi32(vals), u64.lo32(vals), rank[..., -1].contiguous()
