"""The sketch-kernel instruments: CUDA wrappers, launch counters and plain
PyTorch versions of the kernels in `csrc/sketch_parts.cu`, which take K1
(`cuda_sketch.survivor_slots`) apart. The tools under
`sourmash_tpu_torch/tools/` drive them; no sketch path does.

- T2 (`tools/exp_split_kernel.py:split_sketch`): `split_words`, every
  window's canonical bytes as little-endian words and its validity, then
  `split_slots`, murmur, the threshold and K1's segment compaction from
  those words. `split_slots(*split_words(x), ...)` is K1's output.
- T3 (`tools/exp_v2_kernel.py:v2_sketch`): `survivor_slots_v2`, K1's
  output from a kernel on K1's tile that finishes one window before it
  starts the next (one murmur chain live a thread) and hashes only valid
  windows.
- T4 (`tools/profile_sketch_parts.py`): `murmur_only`, `assembly_only` and
  `mulchain` over the tool's block layout: blocks
  `[nblk * (rows + EXTRA_ROWS), 128]` int32 in, `[nblk * rows, 128]` int32
  bit patterns of u32 out, element (r, lane) of block b computed from the
  block's values at r * 128 + lane onwards.
- The integer-pipe probe (`int_probe`): chains of one kind of integer
  instruction over the mul-chain's layout, whose time per round gives the
  card's IMAD.WIDE.U32, IMAD and ALU rates (`chip_smoke.py` sets its
  "operations" bounds from them). It replaces no TPU kernel.

Each wrapper checks its inputs (a wrong dtype, shape or layout raises
TypeError), allocates its outputs, launches on the current CUDA stream and
counts the launch in `LAUNCHES`. A CPU tensor goes to the plain version
beside the wrapper; a CUDA tensor launches the kernel or raises. The plain
versions follow the JAX functions' semantics, so the tests can hold them
to the Pallas bodies in interpret mode.
"""

from __future__ import annotations

import torch

from . import u64
from .cuda_sketch import (
    SEG,
    _check_rows,
    canonical_columns,
    check_slots,
    geometry,
    le64_words,
    murmur_words,
    slots_from_hashes,
    slots_outputs,
)
from .murmur import C1

LANES = 128
EXTRA_ROWS = 8  # lookahead rows of a T4 block
T4_KSIZE, T4_SEED = 31, 42  # the JAX tool's fixed KSIZE and SEED (kT4K, kT4Seed)

# kernel launches since the last reset_launch_counts(); only the CUDA
# wrappers add to them, the plain versions never do
LAUNCHES = {
    "split_words": 0, "split_slots": 0, "survivor_slots_v2": 0,
    "murmur_only": 0, "assembly_only": 0, "mulchain": 0, "int_probe": 0,
}
# the probe's modes, in the kernel's order (IntProbeMode in sketch_parts.cu):
# what one round does to v = hi << 32 | lo
PROBE_MODES = ("mul64", "mul32", "alu", "mix")
# mul32's multipliers (kProbeC, kProbeC2): C1's halves, the high one made
# even so that a round is invertible and no chain decays to 0
PROBE_C, PROBE_C2 = int(C1) & u64.MASK32, (int(C1) >> 32) ^ 1


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launch(fn_name: str, device, *args):
    from . import _build

    _build.launch("sketch_parts", fn_name, device, *args)


def n_words(ksize: int) -> int:
    "Words per window of `split_words`: ceil(k / 8), rounded up to even."
    nw = -(-ksize // 8)
    return nw + nw % 2


# -- T2 pass A: canonical words ---------------------------------------------


def split_words(squ: torch.Tensor, *, ksize: int):
    """Every window's canonical bytes as little-endian 64-bit words (zero
    past k) and its validity, for K2's windows (`cuda_sketch.geometry`).

    Returns (words [B, n_pad, n_words(ksize)] int64 bit patterns, valid
    [B, n_pad] uint8). Invalid windows hold the kernels' garbage words."""
    _check_rows(squ, ksize)
    if squ.device.type == "cpu":
        return split_words_plain(squ, ksize=ksize)
    B, S = squ.shape
    _, _, n_pad = geometry(S, ksize)
    nw = n_words(ksize)
    words = torch.empty((B, n_pad, nw), dtype=torch.int64, device=squ.device)
    valid = torch.empty((B, n_pad), dtype=torch.uint8, device=squ.device)
    _launch("sp_split_words", squ.device, squ.data_ptr(), B, S, n_pad, ksize, nw,
            words.data_ptr(), valid.data_ptr())
    LAUNCHES["split_words"] += 1
    return words, valid


def split_words_plain(squ: torch.Tensor, *, ksize: int):
    "Plain PyTorch version of `split_words`, on squ's device."
    _check_rows(squ, ksize)
    ccol, valid = canonical_columns(squ, ksize)
    word = le64_words(ccol, ksize)
    nw = n_words(ksize)
    real = -(-ksize // 8)
    words = [word(i) for i in range(real)]
    words += [torch.zeros_like(words[0])] * (nw - real)
    return torch.stack(words, dim=-1), valid


# -- T2 pass B: murmur, threshold and compaction from the words -------------


def _check_words(words, valid, ksize: int):
    if not torch.is_tensor(words) or words.dtype != torch.int64 or words.dim() != 3:
        raise TypeError("expected words as a [B, n_pad, nw] torch.int64 tensor")
    if not torch.is_tensor(valid) or valid.dtype != torch.uint8 or valid.dim() != 2:
        raise TypeError("expected valid as a [B, n_pad] torch.uint8 tensor")
    B, n_pad, nw = words.shape
    if tuple(valid.shape) != (B, n_pad) or n_pad % SEG or nw != n_words(ksize):
        raise TypeError(f"words {tuple(words.shape)} and valid {tuple(valid.shape)} "
                        f"are not split_words' outputs for ksize={ksize}")
    if valid.device != words.device or not (words.is_contiguous() and valid.is_contiguous()):
        raise TypeError("words and valid must be contiguous, on one device")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")
    if B < 1 or B > 65535 or n_pad < SEG:
        raise TypeError(f"batch [{B}, {n_pad}] is out of the kernels' range")


def split_slots(words, valid, max_hash: int, *, ksize: int, seed: int = 42, slots: int = 8):
    """K1's outputs from `split_words`' outputs: per 128-window segment the
    first `slots` valid windows with hash <= max_hash and the TRUE count.

    Returns (slots_hi, slots_lo [B, R, slots] int32, counts [B, R] int32)
    as `cuda_sketch.survivor_slots` does."""
    _check_words(words, valid, ksize)
    check_slots(slots)
    if words.device.type == "cpu":
        return split_slots_plain(words, valid, max_hash, ksize=ksize, seed=seed, slots=slots)
    B, n_pad, nw = words.shape
    R = n_pad // SEG
    hi, lo, counts = slots_outputs(B, R, slots, words.device)
    _launch("sp_split_slots", words.device, words.data_ptr(), valid.data_ptr(), B, n_pad, R,
            ksize, nw, int(seed) & u64.MASK64, int(max_hash) & u64.MASK64, slots,
            hi.data_ptr(), lo.data_ptr(), counts.data_ptr())
    LAUNCHES["split_slots"] += 1
    return hi, lo, counts


def split_slots_plain(words, valid, max_hash: int, *, ksize: int, seed: int = 42,
                      slots: int = 8):
    "Plain PyTorch version of `split_slots`, on the words' device."
    _check_words(words, valid, ksize)
    hashes = murmur_words(lambda i: words[..., i], ksize, seed, valid)
    return slots_from_hashes(hashes, valid, max_hash, slots=slots)


# -- T3: K1 with a small live set --------------------------------------------


def survivor_slots_v2(squ: torch.Tensor, max_hash: int, *, ksize: int, seed: int = 42,
                      slots: int = 8):
    """`cuda_sketch.survivor_slots`' function, value for value, from the
    small-live-set kernel. Returns (slots_hi, slots_lo, counts) as it does."""
    _check_rows(squ, ksize)
    check_slots(slots)
    if squ.device.type == "cpu":
        return survivor_slots_v2_plain(squ, max_hash, ksize=ksize, seed=seed, slots=slots)
    B, S = squ.shape
    n, R, _ = geometry(S, ksize)
    hi, lo, counts = slots_outputs(B, R, slots, squ.device)
    _launch("sp_survivor_slots_v2", squ.device, squ.data_ptr(), B, S, n, R, ksize,
            int(seed) & u64.MASK64, int(max_hash) & u64.MASK64, slots,
            hi.data_ptr(), lo.data_ptr(), counts.data_ptr())
    LAUNCHES["survivor_slots_v2"] += 1
    return hi, lo, counts


def survivor_slots_v2_plain(squ: torch.Tensor, max_hash: int, *, ksize: int,
                            seed: int = 42, slots: int = 8):
    """Plain PyTorch version of `survivor_slots_v2`: the canonical words,
    then murmur, threshold and compaction (T2's plain passes)."""
    words, valid = split_words_plain(squ, ksize=ksize)
    return split_slots_plain(words, valid, max_hash, ksize=ksize, seed=seed, slots=slots)


# -- T4: microkernels over the tool's block layout ---------------------------


def _check_blocks(blocks, rows: int) -> int:
    "The number of blocks in `blocks`; raises on a malformed layout."
    if not torch.is_tensor(blocks) or blocks.dtype != torch.int32 or blocks.dim() != 2:
        raise TypeError("expected blocks as a [nblk * (rows + 8), 128] torch.int32 tensor")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {blocks.device}")
    if not blocks.is_contiguous():
        raise TypeError("blocks must be contiguous")
    brows = rows + EXTRA_ROWS
    if rows < 1 or blocks.shape[1] != LANES or blocks.shape[0] % brows:
        raise TypeError(f"blocks {tuple(blocks.shape)} are not whole blocks of {brows} rows")
    nblk = blocks.shape[0] // brows
    if nblk < 1 or nblk > 65535 or blocks.numel() >= 2**31:
        raise TypeError(f"{nblk} blocks of {brows} rows are out of the kernels' range")
    return nblk


def _block_values(blocks, rows: int):
    "[nblk, rows * 128] int64: the value each output element starts from."
    nblk = blocks.shape[0] // (rows + EXTRA_ROWS)
    x = blocks.view(nblk, rows + EXTRA_ROWS, LANES)[:, :rows].reshape(nblk, rows * LANES)
    return x.to(torch.int64) & u64.MASK32


def _as_output(x: torch.Tensor):
    "[nblk, rows * 128] int64 holding u32 values -> [nblk * rows, 128] int32 bit patterns."
    return u64.lo32(x).reshape(-1, LANES)


def _out(blocks, rows: int):
    nblk = blocks.shape[0] // (rows + EXTRA_ROWS)
    return torch.empty((nblk * rows, LANES), dtype=torch.int32, device=blocks.device)


def _check_aligned(blocks):
    "The kernels that read four values a load need the blocks 16-byte aligned."
    if blocks.data_ptr() % 16:
        raise TypeError("blocks must be 16-byte aligned")


def murmur_only(blocks, *, rows: int = 512):
    """Murmur alone: per element x, murmur (seed T4_SEED) of T4_KSIZE bytes
    given as the words (x ^ 2i) << 32 | (x ^ (2i + 1)), i = 0, 1, ...,
    unmasked; then hi ^ lo. The blocks must be 16-byte aligned, on the CPU
    too (the kernel reads four values a load)."""
    nblk = _check_blocks(blocks, rows)
    _check_aligned(blocks)
    if blocks.device.type == "cpu":
        return murmur_only_plain(blocks, rows=rows)
    out = _out(blocks, rows)
    _launch("sp_murmur_only", blocks.device, blocks.data_ptr(), nblk, rows, out.data_ptr())
    LAUNCHES["murmur_only"] += 1
    return out


def murmur_only_plain(blocks, *, rows: int = 512):
    """Plain PyTorch version of `murmur_only`: the JAX tool's
    murmur_words32 over fake word pairs (x ^ 2i, x ^ (2i + 1))."""
    _check_blocks(blocks, rows)
    x = _block_values(blocks, rows)

    def word(i):
        return ((x ^ (2 * i)) << 32) | (x ^ (2 * i + 1))

    h = murmur_words(word, T4_KSIZE, T4_SEED, x)
    return _as_output(u64.srl(h, 32) ^ (h & u64.MASK32))


def assembly_only(blocks, *, rows: int = 512):
    """The canonical gather alone: per element, the window of T4_KSIZE
    values (their low bytes) from it on, its canonical strand's 32-bit limbs
    XORed together, xor its validity (1 when every byte is ACGT)."""
    nblk = _check_blocks(blocks, rows)
    if blocks.device.type == "cpu":
        return assembly_only_plain(blocks, rows=rows)
    _check_aligned(blocks)
    out = _out(blocks, rows)
    _launch("sp_assembly_only", blocks.device, blocks.data_ptr(), nblk, rows, out.data_ptr())
    LAUNCHES["assembly_only"] += 1
    return out


def assembly_only_plain(blocks, *, rows: int = 512):
    "Plain PyTorch version of `assembly_only`, on the blocks' device."
    _check_blocks(blocks, rows)
    nblk = blocks.shape[0] // (rows + EXTRA_ROWS)
    squ = (blocks & 0xFF).to(torch.uint8).view(nblk, -1)
    words, valid = split_words_plain(squ, ksize=T4_KSIZE)
    x = words[:, : rows * LANES]
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc ^ x[..., i]
    folded = u64.srl(acc, 32) ^ (acc & u64.MASK32) ^ valid[:, : rows * LANES].to(torch.int64)
    return _as_output(folded)


def mulchain(blocks, n_rounds: int, *, rows: int = 512):
    """n_rounds of v = v * C1, v = rotl64(v, 31), v ^= v with its halves
    swapped, from v = x << 32 | (x ^ 1); then hi ^ lo. The output is 0 for
    every n_rounds >= 1 (1 for 0), as the JAX tool's is: the work is the
    measurement."""
    nblk = _check_blocks(blocks, rows)
    if n_rounds < 0:
        raise ValueError(f"n_rounds must be >= 0, not {n_rounds}")
    if blocks.device.type == "cpu":
        return mulchain_plain(blocks, n_rounds, rows=rows)
    _check_aligned(blocks)
    out = _out(blocks, rows)
    _launch("sp_mulchain", blocks.device, blocks.data_ptr(), nblk, rows, int(n_rounds),
            out.data_ptr())
    LAUNCHES["mulchain"] += 1
    return out


def mulchain_plain(blocks, n_rounds: int, *, rows: int = 512):
    "Plain PyTorch version of `mulchain`, on the blocks' device."
    _check_blocks(blocks, rows)
    x = _block_values(blocks, rows)
    v = (x << 32) | (x ^ 1)
    for _ in range(n_rounds):
        v = u64.rotl(u64.mul(v, C1), 31)
        v = v ^ u64.rotl(v, 32)
    return _as_output(u64.srl(v, 32) ^ (v & u64.MASK32))


# -- the integer-pipe probe ---------------------------------------------------


def int_probe(blocks, mode: str, n_rounds: int, *, rows: int = 512):
    """n_rounds rounds of `mode` (PROBE_MODES) on v = x << 32 | (x * PROBE_C
    mod 2^32) for each value x, then hi ^ lo. A round: mul64 v *= C1; mul32
    lo = lo * PROBE_C + hi and hi = hi * PROBE_C2 + lo (both from the
    round's start); alu v = rotl64(v, 31), then hi ^= lo; mix a mul64
    round, then an alu round. The blocks must be 16-byte aligned, on the
    CPU too."""
    nblk = _check_blocks(blocks, rows)
    if mode not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {mode!r}; expected one of {PROBE_MODES}")
    if n_rounds < 0:
        raise ValueError(f"n_rounds must be >= 0, not {n_rounds}")
    _check_aligned(blocks)
    if blocks.device.type == "cpu":
        return int_probe_plain(blocks, mode, n_rounds, rows=rows)
    out = _out(blocks, rows)
    _launch("sp_int_probe", blocks.device, blocks.data_ptr(), nblk, rows,
            PROBE_MODES.index(mode), int(n_rounds), out.data_ptr())
    LAUNCHES["int_probe"] += 1
    return out


def int_probe_plain(blocks, mode: str, n_rounds: int, *, rows: int = 512):
    "Plain PyTorch version of `int_probe`, on the blocks' device."
    _check_blocks(blocks, rows)
    hi = _block_values(blocks, rows)
    lo = u64.mul(hi, PROBE_C) & u64.MASK32
    for _ in range(n_rounds):
        if mode in ("mul64", "mix"):
            v = u64.mul((hi << 32) | lo, C1)
            hi, lo = u64.srl(v, 32), v & u64.MASK32
        if mode == "mul32":
            hi, lo = ((u64.mul(hi, PROBE_C2) + lo) & u64.MASK32,
                      (u64.mul(lo, PROBE_C) + hi) & u64.MASK32)
        if mode in ("alu", "mix"):
            v = u64.rotl((hi << 32) | lo, 31)
            lo = v & u64.MASK32
            hi = u64.srl(v, 32) ^ lo
    return _as_output(hi ^ lo)
