"""The card's peaks and the least time a piece of work needs on it.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W
limit): 3.35 TB/s of HBM bandwidth; 132 SMs, each issuing 64 32-bit integer
ops a clock on the IMAD pipe and 64 on the ALU pipe. The integer rate is
taken at the card's maximum SM clock (`nvidia-smi clocks.max.sm`). A 64-bit
multiply by a constant takes IMAD_PER_MUL IMAD-pipe slots, and work on both
pipes costs the larger pipe's time (the integer-pipe probe's model). The
arithmetic is a frozen copy of `chip_smoke.py`'s `int_ops_murmur`,
`int_ops_per_window` and `bound_ms`, so a later change to that script does
not move this benchmark's yardstick.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
SMS = 132
LANES_PER_PIPE = 64
IMAD_PER_MUL = 4
H100_MAX_SM_HZ = 1.98e9  # the SXM part's maximum SM clock, where nvidia-smi cannot say


def int_ops_murmur(k: int, mul: int = IMAD_PER_MUL) -> tuple:
    """(IMAD, other, either) 32-bit integer operations of murmur (seed 42)
    over k bytes at least: IMAD-pipe slots (a 64-bit multiply by a constant
    as `mul`, h * 5 + c as 2 with its addend folded in), ALU-only ops (a
    64-bit rotate as two funnel shifts, a 64-bit xor as two LOP3s, fmix64's
    h ^= h >> 33 as one shift and one LOP3 on the low half) and 64-bit adds
    (2 each), which either pipe can take."""
    blocks, tail = divmod(k, 16)
    halves = 2 * blocks + (tail > 0) + (tail > 8)
    imad = 2 * mul * halves + 2 * 2 * blocks + 2 * 2 * mul
    other = 4 * halves + 2 * 2 * blocks + 2 * 3 * 2
    h1_xored, h2_xored = blocks > 0 or tail > 0, blocks > 0 or tail > 8
    other += -h1_xored - h2_xored + (blocks > 0 and tail == 0) + (blocks > 0 and tail <= 8)
    either = 2 * (2 * blocks - (blocks > 0)) + 2 * 2 + 2
    return imad, other, either


def int_ops_per_window(k: int) -> tuple:
    """(IMAD, other, either) integer operations one canonical DNA window
    hash needs at least: murmur, the canonical bytes assembled four to an
    op for each strand, validity tested four bytes to an op, and the strand
    choice."""
    imad, other, either = int_ops_murmur(k)
    return imad, other + 3 * -(-k // 4) + 2, either


def bound_s(nbytes: float, imad: float, other: float, either: float, clock_hz: float) -> tuple:
    """(seconds, "bytes" | "operations"): the least time for the work, bytes
    over the memory rate or integer ops over the two pipes' published rate,
    side by side (the IMAD pipe's slots, the ALU-only ops, or all of them
    with the ops either pipe can take spread over both)."""
    pipe = SMS * LANES_PER_PIPE * clock_hz
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(imad, other, (imad + other + either) / 2) / pipe
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi(query: str) -> str:
    "The first card's answer to `nvidia-smi --query-gpu=QUERY`, or '' where it cannot say."
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0].strip() if out.strip() else ""


def max_sm_clock_hz() -> float:
    "The card's maximum SM clock, as nvidia-smi reports it."
    got = nvidia_smi("clocks.max.sm")
    try:
        return float(got) * 1e6
    except ValueError:
        return H100_MAX_SM_HZ
