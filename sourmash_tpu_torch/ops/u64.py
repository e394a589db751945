"""Unsigned 64-bit hashes as int64 bit patterns in torch.

torch's uint64 dtype lacks `<`, `<<`, `>>`, `+` and `searchsorted`, so
the port keeps every hash in an int64 tensor holding the same 64 bits:

- numpy uint64 <-> torch int64 by `.view`, never by value conversion;
- unsigned order is signed order after flipping the top bit (`x ^ INT64_MIN`),
  which the threshold `hash <= max_hash` and every sort use;
- a logical right shift is an arithmetic shift plus a mask;
- +, -, * and << wrap modulo 2^64 in two's complement, which is the unsigned
  result's bit pattern.

Python ints given as operands are unsigned values in [0, 2^64) and are
mapped to their int64 bit pattern first.
"""

from __future__ import annotations

import numpy as np
import torch

INT64_MIN = -(1 << 63)
MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1


def signed(v: int) -> int:
    "The int64 bit pattern of an unsigned 64-bit value, as a Python int."
    v = int(v) & MASK64
    return v - (1 << 64) if v >> 63 else v


def from_numpy(a: np.ndarray) -> torch.Tensor:
    "numpy uint64 array -> int64 tensor with the same bits (a view)."
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return torch.from_numpy(a.view(np.int64))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    "int64 tensor (any device) -> numpy uint64 array with the same bits."
    if t.dtype != torch.int64:
        raise TypeError(f"expected int64 bit patterns, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def _operand(v):
    return signed(v) if isinstance(v, (int, np.integer)) else v


def flip(x: torch.Tensor) -> torch.Tensor:
    "Map unsigned order onto signed order (an involution)."
    return x ^ INT64_MIN


def _flipped(v):
    return flip(v) if torch.is_tensor(v) else signed(v) ^ INT64_MIN


def le(a, b) -> torch.Tensor:
    "Unsigned a <= b (tensors or Python ints)."
    return _flipped(a) <= _flipped(b)


def srl(x: torch.Tensor, r: int) -> torch.Tensor:
    "Logical right shift by r in [1, 63]."
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    "Rotate left by r in [1, 63]."
    return (x << r) | srl(x, 64 - r)


def mul(x: torch.Tensor, c) -> torch.Tensor:
    "x * c modulo 2^64."
    return x * _operand(c)


def sort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    "Values sorted in unsigned order."
    return flip(torch.sort(flip(x), dim=dim).values)


def lo32(x: torch.Tensor) -> torch.Tensor:
    "Low 32 bits of each value, as an int32 bit pattern."
    return ((((x & MASK32) + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def hi32(x: torch.Tensor) -> torch.Tensor:
    "High 32 bits of each value, as an int32 bit pattern."
    return lo32(srl(x, 32))


def join32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    "int32 bit-pattern halves -> int64 values (hi << 32 | lo)."
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & MASK32)
