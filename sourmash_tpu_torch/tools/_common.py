"""Shapes, inputs and timing shared by the instruments (see __init__)."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import resolve_device

KSIZE, SEED, SLOTS = 31, 42, 4
BATCH = 8
LENGTH = (1 << 21) + KSIZE - 1  # 2^21 windows a row
ROWS = 512  # T4 block rows (the JAX kernels' DEFAULT_ROWS); + 8 lookahead rows
REPS = 24
MAX_HASH = (2**64 - 1) // 1000


def device() -> torch.device:
    "The device the tool runs on (ops.resolve_device); prints which."
    dev = resolve_device()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU (plain versions)"
    print(f"device: {name}", flush=True)
    return dev


def acgt_rows(rng, B: int, S: int, dev) -> torch.Tensor:
    "[B, S] uint8 rows of uniform ACGT, as the JAX tools draw them."
    rows = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(B, S))
    return torch.from_numpy(rows).to(dev)


def random_bytes(rng, shape, dev, dtype=torch.uint8) -> torch.Tensor:
    "Uniform bytes 0..255 in a tensor of `dtype`: nearly every window invalid."
    return torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.int32)).to(dev, dtype)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_seconds(run, calls: int, dev, rounds: int = 2) -> float:
    """Seconds per call: `run()` makes `calls` calls back to back; the best
    of `rounds` runs, by CUDA events on the card, the host clock on the CPU."""
    best = float("inf")
    for _ in range(rounds):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best / calls


def parse_modes(argv, allowed, default, usage: str) -> list:
    "The modes named on the command line (default if none); exits on others."
    modes = list(argv) or list(default)
    for m in modes:
        if not allowed(m):
            raise SystemExit(f"unknown mode {m!r}\n{usage}")
    return modes
