"""T4: component microkernels of the sketch kernel, on the card. What does
each part of K1 cost, and what is the card's 64-bit multiply rate?
Counterpart of `tools/profile_sketch_parts.py`.

    python -m sourmash_tpu_torch.tools.profile_sketch_parts [murmur] [assembly] [mulN ...]
                                                            [probe-MODE-N ...]

Variants, all over the JAX tool's blocks (8 x 32 blocks of 512 + 8 rows of
128 random values 0..255, one output per window of a block's 512 rows):
  murmur   - murmur alone, on fake words made from each value (no assembly)
  assembly - the canonical strand's words alone (no murmur), xor validity
  mulN     - N rounds of a 64-bit multiply, rotate and half-swap xor: the
             card's multiply rate (the output is 0 for N >= 1, the work is
             the measurement)
  probe-MODE-N - N rounds of the integer-pipe probe in MODE (mul64, mul32,
             alu or mix; `cuda_sketch_parts.int_probe`): one instruction
             kind's rate (chip_smoke.py reads the rates from the slope
             between two N)
Default: murmur assembly mul16. Each prints ms per batch and Mwindows/s.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import cuda_sketch_parts as csp
from . import _common as c

USAGE = ("usage: python -m sourmash_tpu_torch.tools.profile_sketch_parts "
         "[murmur] [assembly] [mulN ...] [probe-MODE-N ...] (MODE: "
         + ", ".join(csp.PROBE_MODES) + ")")
IMAD_PER_ROUND = 3  # v * C1 on 32-bit halves: a wide multiply-add and two multiply-adds


def variant(name: str):
    "(kernel fn of the blocks, printed name) of one variant; None if unknown."
    if name == "murmur":
        return (lambda xb: csp.murmur_only(xb, rows=c.ROWS), "murmur-only")
    if name == "assembly":
        return (lambda xb: csp.assembly_only(xb, rows=c.ROWS), "assembly-only")
    if name.startswith("mul") and name[3:].isdigit():
        n = int(name[3:])
        return (lambda xb: csp.mulchain(xb, n, rows=c.ROWS), f"mulchain-{n}")
    probe = probe_mode(name)
    if probe is not None:
        mode, n = probe
        return (lambda xb: csp.int_probe(xb, mode, n, rows=c.ROWS), f"probe-{mode}-{n}")
    return None


def probe_mode(name: str):
    "(mode, rounds) of a probe-MODE-N variant name; None for another name."
    parts = name.split("-")
    if len(parts) == 3 and parts[0] == "probe" and parts[1] in csp.PROBE_MODES \
            and parts[2].isdigit():
        return parts[1], int(parts[2])
    return None


def blocks_for(rng, dev):
    "The tool's input: [BATCH * nblocks * (ROWS + 8), 128] int32 of bytes 0..255."
    nblocks = (c.LENGTH - c.KSIZE + 1) // (c.ROWS * csp.LANES)
    shape = (c.BATCH * nblocks * (c.ROWS + csp.EXTRA_ROWS), csp.LANES)
    return c.random_bytes(rng, shape, dev, dtype=torch.int32)


def run(name: str, dev, blocks) -> float:
    "Time one variant over two input batches in turn; returns windows/s."
    fn, label = variant(name)
    fn(blocks[0])
    c.sync(dev)

    def reps():
        for i in range(c.REPS):
            fn(blocks[i % 2])

    per = c.best_seconds(reps, c.REPS, dev)
    n_windows = blocks[0].shape[0] // (c.ROWS + csp.EXTRA_ROWS) * c.ROWS * csp.LANES
    print(f"{label}: {per * 1e3:.4f} ms/batch -> {n_windows / per / 1e6:.0f} Mwindows/s",
          flush=True)
    return n_windows / per


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = c.parse_modes(argv, lambda m: variant(m) is not None,
                          ["murmur", "assembly", "mul16"], USAGE)
    dev = c.device()
    rng = np.random.default_rng(0)
    blocks = [blocks_for(rng, dev) for _ in range(2)]
    for name in which:
        rate = run(name, dev, blocks)
        if name.startswith("probe"):
            print(f"  -> {rate * probe_mode(name)[1] / 1e9:.1f} G probe rounds/s", flush=True)
        elif name.startswith("mul"):
            n = int(name[3:])
            print(f"  -> {rate * n / 1e9:.1f} G mul64 rounds/s, "
                  f"{rate * n * IMAD_PER_ROUND / 1e12:.2f} T IMAD/s at "
                  f"{IMAD_PER_ROUND} a round", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
