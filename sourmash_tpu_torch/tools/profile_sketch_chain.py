"""T5: chained timing of K1 on the card. Every step's input depends on the
previous step's output (one output element XORed back into the rows), so
no step can be skipped or served from a cache; one readback closes the
chain. Counterpart of `tools/profile_sketch_chain.py`.

    python -m sourmash_tpu_torch.tools.profile_sketch_chain [full] [kernel] [gatheronly]

Variants (default: all three):
  full       - the port's K1 step, `survivor_slots` on [8, 2^21 + 30] ACGT
               rows (it allocates its outputs), then the perturbation
  kernel     - the bare K1 launch into preallocated outputs, on rows of
               random bytes 0..255, then the perturbation
  gatheronly - the step between byte rows and K1's launch: the port has
               none to time (the tool says so)
The JAX tool's rowsN (a sweep of the kernel's rows per grid step) has no
counterpart: K1's tile is the compile-time kK1Tile of
`csrc/sketch.cu`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import cuda_sketch as cs
from . import _common as c

USAGE = ("usage: python -m sourmash_tpu_torch.tools.profile_sketch_chain "
         "[full] [kernel] [gatheronly]")
N_WINDOWS = c.BATCH * (c.LENGTH - c.KSIZE + 1)
NO_GATHER = ("gather only: the port has no layout step between byte rows and K1's "
             "launch (K1 stages each 1024-window tile and its k-1 halo in shared memory "
             "itself: csrc/sketch.cu:survivor_slots_kernel); nothing to time")


def step_full(x, max_hash: int = c.MAX_HASH):
    "K1 on x, then x with the first count's low two bits XORed into every byte."
    _hi, _lo, cnt = cs.survivor_slots(x, max_hash, ksize=c.KSIZE, seed=c.SEED, slots=c.SLOTS)
    return x ^ (cnt[0, 0] & 3).to(torch.uint8), cnt


def kernel_step(out, max_hash: int = c.MAX_HASH):
    "The bare K1 launch into `out`, then the first slot's low byte XORed in."

    def step(x):
        cs.survivor_slots(x, max_hash, ksize=c.KSIZE, seed=c.SEED, slots=c.SLOTS, out=out)
        return x ^ out[0][0, 0, 0].to(torch.uint8), out[2]

    return step


def measure(step, x0, dev) -> float:
    "Seconds per chained step from x0, best of 2 chains of 24."
    _x, probe = step(x0)
    c.sync(dev)

    def chain():
        x = x0
        for _ in range(c.REPS):
            x, probe = step(x)
        return probe

    return c.best_seconds(chain, c.REPS, dev)


def _refuse_rows(mode: str) -> bool:
    if mode.startswith("rows"):
        raise SystemExit(f"{mode}: no counterpart in the port. K1's tile is the "
                         "compile-time kK1Tile (csrc/sketch.cu), not a rows "
                         f"argument, so there is no rows sweep.\n{USAGE}")
    return mode in ("full", "kernel", "gatheronly")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = c.parse_modes(argv, _refuse_rows, ["full", "kernel", "gatheronly"], USAGE)
    dev = c.device()
    rng = np.random.default_rng(0)
    if "full" in which:
        t = measure(step_full, c.acgt_rows(rng, c.BATCH, c.LENGTH, dev), dev)
        print(f"full (survivor_slots): {t * 1e3:.4f} ms -> {N_WINDOWS / t / 1e6:.0f} Mk/s",
              flush=True)
    if "gatheronly" in which:
        print(NO_GATHER, flush=True)
    if "kernel" in which:
        b0 = c.random_bytes(rng, (c.BATCH, c.LENGTH), dev)
        _n, R, _ = cs.geometry(c.LENGTH, c.KSIZE)
        out = cs.slots_outputs(c.BATCH, R, c.SLOTS, dev)
        t = measure(kernel_step(out), b0, dev)
        print(f"kernel only (slots={c.SLOTS}): {t * 1e3:.4f} ms -> "
              f"{N_WINDOWS / t / 1e6:.0f} Mk/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
