"""T2: K1 cut at the word boundary. Pass A (`split_words`) writes every
window's canonical words and validity to device memory, pass B
(`split_slots`) does murmur, the threshold and K1's slot compaction from
them. Counterpart of `tools/exp_split_kernel.py`; what the cut costs is
this tool's time against K1's (`profile_sketch_chain kernel`).

    python -m sourmash_tpu_torch.tools.exp_split_kernel [check|time]

`check` holds the two passes to K1 (`survivor_slots`) value for value,
`time` prints ms per batch and Mk/s; both at the JAX tool's shapes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import cuda_sketch as cs
from ..ops import cuda_sketch_parts as csp
from . import _common as c

USAGE = "usage: python -m sourmash_tpu_torch.tools.exp_split_kernel [check|time]"


def split_sketch(squ, max_hash: int, *, ksize: int = c.KSIZE, slots: int = c.SLOTS):
    "K1's outputs through the two passes."
    words, valid = csp.split_words(squ, ksize=ksize)
    return csp.split_slots(words, valid, max_hash, ksize=ksize, seed=c.SEED, slots=slots)


def check_against_k1(sketch, what: str, ref: str, dev):
    """Hold `sketch(rows, max_hash)` to K1 on seeded ACGT rows, every output
    equal, and print "<what> == <ref>: value-exact"; raises AssertionError
    on the first difference."""
    rows = c.acgt_rows(np.random.default_rng(0), c.BATCH, c.LENGTH, dev)
    got = sketch(rows, c.MAX_HASH)
    want = cs.survivor_slots(rows, c.MAX_HASH, ksize=c.KSIZE, seed=c.SEED, slots=c.SLOTS)
    for g, w, name in zip(got, want, ("hi", "lo", "cnt")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} differs from K1")
    print(f"{what} == {ref}: value-exact", flush=True)


def time_sketch(sketch, what: str, dev) -> float:
    """ms per batch of `sketch` over two seeded batches and eight cutoffs in
    turn, as the JAX tools time; prints it with Mk/s and returns it."""
    rng = np.random.default_rng(0)
    batches = [c.acgt_rows(rng, c.BATCH, c.LENGTH, dev) for _ in range(2)]
    mhs = [c.MAX_HASH - i for i in range(8)]
    sketch(batches[0], mhs[0])
    c.sync(dev)

    def run():
        for i in range(c.REPS):
            sketch(batches[i % 2], mhs[i % 8])

    per = c.best_seconds(run, c.REPS, dev)
    n_windows = c.BATCH * (c.LENGTH - c.KSIZE + 1)
    print(f"{what} slots={c.SLOTS}: {per * 1e3:.4f} ms/batch -> "
          f"{n_windows / per / 1e6:.0f} Mk/s", flush=True)
    return per * 1e3


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    (mode,) = c.parse_modes(argv[:1], lambda m: m in ("check", "time"), ["time"], USAGE)
    dev = c.device()
    if mode == "check":
        check_against_k1(split_sketch, "split", "fused", dev)
    else:
        time_sketch(split_sketch, "split", dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
