"""T3: K1 with a small live set (`survivor_slots_v2`). On K1's DNA tile,
each thread finishes one window (strand and validity from the tile's bit
planes, then murmur of a valid window) before it starts the next, so one
murmur chain is live where K1 interleaves four. Counterpart of
`tools/exp_v2_kernel.py`; a candidate redesign of K1, held to it value
for value.

    python -m sourmash_tpu_torch.tools.exp_v2_kernel [check|time]

`check` holds it to K1 (`survivor_slots`), `time` prints ms per batch and
Mk/s; both at the JAX tool's shapes.
"""

from __future__ import annotations

import sys

from ..ops import cuda_sketch_parts as csp
from . import _common as c
from .exp_split_kernel import check_against_k1, time_sketch

USAGE = "usage: python -m sourmash_tpu_torch.tools.exp_v2_kernel [check|time]"


def v2_sketch(squ, max_hash: int, *, ksize: int = c.KSIZE, slots: int = c.SLOTS):
    return csp.survivor_slots_v2(squ, max_hash, ksize=ksize, seed=c.SEED, slots=slots)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    (mode,) = c.parse_modes(argv[:1], lambda m: m in ("check", "time"), ["time"], USAGE)
    dev = c.device()
    if mode == "check":
        check_against_k1(v2_sketch, "v2", "production", dev)
    else:
        time_sketch(v2_sketch, "v2", dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
