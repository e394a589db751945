#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the CUDA card of this machine.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the result as the last line of standard output (one JSON object)
and the numbers the correctness check compared, each beside its limit, as
the last lines of standard error. Exits with another code than 0, and
prints no result, where it cannot measure: no card, too few cards, no
program beside it, or a forbidden module loaded.
"""

import os
import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.lib.harness import main

    sys.exit(main(t0=T0))
