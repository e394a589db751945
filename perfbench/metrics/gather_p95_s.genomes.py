"""gather_p95_s.genomes: the 95th percentile of the window's gather latencies, each
from the query's start to its last row, in seconds (read in the traced run, so with the
profiler's cost in it)."""


def read(run):
    return run.quantile(0.95) if run.latencies else None
