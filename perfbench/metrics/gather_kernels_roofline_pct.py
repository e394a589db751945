"""gather_kernels_roofline_pct: the least time the card needs for the
window's gathers over the summed time of every CUDA kernel in the traced
window (copies and memsets left out), in %.

The work comes from the inputs alone: each query reads every hash of the
collection and of itself once (8 bytes each) and writes one 4-byte count a
member; the least time is those bytes over the HBM rate."""

from perfbench.lib import peaks


def read(run):
    t = run.trace
    if t is None or t.kernels_s <= 0:
        return None
    c = run.counters
    nbytes = 8 * (c["collection_hashes"] + c["query_hashes"]) + 4 * c["members"]
    least, _ = peaks.bound_s(nbytes, 0, 0, 0, run.clock_hz)
    return 100.0 * least / t.kernels_s
