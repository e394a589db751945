"""sketch_kernels_roofline_pct: the least time the card needs for the
window's sketching over the summed time of every CUDA kernel in the traced
window (copies and memsets left out), in %.

The work comes from the inputs alone: every base read once for each k,
each kept hash written once (8 bytes; the valid windows times
max_hash / 2^64), and each valid window's canonical murmur at its least
integer-op count (`peaks.int_ops_per_window`). The least time is the larger
of bytes over the HBM rate and the ops over the two integer pipes' rate at
the card's maximum SM clock."""

from perfbench.lib import peaks
from perfbench.reference.sketch import max_hash_for_scaled


def read(run):
    t = run.trace
    if t is None or t.kernels_s <= 0:
        return None
    c = run.counters
    ks = c["ks"]
    keep = max_hash_for_scaled(c["scaled"]) / 2.0**64
    nbytes = c["bases"] * len(ks) + sum(8 * keep * c[f"windows_k{k}"] for k in ks)
    imad = other = either = 0.0
    for k in ks:
        i, o, e = peaks.int_ops_per_window(k)
        w = c[f"windows_k{k}"]
        imad, other, either = imad + i * w, other + o * w, either + e * w
    least, _ = peaks.bound_s(nbytes, imad, other, either, run.clock_hz)
    return 100.0 * least / t.kernels_s
