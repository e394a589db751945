"""sketch_mbp_per_s: Mbp of input sequence sketched in the window (every
request, the one in flight at the close included) over the time from the
window's start to the last completion."""


def read(run):
    return sum(run.work) / run.window_s
