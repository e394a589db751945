"""device_idle_pct: the share of the traced window in which no operation
ran on the card (100 less the union of kernels, copies and memsets), in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
