"""gather_queries_per_s: gather queries answered in the window (the one in
flight at the close included) over the time from the window's start to the
last answer."""


def read(run):
    return sum(run.work) / run.window_s
