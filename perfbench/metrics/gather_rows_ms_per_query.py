"""gather_rows_ms_per_query: host ms in the gather entry's `rows` span
(see perfbench/entries/gather.py) a query answered in the window."""


def read(run):
    t = run.spans.totals.get("rows")
    n = sum(run.work)
    return None if t is None or not n else t * 1e3 / n
