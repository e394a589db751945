"""sketch_parse_ms_per_gbp: host ms inside the iteration of
`sequence_io.iter_record_batches` (reading, decompressing and joining the
records; the `parse` span of the sketch entry) a Gbp sketched."""


def read(run):
    t = run.spans.totals.get("parse")
    gbp = sum(run.work) / 1e3
    return None if t is None or not gbp else t * 1e3 / gbp
