"""setup_s: seconds from the start of the run's process to the end of the
warm-up (imports, CUDA initialisation, kernel builds or loads, inputs,
the collection's banks, one request of the cell's shapes)."""


def read(run):
    return run.setup_s
