"""Command-line utility layer, as far as `sketch dna` needs it: parameter
bounds checks and the --from-file path list. Counterpart of
`sourmash_tpu/sourmash_args.py` (check_scaled_bounds :49,
check_num_bounds :54, load_pathlist_from_file :355)."""

from __future__ import annotations

import argparse
import os

from .logging import notify
from .save_load import SaveSignaturesToLocation  # noqa: F401  (re-export)


def _bounded_arg(value, *, what, low, high, low_warn, high_warn):
    "Validate a sketch-parameter argument, warning outside the sane range."
    if value < 0:
        raise argparse.ArgumentTypeError(f"ERROR: {what} value must be positive")
    if value < low:
        notify(f"WARNING: {what} value should be >= {low_warn}. Continuing anyway.")
    if value > high:
        notify(f"WARNING: {what} value should be <= {high_warn}. Continuing anyway.")
    return value


def check_scaled_bounds(arg):
    return _bounded_arg(float(arg), what="scaled", low=100, high=1e6,
                        low_warn="100", high_warn="1e6")


def check_num_bounds(arg):
    return _bounded_arg(int(arg), what="num", low=50, high=50000,
                        low_warn="50", high_warn="50000")


def load_pathlist_from_file(filename):
    "Load a list-of-files text file; every listed path must exist."
    try:
        with open(filename) as fp:
            paths = {line.rstrip("\r\n") for line in fp}
    except OSError:
        raise ValueError(f"pathlist file '{filename}' does not exist")
    except UnicodeDecodeError:
        raise ValueError(f"cannot parse file '{filename}' as list of filenames")

    if not paths:
        raise ValueError("pathlist is empty")
    for checkfile in paths:
        if not os.path.exists(checkfile):
            raise ValueError(f"file '{checkfile}' inside the pathlist does not exist")
    return paths
