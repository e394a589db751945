"""Shared plumbing for the `sourmash lca` command drivers.

Every lca command repeats the same preamble — require/flatten `--db`,
verify files, load the databases at a common scaled, and gather query
paths.  These helpers centralize that so each driver holds only its own
algorithm.
"""

from __future__ import annotations

import sys

from .. import sourmash_args
from ..logging import error, notify
from . import lca_utils
from .lca_utils import check_files_exist


def flatten(nested):
    "Flatten argparse's list-of-lists for repeated flag values."
    return [item for group in nested for item in group]


def open_databases(args, *, coerce_scaled=False):
    """Validate `--db`, flatten it, and load every database.

    Returns (dblist, ksize, scaled).  Exits with -1 on a missing flag or
    missing files, matching the reference CLI behavior.
    """
    if not args.db:
        error("Error! must specify at least one LCA database with --db")
        sys.exit(-1)

    if coerce_scaled and args.scaled:
        args.scaled = int(args.scaled)

    args.db = flatten(args.db)
    if not check_files_exist(*args.db):
        sys.exit(-1)

    return lca_utils.load_databases(args.db, args.scaled)


def gather_query_paths(args, *, empty_check_first, missing_flag_msg):
    """Collect query paths from positionals plus `--query-from-file`.

    `empty_check_first` selects which validation fires first (the lca
    commands disagree on the order); `missing_flag_msg` is the error shown
    when no queries were given.
    """
    notify("finding query signatures...")
    paths = list(args.query)
    if args.query_from_file:
        paths += sourmash_args.load_pathlist_from_file(args.query_from_file)

    checks = [
        (lambda: bool(paths), lambda: error(missing_flag_msg)),
        (lambda: check_files_exist(*paths), lambda: None),
    ]
    if not empty_check_first:
        checks.reverse()
    for ok, report in checks:
        if not ok():
            report()
            sys.exit(-1)
    return paths
