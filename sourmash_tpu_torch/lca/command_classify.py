"""`sourmash lca classify`: assign each query signature the deepest
taxonomic lineage its hash content supports, by LCA voting across one or
more LCA databases (behavior parity: reference
`src/sourmash/lca/command_classify.py`).
"""

from __future__ import annotations

import csv
import sys

from .. import sourmash_args
from ..logging import debug, error, notify, set_quiet
from ..sourmash_args import load_file_as_signatures
from . import lca_utils
from ._cmdutil import flatten, gather_query_paths, open_databases

DEFAULT_THRESHOLD = 5  # min per-lineage vote count


def _vote_tree(counts, threshold, majority):
    """Build the LCA prefix tree over the "significant" lineage votes.

    Default: every lineage with at least `threshold` votes participates.
    With `majority`, only the single top vote participates (and only if it
    clears the threshold strictly).
    """
    tree = {}
    ranked = counts.most_common()
    if majority:
        if ranked:
            winner, votes = ranked[0]
            if votes > threshold:
                lca_utils.build_tree([winner], tree)
    else:
        for lineage, votes in ranked:
            if votes < threshold:
                break
            lca_utils.build_tree([lineage], tree)
    return tree


def classify_signature(query_sig, dblist, threshold, majority):
    """Classify one signature; returns (lineage, status).

    Status is 'nomatch' (no significant votes), 'found' (votes agree on a
    single path), or 'disagree' (the tree forks).
    """
    assignments = lca_utils.gather_assignments(query_sig.minhash.hashes, dblist)
    counts = lca_utils.count_lca_for_assignments(assignments)
    debug(counts.most_common())

    tree = _vote_tree(counts, threshold, majority)
    if not tree:
        return [], "nomatch"

    lineage, forks = lca_utils.find_lca(tree)
    if forks:
        debug("MULTI", lineage)
        status = "disagree"
    else:
        debug("END", lineage)
        status = "found"
    debug("lineage is:", lineage)
    return lineage, status


def _at_db_scaled(query_sig, scaled):
    "Downsample the query in place if it disagrees with the database scaled."
    if query_sig.minhash.scaled != scaled:
        with query_sig.update() as query_sig:
            query_sig.minhash = query_sig.minhash.downsample(scaled=scaled)
    return query_sig


def classify(args):
    "Main single-genome classification function."
    if not args.db:
        error("Error! must specify at least one LCA database with --db")
        sys.exit(-1)

    set_quiet(args.quiet, args.debug)
    args.query = flatten(args.query)

    dblist, ksize, scaled = open_databases(args)
    query_paths = gather_query_paths(
        args,
        empty_check_first=False,
        missing_flag_msg=(
            "Error! must specify at least one query signature with"
            " --query or --query-from-file"
        ),
    )

    notify(f"outputting classifications to {args.output}")
    with sourmash_args.FileOutputCSV(args.output) as outfp:
        out = csv.writer(outfp)
        out.writerow(["ID", "status"] + list(lca_utils.taxlist()))

        n_classified = 0
        for file_no, path in enumerate(query_paths, 1):
            for query_sig in load_file_as_signatures(path, ksize=ksize):
                notify("\r\033[K", end="")
                notify(
                    f"... classifying {query_sig} (file {file_no} of {len(query_paths)})",
                    end="\r",
                )
                debug("classifying", query_sig)
                n_classified += 1

                query_sig = _at_db_scaled(query_sig, scaled)
                lineage, status = classify_signature(
                    query_sig, dblist, args.threshold, args.majority
                )
                debug(lineage)

                if not args.output:  # keep stdout rows intelligible
                    notify("\r\033[K", end="")
                out.writerow(
                    [str(query_sig), status] + lca_utils.zip_lineage(lineage)
                )

        notify("\r\033[K", end="")
        notify(f"classified {n_classified} signatures total")
