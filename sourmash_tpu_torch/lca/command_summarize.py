"""`sourmash lca summarize`: per-signature taxonomic breakdown.

Each query sketch's hashes are voted across the LCA databases; each
hash's LCA count is then propagated up to the root so every prefix of a
lineage reports the total weight beneath it (behavior parity: reference
`src/sourmash/lca/command_summarize.py`).
"""

from __future__ import annotations

import csv
from collections import defaultdict

from ..logging import debug, notify, print_results, set_quiet
from .. import sourmash_args
from . import lca_utils
from ._cmdutil import flatten, gather_query_paths, open_databases

DEFAULT_THRESHOLD = 5


def _hashval_weights(sig, scaled):
    "Hash → multiplicity for one sketch (abundances kept when tracked)."
    mh = sig.minhash.downsample(scaled=scaled)
    weights = defaultdict(int)
    if mh.track_abundance:
        for hashval, count in mh.hashes.items():
            weights[hashval] += count
    else:
        for hashval in mh.hashes:
            weights[hashval] += 1
    return weights


# kept under the reference's name for API familiarity
def count_signature(sig, scaled, hashvals):
    "Downsample sig to given scaled, count hash values (with abundance)."
    for hashval, count in _hashval_weights(sig, scaled).items():
        hashvals[hashval] += count


def summarize(hashvals, dblist, threshold, ignore_abundance):
    """Vote each hashval's LCA, then roll counts up the lineage prefixes.

    Returns {lineage_prefix: aggregated_count} for every prefix under
    which at least `threshold` weight landed.
    """
    assignments = lca_utils.gather_assignments(hashvals, dblist)
    weights = None if ignore_abundance else hashvals
    counts = lca_utils.count_lca_for_assignments(assignments, weights)
    debug(counts.most_common())

    rollup = defaultdict(int)
    for lca, count in counts.most_common():
        if count < threshold:
            break
        if not lca:
            rollup[lca] += count
        prefix = lca
        while prefix:
            rollup[prefix] += count
            prefix = prefix[:-1]

    debug(rollup)
    return rollup


def load_singletons_and_count(filenames, ksize, scaled, ignore_abundance):
    "Stream (filename, sig, hash-weights) for every sig in the inputs."
    n_sigs = 0
    for file_no, filename in enumerate(filenames, 1):
        idx = sourmash_args.load_file_as_index(filename).select(ksize=ksize)

        for query_sig, query_filename in idx.signatures_with_location():
            notify("\r\033[K", end="")
            notify(
                f"... loading {query_sig} (file {file_no} of {len(filenames)})",
                len(filenames),
                end="\r",
            )
            n_sigs += 1

            if ignore_abundance and query_sig.minhash.track_abundance:
                notify("NOTE: discarding abundances in query, since --ignore-abundance")

            yield query_filename, query_sig, _hashval_weights(query_sig, scaled)

    notify("\r\033[K", end="")
    notify(f"loaded {n_sigs} signatures from {len(filenames)} files total.")


class _SummaryReporter:
    "Console + optional-CSV emission of per-signature lineage counts."

    csv_columns = (
        ["count"]
        + list(lca_utils.taxlist())
        + ["filename", "sig_name", "sig_md5", "total_counts"]
    )

    def __init__(self, csv_fp):
        self.csv_fp = csv_fp
        self._wrote_header = False

    @staticmethod
    def _label(lineage):
        if not lineage:
            return "(root)"
        return ";".join(lca_utils.zip_lineage(lineage, truncate_empty=True))

    def emit(self, lineage_counts, total, filename, sig):
        for lineage, count in lineage_counts.items():
            p = f"{count / total * 100.0:.1f}%"
            print_results(
                f"{p:5} {count:>5}   {self._label(lineage)}   {filename}:{sig.md5sum()[:8]} {sig}"
            )

        if self.csv_fp is None:
            return
        w = csv.writer(self.csv_fp)
        if not self._wrote_header:
            w.writerow(self.csv_columns)
            self._wrote_header = True
        for lineage, count in lineage_counts.items():
            debug("lineage:", lineage)
            row = [count] + lca_utils.zip_lineage(lineage, truncate_empty=False)
            row += [filename, sig.name, sig.md5sum(), total]
            w.writerow(row)


def summarize_main(args):
    "Main summarization function."
    set_quiet(args.quiet, args.debug)
    args.query = flatten(args.query)

    dblist, ksize, scaled = open_databases(args, coerce_scaled=True)
    if args.ignore_abundance:
        notify(
            "Ignoring any k-mer abundances in query, since --ignore-abundance given."
        )

    query_paths = gather_query_paths(
        args,
        empty_check_first=True,
        missing_flag_msg="Error! must specify at least one query signature with --query",
    )

    csv_fp = open(args.output, "w", newline="") if args.output else None
    reporter = _SummaryReporter(csv_fp)

    try:
        singletons = load_singletons_and_count(
            query_paths, ksize, scaled, args.ignore_abundance
        )
        for filename, sig, hashvals in singletons:
            lineage_counts = summarize(
                hashvals, dblist, args.threshold, args.ignore_abundance
            )
            if args.ignore_abundance:
                total = float(len(hashvals))
            else:
                total = float(sum(hashvals.values()))
            reporter.emit(lineage_counts, total, filename, sig)
    finally:
        if csv_fp:
            csv_fp.close()
