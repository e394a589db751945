"""`sourmash lca rankinfo`: report, for each taxonomic rank, how many
hash values across the given LCA databases resolve their LCA at that rank
(behavior parity: reference `src/sourmash/lca/command_rankinfo.py`).
"""

from __future__ import annotations

import sys
from collections import Counter, defaultdict

from ..logging import debug, error, notify, set_quiet
from . import lca_utils


def _pooled_assignments(dblist, min_num):
    "Union every database's lineage assignments, keyed by hashval."
    pooled = defaultdict(set)
    for db in dblist:
        for hashval in db.hashvals:
            lineages = db.get_lineage_assignments(hashval, min_num=min_num)
            if lineages:
                pooled[hashval] |= set(lineages)
    return pooled


def make_lca_counts(dblist, min_num=0):
    "Tally, per LCA lineage, how many hashvals resolve to it."
    counts = Counter()
    for lineages in _pooled_assignments(dblist, min_num).values():
        debug(lineages)
        lca, _n = lca_utils.find_lca(lca_utils.build_tree(lineages))
        counts[lca] += 1
    return counts


def _rank_histogram(lineage_counts):
    "Collapse per-lineage counts into per-rank counts (keyed by last rank)."
    by_rank = Counter()
    for lineage, n in lineage_counts.items():
        if lineage:
            by_rank[lineage[-1].rank] += n
    return by_rank


def rankinfo_main(args):
    "rankinfo!"
    if not args.db:
        error("Error! must specify at least one LCA database with --db")
        sys.exit(-1)

    set_quiet(args.quiet, args.debug)
    if args.scaled:
        args.scaled = int(args.scaled)

    dblist, _ksize, _scaled = lca_utils.load_databases(args.db, args.scaled)
    by_rank = _rank_histogram(make_lca_counts(dblist, args.minimum_num))

    denom = float(sum(by_rank.values()))
    if not denom:
        notify("(no hashvals with lineages found)")
        return

    for rank in lca_utils.taxlist():
        n = by_rank.get(rank, 0)
        print(f"{rank}: {n} ({n / denom * 100.0:.1f}%)")
