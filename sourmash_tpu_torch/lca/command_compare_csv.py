"""`sourmash lca compare_csv`: diff two taxonomy spreadsheets.

For every identifier present in both sheets, the two lineages are folded
into one LCA tree: a clean leaf means one lineage nests inside the other
(compatible); a fork means a genuine disagreement, tallied by the rank it
occurs at (behavior parity: reference
`src/sourmash/lca/command_compare_csv.py`).
"""

from __future__ import annotations

import sys
from collections import Counter

from ..logging import error, notify, print_results, set_quiet
from . import lca_utils
from .command_index import load_taxonomy_assignments
from .lca_utils import zip_lineage

_AGREE, _COMPATIBLE, _INCOMPATIBLE = range(3)


def _load_and_report(label, **load_kwargs):
    "Load one taxonomy spreadsheet, reporting its lineage/row counts."
    notify(f"loading {label}")
    assignments, num_rows = load_taxonomy_assignments(**load_kwargs)
    notify(
        f"loaded {len(set(assignments.values()))} distinct lineages, {num_rows} rows"
    )
    return assignments


def _report_missing(in_classify, in_custom):
    "Note identifiers present in only one of the two spreadsheets."
    classify_only = in_classify - in_custom
    custom_only = in_custom - in_classify
    if custom_only:
        notify(f"missing {len(custom_only)} assignments in classify spreadsheet.")
    if classify_only:
        notify(f"missing {len(classify_only)} assignments in custom spreadsheet.")
    if classify_only or custom_only:
        notify("(these will not be evaluated any further)")
    else:
        notify("note: all IDs are in both spreadsheets!")


def _judge_pair(lin_a, lin_b):
    "Merge two differing lineages; return (_COMPATIBLE/_INCOMPATIBLE, lca)."
    tree = lca_utils.build_tree([lin_a])
    lca_utils.build_tree([lin_b], tree)
    lca, forks = lca_utils.find_lca(tree)
    return (_INCOMPATIBLE if forks else _COMPATIBLE), lca


def compare_csv(args):
    if args.start_column < 2:
        error("error, --start-column cannot be less than 2")
        sys.exit(-1)

    set_quiet(args.quiet, args.debug)

    classify_assign = _load_and_report(
        f"classify output from: {args.csv1}",
        filename=args.csv1,
        start_column=3,
        force=args.force,
    )
    notify("----")
    custom_assign = _load_and_report(
        f"custom spreadsheet from: {args.csv2}",
        filename=args.csv2,
        delimiter="\t" if args.tabs else ",",
        start_column=args.start_column,
        use_headers=not args.no_headers,
        force=args.force,
    )

    _report_missing(set(classify_assign), set(custom_assign))
    shared = set(classify_assign) & set(custom_assign)

    verdicts = Counter()
    incompat_rank = Counter()
    top_rank = next(iter(lca_utils.taxlist()))

    for ident in shared:
        a, b = classify_assign[ident], custom_assign[ident]
        if a == b:
            verdicts[_AGREE] += 1
            continue

        verdict, lca = _judge_pair(a, b)
        verdicts[verdict] += 1
        if verdict == _COMPATIBLE:
            print_results("{},compatible,{}", ident, ";".join(zip_lineage(lca)))
        else:
            print_results("{},incompatible,{}", ident, ";".join(zip_lineage(lca)))
            incompat_rank[lca[-1].rank if lca else top_rank] += 1

    n_differ = verdicts[_COMPATIBLE] + verdicts[_INCOMPATIBLE]
    notify(f"{len(shared)} total assignments, {n_differ} differ between spreadsheets.")
    notify(f"{verdicts[_COMPATIBLE]} are compatible (one lineage is ancestor of another.")
    notify(f"{verdicts[_INCOMPATIBLE]} are incompatible (there is a disagreement in the trees).")

    if verdicts[_INCOMPATIBLE]:
        for rank in lca_utils.taxlist():
            notify(f"{incompat_rank[rank]} incompatible at rank {rank}")
