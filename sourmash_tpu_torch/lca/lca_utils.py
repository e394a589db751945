"""Lowest-common-ancestor primitives shared by the lca and tax commands.

A lineage is a tuple of (rank, name) pairs ordered by `RANKS`.  The LCA of
a set of lineages is computed by folding them into a prefix tree
(`build_tree`) and walking down while exactly one child exists
(`find_lca`).  Parity surface: reference `src/sourmash/lca/lca_utils.py`.
"""

from __future__ import annotations

from collections import Counter, defaultdict, namedtuple
from itertools import zip_longest
from os.path import exists

from ..logging import error
from .lca_db import LCA_Database, load_databases, load_single_database  # noqa: F401

__all__ = [
    "taxlist", "zip_lineage", "build_tree", "find_lca",
    "load_single_database", "load_databases", "gather_assignments",
    "count_lca_for_assignments", "LineagePair", "display_lineage",
    "make_lineage", "pop_to_rank", "is_lineage_match",
]

# the eight standard ranks, most-general first
RANKS = (
    "superkingdom", "phylum", "class", "order",
    "family", "genus", "species", "strain",
)

# one cell of a lineage
LineagePair = namedtuple("LineagePair", ["rank", "name"])

_EMPTY = LineagePair(None, "")

# spreadsheet cell values that mean "no assignment"
null_names = set(["[Blank]", "na", "null"])


def taxlist(include_strain=True):
    "Provide an ordered list of taxonomic ranks."
    return iter(RANKS if include_strain else RANKS[:-1])


def check_files_exist(*files):
    missing = [f for f in files if not exists(f)]
    if missing:
        listing = "\n".join(missing)
        error(
            "Error! Could not find the following files."
            f" Make sure the file paths are specified correctly.\n{listing}"
        )
    return not missing


def zip_lineage(lineage, include_strain=True, truncate_empty=False):
    """Expand a lineage into one name per standard rank.

    Pads with empty strings; validates that each pair sits at its
    expected rank.

    >>> x = [ LineagePair('superkingdom', 'a'), LineagePair('phylum', 'b') ]
    >>> zip_lineage(x)
    ['a', 'b', '', '', '', '', '', '']
    """
    ranks = taxlist(include_strain=include_strain)
    cells = list(zip_longest(ranks, lineage, fillvalue=_EMPTY))

    if truncate_empty:
        while cells and cells[-1][1] == _EMPTY:
            del cells[-1]

    names = []
    for expected_rank, pair in cells:
        if pair != _EMPTY and pair.rank != expected_rank:
            raise ValueError(
                f"incomplete lineage at {expected_rank} - is {pair.rank} instead"
            )
        names.append(pair.name)
    return names


def display_lineage(lineage, include_strain=True, truncate_empty=True):
    names = zip_lineage(lineage, include_strain, truncate_empty=truncate_empty)
    return ";".join(names)


def filter_null(x):
    "Replace blank/na/null cells with 'unassigned'."
    if x is None or x.strip() in ("[Blank]", "na", "null", ""):
        return "unassigned"
    return x


def build_tree(assignments, initial=None):
    """Fold lineages into a nested-dict prefix tree keyed by LineagePair.

    The resulting tree is what `find_lca` walks to locate agreement or
    confusion among the assignments.
    """
    if not assignments:
        raise ValueError("empty assignment passed to build_tree")

    tree = initial if initial is not None else {}
    for lineage in assignments:
        node = tree
        for pair in lineage:
            if pair.name:
                node = node.setdefault(pair, {})
    return tree


def find_lca(tree):
    """Walk a prefix tree to the deepest unanimous node.

    Returns (lineage_tuple, n_children_at_stop): 0 children means a clean
    leaf, >1 means the assignments diverge there.
    """
    path = []
    node = tree
    while len(node) == 1:
        (pair, node), = node.items()
        path.append(pair)
    return tuple(path), len(node)


def gather_assignments(hashvals, dblist):
    "Collect each hashval's lineage assignments across all databases."
    found = defaultdict(set)
    for hashval in hashvals:
        for db in dblist:
            lineages = db.get_lineage_assignments(hashval)
            if lineages:
                found[hashval].update(lineages)
    return found


def count_lca_for_assignments(assignments, hashval_counts=None):
    """Resolve each hashval's assignments to an LCA and tally them.

    With `hashval_counts`, each LCA is weighted by its hashval's count;
    otherwise every hashval contributes 1.
    """
    tally = Counter()
    for hashval, lineages in assignments.items():
        lca, _n_children = find_lca(build_tree(lineages))
        tally[lca] += hashval_counts[hashval] if hashval_counts else 1
    return tally


def is_lineage_match(lin_a, lin_b, rank):
    "1 if the two lineages agree at every rank down to `rank`, else 0."
    for a, b in zip(lin_a, lin_b):
        assert a.rank == b.rank
        if a != b:
            return 0
        if a.rank == rank:  # agreed all the way down
            return 1
    return 0


def pop_to_rank(lin, rank):
    "Truncate a lineage so its last pair sits at `rank` (no-op if above)."
    kept = list(lin)
    shallower = RANKS[: RANKS.index(rank)] if rank in RANKS else ()

    already_above = kept and kept[-1].rank in shallower
    if not already_above:
        while kept and kept[-1].rank != rank:
            kept.pop()
    return tuple(kept)


def make_lineage(lineage):
    "Parse a ';'- or ','-separated lineage string into LineagePairs."
    from ..tax.tax_utils import LineagePair as TaxLineagePair

    names = lineage.split(";")
    if len(names) == 1:
        names = lineage.split(",")
    return tuple(
        TaxLineagePair(rank, name) for rank, name in zip(taxlist(), names)
    )
