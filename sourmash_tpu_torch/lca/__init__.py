"""LCA (lowest-common-ancestor) databases and commands."""

from .lca_db import LCA_Database, load_single_database, load_databases
from .lca_utils import (
    taxlist,
    zip_lineage,
    display_lineage,
    build_tree,
    find_lca,
    gather_assignments,
    count_lca_for_assignments,
    LineagePair,
    make_lineage,
    pop_to_rank,
    is_lineage_match,
)
