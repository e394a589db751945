"""Taxonomy utilities: lineage types, lineage databases, gather-CSV
summarization.

Organization:

* lineage model — ``LineagePair`` + the ``BaseLineageInfo`` family
  (NCBI ranks, ICTV viral ranks, positional LINs), all frozen dataclasses
  normalized through the shared ``_store_lineage``/``_split_lineage_string``
  helpers;
* lineage databases — ``LineageDB`` (CSV), ``LineageDB_Sqlite``, and the
  precedence-ordered ``MultiLineageDB``, all sharing the read-only mapping
  protocol of ``_LineageMapping``;
* gather-CSV summarization — the ``TaxResult``/``QueryTaxResult`` pipeline
  producing csv_summary / krona / kreport / lingroup / bioboxes outputs.

The port's copy of `sourmash_tpu/tax/tax_utils.py`. Parity target: reference `src/sourmash/tax/tax_utils.py` (LineagePair:83,
BaseLineageInfo/RankLineageInfo/LINLineageInfo :89-640, LineageDB:1210,
MultiLineageDB:1590+, summarization dataclasses :1825+). All console and
CSV output formats match the reference exactly.
"""

from __future__ import annotations

import csv
import sqlite3
from collections import defaultdict
from dataclasses import asdict, dataclass, field, fields, replace
from itertools import zip_longest
from typing import NamedTuple

from ..logging import notify
from ..distance_utils import containment_to_distance
from ..sourmash_args import load_pathlist_from_file
from .. import sourmash_args

__all__ = [
    "LineagePair",
    "RankLineageInfo",
    "ICTVRankLineageInfo",
    "LINLineageInfo",
    "LineageDB",
    "MultiLineageDB",
    "ascending_taxlist",
]

RANKS = NCBI_RANKS = (
    "superkingdom",
    "phylum",
    "class",
    "order",
    "family",
    "genus",
    "species",
    "strain",
)

ICTV_RANKS = (
    "realm",
    "subrealm",
    "kingdom",
    "subkingdom",
    "phylum",
    "subphylum",
    "class",
    "subclass",
    "order",
    "suborder",
    "family",
    "subfamily",
    "genus",
    "subgenus",
    "species",
    "name",
)

# kraken-style rank codes for kreport output
RANKCODE = {
    "superkingdom": "D",
    "kingdom": "K",
    "phylum": "P",
    "class": "C",
    "order": "O",
    "family": "F",
    "genus": "G",
    "species": "S",
    "unclassified": "U",
}

# placeholder strings treated as "no name" in taxonomy-CSV cells
_NULL_NAMES = frozenset(["[Blank]", "na", "null", "NA", ""])


class LineagePair(NamedTuple):
    rank: str
    name: str = None
    taxid: int = None


def ascending_taxlist(include_strain=True):
    "Provide an ordered list of taxonomic ranks: strain --> superkingdom."
    ascending = [
        "species",
        "genus",
        "family",
        "order",
        "class",
        "phylum",
        "superkingdom",
    ]
    if include_strain:
        ascending = ["strain"] + ascending
    yield from ascending


def _split_lineage_string(lineage_str):
    "Split a lineage-name string on ';' (or ',' when no ';' present)."
    parts = lineage_str.split(";")
    if len(parts) == 1:
        parts = lineage_str.split(",")
    return parts


def _lineage_info_class(lins=False, ictv=False):
    "Pick the LineageInfo class for the requested taxonomy flavor."
    if lins:
        return LINLineageInfo
    if ictv:
        return ICTVRankLineageInfo
    return RankLineageInfo


@dataclass(frozen=True, order=True)
class BaseLineageInfo:
    """Handle hierarchical taxonomic lineages over a fixed rank list.

    Storage: `lineage` is a tuple of LineagePair, one per rank; missing
    ranks hold LineagePair(rank, None). `filled_ranks` records which ranks
    carry a (possibly empty-string) name. Behavior parity: reference
    tax_utils.py:89-345."""

    ranks: tuple  # required
    lineage: tuple = None
    lineage_str: str = field(default=None, compare=False)

    def __post_init__(self):
        if isinstance(self.ranks, list):
            object.__setattr__(self, "ranks", tuple(self.ranks))
        if self.lineage is not None:
            self._init_from_lineage_tuples()
        elif self.lineage_str is not None:
            self._init_from_lineage_str()
        else:
            self._init_empty()

    def __eq__(self, other):
        if other == ():
            return False
        return self.ranks == other.ranks and self.lineage == other.lineage

    # -- construction plumbing (frozen dataclass ⇒ object.__setattr__) -----

    def _store_lineage(self, pairs, *, named_only=False):
        """Freeze a normalized pair list in place and derive filled_ranks.

        `named_only=True` treats empty-string names as unfilled (dict-based
        initialization); the default counts any non-None name as filled."""
        if named_only:
            filled = tuple(p.rank for p in pairs if p.name)
        else:
            filled = tuple(p.rank for p in pairs if p.name is not None)
        object.__setattr__(self, "lineage", tuple(pairs))
        object.__setattr__(self, "filled_ranks", filled)

    def _blank_pairs(self):
        return [LineagePair(rank=rank) for rank in self.ranks]

    def _init_empty(self):
        "Initialize an empty lineage over the given ranks."
        self._store_lineage(self._blank_pairs())

    def _init_from_lineage_tuples(self):
        """Initialize from a tuple/list of LineagePairs; empty ranks and
        out-of-order input are allowed and normalized."""
        pairs = self._blank_pairs()
        for lin_tup in self.lineage:
            if not isinstance(lin_tup, LineagePair):
                raise ValueError(f"{lin_tup} is not tax_utils LineagePair.")
            if not lin_tup.rank:  # skip empty-rank pairs
                continue
            try:
                rank_idx = self.rank_index(lin_tup.rank)
            except ValueError as e:
                raise ValueError(
                    f"Rank '{lin_tup.rank}' not present in {', '.join(self.ranks)}"
                ) from e
            pairs[rank_idx] = lin_tup
        self._store_lineage(pairs)

    def _init_from_lineage_str(self):
        "Initialize from a ';'- or ','-separated lineage-name string."
        names = _split_lineage_string(self.lineage_str)
        pairs = [
            LineagePair(rank=rank, name=n)
            for (rank, n) in zip_longest(self.ranks, names)
        ]
        self._store_lineage(pairs)

    # -- rank bookkeeping ---------------------------------------------------

    @property
    def taxlist(self):
        return self.ranks

    @property
    def ascending_taxlist(self):
        return self.ranks[::-1]

    def rank_index(self, rank):
        self.check_rank_availability(rank)
        return self.ranks.index(rank)

    def check_rank_availability(self, rank):
        if rank in self.ranks:
            return True
        raise ValueError(f"Desired Rank '{rank}' not available for this lineage.")

    def rank_is_filled(self, rank, other=None):
        self.check_rank_availability(rank)
        if rank not in self.filled_ranks:
            return False
        if other is not None:
            return rank in other.filled_ranks
        return True

    def is_compatible(self, other):
        return self.ranks == other.ranks

    # -- accessors ------------------------------------------------------------

    @property
    def filled_lineage(self):
        "Return lineage down to the lowest non-empty rank."
        if not self.filled_ranks:
            return ()
        lowest_filled_rank_idx = self.rank_index(self.filled_ranks[-1])
        return self.lineage[: lowest_filled_rank_idx + 1]

    @property
    def lowest_rank(self):
        return self.filled_ranks[-1] if self.filled_ranks else None

    @property
    def lowest_lineage_name(self):
        return self.filled_lineage[-1].name if self.filled_ranks else None

    @property
    def lowest_lineage_taxid(self):
        return self.filled_lineage[-1].taxid if self.filled_ranks else None

    def _pair_at_rank(self, rank):
        self.check_rank_availability(rank)
        if not self.filled_ranks or rank not in self.filled_ranks:
            return None
        return self.filled_lineage[self.rank_index(rank)]

    def name_at_rank(self, rank):
        "Return the lineage name at this rank."
        pair = self._pair_at_rank(rank)
        return pair.name if pair else None

    def taxid_at_rank(self, rank):
        "Return the lineage taxid at this rank."
        pair = self._pair_at_rank(rank)
        return pair.taxid if pair else None

    # -- display ---------------------------------------------------------------

    def zip_lineage(self, truncate_empty=False):
        "Return lineage names as a list (None replaced with '')."
        source = self.filled_lineage if truncate_empty else self.lineage
        return [p.name if p.name is not None else "" for p in source]

    def zip_taxid(self, truncate_empty=False):
        "Return taxids as a list of strings (None replaced with '')."
        source = self.filled_lineage if truncate_empty else self.lineage
        return [str(p.taxid) if p.taxid is not None else "" for p in source]

    def display_lineage(self, truncate_empty=True, null_as_unclassified=False, sep=";"):
        "Return lineage names as a separator-joined string."
        lin = sep.join(self.zip_lineage(truncate_empty=truncate_empty))
        if (null_as_unclassified and lin == "") or lin is None:
            return "unclassified"
        return lin

    def display_taxid(self, truncate_empty=True, sep=";"):
        return sep.join(self.zip_taxid(truncate_empty=truncate_empty))

    # -- lineage algebra --------------------------------------------------------

    def is_lineage_match(self, other, rank):
        "Check whether two lineages match down to the given rank (1/0)."
        self.check_rank_availability(rank)
        if not self.is_compatible(other):
            raise ValueError(
                "Cannot compare lineages from taxonomies with different ranks."
            )
        # always false if rank is not filled in either lineage
        if self.rank_is_filled(rank, other=other):
            rank_idx = self.rank_index(rank)
            if self.lineage[: rank_idx + 1] == other.lineage[: rank_idx + 1]:
                return 1
        return 0

    def lineage_at_rank(self, rank):
        "Return the tuple of LineagePairs down to the given rank."
        self.check_rank_availability(rank)
        if not self.rank_is_filled(rank):
            return self.filled_lineage
        rank_idx = self.rank_index(rank)
        return self.filled_lineage[: rank_idx + 1]

    def pop_to_rank(self, rank):
        "Return a new LineageInfo with ranks only filled down to `rank`."
        self.check_rank_availability(rank)
        if not self.rank_is_filled(rank):
            return replace(self)
        new = replace(self, lineage=self.lineage_at_rank(rank))
        # replace() doesn't rerun __post_init__ normalization; redo it.
        new._init_from_lineage_tuples()
        return new

    def find_lca(self, other):
        "Return the lowest-common-ancestor lineage with `other`, or None."
        for rank in self.ascending_taxlist:
            if self.is_lineage_match(other, rank):
                return self.pop_to_rank(rank)
        return None


def _pairs_from_dict(info, *, with_taxpath):
    """Build the normalized pair list for a dict-based initialization.

    Non-rank dict keys (extra CSV columns) are skipped; placeholder names
    (_NULL_NAMES) are treated as missing. With `with_taxpath`, an optional
    '|'-separated NCBI 'taxpath' entry supplies per-rank taxids."""
    if not isinstance(info.lineage_dict, dict):
        raise ValueError(f"{info.lineage_dict} is not dictionary")
    pairs = info._blank_pairs()

    taxpath = []
    if with_taxpath:
        taxpath_str = info.lineage_dict.get("taxpath", [])
        if taxpath_str:
            taxpath = taxpath_str.split("|")
            if len(taxpath) > len(info.ranks):
                raise ValueError(
                    f"Number of NCBI taxids ({len(taxpath)}) exceeds number of ranks ({len(info.ranks)})"
                )

    for rank, name in info.lineage_dict.items():
        try:
            rank_idx = info.rank_index(rank)
        except ValueError:
            continue  # ignore columns that don't match a rank

        taxid = None
        if taxpath:
            try:
                taxid = taxpath[rank_idx]
            except IndexError:
                taxid = None
        if name is not None and name.strip() in _NULL_NAMES:
            name = None
        pairs[rank_idx] = LineagePair(rank=rank, name=name, taxid=taxid)
    return pairs


@dataclass(frozen=True, order=True)
class RankLineageInfo(BaseLineageInfo):
    """Taxonomic lineage over the standard 8 NCBI ranks
    (superkingdom..strain) — reference tax_utils.py:346-433. Adds
    dict-based initialization with optional '|'-separated NCBI 'taxpath'
    taxids; unknown dict keys (extra CSV columns) are ignored and null
    placeholder names filtered."""

    ranks: tuple = NCBI_RANKS
    lineage_dict: dict = field(default=None, compare=False)

    def __post_init__(self):
        if isinstance(self.ranks, list):
            object.__setattr__(self, "ranks", tuple(self.ranks))
        # first provided source wins: tuples, string, dict, else empty
        for value, init in (
            (self.lineage, self._init_from_lineage_tuples),
            (self.lineage_str, self._init_from_lineage_str),
            (self.lineage_dict, self._init_from_lineage_dict),
        ):
            if value is not None:
                init()
                break
        else:
            if self.ranks:
                self._init_empty()

    def _init_from_lineage_dict(self):
        "Initialize from a lineage dict (e.g. a taxonomy-CSV row)."
        pairs = _pairs_from_dict(self, with_taxpath=True)
        self._store_lineage(pairs, named_only=True)


@dataclass(frozen=True, order=True)
class ICTVRankLineageInfo(RankLineageInfo):
    """Lineage over the 15-rank ICTV viral taxonomy plus a trailing 'name'
    column (virus name as sub-species rank) — reference tax_utils.py:434-504.
    Unlike RankLineageInfo, unknown dict keys are ignored (extra CSV columns
    allowed) and null placeholder names are filtered."""

    ranks: tuple = ICTV_RANKS
    lineage_dict: dict = field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "ranks", ICTV_RANKS)
        if self.lineage is not None:
            self._init_from_lineage_tuples()
        elif self.lineage_str is not None:
            self._init_from_lineage_str()
        elif self.lineage_dict is not None:
            self._init_from_lineage_dict()
        else:
            self._init_empty()

    def _init_from_lineage_dict(self):
        "Initialize from a lineage dict; skips non-rank columns, null names."
        pairs = _pairs_from_dict(self, with_taxpath=False)
        self._store_lineage(pairs, named_only=True)


@dataclass(frozen=True, order=True)
class LINLineageInfo(BaseLineageInfo):
    """LIN taxonomic lineage: positional integer 'ranks'
    (reference tax_utils.py:507-640). Equality compares only the filled
    lineage so LIN prefixes can match full LINs; `is_compatible` just
    requires a shared position."""

    ranks: tuple = field(default=None, init=False, compare=False)
    lineage: tuple = None
    n_lin_positions: int = field(default=None, compare=False)

    def __post_init__(self):
        if self.lineage is not None:
            self._init_from_lineage_tuples()
        elif self.lineage_str is not None:
            self._init_from_lineage_str()
        else:
            self._init_empty()

    def __eq__(self, other):
        if other == ():
            return False
        return self.filled_lineage == other.filled_lineage

    def _set_positions(self, n_positions):
        object.__setattr__(self, "n_lin_positions", n_positions)
        object.__setattr__(self, "ranks", [str(x) for x in range(0, n_positions)])

    def _store_lin(self, pairs):
        self._store_lineage(pairs)
        object.__setattr__(self, "n_filled_pos", len(self.filled_ranks))

    def _init_empty(self):
        self._set_positions(self.n_lin_positions or 0)
        pairs = self._blank_pairs()
        self._store_lin(pairs)

    def _init_from_lineage_str(self):
        "Initialize from a ';'- or ','-separated LIN string."
        names = _split_lineage_string(self.lineage_str)
        if self.n_lin_positions is not None:
            if self.n_lin_positions < len(names):
                raise ValueError(
                    "Provided 'n_lin_positions' has fewer positions than provided 'lineage_str'."
                )
            self._set_positions(self.n_lin_positions)
        else:
            self._set_positions(len(names))

        pairs = [
            LineagePair(rank=rank, name=n)
            for (rank, n) in zip_longest(self.ranks, names)
        ]
        self._store_lin(pairs)

    def _init_from_lineage_tuples(self):
        "Initialize from LineagePairs, taking ranks from the pairs."
        pairs = []
        for lin_tup in self.lineage:
            if not isinstance(lin_tup, LineagePair):
                raise ValueError(f"{lin_tup} is not tax_utils LineagePair.")
            pairs.append(lin_tup)
        object.__setattr__(self, "n_lin_positions", len(pairs))
        object.__setattr__(self, "ranks", tuple(p.rank for p in pairs))
        self._store_lin(pairs)

    def is_compatible(self, other):
        "LIN prefixes may match full LINs: require any shared position."
        return any(x in self.ranks for x in other.ranks)


# ---------------------------------------------------------------------------
# lineage databases
# ---------------------------------------------------------------------------


def get_ident(ident, *, keep_full_identifiers=False, keep_identifier_versions=False):
    """Hack identifiers: split on whitespace unless keep_full_identifiers;
    strip trailing .N version unless keep_identifier_versions."""
    if not keep_full_identifiers:
        ident = ident.split(" ")[0]
        if not keep_identifier_versions:
            ident = ident.split(".")[0]
    return ident


class _LineageMapping:
    """Read-only mapping protocol over {identifier: lineage tuple};
    subclasses provide __getitem__, __iter__, and __len__."""

    def __contains__(self, ident):
        try:
            self[ident]
            return True
        except KeyError:
            return False

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __bool__(self):
        return bool(len(self))

    def keys(self):
        yield from iter(self)

    def items(self):
        for k in self:
            yield k, self[k]

    def values(self):
        for _, v in self.items():
            yield v


def _require_regular_file(filename):
    import os

    if not os.path.exists(filename):
        raise ValueError(f"'{filename}' does not exist")
    if os.path.isdir(filename):
        raise ValueError(f"'{filename}' is a directory")


def _resolve_ident_column(header):
    """Locate the identifier column among the common alternatives; returns
    (column_name, normalized_header) or (None, header) when the file looks
    like a with-lineages CSV instead."""
    if "ident" in header:
        return "ident", header
    for alt in ("identifiers", "accession"):
        if alt in header:
            return alt, ["ident" if c == alt else c for c in header]
    if "lineage" in header and ("name" in header or "match_name" in header):
        return None, header  # with-lineages flavor
    header_str = ",".join([repr(x) for x in header])
    raise ValueError(f"No taxonomic identifiers found; headers are {header_str}")


class LineageDB(_LineageMapping):
    """An in-memory mapping {identifier: lineage tuple}.

    Parity: reference `tax_utils.py:1210+` — load from taxonomy CSV with
    'ident' + rank columns."""

    def __init__(self, assign_d, avail_ranks):
        self.assignments = dict(assign_d)
        self.available_ranks = set(avail_ranks)

    def __getitem__(self, ident):
        return self.assignments[ident]

    def __iter__(self):
        return iter(self.assignments)

    def __len__(self):
        return len(self.assignments)

    # direct dict views beat the mixin's generic generators
    def keys(self):
        return self.assignments.keys()

    def items(self):
        return self.assignments.items()

    def values(self):
        return self.assignments.values()

    @classmethod
    def load(cls, filename, *, delimiter=",", force=False,
             keep_full_identifiers=False, keep_identifier_versions=True,
             lins=False, ictv=False):
        """Load a taxonomy-assignment CSV into a LineageDB
        (reference tax_utils.py:1233-1377)."""
        if not keep_identifier_versions and keep_full_identifiers:
            raise ValueError(
                "keep_identifer_versions=False doesn't make sense with keep_full_identifiers=True"
            )
        _require_regular_file(filename)

        with sourmash_args.FileInputCSV(filename, delimiter=",") as r:
            header = r.fieldnames
            if not header:
                raise ValueError(f"cannot read taxonomy assignments from {filename}")

            identifier, header = _resolve_ident_column(header)
            if identifier is None:
                return cls.load_from_gather_with_lineages(
                    filename, force=force, lins=lins, ictv=ictv
                )

            if lins:
                notify("Trying to read LIN taxonomy assignments.")
                if "lin" not in header:
                    raise ValueError(
                        f"'lin' column not found: cannot read LIN taxonomy assignments from {filename}."
                    )
            elif ictv:
                notify("Trying to read ICTV taxonomy assignments.")
                ranks = list(ICTVRankLineageInfo().taxlist)
                if not set(ranks).issubset(header):
                    raise ValueError("Not all taxonomy ranks present")
            else:
                ranks = list(RankLineageInfo().taxlist)
                if "strain" not in header:
                    ranks.remove("strain")
                if not set(ranks).issubset(header):
                    raise ValueError("Not all taxonomy ranks present")

            assignments = {}
            n_pos = None

            for row in r:
                if lins:
                    lineageInfo = LINLineageInfo(lineage_str=row["lin"])
                    if n_pos is None:
                        n_pos = lineageInfo.n_lin_positions
                        ranks = lineageInfo.ranks
                    elif lineageInfo.n_lin_positions != n_pos:
                        raise ValueError(
                            "For taxonomic summarization, all LIN assignments must use the same number of LIN positions."
                        )
                else:
                    info_cls = _lineage_info_class(ictv=ictv)
                    lineageInfo = info_cls(lineage_dict=row)

                ident = get_ident(
                    row[identifier],
                    keep_full_identifiers=keep_full_identifiers,
                    keep_identifier_versions=keep_identifier_versions,
                )

                lineage = lineageInfo.filled_lineage
                if not lineage:
                    continue
                if ident in assignments:
                    if assignments[ident] != lineage and not force:
                        raise ValueError(f"multiple lineages for identifier {ident}")
                else:
                    assignments[ident] = lineage

        return LineageDB(assignments, ranks)

    @classmethod
    def load_from_gather_with_lineages(cls, filename, *, force=False, lins=False,
                                       ictv=False):
        """Load a 'tax annotate'-style with-lineages CSV into a LineageDB
        (reference tax_utils.py:1379-1452)."""
        _require_regular_file(filename)

        info_cls = _lineage_info_class(lins=lins, ictv=ictv)

        with sourmash_args.FileInputCSV(filename) as r:
            header = r.fieldnames
            if not header:
                raise ValueError(f"cannot read taxonomy assignments from {filename}")

            ident_col = next((c for c in ("name", "match_name") if c in header), None)
            if "lineage" not in header or ident_col is None:
                raise ValueError(
                    "Expected headers 'name'/'match_name' and 'lineage' not found. Is this a with-lineages file?"
                )

            ranks = None
            assignments = {}

            for row in r:
                ident = get_ident(row[ident_col])
                lineageInfo = info_cls(lineage_str=row["lineage"])

                if ranks is None:
                    ranks = lineageInfo.taxlist

                lineage = lineageInfo.filled_lineage
                if ident in assignments:
                    if assignments[ident] != lineage and not force:
                        raise ValueError(f"multiple lineages for identifier {ident}")
                else:
                    assignments[ident] = lineage

        return LineageDB(assignments, ranks)


class LineageDB_Sqlite(_LineageMapping):
    """A LineageDB over a sqlite3 'sourmash_taxonomy' table
    (parity: reference `tax_utils.py:1455+`)."""

    # NOTE: 'order' is a reserved word in SQL; the column is 'order_'.
    columns = (
        "superkingdom",
        "phylum",
        "class",
        "order_",
        "family",
        "genus",
        "species",
        "strain",
    )
    table_name = "sourmash_taxonomy"

    def __init__(self, conn, *, table_name=None):
        self.conn = conn
        self.table_name = table_name if table_name is not None else self.table_name

        probe = conn.cursor()
        try:
            probe.execute(f"SELECT * FROM {self.table_name} LIMIT 1")
        except (sqlite3.DatabaseError, sqlite3.OperationalError):
            raise ValueError("not a taxonomy database")

        self.__len__()
        c = conn.cursor()

        # a rank is available iff its column holds any non-empty value
        ranks = set()
        for column, rank in zip(self.columns, RANKS):
            c.execute(
                f'SELECT COUNT({column}) FROM {self.table_name} '
                f'WHERE {column} IS NOT NULL AND {column} != ""'
            )
            (cnt,) = c.fetchone()
            if cnt:
                ranks.add(rank)

        self.available_ranks = ranks
        self.cursor = c

    @classmethod
    def load(cls, location):
        "Load taxonomy information from an existing sqlite3 database."
        from .. import sqlite_utils

        conn = sqlite_utils.open_sqlite_db(location)
        if not conn:
            raise ValueError("not a sqlite taxonomy database")

        c = conn.cursor()
        try:
            info = sqlite_utils.get_sourmash_internal(c)
        except sqlite3.OperationalError:
            info = {}

        version = info.get("SqliteLineage")
        if version is not None:
            if version != "1.0":
                from ..exceptions import IndexNotSupported

                raise IndexNotSupported("unsupported SqliteLineage version")
            return cls(conn, table_name="sourmash_taxonomy")

        # legacy layout: a bare 'taxonomy' table
        try:
            c.execute("SELECT * FROM taxonomy LIMIT 1")
        except sqlite3.OperationalError:
            raise ValueError("not a sqlite taxonomy database")
        return cls(conn, table_name="taxonomy")

    @staticmethod
    def _row_to_lineage(names):
        "Build a (trailing-empties trimmed) lineage tuple from a sqlite row."
        tup = tuple(LineagePair(rank, name) for (rank, name) in zip(RANKS, names))
        while tup and not tup[-1].name:
            tup = tup[:-1]
        return tup

    def __getitem__(self, ident):
        c = self.cursor
        c.execute(
            f"SELECT superkingdom, phylum, class, order_, family, genus, species, strain FROM {self.table_name} WHERE ident=?",
            (ident,),
        )
        names = c.fetchone()
        if names:
            return self._row_to_lineage(names)
        raise KeyError(ident)

    def __len__(self):
        c = self.conn.cursor()
        c.execute(f"SELECT COUNT(DISTINCT ident) FROM {self.table_name}")
        (nrows,) = c.fetchone()
        return nrows

    def __iter__(self):
        c = self.conn.cursor()
        c.execute(f"SELECT DISTINCT ident FROM {self.table_name}")
        for (ident,) in c:
            yield ident

    def items(self):
        c = self.conn.cursor()
        c.execute(
            f"SELECT DISTINCT ident, superkingdom, phylum, class, order_, family, genus, species, strain FROM {self.table_name}"
        )
        for ident, *names in c:
            yield ident, self._row_to_lineage(names)


class MultiLineageDB(_LineageMapping):
    "A wrapper for (possibly multiple) lineage databases."

    def __init__(self):
        self.lineage_dbs = []

    def add(self, db):
        "Add a database; later additions take precedence for lookups."
        self.lineage_dbs.insert(0, db)

    @property
    def available_ranks(self):
        "Compute available ranks across all databases."
        x = set()
        for db in self.lineage_dbs:
            x.update(db.available_ranks)
        return x

    def shadowed_identifiers(self):
        "Return identifiers seen across databases (reference tax_utils.py:1631)."
        seen = set()
        dups = set()
        for db in self.lineage_dbs:
            for k, v in db.items():
                if k in seen:
                    dups.add(k)
                else:
                    seen.add(k)
        return seen

    def __iter__(self):
        yield from (k for k, _v in self.items())

    def items(self):
        "Yield (ident, lineage), first database wins on duplicates."
        seen = set()
        for db in self.lineage_dbs:
            for k, v in db.items():
                if k not in seen:
                    seen.add(k)
                    yield k, v

    def __getitem__(self, ident):
        "Return lineage tuple for first match to identifier."
        for db in self.lineage_dbs:
            if ident in db:
                return db[ident]
        raise KeyError(ident)

    def __contains__(self, ident):
        return any(ident in db for db in self.lineage_dbs)

    def __bool__(self):
        return any(self.lineage_dbs)

    def __len__(self):
        return len(set(iter(self)))

    @classmethod
    def load(cls, locations, **kwargs):
        "Load one or more taxonomies into a MultiLineageDB."
        if isinstance(locations, str):
            raise TypeError("'locations' should be a list, not a string")

        force = kwargs.get("force", False)
        tax_assign = cls()
        for location in locations:
            # try sqlite first, then the CSV flavors
            try:
                db = LineageDB_Sqlite.load(location)
            except ValueError:
                db = None
            if db is None:
                try:
                    db = LineageDB.load(location, **kwargs)
                except (ValueError, csv.Error) as exc:
                    if not force:
                        raise ValueError(
                            f"cannot read taxonomy assignments from '{location}': {str(exc)}"
                        )
            if db is not None:
                tax_assign.add(db)

        return tax_assign

    # -- persistence -----------------------------------------------------

    def save(self, filename_or_fp, file_format="csv"):
        "Save to CSV or a sqlite taxonomy database."
        is_filename = isinstance(filename_or_fp, str)
        if file_format == "sql":
            if not is_filename:
                raise ValueError("sql output requires a filename")
            self._save_sqlite(filename_or_fp)
        elif is_filename:
            import gzip as _gzip

            opener = _gzip.open if filename_or_fp.endswith(".gz") else open
            with opener(filename_or_fp, "wt", newline="") as fp:
                self._save_csv(fp)
        else:
            self._save_csv(filename_or_fp)

    def _save_sqlite(self, filename, *, conn=None):
        "Save taxonomy into a sqlite 'sourmash_taxonomy' table."
        from .. import sqlite_utils

        if conn is not None:
            assert not filename
            db = conn
        else:
            db = sqlite3.connect(filename)

        cursor = db.cursor()
        try:
            sqlite_utils.add_sourmash_internal(cursor, "SqliteLineage", "1.0")
        except sqlite3.OperationalError:
            raise ValueError("attempt to write a readonly database")

        # 'order' is a SQL keyword, hence the trailing underscore
        columns = ", ".join(
            ["ident TEXT NOT NULL"]
            + [f"{r if r != 'order' else 'order_'} TEXT" for r in RANKS]
        )
        try:
            cursor.execute(f"CREATE TABLE sourmash_taxonomy ( {columns} )")
        except sqlite3.OperationalError:
            raise ValueError(f"taxonomy table already exists in '{filename}'")

        cursor.execute(
            "CREATE UNIQUE INDEX sourmash_taxonomy_ident ON sourmash_taxonomy(ident);"
        )
        for ident, tax in self.items():
            names = {p.rank: p.name for p in tax}
            values = [ident] + [names.get(r) for r in RANKS]
            cursor.execute(
                "INSERT INTO sourmash_taxonomy (ident, superkingdom, phylum, class, order_, family, genus, species, strain) VALUES (?,?,?,?,?,?,?,?,?)",
                values,
            )

        db.commit()

    def _save_csv(self, fp):
        ranks = sorted(
            self.available_ranks,
            key=lambda r: RANKS.index(r) if r in RANKS else 99,
        )
        w = csv.writer(fp)
        w.writerow(["ident"] + list(ranks))
        for ident, lineage in self.items():
            d = {p.rank: p.name for p in lineage}
            w.writerow([ident] + [d.get(r, "") or "" for r in ranks])


# ---------------------------------------------------------------------------
# lineage trees (LCA / ordered traversal over nested dicts)
# ---------------------------------------------------------------------------


class LineageTree:
    """Tree of nested dicts over LineagePair / LineageInfo objects, for
    LCA-finding and ordered path traversal."""

    def __init__(self, assignments):
        self.assignments = assignments
        self.tree = {}
        self.add_lineages(assignments)

    def add_lineage(self, lineage):
        if isinstance(lineage, BaseLineageInfo):
            lineage = lineage.filled_lineage
        node = self.tree
        for lineage_tup in lineage:
            if lineage_tup.name:
                node = node.setdefault(lineage_tup, {})

    def add_lineages(self, lineages):
        from collections import abc as _abc

        if not lineages:
            raise ValueError("empty assignment passed to build_tree")
        if not isinstance(lineages, _abc.Iterable):
            raise ValueError(
                "Must pass in an iterable containing LineagePair or LineageInfo objects."
            )
        for lineageInf in lineages:
            self.add_lineage(lineageInf)

    def find_lca(self):
        "Find the first node with multiple children (or the only leaf)."
        node = self.tree
        lca = []
        while len(node) == 1:
            lineage_tup = next(iter(node))
            lca.append(lineage_tup)
            node = node[lineage_tup]
        return tuple(lca), len(node)

    def ordered_paths(self, include_internal=False):
        "Depth-first list of all root->leaf paths (optionally internal too)."
        paths = []
        stack = [((), self.tree)]
        while stack:
            path, node = stack.pop()
            for key, children in node.items():
                if children:
                    stack.append((path + (key,), children))
                    continue
                if include_internal:
                    internal_path = path
                    while internal_path:
                        if internal_path not in paths:
                            paths.append(internal_path)
                        internal_path = internal_path[:-1]
                paths.append(path + (key,))
        return paths


# ---------------------------------------------------------------------------
# gather-CSV taxonomic summarization machinery
# (parity: reference tax_utils.py:1810-2829)
# ---------------------------------------------------------------------------


def filter_row(row, dataclass_type):
    "Keep only keys matching the dataclass fields ('match_name' -> 'name')."
    valid_keys = {field.name for field in fields(dataclass_type)}
    if "match_name" in row.keys() and "name" not in row.keys():
        row["name"] = row.pop("match_name")
    return {k: v for k, v in row.items() if k in valid_keys}


@dataclass
class GatherRow:
    """Typed view of one gather-CSV row; fields match gather_write_cols in
    search.py. Required columns raise TypeError if missing."""

    # essential columns
    query_name: str
    name: str
    f_unique_weighted: float
    f_unique_to_query: float
    unique_intersect_bp: int
    remaining_bp: int
    query_md5: str
    query_filename: str
    query_bp: int
    ksize: int
    scaled: int

    # non-essential
    query_n_hashes: int = None
    sum_weighted_found: int = None
    total_weighted_hashes: int = None


@dataclass
class QueryInfo:
    "Query metadata carried through taxonomic summarization."

    query_name: str
    query_md5: str
    query_filename: str
    query_bp: int
    ksize: int
    scaled: int
    query_n_hashes: int = None
    total_weighted_hashes: int = 0

    def __post_init__(self):
        # CSV cells arrive as strings; coerce the numeric fields
        for intfield in ("query_bp", "ksize", "scaled"):
            setattr(self, intfield, int(getattr(self, intfield)))
        for optfield in ("query_n_hashes", "total_weighted_hashes"):
            value = getattr(self, optfield)
            setattr(self, optfield, int(value) if value else 0)

    @property
    def total_weighted_bp(self):
        return self.total_weighted_hashes * self.scaled

    @classmethod
    def from_gather_row(cls, row):
        "Collect the query metadata columns from one gather-CSV row."
        return cls(**{f.name: getattr(row, f.name) for f in fields(cls)})


@dataclass
class BaseTaxResult:
    "Base class for taxonomic annotation of one CSV row."

    raw: dict
    keep_full_identifiers: bool = False
    keep_identifier_versions: bool = False
    match_ident: str = field(init=False)
    skipped_ident: bool = False
    missed_ident: bool = False
    match_lineage_attempted: bool = False
    lins: bool = False
    ictv: bool = False

    def _empty_lineage_info(self):
        return _lineage_info_class(lins=self.lins, ictv=self.ictv)()

    def get_ident(self, id_col=None):
        "Hack and slash identifiers."
        ident = self.raw[id_col] if id_col else self.raw.name
        if self.keep_full_identifiers:
            self.keep_identifier_versions = True
        else:
            ident = ident.split(" ")[0]
        if not self.keep_identifier_versions:
            ident = ident.split(".")[0]
        self.match_ident = ident

    def get_match_lineage(self, tax_assignments, skip_idents=None,
                          fail_on_missing_taxonomy=False):
        if skip_idents and self.match_ident in skip_idents:
            self.skipped_ident = True
        else:
            lin = tax_assignments.get(self.match_ident)
            if lin:
                info_cls = _lineage_info_class(lins=self.lins, ictv=self.ictv)
                self.lineageInfo = info_cls(lineage=lin)
            else:
                self.missed_ident = True
        self.match_lineage_attempted = True
        if self.missed_ident and fail_on_missing_taxonomy:
            msg = (f"Error: ident '{self.match_ident}' is not in the taxonomy"
                   " database. Failing, as requested via"
                   " --fail-on-missing-taxonomy")
            raise ValueError(msg)


@dataclass
class AnnotateTaxResult(BaseTaxResult):
    "Taxonomic annotation for any sourmash CSV with a name-ish column."

    id_col: str = "name"

    def __post_init__(self):
        if self.id_col not in self.raw.keys():
            raise ValueError(f"ID column '{self.id_col}' not found.")
        self.get_ident(id_col=self.id_col)
        self.lineageInfo = self._empty_lineage_info()

    def row_with_lineages(self):
        lineage = self.lineageInfo.display_lineage(truncate_empty=True)
        rl = {"lineage": lineage}
        rl.update(self.raw)
        return rl


@dataclass
class TaxResult(BaseTaxResult):
    "Taxonomic result of a single gather-CSV row."

    raw: GatherRow = None
    query_name: str = field(init=False)
    query_info: QueryInfo = field(init=False)

    def __post_init__(self):
        self.get_ident()
        self.query_name = self.raw.query_name
        self.query_info = QueryInfo.from_gather_row(self.raw)
        self.f_unique_to_query = float(self.raw.f_unique_to_query)
        self.f_unique_weighted = float(self.raw.f_unique_weighted)
        self.unique_intersect_bp = int(self.raw.unique_intersect_bp)
        self.lineageInfo = self._empty_lineage_info()


@dataclass
class SummarizedGatherResult:
    "Lineage-summarized gather information at one rank."

    rank: str
    fraction: float
    lineage: RankLineageInfo
    f_weighted_at_rank: float
    bp_match_at_rank: int
    query_ani_at_rank: float = None

    def __post_init__(self):
        self.check_values()

    def check_values(self):
        if self.fraction > 1 or self.f_weighted_at_rank > 1:
            raise ValueError(
                "Summarized fraction is > 100% of the query! This should not be possible. Please check that your input files come directly from a single gather run per query."
            )
        if self.fraction <= 0 or self.f_weighted_at_rank <= 0:
            raise ValueError(
                "Summarized fraction is <=0% of the query! This should not occur."
            )

    def set_query_ani(self, query_info):
        self.query_ani_at_rank = containment_to_distance(
            self.fraction,
            query_info.ksize,
            query_info.scaled,
            n_unique_kmers=query_info.query_n_hashes,
            sequence_len_bp=query_info.query_bp,
        ).ani

    def _is_default_lineage(self):
        "True when this row carries the empty/unclassified lineage."
        return self.lineage == RankLineageInfo()

    def as_lineage_dict(self, query_info, ranks):
        "Lineage-CSV row dict ('ident' + one column per rank)."
        lD = {"ident": query_info.query_name}
        for rank in ranks:
            lD[rank] = self.lineage.name_at_rank(rank) or ""
        return lD

    def as_summary_dict(self, query_info, limit_float=False, lingroups=None):
        sD = asdict(self)
        display = self.lineage.display_lineage(null_as_unclassified=True)
        if lingroups is not None and display in lingroups:
            display = lingroups[display]
        elif lingroups and display != "unclassified":
            return None  # lingroup mode drops unlisted lineages
        sD["lineage"] = display

        sD.update(
            query_name=query_info.query_name,
            query_md5=query_info.query_md5,
            query_filename=query_info.query_filename,
            total_weighted_hashes=str(query_info.total_weighted_hashes),
            bp_match_at_rank=str(self.bp_match_at_rank),
        )
        if limit_float:
            sD["fraction"] = f"{self.fraction:.3f}"
            sD["f_weighted_at_rank"] = f"{self.f_weighted_at_rank:.3f}"
            if self.query_ani_at_rank:
                sD["query_ani_at_rank"] = f"{self.query_ani_at_rank:.3f}"
        else:
            sD["fraction"] = str(self.fraction)
            sD["f_weighted_at_rank"] = str(self.f_weighted_at_rank)
        return sD

    def as_human_friendly_dict(self, query_info):
        sD = self.as_summary_dict(query_info=query_info, limit_float=True)
        sD["f_weighted_at_rank"] = f"{self.f_weighted_at_rank*100:>4.1f}%"
        ani = self.query_ani_at_rank
        sD["query_ani_at_rank"] = "-    " if ani is None else f"{ani*100:>3.1f}%"
        return sD

    def as_kreport_dict(self, query_info):
        "kraken-style kreport row."
        if isinstance(self.lineage, LINLineageInfo):
            raise ValueError("Cannot produce 'kreport' with LIN taxonomy.")

        contained_bp = str(int(self.f_weighted_at_rank * query_info.total_weighted_bp))
        sD = {
            "num_bp_assigned": str(0),
            "ncbi_taxid": None,
            "percent_containment": f"{self.f_weighted_at_rank * 100:.2f}",
            "num_bp_contained": contained_bp,
        }
        if self._is_default_lineage():
            sD["sci_name"] = "unclassified"
            sD["rank_code"] = RANKCODE["unclassified"]
            sD["num_bp_assigned"] = contained_bp
        else:
            this_rank = self.lineage.lowest_rank
            sD["rank_code"] = RANKCODE[this_rank]
            sD["sci_name"] = self.lineage.lowest_lineage_name
            taxid = self.lineage.lowest_lineage_taxid
            if taxid:
                sD["ncbi_taxid"] = str(taxid)
            # only species-level assignments count as "assigned"
            if this_rank == "species":
                sD["num_bp_assigned"] = contained_bp
        return sD

    def as_lingroup_dict(self, query_info, lg_name):
        "lingroup report row."
        return {
            "percent_containment": f"{self.f_weighted_at_rank * 100:.2f}",
            "num_bp_contained": str(
                int(self.f_weighted_at_rank * query_info.total_weighted_bp)
            ),
            "lin": self.lineage.display_lineage(),
            "name": lg_name,
        }

    def as_cami_bioboxes(self):
        "CAMI profiling Bioboxes row: TAXID RANK TAXPATH TAXPATHSN PERCENTAGE."
        if isinstance(self.lineage, LINLineageInfo):
            raise ValueError("Cannot produce 'bioboxes' with LIN taxonomy.")
        if self._is_default_lineage():
            return []
        taxid = self.lineage.lowest_lineage_taxid
        if taxid:
            taxpath = self.lineage.display_taxid(sep="|")
            taxid = str(taxid)
        else:
            taxpath = None
        taxpathsn = self.lineage.display_lineage(sep="|")
        percentage = f"{(self.f_weighted_at_rank * 100):.2f}"
        return [taxid, self.rank, taxpath, taxpathsn, percentage]


@dataclass
class ClassificationResult(SummarizedGatherResult):
    "Query classification result (thresholded best-at-rank)."

    status: str = field(init=False)

    def __post_init__(self):
        self.check_values()
        self.status = "nomatch"

    def set_status(self, query_info, containment_threshold=None, ani_threshold=None):
        if containment_threshold is not None or ani_threshold is not None:
            self.status = "below_threshold"
        self.set_query_ani(query_info=query_info)
        if ani_threshold is not None:
            if self.query_ani_at_rank >= ani_threshold:
                self.status = "match"
        elif (
            containment_threshold is not None and self.fraction >= containment_threshold
        ):
            self.status = "match"

    def build_krona_result(self, rank=None):
        krona_classified, krona_unclassified = None, None
        if rank is not None and rank == self.rank:
            lin_as_list = self.lineage.display_lineage().split(";")
            krona_classified = (self.fraction, *lin_as_list)
            unclassified_names = ["unclassified"] * len(lin_as_list)
            krona_unclassified = (1.0 - self.fraction, *unclassified_names)
        return krona_classified, krona_unclassified


@dataclass
class QueryTaxResult:
    "All TaxResults for one query + summarization/classification methods."

    query_info: QueryInfo
    lins: bool = False
    ictv: bool = False

    def __post_init__(self):
        self.query_name = self.query_info.query_name
        self._init_taxresult_vars()
        self._init_summarization_vars()
        self._init_classification_results()

    def _init_taxresult_vars(self):
        self.ranks, self.raw_taxresults = [], []
        self.skipped_idents, self.missed_idents = set(), set()
        self.n_missed = self.n_skipped = 0
        self.perfect_match = set()

    def _init_summarization_vars(self):
        # rank -> lineage -> accumulated weight/fraction/bp
        nested_float = lambda: defaultdict(float)  # noqa: E731
        self.sum_uniq_weighted = defaultdict(nested_float)
        self.sum_uniq_to_query = defaultdict(nested_float)
        self.sum_uniq_bp = defaultdict(lambda: defaultdict(int))
        self.summarized_ranks = []
        self._init_summarization_results()

    def _init_summarization_results(self):
        self.total_f_weighted = defaultdict(float)
        self.total_f_classified = defaultdict(float)
        self.total_bp_classified = defaultdict(int)
        self.summarized_lineage_results = defaultdict(list)

    def _init_classification_results(self):
        self.status = "nomatch"
        self.classified_ranks = []
        self.classification_result = None
        self.krona_classified = None
        self.krona_unclassified = None
        self.krona_header = []

    def _empty_lineage_info(self):
        return _lineage_info_class(lins=self.lins, ictv=self.ictv)()

    def is_compatible(self, taxresult):
        return (
            taxresult.query_info == self.query_info
            and taxresult.lins == self.lins
            and taxresult.ictv == self.ictv
        )

    @property
    def ascending_ranks(self):
        if not self.ranks:
            return []
        return self.ranks[::-1]

    def add_taxresult(self, taxresult):
        if not self.is_compatible(taxresult=taxresult):
            raise ValueError(
                "Error: Cannot add TaxResult: query information does not match."
            )
        if not taxresult.match_lineage_attempted:
            raise ValueError(
                "Error: Cannot add TaxResult. Please use get_match_lineage() to add taxonomic lineage information first."
            )
        self.ranks = self.ranks or taxresult.lineageInfo.ranks
        if taxresult.skipped_ident:
            self.skipped_idents.add(taxresult.match_ident)
            self.n_skipped += 1
        elif taxresult.missed_ident:
            self.missed_idents.add(taxresult.match_ident)
            self.n_missed += 1
        self.raw_taxresults.append(taxresult)

    # -- summarization ---------------------------------------------------

    def _warn_perfect_match(self, taxres):
        if taxres.f_unique_to_query >= 1.0 and taxres.match_ident not in self.perfect_match:
            notify(
                f"WARNING: 100% match! Is query '{self.query_name}' identical to its database match, '{taxres.match_ident}'?"
            )
            self.perfect_match.add(taxres.match_ident)

    def summarize_up_ranks(self, single_rank=None, force_resummarize=False):
        if self.summarized_ranks:
            if force_resummarize:
                self._init_summarization_vars()
            else:
                raise ValueError(
                    f"Error: already summarized using rank(s): '{', '.join(self.summarized_ranks)}'. Use 'force_resummarize=True' to reset and resummarize"
                )

        if single_rank and single_rank not in self.ascending_ranks:
            raise ValueError(
                f"Error: rank '{single_rank}' not in available ranks ({', '.join(self.ascending_ranks)})"
            )
        self.summarized_ranks = [single_rank] if single_rank else self.ascending_ranks

        for taxres in self.raw_taxresults:
            lininfo = taxres.lineageInfo
            if not (lininfo and lininfo.filled_lineage):
                continue
            self._warn_perfect_match(taxres)
            for rank in self.summarized_ranks:
                if rank in lininfo.filled_ranks:
                    lin_at_rank = lininfo.pop_to_rank(rank)
                    self.sum_uniq_weighted[rank][lin_at_rank] += taxres.f_unique_weighted
                    self.sum_uniq_to_query[rank][lin_at_rank] += taxres.f_unique_to_query
                    self.sum_uniq_bp[rank][lin_at_rank] += taxres.unique_intersect_bp

        self.summarized_ranks = [
            x for x in self.summarized_ranks if x in self.sum_uniq_bp.keys()
        ]
        if single_rank and single_rank not in self.summarized_ranks:
            raise ValueError(
                f"Error: rank '{single_rank}' was not available for any matching lineages."
            )

    def _lineages_by_fraction(self, rank):
        "Summed (lineage, f_unique) at one rank, largest fraction first."
        return sorted(self.sum_uniq_to_query[rank].items(), key=lambda x: -x[1])

    def _accumulate_classified(self, rank, sres):
        "Track per-rank classified totals as summary rows are emitted."
        self.total_f_classified[rank] += sres.fraction
        self.total_f_weighted[rank] += sres.f_weighted_at_rank
        self.total_bp_classified[rank] += sres.bp_match_at_rank

    def build_summarized_result(self, single_rank=None, force_resummarize=False):
        self._init_summarization_results()
        if not self.summarized_ranks or force_resummarize:
            self.summarize_up_ranks(
                single_rank=single_rank, force_resummarize=force_resummarize
            )
        if single_rank and single_rank not in self.summarized_ranks:
            raise ValueError(
                f"Error: rank '{single_rank}' not in summarized rank(s), {','.join(self.summarized_ranks)}"
            )

        for rank in self.summarized_ranks[::-1]:
            for lineage, f_unique in self._lineages_by_fraction(rank):
                if f_unique == 0:
                    continue
                sres = SummarizedGatherResult(
                    rank=rank,
                    lineage=lineage,
                    fraction=f_unique,
                    f_weighted_at_rank=self.sum_uniq_weighted[rank][lineage],
                    bp_match_at_rank=self.sum_uniq_bp[rank][lineage],
                )
                sres.set_query_ani(query_info=self.query_info)
                self.summarized_lineage_results[rank].append(sres)
                self._accumulate_classified(rank, sres)

            # one trailing "unclassified" row per rank covering the remainder
            f_unclassified = 1.0 - self.total_f_classified[rank]
            if f_unclassified > 0:
                sres = SummarizedGatherResult(
                    lineage=self._empty_lineage_info(),
                    rank=rank,
                    f_weighted_at_rank=1.0 - self.total_f_weighted[rank],
                    fraction=f_unclassified,
                    bp_match_at_rank=(
                        self.query_info.query_bp - self.total_bp_classified[rank]
                    ),
                    query_ani_at_rank=None,
                )
                self.summarized_lineage_results[rank].append(sres)

    # -- classification -----------------------------------------------------

    @staticmethod
    def _check_threshold(value, what):
        if value is not None and not 0 <= value <= 1:
            raise ValueError(
                f"{what} threshold must be between 0 and 1 (input value: {value})."
            )

    def build_classification_result(
        self,
        rank=None,
        ani_threshold=None,
        containment_threshold=0.1,
        force_resummarize=False,
        lingroup_ranks=None,
        lingroups=None,
    ):
        self._check_threshold(containment_threshold, "Containment")
        self._check_threshold(ani_threshold, "ANI")

        self._init_classification_results()
        if not self.summarized_ranks or force_resummarize:
            self.summarize_up_ranks(
                single_rank=rank, force_resummarize=force_resummarize
            )

        if rank and rank not in self.summarized_ranks:
            raise ValueError(
                f"Error: rank '{rank}' not in summarized rank(s), {','.join(self.summarized_ranks)}"
            )
        self.classified_ranks = [rank] if rank else self.summarized_ranks
        if lingroup_ranks:
            notify("Restricting classification to lingroups.")
            self.classified_ranks = [
                x for x in self.classified_ranks if x in lingroup_ranks
            ]
        if not self.classified_ranks:
            raise ValueError("Error: no ranks remain for classification.")

        classif = None
        for this_rank in self.classified_ranks:
            by_fraction = self._lineages_by_fraction(this_rank)
            if not by_fraction:
                continue
            this_lineage, f_unique_at_rank = by_fraction[0]
            if lingroups and this_lineage not in lingroups:
                continue

            classif = ClassificationResult(
                rank=this_rank,
                fraction=f_unique_at_rank,
                lineage=this_lineage,
                f_weighted_at_rank=self.sum_uniq_weighted[this_rank][this_lineage],
                bp_match_at_rank=self.sum_uniq_bp[this_rank][this_lineage],
            )
            classif.set_status(
                self.query_info,
                containment_threshold=containment_threshold,
                ani_threshold=ani_threshold,
            )
            if classif.status in ("match", "nomatch"):
                break

        self.classification_result = classif
        if classif is not None:
            (
                self.krona_classified,
                self.krona_unclassified,
            ) = self.classification_result.build_krona_result(rank=rank)
            self.krona_header = self.make_krona_header(min_rank=rank)

    def make_krona_header(self, min_rank):
        if min_rank is None:
            return []
        if min_rank not in self.summarized_ranks:
            raise ValueError(f"Rank '{min_rank}' not present in summarized ranks.")
        rank_index = self.ranks.index(min_rank)
        return ["fraction"] + list(self.ranks[: rank_index + 1])

    # -- report generation --------------------------------------------------

    def check_classification(self):
        if not self.classification_result:
            raise ValueError("query not classified yet.")

    def check_summarization(self):
        if not self.summarized_lineage_results:
            raise ValueError("lineages not summarized yet.")

    def make_human_summary(self, display_rank, classification=False):
        if classification:
            self.check_classification()
            display_rank_results = [self.classification_result]
        else:
            self.check_summarization()
            display_rank_results = self.summarized_lineage_results[display_rank]
            display_rank_results.sort(key=lambda res: -res.f_weighted_at_rank)

        return [
            res.as_human_friendly_dict(query_info=self.query_info)
            for res in display_rank_results
        ]

    def _make_classification_summary(self, limit_float):
        self.check_classification()
        header = ["query_name", "status", *_SUMMARY_COLS[1:]]
        rD = self.classification_result.as_summary_dict(
            query_info=self.query_info, limit_float=limit_float
        )
        del rD["total_weighted_hashes"]
        return header, [rD]

    def _make_rank_summary(self, limit_float, lingroups):
        self.check_summarization()
        header = [*_SUMMARY_COLS, "total_weighted_hashes"]

        lingroup_ranks = set()
        if lingroups is not None:
            lingroup_ranks = {len(lin.split(";")) - 1 for lin in lingroups}

        results = []
        for rank in self.summarized_ranks[::-1]:
            if lingroup_ranks and int(rank) not in lingroup_ranks:
                continue
            unclassified = []
            rank_results = self.summarized_lineage_results[rank]
            rank_results.sort(key=lambda res: -res.fraction)
            for res in rank_results:
                rD = res.as_summary_dict(
                    query_info=self.query_info,
                    limit_float=limit_float,
                    lingroups=lingroups,
                )
                if rD is None:
                    continue
                bucket = unclassified if rD["lineage"] == "unclassified" else results
                bucket.append(rD)
            results += unclassified
        return header, results

    def make_full_summary(
        self, classification=False, limit_float=False, lingroups=None
    ):
        if classification:
            return self._make_classification_summary(limit_float)
        return self._make_rank_summary(limit_float, lingroups)

    def make_kreport_results(self):
        "Format summarized results as a kraken-style kreport."
        self.check_summarization()
        header = list(_KREPORT_COLS)
        if not self.query_info.total_weighted_hashes:
            raise ValueError(
                "ERROR: cannot produce 'kreport' format from gather results before sourmash v4.5.0"
            )
        acceptable = set(self.ranks) | {"unclassified", "kingdom"}
        if not set(RANKCODE).issubset(acceptable):
            raise ValueError(
                f"ERROR: cannot produce 'kreport' format from ranks {', '.join(self.ranks)}"
            )
        kreport_results = []
        unclassified_recorded = False
        for rank in self.ranks:
            if rank == "strain":
                continue
            for res in self.summarized_lineage_results[rank]:
                kresD = res.as_kreport_dict(self.query_info)
                if kresD["sci_name"] == "unclassified":
                    # only report the unclassified remainder once
                    if unclassified_recorded:
                        continue
                    unclassified_recorded = True
                kreport_results.append(kresD)
        return header, kreport_results

    def make_lingroup_results(self, LINgroupsD):
        "Report results for the specified LINgroups (prefix -> name dict)."
        self.check_summarization()
        header = ["name", "lin", "percent_containment", "num_bp_contained"]

        if self.query_info.total_weighted_hashes == 0:
            raise ValueError(
                "ERROR: cannot produce 'lingroup' format from gather results before sourmash v4.5.0"
            )

        lg_ranks, all_lgs = parse_lingroups(LINgroupsD)

        lg_results = {}
        for rank in lg_ranks:
            for res in self.summarized_lineage_results[rank]:
                if res.lineage in all_lgs:
                    this_lingroup_name = LINgroupsD[
                        res.lineage.display_lineage(truncate_empty=True)
                    ]
                    lg_results[res.lineage] = res.as_lingroup_dict(
                        self.query_info, this_lingroup_name
                    )

        # emit in depth-first LINgroup-tree order (internal nodes included)
        lg_tree = LineageTree(all_lgs)
        lingroup_results = []
        for lg in lg_tree.ordered_paths(include_internal=True):
            lg_res = lg_results.get(LINLineageInfo(lineage=lg))
            if lg_res:
                lingroup_results.append(lg_res)

        return header, lingroup_results

    def make_cami_bioboxes(self):
        "CAMI profiling Bioboxes format output."
        ranks = list(self.ranks)
        header_lines = [
            "# Taxonomic Profiling Output",
            f"@SampleID:{self.query_info.query_name}",
            "@Version:0.10.0",
            f"@Ranks:{'|'.join(ranks)}",
            "@__program__:sourmash",
            "\t".join(["@@TAXID", "RANK", "TAXPATH", "TAXPATHSN", "PERCENTAGE"]),
        ]

        bioboxes_results = []
        for rank in ranks:
            for res in self.summarized_lineage_results[rank]:
                bb_info = res.as_cami_bioboxes()
                if bb_info:
                    bioboxes_results.append(bb_info)

        return header_lines, bioboxes_results


# ---------------------------------------------------------------------------
# gather-CSV collection/loading helpers
# ---------------------------------------------------------------------------


def collect_gather_csvs(cmdline_gather_input, *, from_file=None):
    "Collect gather files from the command line + --from-file, deduplicated."
    gather_csvs = []
    more = list(load_pathlist_from_file(from_file)) if from_file else []
    for gf in list(cmdline_gather_input) + more:
        if gf not in gather_csvs:
            gather_csvs.append(gf)
        else:
            notify(f"ignoring duplicated reference to file: {gf}")
    return gather_csvs


def read_lingroups(lingroup_csv):
    """Load a lingroup CSV into {lin prefix: display name} (last name wins).

    The file must carry 'lin' and 'name' columns and at least one data row.
    (parity surface: reference tax_utils.py read_lingroups console strings)
    """
    with sourmash_args.FileInputCSV(lingroup_csv) as rows:
        cols = rows.fieldnames
        if not cols:
            raise ValueError(
                f"Cannot read lingroups from '{lingroup_csv}'. Is file empty?"
            )
        if not {"lin", "name"}.issubset(cols):
            raise ValueError(
                f"'{lingroup_csv}' must contain the following columns: 'name', 'lin'."
            )
        total_rows = 0
        prefix_to_name = {}
        for row in rows:
            total_rows += 1
            prefix_to_name[row["lin"]] = row["name"]

    if not total_rows:
        raise ValueError(f"No lingroups loaded from {lingroup_csv}.")
    notify(
        f"Read {total_rows} lingroup rows and found {len(prefix_to_name)}"
        " distinct lingroup prefixes."
    )
    return prefix_to_name


def parse_lingroups(lingroupD):
    """Expand lingroup prefixes into LINLineageInfo objects plus the set of
    rank strings those prefixes terminate at (the ranks worth summarizing)."""
    infos = {LINLineageInfo(lineage_str=prefix) for prefix in lingroupD}
    return {str(info.lowest_rank) for info in infos}, infos


def _annotated_taxresults(csv_name, reader, tax_assignments, *, opts):
    """Yield one lineage-annotated TaxResult per gather-CSV row.

    `opts` carries the identifier/lineage-flavor keywords shared by every
    row of the file. Raises ValueError with the exact console strings the
    CLI promises when a row is missing required gather columns.
    """
    for row in reader:
        try:
            raw = GatherRow(**filter_row(row, GatherRow))
        except TypeError as exc:
            raise ValueError(
                f"'{csv_name}' is missing columns needed for taxonomic summarization. Please run gather with sourmash >= 4.4."
            ) from exc
        res = TaxResult(
            raw=raw,
            keep_full_identifiers=opts["keep_full_identifiers"],
            keep_identifier_versions=opts["keep_identifier_versions"],
            lins=opts["lins"],
            ictv=opts["ictv"],
        )
        res.get_match_lineage(
            tax_assignments=tax_assignments,
            skip_idents=opts["skip_idents"],
            fail_on_missing_taxonomy=opts["fail_on_missing_taxonomy"],
        )
        yield res


def load_gather_results(
    gather_csv,
    tax_assignments,
    *,
    seen_queries=None,
    force=False,
    skip_idents=None,
    fail_on_missing_taxonomy=False,
    keep_full_identifiers=False,
    keep_identifier_versions=False,
    lins=False,
    ictv=False,
):
    """Load one gather CSV into {query_name: QueryTaxResult}.

    Rows are streamed through _annotated_taxresults and folded into a
    per-query accumulator; a run of mutually-compatible rows reuses the
    live accumulator without a dict lookup (matching the reference's
    grouping behavior). `seen_queries` holds names already loaded from
    OTHER files — a repeat across files is an error.
    """
    forbidden = seen_queries if seen_queries else set()
    row_opts = dict(
        keep_full_identifiers=keep_full_identifiers,
        keep_identifier_versions=keep_identifier_versions,
        lins=lins,
        ictv=ictv,
        skip_idents=skip_idents,
        fail_on_missing_taxonomy=fail_on_missing_taxonomy,
    )
    by_query = {}
    with sourmash_args.FileInputCSV(gather_csv) as reader:
        header = reader.fieldnames
        if not header:
            raise ValueError(
                f"Cannot read gather results from '{gather_csv}'. Is file empty?"
            )

        bucket = None
        stream = _annotated_taxresults(
            gather_csv, reader, tax_assignments, opts=row_opts
        )
        for taxres in stream:
            qname = taxres.query_name
            if qname in forbidden:
                raise ValueError(
                    f"Gather query {qname} was found in more than one CSV. Cannot load from '{gather_csv}'."
                )
            if bucket is None or not bucket.is_compatible(taxres):
                bucket = by_query.get(qname)
                if bucket is None:
                    bucket = QueryTaxResult(taxres.query_info, lins=lins, ictv=ictv)
            bucket.add_taxresult(taxres)
            by_query[qname] = bucket

    if not by_query:
        raise ValueError(f"No gather results loaded from {gather_csv}.")
    notify(f"loaded {len(by_query)} gather results from '{gather_csv}'.")
    return (by_query, header)


_SUMMARY_COLS = (
    "query_name",
    "rank",
    "fraction",
    "lineage",
    "query_md5",
    "query_filename",
    "f_weighted_at_rank",
    "bp_match_at_rank",
    "query_ani_at_rank",
)

_KREPORT_COLS = (
    "percent_containment",
    "num_bp_contained",
    "num_bp_assigned",
    "rank_code",
    "ncbi_taxid",
    "sci_name",
)


def check_and_load_gather_csvs(
    gather_csvs,
    tax_assign,
    *,
    fail_on_missing_taxonomy=False,
    force=False,
    keep_full_identifiers=False,
    keep_identifier_versions=False,
    lins=False,
    ictv=False,
):
    "Load gather CSVs, handling empties and missing-taxonomy idents."
    if not isinstance(gather_csvs, list):
        gather_csvs = [gather_csvs]
    gather_results = {}
    n_ignored = 0
    n = 0
    load_opts = dict(
        force=force,
        keep_full_identifiers=keep_full_identifiers,
        keep_identifier_versions=keep_identifier_versions,
        fail_on_missing_taxonomy=fail_on_missing_taxonomy,
        lins=lins,
        ictv=ictv,
    )
    for n, gather_csv in enumerate(gather_csvs):
        try:
            these_results, _ = load_gather_results(
                gather_csv,
                tax_assign,
                seen_queries=gather_results.keys(),
                **load_opts,
            )
        except ValueError as exc:
            msg = str(exc)
            if not force:
                notify("Exiting.")
                raise
            if "found in more than one CSV" in msg:
                notify("Cannot force past duplicated gather query. Exiting.")
                raise
            if "Failing, as requested via --fail-on-missing-taxonomy" in msg:
                raise
            notify(msg)
            notify(
                "--force is set. Attempting to continue to next set of gather results."
            )
            n_ignored += 1
            continue

        gather_results.update(these_results)

    num_gather_csvs_loaded = n + 1 - n_ignored
    notify(
        f"loaded results for {len(gather_results)} queries from {str(num_gather_csvs_loaded)} gather CSVs"
    )
    report_missing_and_skipped_identities(gather_results)

    return list(gather_results.values())


def report_missing_and_skipped_identities(gather_results):
    "Report match identifiers absent from the taxonomy assignments."
    ident_missed = set()
    total_n_missed = 0
    total_taxresults = 0
    for querytaxres in gather_results.values():
        ident_missed.update(querytaxres.missed_idents)
        total_n_missed += querytaxres.n_missed
        total_taxresults += len(querytaxres.raw_taxresults)

    if ident_missed:
        notify(
            f"of {total_taxresults} gather results, lineage assignments for {total_n_missed} results were missed."
        )
        notify(
            f'The following are missing from the taxonomy information: {", ".join(ident_missed)}'
        )


# ---------------------------------------------------------------------------
# aggregation + output writers
# ---------------------------------------------------------------------------


def aggregate_by_lineage_at_rank(query_gather_results, rank, *, by_query=False):
    "Aggregate summarized results at one rank, optionally per query."
    lineage_summary = defaultdict(dict) if by_query else defaultdict(float)
    all_queries = []

    for queryResult in query_gather_results:
        query_name = queryResult.query_name
        all_queries.append(query_name)

        if rank not in queryResult.summarized_ranks:
            raise ValueError(f"Error: rank '{rank}' not available for aggregation.")

        for res in queryResult.summarized_lineage_results[rank]:
            lineage = res.lineage.display_lineage(null_as_unclassified=True)
            if by_query:
                lineage_summary[lineage][query_name] = res.fraction
            else:
                lineage_summary[lineage] += res.fraction

    if not by_query:
        n_queries = len(all_queries)
        for lin, fraction in lineage_summary.items():
            lineage_summary[lin] = fraction / n_queries
    return lineage_summary, all_queries


def format_for_krona(query_gather_results, rank, *, classification=False):
    "Aggregate and format for krona output."
    header = query_gather_results[0].make_krona_header(min_rank=rank)
    if len(query_gather_results) > 1:
        notify(
            "WARNING: results from more than one query found. Krona summarization not recommended.\n"
            "Percentage assignment will be normalized by the number of queries to maintain range 0-100%."
        )

    krona_results = []
    if classification:
        for q_res in query_gather_results:
            if q_res.classified_ranks != [rank]:
                q_res.build_classification_result(rank=rank)
                header = q_res.make_krona_header(min_rank=rank)
            krona_results.append(q_res.krona_classified)
        return krona_results, header

    lineage_summary, _ = aggregate_by_lineage_at_rank(
        query_gather_results, rank, by_query=False
    )

    unclassified_fraction = 0
    for lin, fraction in sorted(lineage_summary.items(), key=lambda x: -x[1]):
        if lin == "unclassified":
            unclassified_fraction = fraction
        else:
            krona_results.append((fraction, *lin.split(";")))

    if unclassified_fraction:
        unclassified_names = ["unclassified"] * (len(header) - 1)
        krona_results.append((unclassified_fraction, *unclassified_names))

    return krona_results, header


def write_krona(header, krona_results, out_fp, *, sep="\t"):
    "Write krona output."
    tsv_output = csv.writer(out_fp, delimiter=sep)
    tsv_output.writerow(header)
    for res in krona_results:
        tsv_output.writerow(res)


def write_output(header, results, out_fp, *, sep=",", write_header=True):
    "Write a list of result-row dicts."
    output = csv.DictWriter(out_fp, header, delimiter=sep)
    if write_header:
        output.writeheader()
    for res in results:
        output.writerow(res)


def write_bioboxes(header_lines, results, out_fp, *, sep="\t"):
    "Write bioboxes-format rows (lists)."
    for inf in header_lines:
        out_fp.write(inf + "\n")
    for res in results:
        out_fp.write(sep.join(res) + "\n")


def write_summary(
    query_gather_results,
    csv_fp,
    *,
    sep=",",
    limit_float_decimals=False,
    classification=False,
    lingroups=None,
):
    "Write taxonomy-summarized gather results for each rank."
    writer = None
    for q_res in query_gather_results:
        header, summary = q_res.make_full_summary(
            classification=classification,
            limit_float=limit_float_decimals,
            lingroups=lingroups,
        )
        if writer is None:
            writer = csv.DictWriter(csv_fp, header, delimiter=sep)
            writer.writeheader()
        writer.writerows(summary)


_HUMAN_CLS_HEADER = (
    "sample name    status    proportion   cANI   lineage\n"
    "-----------    ------    ----------   ----   -------\n"
)
_HUMAN_CLS_ROW = (
    "{query_name:<15s}   {status}    {f_weighted_at_rank}     {query_ani_at_rank}  {lineage}\n"
)
_HUMAN_SUM_HEADER = (
    "sample name    proportion   cANI   lineage\n"
    "-----------    ----------   ----   -------\n"
)
_HUMAN_SUM_ROW = (
    "{query_name:<15s}   {f_weighted_at_rank}     {query_ani_at_rank}  {lineage}\n"
)


def write_human_summary(
    query_gather_results, out_fp, display_rank, classification=False
):
    "Write human-readable summary for a specific rank."
    if classification:
        header, row_template = _HUMAN_CLS_HEADER, _HUMAN_CLS_ROW
    else:
        header, row_template = _HUMAN_SUM_HEADER, _HUMAN_SUM_ROW

    for queryResult in query_gather_results:
        results = queryResult.make_human_summary(
            display_rank=display_rank, classification=classification
        )
        out_fp.write(header)
        for rD in results:
            out_fp.write(row_template.format(**rD))


def write_lineage_sample_frac(sample_names, lineage_dict, out_fp, *, sep="\t"):
    "Write per-sample lineage fractions as a tab-separated table."
    header = ["lineage"] + sample_names
    w = csv.DictWriter(out_fp, header, delimiter=sep)
    w.writeheader()
    blank_row = {query_name: 0 for query_name in sample_names}
    unclassified_row = None
    for lin, sampleinfo in sorted(lineage_dict.items()):
        row = {"lineage": lin, **blank_row, **sampleinfo}
        if lin == "unclassified":
            unclassified_row = row
            continue
        w.writerow(row)
    if unclassified_row:
        w.writerow(unclassified_row)
