"""sqlite3-backed Index and CollectionManifest.

The port of `sourmash_tpu/index/sqlite_index.py` (reference
`src/sourmash/index/sqlite_index.py`: SqliteIndex:188,
SqliteCollectionManifest:625; schema: `sourmash_hashes` /
`sourmash_sketches` / `sourmash_internal` tables, hashes > 2^63-1 stored as
wrapped signed ints), so a `.sqldb` written by either package loads in the
other. `search` and `prefetch` score through SQL overlap counts as the
reference does; `gather` goes through `Index.counter_gather`, whose flat
view puts collections of SOURMASH_TORCH_FLAT_VIEW sketches or more on the
device engine. `LCA_SqliteDatabase` is a sqlite LCA database: the index
with a `SqliteLineage` table beside it.

Shared plumbing lives at module level: `_hash_window` builds the
bounded-hashval WHERE fragment used by every reverse-index query, and
`_minhash_for` materializes a MinHash from stored sketch parameters.
"""

from __future__ import annotations

import itertools
import os
import sqlite3

import numpy as np

from .. import sqlite_utils
from ..exceptions import IndexNotSupported
from ..index import (
    Index,
    IndexSearchResult,
    StandaloneManifestIndex,
    _check_select_parameters,
)
from ..lca.lca_db import cached_property
from ..logging import debug_literal
from ..manifest import BaseCollectionManifest
from ..minhash import MinHash
from ..picklist import SignaturePicklist
from ..signature import SourmashSignature

MAX_SQLITE_INT = 2**63 - 1


def convert_hash_to(x):
    "uint64 -> sqlite signed int (wrap around 2^63)."
    return x - 2**64 if x > MAX_SQLITE_INT else x


def convert_hash_from(x):
    "sqlite signed int -> uint64."
    return x + 2**64 if x < 0 else x


def _hash_window(max_hash, *, table="sourmash_hashes"):
    """WHERE fragment + values restricting hashval to [0, max_hash].

    Stored hashes above 2^63-1 wrap negative, so the restriction only
    works (and is only needed) when max_hash fits in a signed int; above
    that every row qualifies and the fragment is empty."""
    if max_hash <= MAX_SQLITE_INT:
        return [f"{table}.hashval >= 0 AND {table}.hashval <= ?"], [max_hash]
    return [], []


def _minhash_for(*, ksize, scaled, moltype, seed):
    "An empty scaled MinHash matching stored sketch parameters."
    return MinHash(
        n=0,
        ksize=ksize,
        scaled=scaled,
        seed=seed,
        is_protein=moltype == "protein",
        dayhoff=moltype == "dayhoff",
        hp=moltype == "hp",
    )


def _fetched_hashvals(cursor):
    "Drain a hashval query into a uint64 array (the stored ints' bit patterns)."
    return np.fromiter((hashval for (hashval,) in cursor), dtype=np.int64).view(np.uint64)


def _wrapped(hashes: np.ndarray) -> list:
    "uint64 hashes as the signed ints sqlite stores (`convert_hash_to` of each)."
    return np.asarray(hashes, dtype=np.uint64).view(np.int64).tolist()


def _versioned_flag(internal_d, key, what):
    "True if `key` is present at version 1.0; raise on other versions."
    if key not in internal_d:
        return False
    if internal_d[key] != "1.0":
        raise IndexNotSupported(f"unsupported {what} version")
    return True


class SqliteIndex(Index):
    "Scaled signatures reverse-indexed by hash in a sqlite database."

    is_database = True

    def __init__(self, dbfile, *, sqlite_manifest=None, conn=None):
        self.dbfile = dbfile

        if conn is None:
            conn = self._open(dbfile)

        if sqlite_manifest is None:
            sqlite_manifest = SqliteCollectionManifest(conn, managed_by_index=True)
        self.manifest = sqlite_manifest
        self.conn = conn

        c = self.conn.cursor()
        c.execute("SELECT DISTINCT scaled FROM sourmash_sketches")
        scaled_vals = [v for (v,) in c.fetchall()]
        if len(scaled_vals) > 1:
            msg = "this database has multiple scaled values, which is not currently allowed"
            raise ValueError(msg)
        self.scaled = scaled_vals[0] if scaled_vals else None

    _PRAGMAS = (
        "PRAGMA cache_size=10000000",
        "PRAGMA synchronous = OFF",
        "PRAGMA journal_mode = MEMORY",
        "PRAGMA temp_store = MEMORY",
    )

    @classmethod
    def _open(cls, dbfile, *, empty_ok=True):
        "Connect to an existing SQLite database or create a new one."
        try:
            conn = sqlite3.connect(dbfile)
            c = conn.cursor()
            for pragma in cls._PRAGMAS:
                c.execute(pragma)
            if not empty_ok:
                c.execute("SELECT * FROM sourmash_hashes LIMIT 1")
                c.fetchone()
        except (sqlite3.OperationalError, sqlite3.DatabaseError):
            raise ValueError(f"cannot open '{dbfile}' as SqliteIndex database")
        return conn

    @classmethod
    def load(cls, dbfile):
        return SqliteIndex(dbfile)

    @classmethod
    def create(cls, dbfile, *, append=False):
        conn = cls._open(dbfile, empty_ok=True)
        cls._create_tables(conn.cursor(), ignore_exists=append)
        conn.commit()
        return cls(dbfile, conn=conn)

    _HASH_TABLE_DDL = (
        "CREATE TABLE IF NOT EXISTS sourmash_hashes ("
        " hashval INTEGER NOT NULL,"
        " sketch_id INTEGER NOT NULL,"
        " FOREIGN KEY (sketch_id) REFERENCES sourmash_sketches (id) )",
        "CREATE INDEX IF NOT EXISTS sourmash_hashval_idx"
        " ON sourmash_hashes ( hashval, sketch_id )",
        "CREATE INDEX IF NOT EXISTS sourmash_hashval_idx2 ON sourmash_hashes (hashval)",
        "CREATE INDEX IF NOT EXISTS sourmash_sketch_idx ON sourmash_hashes (sketch_id)",
    )

    @classmethod
    def _create_tables(cls, c, *, ignore_exists=False):
        "Create the index + manifest tables."
        try:
            sqlite_utils.add_sourmash_internal(c, "SqliteIndex", "1.0")
            SqliteCollectionManifest._create_tables(c)
            for statement in cls._HASH_TABLE_DDL:
                c.execute(statement)
        except (sqlite3.OperationalError, sqlite3.DatabaseError):
            if not ignore_exists:
                raise ValueError("cannot create SqliteIndex tables")
        return c

    # thin connection passthroughs
    def cursor(self):
        return self.conn.cursor()

    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.close()

    @property
    def location(self):
        return self.dbfile

    def __len__(self):
        return len(self.manifest)

    def _load_sketch_size(self, c1, sketch_id, max_hash):
        "Number of a sketch's hashes within [0, max_hash]."
        window, values = _hash_window(max_hash)
        where = " AND ".join(["sketch_id=?"] + window)
        c1.execute(
            f"SELECT COUNT(hashval) FROM sourmash_hashes WHERE {where}",
            [sketch_id] + values,
        )
        (n_hashes,) = c1.fetchone()
        return n_hashes

    def _load_sketch(self, c, sketch_id, *, match_scaled=None):
        "Load one sketch as a signature, optionally downsampled."
        c.execute(
            "SELECT id, name, scaled, ksize, filename, moltype, seed"
            " FROM sourmash_sketches WHERE id=?",
            (sketch_id,),
        )

        sketch_id, name, scaled, ksize, filename, moltype, seed = c.fetchone()
        if match_scaled is not None:
            scaled = max(scaled, match_scaled)

        mh = _minhash_for(ksize=ksize, scaled=scaled, moltype=moltype, seed=seed)

        window, values = _hash_window(mh._max_hash)
        where = " AND ".join(window + ["sourmash_hashes.sketch_id=?"])
        c.execute(
            f"SELECT hashval FROM sourmash_hashes WHERE {where}",
            values + [sketch_id],
        )
        mh.add_many(_fetched_hashvals(c))

        return SourmashSignature(mh, name=name, filename=filename)

    def _load_sketches(self, c):
        "Load all (selected) sketches via the manifest's _id column."
        for row in self.manifest.rows:
            sketch_id = row["_id"]
            assert row["num"] == 0

            mh = _minhash_for(
                ksize=row["ksize"],
                scaled=row["scaled"],
                moltype=row["moltype"],
                seed=row["seed"],
            )

            c.execute(
                "SELECT hashval FROM sourmash_hashes WHERE sketch_id=?", (sketch_id,)
            )
            mh.add_many(_fetched_hashvals(c))

            ss = SourmashSignature(mh, name=row["name"], filename=row["filename"])
            yield ss, self.dbfile, sketch_id

    def _get_matching_sketches(self, c, hashes, max_hash):
        """All sketches overlapping the given hashes (a uint64 array), with
        overlap counts, ordered by count descending."""
        c.execute("DROP TABLE IF EXISTS sourmash_hash_query")
        c.execute("CREATE TEMPORARY TABLE sourmash_hash_query"
                  " (hashval INTEGER PRIMARY KEY)")
        wrapped = [(h,) for h in _wrapped(hashes)]
        c.executemany(
            "INSERT OR IGNORE INTO sourmash_hash_query (hashval) VALUES (?)",
            wrapped,
        )

        conditions, template_values = _hash_window(min(max_hash, int(hashes.max())))
        conditions.append("sourmash_hashes.hashval=sourmash_hash_query.hashval")

        overlap_query = (
            "SELECT DISTINCT sourmash_hashes.sketch_id,"
            "COUNT(sourmash_hashes.hashval) as CNT"
            " FROM sourmash_hashes, sourmash_hash_query"
            f" WHERE {' AND '.join(conditions)}"
            " GROUP BY sourmash_hashes.sketch_id ORDER BY CNT DESC"
        )
        c.execute(overlap_query, template_values)
        return c


    def insert(self, ss, *, cursor=None, commit=True):
        "Insert a signature; hashes go into the reverse index."
        c = cursor if cursor else self.conn.cursor()
        mh = ss.minhash

        if mh.num:
            raise ValueError("cannot store 'num' signatures in SqliteIndex")
        if mh.track_abundance:
            raise ValueError("cannot store signatures with abundance in SqliteIndex")

        if self.scaled is None:
            self.scaled = mh.scaled
        elif self.scaled != mh.scaled:
            msg = f"this database can only store scaled values={self.scaled}"
            raise ValueError(msg)

        row = BaseCollectionManifest.make_manifest_row(
            ss, None, include_signature=False
        )
        self.manifest._insert_row(c, row, call_is_from_index=True)

        c.execute("SELECT last_insert_rowid()")
        (sketch_id,) = c.fetchone()

        c.executemany(
            "INSERT INTO sourmash_hashes (hashval, sketch_id) VALUES (?, ?)",
            zip(_wrapped(mh.mins_array()), itertools.repeat(sketch_id)),
        )

        if commit:
            self.conn.commit()

    def signatures(self):
        for ss, loc in self.signatures_with_location():
            yield ss

    def signatures_with_location(self):
        c = self.conn.cursor()
        yield from ((ss, loc) for ss, loc, _iloc in self._load_sketches(c))

    def save(self, *args, **kwargs):
        raise NotImplementedError  # insert() writes through immediately

    def find(self, search_fn, query, **kwargs):
        "Search via SQL: reverse-index overlap counts drive scoring."
        search_fn.check_is_compatible(query)

        query_mh = query.minhash
        if self.scaled > query_mh.scaled:
            query_mh = query_mh.downsample(scaled=self.scaled)

        selection = self.manifest.selection_dict or {}
        picklist = selection.get("picklist")

        c1, c2 = self.conn.cursor(), self.conn.cursor()

        query_size = len(query_mh)
        for sketch_id, n_matching_hashes in self._get_matching_sketches(
            c1, query_mh.mins_array(), query_mh._max_hash
        ):
            subj_size = self._load_sketch_size(c2, sketch_id, query_mh._max_hash)
            shared_size = n_matching_hashes
            total_size = query_size + subj_size - shared_size

            score = search_fn.score_fn(query_size, shared_size, subj_size, total_size)
            if not search_fn.passes(score):
                continue

            subj = self._load_sketch(c2, sketch_id)
            if search_fn.collect(score, subj):
                if picklist is None or subj in picklist:
                    yield IndexSearchResult(score, subj, self.location)

    def _select(self, *, num=0, track_abundance=False, **kwargs):
        _check_select_parameters(**kwargs)

        if num:
            raise ValueError("cannot select on 'num' in SqliteIndex")
        if track_abundance:
            raise ValueError("cannot store or search signatures with abundance")

        manifest = self.manifest
        if manifest is None:
            manifest = SqliteCollectionManifest(self.conn, managed_by_index=True)

        return manifest.select_to_manifest(**kwargs)

    def select(self, *args, **kwargs):
        sqlite_manifest = self._select(*args, **kwargs)
        return SqliteIndex(self.dbfile, sqlite_manifest=sqlite_manifest, conn=self.conn)

    # -- SQL helpers -------------------------------------------------------

# column order of the sourmash_sketches SELECTs used by `rows`
_SKETCH_COLUMNS = (
    "id",
    "name",
    "md5sum",
    "num",
    "scaled",
    "ksize",
    "filename",
    "moltype",
    "seed",
    "n_hashes",
    "internal_location",
)


class SqliteCollectionManifest(BaseCollectionManifest):
    "SQLite-backed manifest (standalone, or managed by a SqliteIndex)."

    def __init__(self, conn, *, selection_dict=None, managed_by_index=False):
        assert conn is not None
        self.conn, self.selection_dict = conn, selection_dict
        self.managed_by_index = managed_by_index
        self._num_rows = None  # lazily-computed row count

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, filename):
        conn = sqlite3.connect(filename)
        cls._create_tables(conn.cursor())
        return cls(conn)

    @classmethod
    def create_or_open(cls, filename):
        conn = sqlite3.connect(filename)
        try:
            cls._create_tables(conn.cursor())
        except sqlite3.OperationalError:
            pass
        return cls(conn)

    @classmethod
    def load_from_manifest(cls, manifest, *, dbfile=":memory:", append=False):
        return cls._create_manifest_from_rows(manifest.rows, location=dbfile,
                                              append=append)

    @classmethod
    def create_manifest(cls, locations_iter, *, include_signature=False):
        rows = (
            cls.make_manifest_row(ss, location, include_signature=False)
            for ss, location in locations_iter
        )
        return cls._create_manifest_from_rows(rows)

    @classmethod
    def _create_manifest_from_rows(cls, rows_iter, *, location=":memory:", append=False):
        try:
            mf = cls.create(location)
        except (sqlite3.OperationalError, sqlite3.DatabaseError) as exc:
            if not append:
                msg = f"cannot create sqlite3 db at '{location}'; exception: {str(exc)}"
                raise Exception(msg)
            mf = load_sqlite_index(location, request_manifest=True).manifest

        cursor = mf.conn.cursor()
        for row in rows_iter:
            mf._insert_row(cursor, row)
        mf.conn.commit()
        return mf

    _SKETCH_TABLE_DDL = (
        "CREATE TABLE sourmash_sketches"
        " (id INTEGER PRIMARY KEY,"
        " name TEXT,"
        " num INTEGER NOT NULL,"
        " scaled INTEGER NOT NULL,"
        " ksize INTEGER NOT NULL,"
        " filename TEXT,"
        " moltype TEXT NOT NULL,"
        " with_abundance BOOLEAN NOT NULL,"
        " md5sum TEXT NOT NULL,"
        " seed INTEGER NOT NULL,"
        " n_hashes INTEGER NOT NULL,"
        " internal_location TEXT,"
        " UNIQUE(internal_location, md5sum) )"
    )

    @classmethod
    def _create_tables(cls, cursor):
        sqlite_utils.add_sourmash_internal(cursor, "SqliteManifest", "1.0")
        cursor.execute(cls._SKETCH_TABLE_DDL)

    # -- row insertion -------------------------------------------------------

    def add_row(self, row):
        self._insert_row(self.conn.cursor(), row)

    def _insert_row(self, cursor, row, *, call_is_from_index=False):
        if self.managed_by_index and not call_is_from_index:
            raise Exception("must use SqliteIndex.insert to add to this manifest")

        row = dict(row)
        row.setdefault("seed", 42)

        cursor.execute(
            "INSERT OR IGNORE INTO sourmash_sketches"
            " (name, num, scaled, ksize, filename, md5sum, moltype,"
            "  seed, n_hashes, with_abundance, internal_location)"
            " VALUES (:name, :num, :scaled, :ksize, :filename, :md5,"
            "  :moltype, :seed, :n_hashes, :with_abundance, :internal_location)",
            row,
        )
        self._num_rows = None  # invalidate the cached count

    # -- container protocol --------------------------------------------------

    def __bool__(self):
        if self._num_rows is not None:
            return bool(self._num_rows)
        return any(True for _ in self.rows)

    def __len__(self):
        if self._num_rows is None:
            self._num_rows = sum(1 for _ in self.rows)
        return self._num_rows

    def __iadd__(self, other):
        c = self.conn.cursor()
        for row in other.rows:
            self._insert_row(c, row)
        return self  # rows appended in place

    def __add__(self, other):
        merged = self.create(":memory:")
        merged += self
        merged += other
        return merged

    def __contains__(self, ss):
        c = self.conn.cursor()
        c.execute(
            "SELECT COUNT(*) FROM sourmash_sketches WHERE md5sum=?", (ss.md5sum(),)
        )
        (n_stored,) = c.fetchone()
        if not n_stored:
            return False
        return self.picklist is None or ss in self.picklist

    def close(self):
        self.conn.commit()

    # -- selection -----------------------------------------------------------

    def _make_select(self):
        "Build SQL WHERE conditions + values + picklist from selection_dict."
        conditions = []
        values = []
        picklist = None
        if self.selection_dict:
            select_d = self.selection_dict
            if select_d.get("ksize"):
                conditions.append("sourmash_sketches.ksize = ?")
                values.append(select_d["ksize"])
            if (select_d.get("num") or 0) > 0:
                conditions.append("sourmash_sketches.num > 0")
            if (select_d.get("scaled") or 0) > 0 or select_d.get("containment"):
                conditions.append("sourmash_sketches.scaled > 0")
            moltype = select_d.get("moltype")
            if moltype is not None:
                assert moltype in ("DNA", "protein", "dayhoff", "hp"), moltype
                conditions.append(f"sourmash_sketches.moltype = '{moltype}'")

            picklist = select_d.get("picklist")

        return conditions, values, picklist

    def _merged_selection(self, kwargs):
        "Layer new selector kwargs over the existing ones; reject conflicts."
        merged = dict(self.selection_dict)
        for key, value in kwargs.items():
            prior = merged.get(key)
            if key in merged and prior is not None and prior != value:
                raise ValueError(f"incompatible select on '{key}'")
            merged[key] = value
        return merged

    def select_to_manifest(self, **kwargs):
        if self.selection_dict:
            kwargs = self._merged_selection(kwargs)

        new_mf = SqliteCollectionManifest(self.conn, selection_dict=kwargs)

        if kwargs.get("picklist") is not None:
            _ = len(self)  # forces iteration, filling picklist.found

        return new_mf

    def _selected_sketch_query(self, columns):
        "SELECT the given columns under the current selection conditions."
        c1 = self.conn.cursor()
        conditions, values, picklist = self._make_select()
        where = f"WHERE {' AND '.join(conditions)}" if conditions else ""
        c1.execute(f"SELECT {columns} FROM sourmash_sketches {where}", values)
        return c1, picklist

    @property
    def rows(self):
        c1, picklist = self._selected_sketch_query(", ".join(_SKETCH_COLUMNS))

        for values in c1:
            stored = dict(zip(_SKETCH_COLUMNS, values))
            row = dict(
                num=stored["num"],
                scaled=stored["scaled"],
                name=stored["name"],
                filename=stored["filename"],
                n_hashes=stored["n_hashes"],
                with_abundance=False,
                ksize=stored["ksize"],
                md5=stored["md5sum"],
                internal_location=stored["internal_location"],
                moltype=stored["moltype"],
                md5short=stored["md5sum"][:8],
                seed=stored["seed"],
                _id=stored["id"],
            )
            if picklist is None or picklist.matches_manifest_row(row):
                yield row

    def locations(self):
        "All possible internal locations (may be a superset under picklists)."
        c1, _ = self._selected_sketch_query("DISTINCT internal_location")
        return (iloc for (iloc,) in c1)

    def filter_rows(self, row_filter_fn):
        return self._create_manifest_from_rows(
            row for row in self.rows if row_filter_fn(row)
        )

    def filter_on_columns(self, col_filter_fn, col_names):
        def row_filter_fn(row):
            vals = [row[col] for col in col_names if row[col] is not None]
            return col_filter_fn(vals)

        return self.filter_rows(row_filter_fn)

    @property
    def picklist(self):
        if self.selection_dict:
            return self.selection_dict.get("picklist")
        return None

    def to_picklist(self):
        pl = SignaturePicklist("manifest")
        pl.pickset = {pl._get_value_for_manifest_row(row) for row in self.rows}
        return pl


class LCA_SqliteDatabase(SqliteIndex):
    "SqliteIndex + sqlite lineage table => on-disk LCA database."

    is_database = True

    def __init__(self, dbfile, *, lineage_db=None, sqlite_manifest=None):
        super().__init__(dbfile, sqlite_manifest=sqlite_manifest)

        c = self.conn.cursor()
        c.execute("SELECT DISTINCT ksize, moltype FROM sourmash_sketches")
        params = list(c)
        if not params:
            raise ValueError("cannot load an LCA_SqliteDatabase")
        if len(params) > 1:
            raise TypeError(
                "can only have one ksize & moltype in an LCA_SqliteDatabase"
            )
        (self.ksize, self.moltype), = params

        if lineage_db is not None:
            self.lineage_db = lineage_db
            self._build_index()

    @classmethod
    def load(cls, filename):
        from ..tax.tax_utils import LineageDB_Sqlite

        try:
            obj = cls(filename)
        except sqlite3.OperationalError:
            raise ValueError(f"cannot open '{filename}' as a SQLite index.")

        obj.lineage_db = LineageDB_Sqlite(obj.conn)
        obj._build_index()
        return obj

    @classmethod
    def create(cls, filename, idx, lineage_db):
        "Build an LCA_SqliteDatabase in one file from an index + lineage db."
        from ..tax.tax_utils import MultiLineageDB

        sqlidx = SqliteIndex.create(filename)

        for ss in idx.signatures():
            sqlidx.insert(ss)

        out_lineage_db = MultiLineageDB()
        out_lineage_db.add(lineage_db)
        out_lineage_db._save_sqlite(None, conn=sqlidx.conn)

        return cls.load(filename)

    def _build_index(self):
        "Build identifier <-> lineage mappings from manifest + lineage db."
        ident_to_idx, idx_to_lid = {}, {}
        lineage_to_lid, lid_to_lineage = {}, {}
        next_lid = 0

        for row in self.manifest.rows:
            name = row["name"]
            if not name:
                continue

            # look up by the space-split identifier, then by version-stripped
            ident = name.split(" ")[0]
            lineage = self.lineage_db.get(ident)
            if lineage is None:
                ident = name.split(".")[0]
                lineage = self.lineage_db.get(ident)

            idx = row["_id"]
            ident_to_idx[ident] = idx

            if lineage:
                if lineage not in lineage_to_lid:
                    lineage_to_lid[lineage] = next_lid
                    lid_to_lineage[next_lid] = lineage
                    next_lid += 1
                idx_to_lid[idx] = lineage_to_lid[lineage]

        self.ident_to_idx = ident_to_idx
        self.idx_to_lid = idx_to_lid
        self.lid_to_lineage = lid_to_lineage

    def insert(self, *args, **kwargs):
        raise NotImplementedError

    def select(self, *args, **kwargs):
        narrowed = self._select(*args, **kwargs)
        return LCA_SqliteDatabase(self.dbfile, sqlite_manifest=narrowed,
                                  lineage_db=self.lineage_db)

    ### LCA_Database API/protocol.

    def downsample_scaled(self, scaled):
        if scaled < self.scaled:
            raise ValueError(f"cannot decrease scaled from {self.scaled} to {scaled}")
        self.scaled = scaled

    def get_lineage_assignments(self, hashval, *, min_num=None):
        idx_list = self.hashval_to_idx.get(hashval, [])
        if min_num is not None and len(idx_list) < min_num:
            return []

        lineages = []
        for idx in idx_list:
            lid = self.idx_to_lid.get(idx, None)
            if lid is not None:
                lineages.append(self.lid_to_lineage[lid])
        return lineages

    @cached_property
    def idx_to_ident(self):
        inverted = {idx: ident for ident, idx in self.ident_to_idx.items()}
        assert len(inverted) == len(self.ident_to_idx)
        return inverted

    @property
    def hashval_to_idx(self):
        return _SqliteIndexHashvalToIndex(self)

    @property
    def hashvals(self):
        return iter(_SqliteIndexHashvalToIndex(self))

    def get_identifiers_for_hashval(self, hashval):
        for idx in self.hashval_to_idx[hashval]:
            yield self.idx_to_ident[idx]


class _SqliteIndexHashvalToIndex:
    "Dict-like view of the hashval -> [sketch ids] reverse index."

    def __init__(self, sqlidx):
        self.sqlidx = sqlidx

    def __iter__(self):
        c = self.sqlidx.conn.cursor()
        c.execute("SELECT DISTINCT hashval FROM sourmash_hashes")
        for (hashval,) in c:
            yield convert_hash_from(hashval)

    def get(self, key, dv=None):
        c = self.sqlidx.cursor()
        c.execute(
            "SELECT sketch_id FROM sourmash_hashes WHERE hashval=?",
            (convert_hash_to(key),),
        )
        ids = [sketch_id for (sketch_id,) in c]
        return ids or dv

    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v


def load_sqlite_index(filename, *, request_manifest=False):
    """Load a SqliteIndex, standalone sqlite manifest, or LCA_SqliteDatabase
    from filename, depending on which tables are present."""
    conn = sqlite_utils.open_sqlite_db(filename)
    if conn is None:
        debug_literal("load_sqlite_index: conn is None.")
        return None

    c = conn.cursor()
    try:
        internal_d = sqlite_utils.get_sourmash_internal(c)
    except (sqlite3.OperationalError, sqlite3.DatabaseError):
        internal_d = {}

    is_index = _versioned_flag(internal_d, "SqliteIndex", "SqliteIndex")
    if is_index:
        debug_literal("load_sqlite_index: it's an index!")

    is_lca_db = is_index and _versioned_flag(
        internal_d, "SqliteLineage", "SqliteLineage"
    )
    if is_lca_db:
        debug_literal("load_sqlite_index: it's got a lineage table!")

    is_manifest = _versioned_flag(internal_d, "SqliteManifest", "SqliteManifest")

    if is_index or is_lca_db:
        assert is_manifest

    if is_index and not request_manifest:
        conn.close()
        if is_lca_db:
            debug_literal("load_sqlite_index: returning LCA_SqliteDatabase")
            return LCA_SqliteDatabase.load(filename)
        debug_literal("load_sqlite_index: returning SqliteIndex")
        return SqliteIndex(filename)

    if is_manifest:
        mf = SqliteCollectionManifest(conn, managed_by_index=is_index)
        prefix = os.path.dirname(filename)
        debug_literal("load_sqlite_index: returning StandaloneManifestIndex")
        return StandaloneManifestIndex(mf, filename, prefix=prefix)

    return None

