"""Common sqlite3 helpers.

Sourmash sqlite files carry a `sourmash_internal` key/value table naming
each use (index, manifest, taxonomy) and its format version; these
helpers probe and maintain it. The port's copy of
`sourmash_tpu/sqlite_utils.py` (reference `src/sourmash/sqlite_utils.py`).
"""

from __future__ import annotations

import os
import sqlite3

from .logging import debug_literal

_SQLITE_ERRORS = (sqlite3.OperationalError, sqlite3.DatabaseError)

_READ_INTERNAL = "SELECT DISTINCT key, value FROM sourmash_internal"
_PROBE_TAXONOMY = "SELECT * FROM taxonomy LIMIT 1"
_MAKE_INTERNAL = (
    "CREATE TABLE IF NOT EXISTS sourmash_internal"
    " ( key TEXT UNIQUE, value TEXT )"
)
_PUT_INTERNAL = "INSERT INTO sourmash_internal (key, value) VALUES (?, ?)"


def _probe(cursor, query, failure_note):
    "Execute a probing query; False (with a debug note) on sqlite errors."
    try:
        cursor.execute(query)
    except _SQLITE_ERRORS:
        debug_literal(failure_note)
        return False
    return True


def open_sqlite_db(filename):
    """Return a connection iff `filename` is an existing sourmash sqlite db.

    Never creates the file (plain sqlite3.connect would); recognizes a db
    by its `sourmash_internal` table, or — for legacy LCA taxonomy
    databases — a bare `taxonomy` table.
    """
    debug_literal("open_sqlite_db: started")
    if not os.path.exists(filename) or os.path.getsize(filename) == 0:
        debug_literal("open_sqlite_db: no file/zero sized file")
        return None

    try:
        conn = sqlite3.connect(filename)
    except _SQLITE_ERRORS:
        debug_literal("open_sqlite_db: cannot connect.")
        return None

    cursor = conn.cursor()
    recognized = _probe(
        cursor, _READ_INTERNAL, "open_sqlite_db: cannot read sourmash_internal."
    ) or _probe(
        cursor, _PROBE_TAXONOMY, "open_sqlite_db: cannot read 'taxonomy', either."
    )
    return conn if recognized else None


def get_sourmash_internal(cursor):
    "Retrieve the key/value dict from sourmash_internal."
    cursor.execute(_READ_INTERNAL)
    return dict(cursor)


def add_sourmash_internal(cursor, use_type, version):
    "Record use_type→version in sourmash_internal; reject version clashes."
    cursor.execute(_MAKE_INTERNAL)

    known = get_sourmash_internal(cursor).get(use_type)
    if known is None:
        cursor.execute(_PUT_INTERNAL, (use_type, version))
    elif version != known:
        raise Exception(
            f"sqlite problem: for {use_type}, want version {version}, got version {known}"
        )
