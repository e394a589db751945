"""Collection manifests: tabular metadata describing every sketch in a
collection, enabling selection and lazy loading without deserializing
signatures.

The port's copy of `sourmash_tpu/manifest.py` (reference
`src/sourmash/manifest.py`): the eleven required columns, the
`# SOURMASH-MANIFEST-VERSION: 1.0` header line and the in-memory
`CollectionManifest` with the index layer's selection entry points
(`select_to_manifest`, `filter_on_columns`, `locations`, `create_manifest`).
One column-spec table (`_COLUMNS`) drives CSV decode, encode and row
construction. `BaseCollectionManifest` holds what every manifest shares
(loading by filename, CSV I/O, row construction); `CollectionManifest`
keeps its rows in memory, `index/sqlite_index.SqliteCollectionManifest` in
sqlite. A manifest file may be either: `load_from_filename` probes sqlite
first, then (gzipped) CSV.
"""

from __future__ import annotations

import ast
import csv
import gzip
import os

from . import picklist as picklist_mod

_HEADER_TAG = "# SOURMASH-MANIFEST-VERSION: "
_FORMAT_VERSION = 1.0


def _as_bool(cell):
    "Decode a CSV truth cell ('0'/'1'/'True'/'False') to a real bool."
    return bool(ast.literal_eval(str(cell)))


# Wire schema: (column name, CSV-decode coercion or None for identity),
# in on-disk column order.
_COLUMNS = (
    ("internal_location", None),
    ("md5", None),
    ("md5short", None),
    ("ksize", int),
    ("moltype", None),
    ("num", int),
    ("scaled", int),
    ("n_hashes", int),
    ("with_abundance", _as_bool),
    ("name", None),
    ("filename", None),
)

_DECODERS = tuple((name, fn) for name, fn in _COLUMNS if fn is not None)

# Index.select() keywords (`sourmash_tpu/index/__init__.py:_SELECT_KEYS`)
_SELECT_KEYS = frozenset(
    ["ksize", "num", "moltype", "scaled", "abund", "picklist", "containment"]
)


def _decode_row_inplace(row):
    "Apply per-column type coercions to one freshly-read CSV row."
    for name, decode in _DECODERS:
        row[name] = decode(row[name])
    row["signature"] = None
    return row


def _check_select_parameters(**kw):
    "Validate types of select() keyword arguments."
    unknown = set(kw) - _SELECT_KEYS
    if unknown:
        raise ValueError(f"unknown 'select' parameters: {unknown}")

    for name, want, kindname in (
        ("ksize", int, "an integer"),
        ("scaled", int, "an integer"),
        ("num", int, "an integer"),
        ("containment", bool, "a bool"),
        ("abund", bool, "a bool"),
    ):
        value = kw.get(name)
        if value is not None and not isinstance(value, want):
            raise ValueError(
                f"{name} value '{value}' must be {kindname}, is: {type(value)}"
            )

    moltype = kw.get("moltype")
    if moltype is not None and moltype not in ["DNA", "protein", "dayhoff", "hp"]:
        raise ValueError(f"unknown moltype: {moltype}")


def _selector_predicates(
    *, ksize=None, moltype=None, scaled=0, num=0, containment=False,
    abund=None, picklist=None,
):
    "Translate selector kwargs into a list of row predicates."
    _check_select_parameters(
        ksize=ksize, num=num, abund=abund, moltype=moltype, scaled=scaled
    )

    tests = []
    if ksize:
        tests.append(lambda row: row["ksize"] == ksize)
    if moltype:
        tests.append(lambda row: row["moltype"] == moltype)
    if scaled or containment:
        tests.append(lambda row: row["scaled"] and not row["num"])
    if num:
        tests.append(lambda row: row["num"] and not row["scaled"])
    if abund:
        # only constrains when abundance is *required*
        tests.append(lambda row: row["with_abundance"])
    if picklist:
        tests.append(picklist.matches_manifest_row)
    return tests


class BaseCollectionManifest:
    """What every manifest shares: loading by filename, CSV I/O and row
    construction. Subclasses hold `rows` (an iterable of row dicts) and
    the selection protocol (`select_to_manifest`, `locations`, `ss in
    manifest`, `to_picklist`)."""

    required_keys = tuple(name for name, _ in _COLUMNS)

    @classmethod
    def load_from_filename(cls, filename):
        "Load from a path: sqlite databases first, then (gzipped) CSV."
        from_sql = cls.load_from_sql(filename)
        if from_sql is not None:
            return from_sql

        opener = gzip.open if filename.endswith(".gz") else open
        with opener(filename, "rt", newline="") as fp:
            return cls.load_from_csv(fp)

    @classmethod
    def load_from_sql(cls, filename):
        from .index.sqlite_index import load_sqlite_index

        db = load_sqlite_index(filename, request_manifest=True)
        return db.manifest if db is not None else None

    # -- CSV ------------------------------------------------------------

    @classmethod
    def load_from_csv(cls, fp):
        "Load a manifest from an open CSV file with the version header."
        header = fp.readline().rstrip()
        if not header.startswith(_HEADER_TAG):
            raise ValueError("manifest is missing version header")
        version = header[len(_HEADER_TAG):]
        if float(version) != _FORMAT_VERSION:
            raise ValueError(f"unknown manifest version number {version}")

        reader = csv.DictReader(fp)
        available = reader.fieldnames
        if not available:
            raise ValueError("missing column headers in manifest")
        for name in cls.required_keys:
            if name not in available:
                raise ValueError(f"missing column '{name}' in manifest.")

        return CollectionManifest(map(_decode_row_inplace, reader))

    @classmethod
    def write_csv_header(cls, fp):
        "Write the version line + column-name row."
        fp.write(f"{_HEADER_TAG}{_FORMAT_VERSION}\n")
        csv.DictWriter(fp, fieldnames=cls.required_keys).writeheader()

    def write_to_csv(self, fp, write_header=False):
        "Write manifest rows as CSV to an open file handle."
        if write_header:
            self.write_csv_header(fp)
        writer = csv.DictWriter(
            fp, fieldnames=self.required_keys, extrasaction="ignore"
        )
        for row in self.rows:
            row.pop("signature", None)  # never serialize the payload
            writer.writerow(row)

    def write_to_filename(self, filename, *, database_format="csv", ok_if_exists=False):
        if database_format == "sql":
            from .index.sqlite_index import SqliteCollectionManifest

            SqliteCollectionManifest.load_from_manifest(
                self, dbfile=filename, append=ok_if_exists
            )
            return None

        assert database_format == "csv"
        if os.path.exists(filename) and not ok_if_exists:
            raise Exception("output manifest already exists")

        from .sourmash_args import FileOutputCSV

        with FileOutputCSV(filename) as fp:
            return self.write_to_csv(fp, write_header=True)

    # -- rows -----------------------------------------------------------

    @classmethod
    def make_manifest_row(cls, ss, location, *, include_signature=True):
        "Summarize one signature into a manifest row dict."
        mh = ss.minhash
        md5 = ss.md5sum()
        row = dict(
            internal_location=location,
            md5=md5,
            md5short=md5[:8],
            ksize=int(mh.ksize),
            moltype=mh.moltype,
            num=int(mh.num),
            scaled=int(mh.scaled),
            n_hashes=len(mh),
            with_abundance=mh.track_abundance,
            name=ss.name,
            filename=ss.filename,
        )
        assert set(row) == set(cls.required_keys)
        if include_signature:
            row["signature"] = ss
        return row

    @classmethod
    def create_manifest(cls, locations_iter, *, include_signature=True):
        """Build a manifest from an iterator of (signature, location) pairs;
        load exceptions from the iterator propagate to the caller."""
        return cls(
            cls.make_manifest_row(ss, loc, include_signature=include_signature)
            for ss, loc in locations_iter
        )

    def _check_row_values(self):
        "Validate row types and values with the selector checker."
        for row in self.rows:
            _check_select_parameters(
                num=row["num"],
                ksize=row["ksize"],
                moltype=row["moltype"],
                scaled=row["scaled"],
                abund=row["with_abundance"],
            )


class CollectionManifest(BaseCollectionManifest):
    "In-memory manifest: ordered row dicts plus an md5 membership set."

    def __init__(self, rows=()):
        self.rows = list(rows)  # `rows` may be a generator
        self._md5_set = {row["md5"] for row in self.rows}

    def add_row(self, row):
        self.rows.append(row)
        self._md5_set.add(row["md5"])

    def __bool__(self):
        return bool(self.rows)

    def __len__(self):
        return len(self.rows)

    def __contains__(self, ss):
        return ss.md5sum() in self._md5_set

    def _select(self, **kwargs):
        "Yield rows passing every selector predicate (ksize, moltype, ...)."
        tests = _selector_predicates(**kwargs)
        return (row for row in self.rows if all(t(row) for t in tests))

    def select_to_manifest(self, **kwargs):
        return CollectionManifest(self._select(**kwargs))

    def filter_rows(self, row_filter_fn):
        return CollectionManifest(filter(row_filter_fn, self.rows))

    def filter_on_columns(self, col_filter_fn, col_names):
        def over_columns(row):
            cells = [row[c] for c in col_names if row[c] is not None]
            return col_filter_fn(cells)

        return self.filter_rows(over_columns)

    def locations(self):
        "Distinct internal locations, first-seen order."
        return iter(dict.fromkeys(row["internal_location"] for row in self.rows))

    def to_picklist(self):
        pl = picklist_mod.SignaturePicklist("manifest")
        pl.pickset = {pl._get_value_for_manifest_row(row) for row in self.rows}
        return pl
