"""LCA database: in-memory inverted index (hash -> dataset idx) with
optional lineage assignments.

The port's copy of `sourmash_tpu/lca/lca_db.py`. `gather` goes through
`Index.counter_gather`, whose flat view walks `_signatures` in its rebuild
order (the order of `_hashval_to_idx`) onto the device engine.

Behavior + format parity: reference `src/sourmash/lca/lca_db.py`
(LCA_Database:33, insert:145, JSON load/save :296-492, find:619). The JSON
v2.x on-disk format round-trips.
"""

from __future__ import annotations

import functools
import gzip
import json
import os
from collections import OrderedDict, defaultdict, Counter

from ..minhash import _get_max_hash_for_scaled
from ..logging import notify, error, debug
from ..index import Index, IndexSearchResult, _check_select_parameters
from ..picklist import passes_all_picklists


def cached_property(fun):
    "Memoizing property (invalidated via _invalidate_cache)."

    @functools.wraps(fun)
    def get(self):
        cache = getattr(self, "_cache", None)
        if cache is None:
            cache = self._cache = {}
        if fun not in cache:
            cache[fun] = fun(self)
        return cache[fun]

    return property(get)


def _open_maybe_gz(path, mode):
    "Text-mode open, transparently gzipped for .gz paths."
    opener = gzip.open if path.endswith(".gz") else open
    return opener(path, mode)


def _parse_lca_json(db_name, fp):
    "Read + sanity-check the LCA-db JSON document; returns the parsed dict."
    try:
        looks_like_json = fp.read(1) == "{"
    except ValueError:
        looks_like_json = False
    if not looks_like_json:
        raise ValueError(f"'{db_name}' is not an LCA database file.")
    fp.seek(0)

    try:
        load_d = json.load(fp)
    except json.decoder.JSONDecodeError:
        load_d = {}

    if not load_d:
        raise ValueError("cannot parse database file '{}' as JSON; invalid format.")

    version = None
    db_type = None
    try:
        version = load_d.get("version")
        db_type = load_d.get("type")
    except AttributeError:
        pass

    if db_type != "sourmash_lca":
        raise ValueError(f"database file '{db_name}' is not an LCA db.")

    if float(version) < 2.0 or "lid_to_lineage" not in load_d:
        raise ValueError(
            "Error! This is an old-style LCA DB. You'll need to rebuild or download a newer one."
        )
    return load_d


def _decode_lineage_table(lid_to_lineage_json):
    """Decode the JSON lid → [[rank, name], ...] table into LineagePair
    tuples over the full standard rank list; returns both directions."""
    from .lca_utils import taxlist
    from ..tax.tax_utils import LineagePair

    lid_to_lineage = {}
    lineage_to_lid = {}
    for lid_str, rank_name_pairs in lid_to_lineage_json.items():
        by_rank = {pair[0]: pair[1] for pair in rank_name_pairs}
        lineage = tuple(
            LineagePair(rank, by_rank.get(rank, "")) for rank in taxlist()
        )
        lid = int(lid_str)
        lid_to_lineage[lid] = lineage
        lineage_to_lid[lineage] = lid
    return lid_to_lineage, lineage_to_lid


class LCA_Database(Index):
    """In-memory inverted index over hashes with lineage classification.

    Dictionaries: _ident_to_name/_ident_to_idx, _idx_to_lid,
    _lineage_to_lid/_lid_to_lineage, _hashval_to_idx (hash -> set of idx).
    """

    is_database = True
    manifest = None

    # per-instance tables, reset by _reset_tables
    _TABLE_NAMES = (
        "_ident_to_name", "_ident_to_idx", "_idx_to_lid",
        "_lineage_to_lid", "_lid_to_lineage",
    )

    def __init__(self, ksize, scaled, moltype="DNA"):
        self.ksize = int(ksize)
        self.scaled = int(scaled)
        self.moltype = moltype
        self.filename = None
        self.picklists = []
        self._reset_tables()

    def _reset_tables(self):
        for name in self._TABLE_NAMES:
            setattr(self, name, {})
        self._hashval_to_idx = defaultdict(set)
        self._next_index = self._next_lid = 0

    @property
    def location(self):
        return self.filename

    def __len__(self):
        return self._next_index

    def __repr__(self):
        return f"LCA_Database('{self.filename}')"

    def _invalidate_cache(self):
        if hasattr(self, "_cache"):
            del self._cache

    # -- idx / lid assignment ------------------------------------------------

    def _get_ident_index(self, ident, fail_on_duplicate=False):
        idx = self._ident_to_idx.get(ident)
        if fail_on_duplicate:
            assert idx is None
        if idx is None:
            idx = self._next_index
            self._next_index += 1
            self._ident_to_idx[ident] = idx
        return idx

    def _get_lineage_id(self, lineage):
        lid = self._lineage_to_lid.get(lineage)
        if lid is None:
            lid = self._next_lid
            self._next_lid += 1
            self._lineage_to_lid[lineage] = lid
            self._lid_to_lineage[lid] = lineage
        return lid

    # -- insertion -------------------------------------------------------------

    def _admissible_sketch(self, minhash):
        "Validate ksize/moltype and downsample to the DB scaled, or raise."
        mismatches = (
            ("ksize", minhash.ksize, self.ksize),
            ("moltype", minhash.moltype, self.moltype),
        )
        for param, got, want in mismatches:
            if got != want:
                raise ValueError(
                    f"cannot insert signature with {param} {got} into DB ({param} {want})"
                )
        try:
            return minhash.downsample(scaled=self.scaled)
        except ValueError:
            raise ValueError("cannot downsample signature; is it a scaled signature?")

    def insert(self, sig, ident=None, lineage=None):
        "Add a signature (with optional ident/lineage) to the database."
        minhash = self._admissible_sketch(sig.minhash)
        ident = ident or str(sig)

        if ident in self._ident_to_name:
            msg = f"signature '{ident}' is already in this LCA db."
            raise ValueError(msg)

        self._invalidate_cache()
        self._ident_to_name[ident] = sig.name
        idx = self._get_ident_index(ident, fail_on_duplicate=True)

        if lineage:
            try:
                self._idx_to_lid[idx] = self._get_lineage_id(tuple(lineage))
            except TypeError:
                raise ValueError("lineage cannot be used as a key?!")

        for hashval in minhash.hashes:
            self._hashval_to_idx[hashval].add(idx)

        return len(minhash)

    # -- signature access -----------------------------------------------------

    def signatures(self):
        "Yield all signatures (rebuilt from the inverted index)."
        survivors = self._signatures.values()
        if self.picklists:
            survivors = (
                v for v in survivors if passes_all_picklists(v, self.picklists)
            )
        yield from survivors

    def _signatures_with_internal(self):
        yield from ((ss, idx) for idx, ss in self._signatures.items())

    def select(self, ksize=None, moltype=None, num=0, scaled=0, abund=None,
               containment=False, picklist=None, **kwargs):
        "Check requirements; raise ValueError if unmet."
        _check_select_parameters(
            ksize=ksize, num=num, moltype=moltype, scaled=scaled,
            containment=containment, abund=abund, picklist=picklist, **kwargs,
        )

        # (failure condition, message) pairs, checked in reference order
        rejections = (
            (num, "cannot use 'num' MinHashes to search LCA database"),
            (
                scaled > self.scaled and not containment,
                f"cannot use scaled={scaled} on this database (scaled={self.scaled})",
            ),
            (
                ksize is not None and self.ksize != ksize,
                f"ksize on this database is {self.ksize}; this is different from requested ksize of {ksize}",
            ),
            (
                moltype is not None and moltype != self.moltype,
                f"moltype on this database is {self.moltype}; this is different from requested moltype of {moltype}",
            ),
            (abund, "LCA databases do not support sketches with abund=True"),
        )
        for failed, message in rejections:
            if failed:
                raise ValueError(message)

        if picklist is not None:
            self.picklists.append(picklist)
            if len(self.picklists) > 1:
                msg = "we do not (yet) support multiple picklists for LCA databases"
                raise ValueError(msg)

        return self

    # -- persistence -----------------------------------------------------------

    @classmethod
    def load(cls, db_name):
        "Load LCA_Database from a JSON(.gz) file (v2.x format)."
        if not os.path.isfile(db_name):
            msg = f"'{db_name}' is not a file and cannot be loaded as an LCA database"
            raise ValueError(msg)

        # sqlite-backed LCA databases take priority if the file is one
        try:
            from ..index.sqlite_index import LCA_SqliteDatabase

            return LCA_SqliteDatabase.load(db_name)
        except (ImportError, ValueError):
            pass

        with _open_maybe_gz(db_name, "rt") as fp:
            load_d = _parse_lca_json(db_name, fp)

        ksize = int(load_d["ksize"])
        scaled = int(load_d["scaled"])
        moltype = load_d.get("moltype", "DNA")
        if moltype != "DNA":
            # protein-family ksizes are stored pre-multiplied by 3
            assert ksize % 3 == 0
            ksize = int(ksize / 3)

        db = cls(ksize, scaled, moltype)

        db._lid_to_lineage, db._lineage_to_lid = _decode_lineage_table(
            load_d["lid_to_lineage"]
        )
        db._hashval_to_idx = {
            int(k): v for k, v in load_d["hashval_to_idx"].items()
        }
        db._ident_to_name = load_d["ident_to_name"]
        db._ident_to_idx = load_d["ident_to_idx"]
        db._idx_to_lid = {int(k): v for k, v in load_d["idx_to_lid"].items()}

        next_of = lambda d: max(d.values()) + 1 if d else 0  # noqa: E731
        db._next_index = next_of(db._ident_to_idx)
        db._next_lid = next_of(db._idx_to_lid)

        db.filename = db_name
        return db

    def save(self, db_name, *, format="json"):
        assert format in ("json", "sql")
        writer = self.save_to_sql if format == "sql" else self.save_to_json
        writer(db_name)

    def _refuse_overwrite(self, db_name):
        if os.path.exists(db_name):
            msg = f"LCA database {db_name} already exists; not overwriting or appending"
            raise ValueError(msg)

    def save_to_json(self, db_name):
        "Save LCA_Database to a JSON(.gz) file."
        self._refuse_overwrite(db_name)

        save_d = OrderedDict()
        save_d["version"] = "2.1"
        save_d["type"] = "sourmash_lca"
        save_d["license"] = "CC0"

        # protein-family ksizes are stored pre-multiplied by 3
        save_d["ksize"] = self.ksize * 3 if self.moltype != "DNA" else self.ksize
        save_d["scaled"] = self.scaled
        save_d["moltype"] = self.moltype

        save_d["hashval_to_idx"] = {
            k: list(v) for (k, v) in self._hashval_to_idx.items()
        }

        save_d["ident_to_name"] = self._ident_to_name
        save_d["ident_to_idx"] = self._ident_to_idx
        save_d["idx_to_lid"] = self._idx_to_lid
        # lineages serialize as lists of [rank, name] pairs (the loader
        # reads x[0]/x[1] of each entry — reference format).
        save_d["lid_to_lineage"] = {
            k: [[vv.rank, vv.name] for vv in v]
            for k, v in self._lid_to_lineage.items()
        }

        with _open_maybe_gz(db_name, "wt") as fp:
            json.dump(save_d, fp)

    def save_to_sql(self, dbname):
        "Save this LCA_Database into an LCA_SqliteDatabase."
        from ..index.sqlite_index import LCA_SqliteDatabase
        from ..tax.tax_utils import LineageDB

        self._refuse_overwrite(dbname)

        assignments = {}
        available_ranks = set()
        for ident, idx in self._ident_to_idx.items():
            lid = self._idx_to_lid.get(idx)
            if lid is None:
                continue
            lineage = self._lid_to_lineage[lid]
            assignments[ident] = lineage
            available_ranks.update(pair.rank for pair in lineage)

        ldb = LineageDB(assignments, available_ranks)
        LCA_SqliteDatabase.create(dbname, self, ldb)

    # -- hash-level queries ------------------------------------------------

    def downsample_scaled(self, scaled):
        "In-place downsample: drop hashes above the new threshold."
        if scaled == self.scaled:
            return
        if scaled < self.scaled:
            raise ValueError(f"cannot decrease scaled from {self.scaled} to {scaled}")

        self._invalidate_cache()

        max_hash = _get_max_hash_for_scaled(scaled)
        kept = defaultdict(set)
        for hashval, idxs in self._hashval_to_idx.items():
            if hashval < max_hash:
                kept[hashval] = idxs
        self._hashval_to_idx = kept
        self.scaled = scaled

    @property
    def hashvals(self):
        return self._hashval_to_idx.keys()

    def get_lineage_assignments(self, hashval, min_num=None):
        "List of lineages for this hashval."
        idx_list = self._hashval_to_idx.get(hashval, [])
        if min_num and len(idx_list) < min_num:
            return []

        lineages = []
        for idx in idx_list:
            lid = self._idx_to_lid.get(idx, None)
            if lid is not None:
                lineages.append(self._lid_to_lineage[lid])
        return lineages

    def get_identifiers_for_hashval(self, hashval):
        "Identifiers of signatures containing this hashval."
        for idx in self._hashval_to_idx.get(hashval, []):
            yield self._idx_to_ident[idx]

    # -- derived caches ------------------------------------------------------

    def _template_minhash(self):
        "An empty MinHash matching this database's sketch parameters."
        from .. import MinHash

        return MinHash(
            n=0,
            ksize=self.ksize,
            scaled=self.scaled,
            is_protein=self.moltype == "protein",
            hp=self.moltype == "hp",
            dayhoff=self.moltype == "dayhoff",
        )

    @cached_property
    def _signatures(self):
        "Rebuild {idx: FrozenSourmashSignature} from the inverted index."
        from .. import SourmashSignature

        debug("creating signatures for LCA DB...")
        template = self._template_minhash()
        mhd = defaultdict(template.copy_and_clear)
        pending = defaultdict(list)

        # invert hash→idx into per-idx hash batches, flushing every 50
        for hashval, idlist in self._hashval_to_idx.items():
            for idx in idlist:
                batch = pending[idx]
                batch.append(hashval)
                if len(batch) > 50:
                    mhd[idx].add_many(batch)
                    del pending[idx]
        for idx, batch in pending.items():
            mhd[idx].add_many(batch)

        sigd = {}
        for idx, mh in mhd.items():
            name = self._ident_to_name[self._idx_to_ident[idx]]
            ss = SourmashSignature(mh, name=name)
            ss.into_frozen()
            if passes_all_picklists(ss, self.picklists):
                sigd[idx] = ss

        debug("=> {} signatures!", len(sigd))
        return sigd

    @cached_property
    def _lid_to_idx(self):
        grouped = defaultdict(set)
        for idx, lid in self._idx_to_lid.items():
            grouped[lid].add(idx)
        return grouped

    @cached_property
    def _idx_to_ident(self):
        inverted = {idx: ident for ident, idx in self._ident_to_idx.items()}
        assert len(inverted) == len(self._ident_to_idx)
        return inverted

    # -- search ---------------------------------------------------------------

    def _aligned_to_query(self, query_mh):
        """Bring query and subjects to a common scaled; returns the working
        query sketch and a subject-preparation function."""
        if self.scaled > query_mh.scaled:
            return query_mh.downsample(scaled=self.scaled), lambda subj: subj
        query_scaled = query_mh.scaled
        return query_mh, lambda subj: subj.downsample(scaled=query_scaled)

    def find(self, search_fn, query, **kwargs):
        "Jaccard/containment search via the inverted index counter."
        search_fn.check_is_compatible(query)

        query_mh, prepare_subject = self._aligned_to_query(query.minhash)

        c = Counter()
        for hashval in set(query_mh.hashes):
            for idx in self._hashval_to_idx.get(hashval, []):
                c[idx] += 1

        debug("number of matching signatures for hashes: {}", len(c))

        for idx, count in c.most_common():
            subj = self._signatures.get(idx)
            if subj is None:
                assert self.picklists
                continue

            subj_mh = prepare_subject(subj.minhash)

            score = search_fn.score_fn(
                len(query_mh),
                query_mh.count_common(subj_mh),
                len(subj_mh),
                len(query_mh + subj_mh),
            )

            keep = search_fn.passes(score) and search_fn.collect(score, subj)
            if keep and passes_all_picklists(subj, self.picklists):
                yield IndexSearchResult(score, subj, self.location)


def load_single_database(filename, verbose=False):
    "Load a single LCA database; return (db, ksize, scaled)."
    (db,), ksize, scaled = load_databases([filename], verbose=verbose)
    return db, ksize, scaled


def load_databases(filenames, scaled=None, verbose=True):
    "Load multiple LCA databases; return (dblist, ksize, scaled)."
    dblist = []
    seen = {"ksize": set(), "scaled": set(), "moltype": set()}

    def _note(param, value, *, unique):
        seen[param].add(value)
        if unique and len(seen[param]) > 1:
            raise Exception(f"multiple {param}s, quitting")

    for db_name in filenames:
        if verbose:
            notify("\r\033[K", end="")
            progress = f"... loading database {format(db_name)}"
            notify(progress, end="\r")
        lca_db = LCA_Database.load(db_name)

        _note("ksize", lca_db.ksize, unique=True)

        if scaled and scaled > lca_db.scaled:
            lca_db.downsample_scaled(scaled)
        _note("scaled", lca_db.scaled, unique=False)

        _note("moltype", lca_db.moltype, unique=True)

        dblist.append(lca_db)

    ksize = seen["ksize"].pop()
    scaled = seen["scaled"].pop()
    moltype = seen["moltype"].pop()

    if verbose:
        notify("\r\033[K", end="")
        summary = f"loaded {len(dblist)} LCA databases. ksize={ksize}, scaled={scaled} moltype={moltype}"
        notify(summary)

    return dblist, ksize, scaled
