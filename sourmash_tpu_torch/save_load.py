"""Index loading chain + bulk signature saving: the port of
`sourmash_tpu/save_load.py` (loader chain :45-187, savers :247-440).

Loading: a priority-ordered chain of loader functions, each probing one
on-disk shape: stdin, sqlite database (index or manifest), standalone
manifest (CSV or sqlite), path (a `.sig`/`.sig.gz` file or a directory),
pathlist, SBT (`.sbt.zip`, `.sbt.json`), revindex directory or LCA
database (`.lca.json[.gz]`; a sqlite one loads at the sqlite step), zip
collection, and the trailing FASTA/FASTQ error.

Saving: `SaveSignaturesToLocation(location)` picks a saver by location
shape: None, 'dir/', '.zip', '.sqldb', '-' or a `.sig[.gz]` file.

Plugins join both: loaders through the 'sourmash.load_from' entry point,
savers through 'sourmash.save_to' (`plugins.py`), each at its priority.
"""

from __future__ import annotations

import gzip
import itertools
import os
import sys
import traceback
import zipfile
from io import StringIO

from . import plugins as sourmash_plugins
from . import signature as sigmod
from .exceptions import SourmashError
from .index import LinearIndex, MultiIndex, ZipFileLinearIndex
from .logging import debug_literal, notify
from .manifest import CollectionManifest


class IndexNotLoaded(SourmashError):
    pass


# -- loader chain ---------------------------------------------------------

_loader_functions = []


def add_loader(name, priority):
    "Decorator registering a loader function at a given priority."

    def register(func):
        _loader_functions.append((priority, name, func))
        return func

    return register


def _iter_loaders():
    "Built-in + plugin loader functions, in priority order."
    plugin_fns = sourmash_plugins.get_load_from_functions()
    yield from sorted(itertools.chain(_loader_functions, plugin_fns))


def _load_database(filename, traverse_yield_all, *, cache_size=None):
    "Try loader functions in priority order; return the first Index."
    for priority, desc, load_fn in _iter_loaders():
        debug_literal(f"_load_databases: trying loader fn - priority {priority} - '{desc}'")
        try:
            db = load_fn(filename, traverse_yield_all=traverse_yield_all, cache_size=cache_size)
        except (ValueError, IndexNotLoaded):
            debug_literal(f"_load_databases: FAIL with ValueError: on fn {desc}.")
            debug_literal(traceback.format_exc())
            continue
        if db is not None:
            debug_literal("_load_databases: success!")
            return db
    raise ValueError(f"Error while reading signatures from '{filename}'.")


def load_file_as_index(filename, *, yield_all_files=False):
    "Load 'filename' as a database via the generic loader chain."
    return _load_database(filename, yield_all_files)


@add_loader("load from stdin", 10)
def _load_stdin(filename, **kwargs):
    "Load collection from .sig file streamed in via stdin."
    if filename != "-":
        return None
    lidx = LinearIndex.load(sys.stdin, filename="-")
    return MultiIndex.load((lidx,), (None,), parent="-")


@add_loader("load collection from sqlitedb", 20)
def _load_sqlite_db(filename, **kwargs):
    "A sqlite index, or a sqlite manifest as a standalone manifest."
    from .index.sqlite_index import load_sqlite_index

    return load_sqlite_index(filename)


@add_loader("load from standalone manifest", 30)
def _load_standalone_manifest(filename, **kwargs):
    "A manifest file (CSV, gzipped CSV or sqlite) naming signature files."
    from .index import StandaloneManifestIndex

    try:
        return StandaloneManifestIndex.load(filename)
    except gzip.BadGzipFile as exc:
        raise IndexNotLoaded(str(exc))


@add_loader("load from path (file or directory)", 40)
def _multiindex_load_from_path(filename, **kwargs):
    "Load collection from a directory or .sig file."
    return MultiIndex.load_from_path(filename, kwargs["traverse_yield_all"])


@add_loader("load from list of paths", 50)
def _multiindex_load_from_pathlist(filename, **kwargs):
    "Load collection from a text file listing signature/database files."
    return MultiIndex.load_from_pathlist(filename)


@add_loader("load SBT", 60)
def _load_sbt(filename, **kwargs):
    "Load collection from an SBT (.sbt.zip / .sbt.json)."
    from .sbtmh import load_sbt_index

    try:
        return load_sbt_index(filename, cache_size=kwargs.get("cache_size"))
    except (FileNotFoundError, TypeError) as exc:
        raise IndexNotLoaded(str(exc))


@add_loader("load revindex", 70)
def _load_revindex(filename, **kwargs):
    """Load collection from a disk revindex directory or an LCA database
    (`LCA_Database.load` tries a sqlite LCA database first, then refuses a
    file that does not start with '{' after reading one character)."""
    from .index.revindex import is_revindex_dir, load_revindex
    from .lca.lca_db import load_single_database

    if is_revindex_dir(filename):
        return load_revindex(filename)

    db, _ksize, _scaled = load_single_database(filename)
    return db


@add_loader("load collection from zipfile", 80)
def _load_zipfile(filename, **kwargs):
    "Load collection from a .zip file."
    if not filename.endswith(".zip"):
        return None
    try:
        return ZipFileLinearIndex.load(filename, traverse_yield_all=kwargs["traverse_yield_all"])
    except FileNotFoundError as exc:
        raise IndexNotLoaded(str(exc))


@add_loader("catch FASTA/FASTQ files and error", 1000)
def _error_on_fastaq(filename, **kwargs):
    "Tail-end loader: FASTA/FASTQ input to a signature loader is an error."
    try:
        from .sequence_io import iter_records_bytes

        next(iter(iter_records_bytes(filename)))
    except Exception:  # not a sequence file either: the chain reports it
        return None

    raise Exception(
        f"Error while reading signatures from '{filename}' - got sequences instead! "
        "Is this a FASTA/FASTQ file?"
    )


# -- savers ---------------------------------------------------------------


def _expand_to_single_sketches(siglist):
    "Normalize to one minhash per signature (md5-keyed outputs need this)."
    for ss in siglist:
        yield from sigmod.expand_signatures(ss)


# kept under the reference helper's name for API familiarity
_one_minhash_per_sig = _expand_to_single_sketches


class Base_SaveSignaturesToLocation:
    """Base signature saver: context manager tracking location + count.

    Subclasses set `location_suffix` (or override `matches`) to claim a
    location shape, and override open/close/add as needed."""

    location_suffix = None

    def __init__(self, location):
        self.location, self.count = location, 0

    @classmethod
    def matches(cls, location):
        if cls.location_suffix is None:
            raise NotImplementedError
        if location:
            return location.endswith(cls.location_suffix)

    def __repr__(self):
        return f"{type(self).__name__}('{self.location}')"

    def __len__(self):
        return self.count

    def open(self):  # optional setup hook
        pass

    def close(self):  # optional teardown hook
        pass

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, _exc_type, _exc, _tb):
        self.close()

    def add(self, ss):
        self.count += 1

    def add_many(self, sslist):
        any(self.add(ss) for ss in sslist)


class SaveSignatures_NoOutput(Base_SaveSignaturesToLocation):
    "Discard everything (location is None)."

    def __repr__(self):
        return "SaveSignatures_NoOutput()"

    matches = classmethod(lambda cls, location: location is None)


class SaveSignatures_SqliteIndex(Base_SaveSignaturesToLocation):
    "Save signatures into a sqlite database (.sqldb)."

    location_suffix = ".sqldb"
    _COMMIT_EVERY = 1000

    def __init__(self, location):
        super().__init__(location)
        self.idx = None
        self.cursor = None

    def open(self):
        from .index.sqlite_index import SqliteIndex

        self.idx = SqliteIndex.create(self.location, append=True)
        self.cursor = self.idx.cursor()

    def close(self):
        self.idx.commit()
        self.cursor.execute("VACUUM")  # compact before handing the file over
        self.idx.close()

    def add(self, add_sig):
        for ss in _expand_to_single_sketches([add_sig]):
            super().add(ss)
            self.idx.insert(ss, cursor=self.cursor, commit=False)
            if self.count % self._COMMIT_EVERY == 0:
                self.idx.commit()


class SaveSignatures_SigFile(Base_SaveSignaturesToLocation):
    "Save signatures to a .sig / .sig.gz JSON file (or '-' for stdout)."

    def __init__(self, location):
        super().__init__(location)
        self.keep = []
        self.compress = 1 if self.location.endswith(".gz") else 0

    @classmethod
    def matches(cls, location):
        return bool(location)  # the catch-all fallback

    def close(self):
        if self.location == "-":
            sigmod.save_signatures_to_json(self.keep, sys.stdout)
            return
        if self.compress:
            fp = open(self.location, "wb")
        else:
            fp = open(self.location, "w", encoding="utf-8")
        with fp:
            sigmod.save_signatures_to_json(self.keep, fp, compression=self.compress)

    def add(self, ss):
        super().add(ss)
        self.keep.append(ss)  # serialized in one batch at close()


class SaveSignatures_Directory(Base_SaveSignaturesToLocation):
    "Save signatures within a directory, using md5sum names."

    location_suffix = "/"

    def open(self):
        try:
            os.mkdir(self.location)
        except FileExistsError:
            pass  # adding to an existing directory is fine
        except Exception:
            notify(f"ERROR: cannot create signature output directory '{self.location}'")
            sys.exit(-1)

    def _fresh_path(self, md5):
        "First non-existing '<md5>[_N].sig.gz' path under the directory."
        candidate = os.path.join(self.location, f"{md5}.sig.gz")
        for i in itertools.count():
            if not os.path.exists(candidate):
                return candidate
            candidate = os.path.join(self.location, f"{md5}_{i}.sig.gz")

    def add(self, ss):
        super().add(ss)
        with open(self._fresh_path(ss.md5sum()), "wb") as fp:
            sigmod.save_signatures_to_json([ss], fp, compression=1)


class SaveSignatures_ZipFile(Base_SaveSignaturesToLocation):
    """Save gzip-compressed signatures into an uncompressed zip collection
    with a manifest; an existing collection is appended to through its
    manifest."""

    location_suffix = ".zip"
    _MANIFEST_NAME = "SOURMASH-MANIFEST.csv"

    def __init__(self, location):
        super().__init__(location)
        self.storage = None

    def _open_storage(self):
        from .sbt_storage import ZipStorage

        try:
            # "w" on an existing path opens read+buffer, so a non-zip file
            # raises BadZipFile here (reference save_load.py:486-489)
            return ZipStorage(self.location, mode="w")
        except zipfile.BadZipFile:
            raise ValueError(f"File '{self.location}' cannot be opened as a zip file.")

    def _prior_manifest_rows(self, storage, fresh_file):
        "Rows of an existing archive's manifest ([] for a fresh archive)."
        try:
            data = storage.load(self._MANIFEST_NAME)
        except (FileNotFoundError, KeyError):
            if not fresh_file:
                raise ValueError(
                    f"Cannot add to existing zipfile '{self.location}' without a manifest"
                )
            return []
        manifest = CollectionManifest.load_from_csv(StringIO(data.decode("utf-8")))
        return list(manifest._select())

    def open(self):
        fresh_file = not os.path.exists(self.location)
        storage = self._open_storage()
        if not storage.subdir:
            storage.subdir = "signatures"
        self.manifest_rows = self._prior_manifest_rows(storage, fresh_file)
        self.storage = storage

    def close(self):
        manifest_fp = StringIO()
        CollectionManifest(self.manifest_rows).write_to_csv(
            manifest_fp, write_header=True
        )
        self.storage.save(
            self._MANIFEST_NAME,
            manifest_fp.getvalue().encode("utf-8"),
            overwrite=True,
            compress=True,
        )
        self.storage.flush()
        self.storage.close()

    def add(self, add_sig):
        if not self.storage:
            raise ValueError("this output is not open")

        for ss in _expand_to_single_sketches([add_sig]):
            buf = sigmod.save_signatures_to_json([ss], compression=1)
            path = f"{self.storage.subdir}/{ss.md5sum()}.sig.gz"
            location = self.storage.save(path, buf)

            self.manifest_rows.append(
                CollectionManifest.make_manifest_row(
                    ss, location, include_signature=False
                )
            )
            super().add(ss)


_save_classes = [
    (10, SaveSignatures_NoOutput),
    (20, SaveSignatures_Directory),
    (30, SaveSignatures_ZipFile),
    (40, SaveSignatures_SqliteIndex),
    (1000, SaveSignatures_SigFile),  # catch-all: any other non-empty location
]


def SaveSignaturesToLocation(location):
    """Context manager that saves signatures in the output format matching
    `location`: None (no output), 'dir/', '.zip', '.sqldb', '-' (stdout) or
    any other name as a .sig[.gz] file, after the 'save_to' plugins of a
    lower priority number."""
    candidates = itertools.chain(
        _save_classes, sourmash_plugins.get_save_to_functions()
    )
    for priority, cls in sorted(candidates, key=lambda x: x[0]):
        debug_literal(f"trying to match save function {cls}, priority={priority}")
        if cls.matches(location):
            debug_literal(f"{cls} is a match!")
            return cls(location)

    raise Exception(
        f"cannot determine how to open location {location} for saving; this should never happen!?"
    )


def _get_signatures_from_rust(siglist):
    """Split multi-sketch signature records into one-minhash signatures by
    JSON roundtrip (reference `save_load.py:297-304`)."""
    json_str = sigmod.save_signatures_to_json(siglist)
    yield from sigmod.load_signatures_from_json(json_str)
