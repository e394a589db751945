"""Command-line utility layer: moltype/picklist handling, query loading,
database loading, file IO helpers, progress reporting.

API parity: reference `src/sourmash/sourmash_args.py` (calculate_moltype:95,
load_picklist:121, load_query_signature:217, load_dbs_and_sigs:298,
traverse_find_sigs:275, FileOutput:402, FileOutputCSV:454, FileInputCSV:528,
SignatureLoadingProgress:601, get_manifest:727, load_file_as_signatures:765).

The port's copy of `sourmash_tpu/sourmash_args.py`.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import gzip
import os
import re
import sys
import zipfile
from io import TextIOWrapper

from .index import LinearIndex
from .logging import debug_literal, error, notify
from .manifest import CollectionManifest
from .picklist import PickStyle, SignaturePicklist
from .save_load import SaveSignaturesToLocation, _load_database, load_file_as_index

DEFAULT_LOAD_K = 31

_SIG_SUFFIXES = (".sig", ".sig.gz")


# ---------------------------------------------------------------------------
# argument checking / selector parsing
# ---------------------------------------------------------------------------


def _bounded_arg(value, *, what, low, high, low_warn, high_warn):
    "Validate a sketch-parameter argument, warning outside the sane range."
    if value < 0:
        raise argparse.ArgumentTypeError(f"ERROR: {what} value must be positive")
    if value < low:
        notify(f"WARNING: {what} value should be >= {low_warn}. Continuing anyway.")
    if value > high:
        notify(f"WARNING: {what} value should be <= {high_warn}. Continuing anyway.")
    return value


def check_scaled_bounds(arg):
    return _bounded_arg(float(arg), what="scaled", low=100, high=1e6,
                        low_warn="100", high_warn="1e6")


def check_num_bounds(arg):
    return _bounded_arg(int(arg), what="num", low=50, high=50000,
                        low_warn="50", high_warn="50000")


def get_moltype(sig, require=False):
    mh = sig.minhash
    if mh.moltype not in ("DNA", "dayhoff", "hp", "protein"):
        raise ValueError(f"unknown molecule type for sig {sig}")
    return mh.moltype


# CLI flag name -> canonical molecule type
_MOLTYPE_FLAGS = (
    ("dna", "DNA"),
    ("dayhoff", "dayhoff"),
    ("hp", "hp"),
    ("protein", "protein"),
)


def calculate_moltype(args, default=None):
    "Derive moltype from --dna/--protein/--dayhoff/--hp flags."
    chosen = [mt for flag, mt in _MOLTYPE_FLAGS if getattr(args, flag, False)]
    if len(chosen) > 1:
        error("cannot specify more than one of"
              " --dna/--rna/--nucleotide/--protein/--hp/--dayhoff")
        sys.exit(-1)
    return chosen[0] if chosen else default


# ---------------------------------------------------------------------------
# picklists and db patterns
# ---------------------------------------------------------------------------


def load_picklist(args):
    "Load a SignaturePicklist from --picklist arguments."
    if not args.picklist:
        return None

    try:
        picklist = SignaturePicklist.from_picklist_args(args.picklist)
        notify(f"picking column '{picklist.column_name}' of type"
               f" '{picklist.coltype}' from '{picklist.pickfile}'")
        n_empty_val, dup_vals = picklist.load()
    except ValueError as exc:
        error("ERROR: could not load picklist.")
        error(str(exc))
        sys.exit(-1)

    notify(f"loaded {len(picklist.pickset)} distinct values into picklist.")
    warnings = (
        (
            n_empty_val,
            f"WARNING: {n_empty_val} empty values in column '{picklist.column_name}' in picklist file",
        ),
        (
            dup_vals,
            f"WARNING: {len(dup_vals)} values in picklist column '{picklist.column_name}' were not distinct",
        ),
    )
    for cond, message in warnings:
        if cond:
            notify(message)
    return picklist


def report_picklist(args, picklist):
    "Summarize picklist hit counts; honor --picklist-require-all."
    n_found = len(picklist.found)
    n_distinct = len(picklist.pickset)

    if picklist.pickstyle == PickStyle.EXCLUDE:
        notify(
            f"for given picklist, found {n_found} matches by excluding {n_distinct} distinct values"
        )
        return

    assert picklist.pickstyle == PickStyle.INCLUDE
    notify(
        f"for given picklist, found {n_found} matches to {n_distinct} distinct values"
    )
    n_missing = len(picklist.pickset - picklist.found)
    if n_missing:
        notify(f"WARNING: {n_missing} missing picklist values.")
        if getattr(args, "picklist_require_all", False):
            error("ERROR: failing because --picklist-require-all was set")
            sys.exit(-1)


def load_include_exclude_db_patterns(args):
    "Compile --include-db-pattern/--exclude-db-pattern into a predicate."
    conflicts = (
        (
            args.picklist and (args.include_db_pattern or args.exclude_db_pattern),
            "ERROR: --picklist and --include-db-pattern/--exclude cannot be used together.",
        ),
        (
            args.include_db_pattern and args.exclude_db_pattern,
            "ERROR: --include-db-pattern and --exclude-db-pattern cannot be used together.",
        ),
    )
    for conflict, message in conflicts:
        if conflict:
            error(message)
            sys.exit(-1)

    if args.include_db_pattern:
        hit = re.compile(args.include_db_pattern, re.IGNORECASE).search
        return lambda vals: any(map(hit, vals))
    if args.exclude_db_pattern:
        hit = re.compile(args.exclude_db_pattern, re.IGNORECASE).search
        return lambda vals: not any(map(hit, vals))
    return None


def apply_picklist_and_pattern(db, picklist, pattern):
    "Narrow an index by a picklist OR a name/filename/md5 pattern."
    assert not (picklist and pattern)
    if picklist:
        return db.select(picklist=picklist)
    if pattern:
        manifest = db.manifest
        if manifest is None:
            error(f"ERROR on filename '{db.location}'.")
            error("--include-db-pattern/--exclude-db-pattern require a manifest.")
            sys.exit(-1)
        narrowed = manifest.filter_on_columns(pattern, ["name", "filename", "md5"])
        return db.select(picklist=narrowed.to_picklist())
    return db


# ---------------------------------------------------------------------------
# query loading
# ---------------------------------------------------------------------------


def _pick_by_md5(sl, select_md5):
    "Narrow a signature list by md5 prefix; exactly one match required."
    prefix = select_md5.lower()
    found_sig = None
    for sig in sl:
        if sig.md5sum().startswith(prefix):
            if found_sig is not None:
                error(f"Error! Multiple signatures start with md5 '{select_md5}'")
                error("Please use a longer --md5 selector.")
                sys.exit(-1)
            found_sig = sig
        sl = [found_sig]  # narrows after every candidate — reference behavior
    return sl


def _pick_query_ksize(sl, ksize):
    "Resolve the query ksize, preferring a unique value then the default."
    if ksize:
        notify(f"selecting specified query k={ksize}")
        return sl
    if not sl:
        return sl

    ksizes = {ss.minhash.ksize for ss in sl}
    if len(ksizes) == 1:
        (only,) = ksizes
        notify(f"select query k={only} automatically.")
        return [ss for ss in sl if ss.minhash.ksize == only]
    if DEFAULT_LOAD_K in ksizes:
        notify(f"selecting default query k={DEFAULT_LOAD_K}.")
        return [ss for ss in sl if ss.minhash.ksize == DEFAULT_LOAD_K]
    return sl


def load_query_signature(filename, ksize, select_moltype, select_md5=None):
    "Load a single signature to use as a query, from any collection type."
    try:
        sl = list(
            load_file_as_signatures(filename, ksize=ksize, select_moltype=select_moltype)
        )
    except (OSError, ValueError):
        error(f"Cannot open query file '{filename}'")
        sys.exit(-1)

    if sl and select_md5:
        sl = _pick_by_md5(sl, select_md5)
    sl = _pick_query_ksize(sl, ksize)

    if len(sl) == 1:
        return sl[0]

    error(f"When loading query from '{filename}'", filename)
    error(f"{len(sl)} signatures matching ksize and molecule type;")
    error("need exactly one. Specify --ksize or --dna, --rna, or --protein.")
    sys.exit(-1)


# ---------------------------------------------------------------------------
# collection traversal + database loading
# ---------------------------------------------------------------------------


def _check_suffix(filename, endings):
    return filename.endswith(tuple(endings))


def traverse_find_sigs(filenames, yield_all_files=False):
    "Find all .sig/.sig.gz files in & beneath 'filenames'."

    def wanted(path):
        return yield_all_files or path.endswith(_SIG_SUFFIXES)

    for filename in filenames:
        if os.path.isfile(filename):
            if wanted(filename):
                yield filename
            continue
        if not os.path.isdir(filename):
            continue
        for root, _dirs, files in os.walk(filename):
            for name in sorted(files):
                fullname = os.path.join(root, name)
                if wanted(fullname):
                    yield fullname


class _DatabaseTally:
    "Counters reported after loading search databases."

    def __init__(self):
        self.loaded = 0
        self.after_select = 0

    def report(self, n_databases):
        notify("--")
        notify(
            f"loaded {self.loaded} total signatures from {n_databases} locations."
        )
        notify(
            f"after selecting signatures compatible with search, {self.after_select} remain."
        )
        print("")


def _open_search_db(filename, cache_size):
    "Load one location as an Index, exiting on failure."
    try:
        return _load_database(filename, False, cache_size=cache_size)
    except ValueError as e:
        notify(f"ERROR on loading from '{filename}':")
        notify(str(e))
        sys.exit(-1)


def _select_for_query(db, filename, query_mh, containment, fail_on_empty):
    "Narrow a db to sketches compatible with the query, or an empty index."
    wanted = dict(
        ksize=query_mh.ksize,
        moltype=query_mh.moltype,
        num=query_mh.num,
        scaled=query_mh.scaled,
        containment=containment,
    )
    try:
        db = db.select(**wanted)
    except ValueError as exc:
        notify(f"ERROR: cannot use '{filename}' for this query.")
        notify(str(exc))
        if fail_on_empty:
            sys.exit(-1)
        db = LinearIndex([])

    if not db:
        notify(f"no compatible signatures found in '{filename}'")
        if fail_on_empty:
            sys.exit(-1)
    return db


def load_dbs_and_sigs(filenames, query, is_similarity_query, *, cache_size=None,
                      picklist=None, pattern=None, fail_on_empty_database=False):
    "Load Index objects to search; select on query compat + picklists."
    query_mh = query.minhash
    tally = _DatabaseTally()

    databases = []
    for filename in filenames:
        notify(f"loading from '{filename}'...", end="\r")

        db = _open_search_db(filename, cache_size)
        tally.loaded += len(db)

        db = _select_for_query(
            db, filename, query_mh, not is_similarity_query, fail_on_empty_database
        )
        tally.after_select += len(db)

        databases.append(apply_picklist_and_pattern(db, picklist, pattern))

    tally.report(len(databases))
    return databases


def load_pathlist_from_file(filename):
    "Load a list-of-files text file; every listed path must exist."
    try:
        with open(filename) as fp:
            paths = {line.rstrip("\r\n") for line in fp}
    except OSError:
        raise ValueError(f"pathlist file '{filename}' does not exist")
    except UnicodeDecodeError:
        raise ValueError(f"cannot parse file '{filename}' as list of filenames")

    if not paths:
        raise ValueError("pathlist is empty")
    for checkfile in paths:
        if not os.path.exists(checkfile):
            raise ValueError(f"file '{checkfile}' inside the pathlist does not exist")
    return paths


# ---------------------------------------------------------------------------
# file IO helpers
# ---------------------------------------------------------------------------


class FileOutput:
    "File-output context manager treating '-'/None as stdout."

    def __init__(self, filename, mode="wt", *, newline=None, encoding="utf-8"):
        self.filename = filename
        self.mode = mode
        self.newline = newline
        self.encoding = encoding
        self.fp = None

    def _open_file(self):
        return open(
            self.filename, self.mode, newline=self.newline, encoding=self.encoding
        )

    def open(self):
        if self.filename in ("-", None):
            return sys.stdout
        self.fp = self._open_file()
        return self.fp

    def close(self):
        if self.fp is not None:
            self.fp.close()

    def __enter__(self):
        return self.open()

    def __exit__(self, _exc_type, _exc, _tb):
        self.close()
        return False


class FileOutputCSV(FileOutput):
    "CSV file-output context manager; handles '-'/None and .gz."

    def __init__(self, filename):
        super().__init__(filename, newline="")

    def _open_file(self):
        if self.filename.endswith(".gz"):
            return gzip.open(self.filename, "wt", newline="")
        return open(self.filename, "w", newline="")


class _DictReader_with_version:
    """csv.DictReader variant allowing a '# KEY: version' first line;
    version stored in 'version_info'."""

    def __init__(self, textfp, *, delimiter=","):
        self.version_info = []

        head = textfp.buffer.peek(1)
        try:
            head = head.decode("utf-8")
        except UnicodeDecodeError:
            raise csv.Error("unable to read CSV file")

        if head.startswith("#"):
            line = textfp.readline()
            assert line.startswith("# "), line
            self.version_info = line[2:].strip().split(": ", 2)

        self.reader = csv.DictReader(textfp, delimiter=delimiter)
        self.fieldnames = self.reader.fieldnames

    def __iter__(self):
        return iter(self.reader)


@contextlib.contextmanager
def FileInputCSV(filename, *, encoding="utf-8", default_csv_name=None,
                 zipfile_obj=None, delimiter=","):
    "Read CSV from gzip, zip, or plain text; yields a DictReader-alike."
    if zipfile_obj and not default_csv_name:
        raise ValueError("must provide default_csv_name with a zipfile_obj")

    @contextlib.contextmanager
    def from_zip_member(zf):
        # keep the member open for the caller's whole with-block
        zi = zf.getinfo(default_csv_name)
        with zf.open(zi) as fp:
            textfp = TextIOWrapper(fp, encoding=encoding, newline="")
            yield _DictReader_with_version(textfp, delimiter=delimiter)

    # a zip member named default_csv_name takes priority when applicable
    if default_csv_name:
        if zipfile_obj:
            try:
                with from_zip_member(zipfile_obj) as reader:
                    yield reader
            except (zipfile.BadZipFile, KeyError):
                pass
            return
        try:
            with zipfile.ZipFile(filename, "r") as zip_fp:
                with from_zip_member(zip_fp) as reader:
                    yield reader
            return
        except (zipfile.BadZipFile, KeyError):
            pass

    # then transparent gzip, falling back to plain text
    try:
        with gzip.open(filename, "rt", newline="", encoding=encoding) as fp:
            fp.buffer.peek(1)  # force the gzip magic check
            yield _DictReader_with_version(fp, delimiter=delimiter)
        return
    except gzip.BadGzipFile:
        pass

    with open(filename, newline="", encoding=encoding) as fp:
        yield _DictReader_with_version(fp, delimiter=delimiter)


# ---------------------------------------------------------------------------
# bulk signature loading
# ---------------------------------------------------------------------------


class SignatureLoadingProgress:
    "Progress reporting for bulk signature loading."

    SCREEN_WIDTH = 79

    def __init__(self, reporting_interval=10):
        self.n_sig = 0
        self.interval = reporting_interval
        self.screen_width = self.SCREEN_WIDTH

    def __len__(self):
        return self.n_sig

    def short_notify(self, msg_template, *args, **kwargs):
        "Shorten the notification message so that it fits on one line."
        msg = msg_template.format(*args, **kwargs)
        overflow = len(msg) - self.screen_width
        if overflow > 0:
            msg = "<<<" + msg[overflow + 3:]
        notify(msg, end=kwargs.get("end", "\n"))

    def notify(self, location):
        self.short_notify(f"...{self.n_sig} sigs so far."
                          f" Now reading from file '{location}'", end="\r")

    def start_file(self, location, loader):
        "Wrap a signature iterator with periodic progress output."
        n_this = 0
        n_before = self.n_sig

        try:
            for result in loader:
                n_this += 1
                n_total = n_before + n_this
                if n_this and n_total % self.interval == 0:
                    self.short_notify("...loading from '{}' / {} sigs total",
                                      location, n_total, end="\r")
                yield result
        except KeyboardInterrupt:
            notify("\n(CTRL-C received! quitting.)")
            sys.exit(-1)
        finally:
            self.n_sig += n_this
        self.short_notify(f"Loaded {n_this} sigs from '{location}'", end="\r")


def _subset_index(db, *, ksize=None, moltype=None, picklist=None, pattern=None):
    "Apply the standard ksize/moltype/picklist/pattern narrowing chain."
    db = db.select(ksize=ksize, moltype=moltype)
    return apply_picklist_and_pattern(db, picklist, pattern)


def load_many_signatures(locations, progress, *, yield_all_files=False, ksize=None,
                         moltype=None, picklist=None, force=False, pattern=None):
    "Load signatures from many files with progress; yields (sig, location)."
    for loc in locations:
        try:
            idx = load_file_as_index(loc, yield_all_files=yield_all_files)
            idx = _subset_index(
                idx, ksize=ksize, moltype=moltype, picklist=picklist, pattern=pattern
            )

            n = 0
            for sig, sigloc in progress.start_file(loc, idx.signatures_with_location()):
                yield sig, sigloc
                n += 1
            notify(f"loaded {n} signatures from '{loc}'", end="\r")
        except ValueError as exc:
            notify(f"ERROR: {str(exc)}")
            if not force:
                sys.exit(-1)
            notify("(continuing)")
        except KeyboardInterrupt:
            notify("Received CTRL-C - exiting.")
            sys.exit(-1)

    notify(f"loaded {len(progress)} signatures total, from {len(locations)} files")


def get_manifest(idx, *, require=True, rebuild=False):
    "Retrieve or build a manifest for this index."
    existing = idx.manifest
    if existing is not None and not rebuild:
        debug_literal("get_manifest: found manifest")
        return existing

    debug_literal(f"get_manifest: no manifest found / rebuild={rebuild}")
    try:
        notify("Generating a manifest...")
        built = CollectionManifest.create_manifest(
            idx._signatures_with_internal(), include_signature=False
        )
        debug_literal("get_manifest: rebuilt manifest.")
        return built
    except NotImplementedError:
        if require:
            error(f"ERROR: manifests cannot be generated for {idx.location}")
            sys.exit(-1)
        debug_literal("get_manifest: cannot build manifest, not req'd")
        return None


def load_file_as_signatures(filename, *, select_moltype=None, ksize=None,
                            picklist=None, yield_all_files=False, progress=None,
                            pattern=None, _use_manifest=True):
    "Load 'filename' as an iterable of signatures (any collection format)."
    if progress:
        progress.notify(filename)

    db = _load_database(filename, yield_all_files)
    if not _use_manifest and db.manifest:
        db.manifest = None

    db = _subset_index(
        db, ksize=ksize, moltype=select_moltype, picklist=picklist, pattern=pattern
    )

    loader = db.signatures()
    return progress.start_file(filename, loader) if progress is not None else loader


def load_one_signature(filename, *, select_moltype=None, ksize=None, picklist=None,
                       yield_all_files=False, pattern=None):
    "Load exactly one signature from the given location."
    db = _load_database(filename, yield_all_files)
    db = _subset_index(
        db, ksize=ksize, moltype=select_moltype, picklist=picklist, pattern=pattern
    )

    it = iter(db.signatures())
    try:
        ss = next(it)
    except StopIteration:
        raise ValueError(f"no signatures in '{filename}'? expected exactly one.")

    if next(it, None) is not None:
        raise ValueError(
            f"more than one signature in '{filename}'; expected exactly one"
        )
    return ss
