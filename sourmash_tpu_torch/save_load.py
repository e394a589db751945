"""Signature output locations for `sketch`: `.sig`, `.sig.gz`, `-` (stdout),
`.zip` collections, `dir/` directories and no output. Counterpart of the
saver classes of `sourmash_tpu/save_load.py` (SaveSignaturesToLocation :423,
SaveSignatures_ZipFile :342, SaveSignatures_SigFile :314,
SaveSignatures_Directory :256, SaveSignatures_NoOutput :247), without the
index layer that module loads.

Sqlite databases (`.sqldb`) are not ported yet: asking for one raises
NotImplementedError.
"""

from __future__ import annotations

import itertools
import os
import sys
import zipfile
from io import StringIO

from . import signature as sigmod
from .logging import notify
from .manifest import CollectionManifest


def _expand_to_single_sketches(siglist):
    "Normalize to one minhash per signature (md5-keyed outputs need this)."
    for ss in siglist:
        yield from sigmod.expand_signatures(ss)


class Base_SaveSignaturesToLocation:
    """Base signature saver: context manager tracking location + count.
    Subclasses override open/close/add as needed."""

    def __init__(self, location):
        self.location, self.count = location, 0

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


class SaveSignatures_NoOutput(Base_SaveSignaturesToLocation):
    "Discard everything (location is None)."

    def __repr__(self):
        return "SaveSignatures_NoOutput()"


class SaveSignatures_SigFile(Base_SaveSignaturesToLocation):
    "Save signatures to a .sig / .sig.gz JSON file (or '-' for stdout)."

    def __init__(self, location):
        super().__init__(location)
        self.keep = []
        self.compress = 1 if self.location.endswith(".gz") else 0

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


def SaveSignaturesToLocation(location):
    """Context manager that saves signatures in the output format matching
    `location`: None (no output), 'dir/', '.zip', '-' (stdout) or any other
    name as a .sig[.gz] file; the order of `sourmash_tpu`'s savers."""
    if location is None:
        return SaveSignatures_NoOutput(location)
    if not location:
        raise ValueError("cannot save signatures to an empty location")
    if location.endswith("/"):
        return SaveSignatures_Directory(location)
    if location.endswith(".zip"):
        return SaveSignatures_ZipFile(location)
    if location.endswith(".sqldb"):
        raise NotImplementedError(
            f"saving to a sqlite database ('{location}') is not yet ported to "
            "sourmash_tpu_torch; write a .zip, .sig or .sig.gz file instead"
        )
    return SaveSignatures_SigFile(location)
