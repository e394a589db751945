"""Signature output locations for `sketch`: `.sig`, `.sig.gz`, `-` (stdout)
and no output. Counterpart of the saver classes of `sourmash_tpu/save_load.py`
(SaveSignaturesToLocation :423, SaveSignatures_SigFile :314,
SaveSignatures_NoOutput :247), without the index layer that module loads.

Zip collections, directories and sqlite databases are not ported yet: asking
for one raises NotImplementedError.
"""

from __future__ import annotations

import sys

from . import signature as sigmod


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


# location shapes `sourmash_tpu` saves to that the port does not yet write
_NOT_PORTED = ((".zip", "zip collection"), (".sqldb", "sqlite database"),
               ("/", "signature directory"))


def SaveSignaturesToLocation(location):
    """Context manager that saves signatures in the output format matching
    `location`: None (no output), '-' (stdout) or a .sig[.gz] file."""
    if location is None:
        return SaveSignatures_NoOutput(location)
    if not location:
        raise ValueError("cannot save signatures to an empty location")
    for suffix, what in _NOT_PORTED:
        if location.endswith(suffix):
            raise NotImplementedError(
                f"saving to a {what} ('{location}') is not yet ported to "
                "sourmash_tpu_torch; write a .sig or .sig.gz file instead"
            )
    return SaveSignatures_SigFile(location)
