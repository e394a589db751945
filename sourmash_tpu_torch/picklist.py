"""Picklists: include/exclude subsetting of signature collections keyed on
CSV column values (API parity: reference `src/sourmash/picklist.py`,
SignaturePicklist:54).

A picklist is a set of preprocessed values plus a column type that says
how to derive the comparison value from a signature, a manifest row, or a
CSV row.  Meta-coltypes (manifest/gather/prefetch/search) compare on
(ident, md5short) tuples pulled from sourmash's own output CSVs.

The port's copy of `sourmash_tpu/picklist.py`.
"""

from __future__ import annotations

import os
from enum import Enum


class PickStyle(Enum):
    INCLUDE, EXCLUDE = 1, 2


def _first_word(x):
    return x.split(" ")[0]


def _first_word_unversioned(x):
    return _first_word(x).split(".")[0]


def _md5short(x):
    return x[:8]


def _ident_md5short(tup):
    name, md5 = tup
    return (_first_word(name), md5[:8])


_META_COLTYPES = ("manifest", "gather", "prefetch", "search")
_SIMPLE_COLTYPES = ("md5", "md5prefix8", "md5short", "name", "ident", "identprefix")

# per-coltype value preprocessing
preprocess = {coltype: _ident_md5short for coltype in _META_COLTYPES}
preprocess.update(
    name=lambda x: x,
    md5=lambda x: x,
    identprefix=_first_word_unversioned,
    ident=_first_word,
    md5prefix8=_md5short,
    md5short=_md5short,
)

# (manifest column, signature accessor) per simple coltype
_SIMPLE_SOURCES = {
    "md5": "md5",
    "md5prefix8": "md5short",
    "md5short": "md5short",
    "name": "name",
    "ident": "name",
    "identprefix": "name",
}

_STYLE_BY_NAME = {"include": PickStyle.INCLUDE, "exclude": PickStyle.EXCLUDE}


class SignaturePicklist:
    """Subset collections by CSV column: 'pickfile:column:coltype[:style]'.

    coltypes: name / md5 / md5prefix8 / md5short / ident / identprefix,
    plus the meta-coltypes manifest / gather / prefetch / search, which
    select on (ident, md5short) tuples from sourmash output CSVs.
    """

    meta_coltypes = _META_COLTYPES
    supported_coltypes = _SIMPLE_COLTYPES

    def __init__(self, coltype, *, pickfile=None, column_name=None,
                 pickstyle=PickStyle.INCLUDE):
        if coltype not in _META_COLTYPES and coltype not in _SIMPLE_COLTYPES:
            raise ValueError(f"invalid picklist column type '{coltype}'")

        self.orig_coltype, self.orig_colname = coltype, column_name

        if coltype in _META_COLTYPES:
            if column_name:
                raise ValueError(f"no column name allowed for coltype '{coltype}'")
            column_name = (
                "(match_name, match_md5)" if coltype == "prefetch" else "(name, md5)"
            )

        self.coltype, self.column_name = coltype, column_name
        self.pickfile, self.pickstyle = pickfile, pickstyle
        self.preprocess_fn = preprocess[coltype]

        self.pickset = None
        self.found, self.n_queries = set(), 0

    @classmethod
    def from_picklist_args(cls, argstr):
        "Parse 'pickfile:col:coltype[:include|exclude]'."
        parts = argstr.split(":")
        pickstyle = PickStyle.INCLUDE

        if len(parts) == 4:
            style_name = parts.pop()
            pickstyle = _STYLE_BY_NAME.get(style_name)
            if pickstyle is None:
                raise ValueError(
                    f"invalid picklist 'pickstyle' argument 4: '{style_name}' must be 'include' or 'exclude'"
                )

        if len(parts) != 3:
            raise ValueError(f"invalid picklist argument '{argstr}'")

        pickfile, column, coltype = parts
        return cls(coltype, pickfile=pickfile, column_name=column, pickstyle=pickstyle)

    # -- comparison-value extraction -----------------------------------

    def _get_sig_attribute(self, ss):
        if self.coltype in _META_COLTYPES:
            return (ss.name, ss.md5sum())
        source = _SIMPLE_SOURCES.get(self.coltype)
        if source == "md5" or source == "md5short":
            return ss.md5sum()
        if source == "name":
            return ss.name
        raise ValueError(
            f"picklist get_sig_attribute {self.coltype} has unhandled branch"
        )

    def _get_value_for_manifest_row(self, row):
        if self.coltype in _META_COLTYPES:
            q = (row["name"], row["md5"])
        else:
            colkey = _SIMPLE_SOURCES.get(self.coltype)
            if colkey is None:
                raise ValueError(
                    f"picklist get_value_for_row {self.coltype} has unhandled branch"
                )
            q = row.get(colkey)
        assert q
        return self.preprocess_fn(q)

    def _get_value_for_csv_row(self, row):
        if self.coltype == "prefetch":
            q = (row["match_name"], row["match_md5"])
        elif self.coltype in _META_COLTYPES:
            q = (row["name"], row["md5"])
        else:
            q = row[self.column_name]
        return self.preprocess_fn(q) if q else q

    # -- pickset management --------------------------------------------

    def init(self, values=[]):
        if self.pickset is not None:
            raise ValueError("already initialized?")
        pickset = self.pickset = set(values)
        return pickset

    def add(self, value):
        self.pickset.add(value)

    def load(self, *, allow_empty=False):
        "Load the pickfile; return (num empty values, set of dup values)."
        from . import sourmash_args

        pickset = self.init()
        pickfile = self.pickfile
        if not (os.path.exists(pickfile) and os.path.isfile(pickfile)):
            raise ValueError(f"pickfile '{pickfile}' must exist and be a regular file")

        n_empty_val, dup_vals = 0, set()
        with sourmash_args.FileInputCSV(pickfile) as reader:
            self.pickfile = pickfile
            if not reader.fieldnames:
                if not allow_empty:
                    msg = f"empty or improperly formatted pickfile '{pickfile}'"
                    raise ValueError(msg)
                return 0, 0

            column_known = (
                self.column_name in reader.fieldnames
                or self.coltype in _META_COLTYPES
            )
            if not column_known:
                raise ValueError(
                    f"column '{self.column_name}' not in pickfile '{pickfile}'"
                )

            for row in reader:
                value = self._get_value_for_csv_row(row)
                if not value:
                    n_empty_val += 1
                elif value in pickset:
                    dup_vals.add(value)
                else:
                    self.add(value)

        return n_empty_val, dup_vals

    # -- membership ----------------------------------------------------

    def _check(self, q):
        "Apply include/exclude semantics to one preprocessed value."
        self.n_queries += 1
        hit = q in self.pickset
        if hit == (self.pickstyle == PickStyle.INCLUDE):
            self.found.add(q)
            return True
        return False

    def __contains__(self, ss):
        return self._check(self.preprocess_fn(self._get_sig_attribute(ss)))

    def matches_manifest_row(self, row):
        return self._check(self._get_value_for_manifest_row(row))

    def matched_csv_row(self, row):
        "Was this (pickfile) CSV row's value among the matched values?"
        q = self._get_value_for_csv_row(row)
        self.n_queries += 1
        return q in self.found

    def filter(self, it):
        return (ss for ss in it if ss in self)


def passes_all_picklists(ss, picklists):
    "Does the signature pass every picklist?"
    return all(ss in picklist for picklist in picklists)
