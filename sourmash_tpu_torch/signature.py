"""SourmashSignature: MinHash sketches + metadata, with bit-identical `.sig`
JSON serialization.

API parity: reference `src/sourmash/signature.py` (SourmashSignature:29,
FrozenSourmashSignature:286, load_signatures_from_json:383,
save_signatures_to_json:493).  Serialization parity: Rust serde layout —
Signature field order class/email/hash_function/filename/name/license/
signatures/version (`src/core/src/signature.rs:401-433`), sketch field order
num/ksize/seed/max_hash/mins/md5sum/[abundances]/molecule
(`src/core/src/sketch/minhash.rs:103-129`).

The PyTorch port of `sourmash_tpu/signature.py`, plus
`signature_from_arrays`, which builds a signature from plain values.
"""

from __future__ import annotations

import contextlib
import gzip
import itertools
import json
import os

import numpy as np

from .minhash import MinHash, FrozenMinHash, minhash_from_arrays
from .exceptions import SourmashError

SIGNATURE_VERSION = 0.4

__all__ = [
    "SourmashSignature",
    "FrozenSourmashSignature",
    "load_signatures_from_json",
    "load_one_signature_from_json",
    "save_signatures_to_json",
    "signature_from_arrays",
]


class SourmashSignature:
    "Main class for signature information."

    def __init__(self, minhash, name="", filename=""):
        self._name = name if name else None
        self._filename = filename if filename else None
        self.minhash = minhash
        self._license = "CC0"
        self._email = ""

    @property
    def minhash(self):
        # the property always exposes a frozen VIEW aliasing the underlying
        # sketch (reference `signature.py:45-46` wraps the same Rust handle
        # in FrozenMinHash); add_sequence/add_protein mutate the internal
        # object directly
        mh = self._minhash
        if isinstance(mh, FrozenMinHash) or not isinstance(mh, MinHash):
            return mh
        view = FrozenMinHash.__new__(FrozenMinHash)
        view.__dict__ = mh.__dict__
        return view

    @minhash.setter
    def minhash(self, value):
        self._minhash = value

    def __hash__(self):
        return hash(self.md5sum())

    def __str__(self):
        return self._display_name()

    def __repr__(self):
        name, md5pref = self.name, self.md5sum()[:8]
        if name == md5pref:
            return f"SourmashSignature({md5pref})"
        return f"SourmashSignature('{name}', {md5pref})"

    def md5sum(self):
        "Calculate md5 hash of the bottom sketch, specifically."
        return self._minhash.md5sum()

    def __eq__(self, other):
        if not isinstance(other, SourmashSignature):
            return NotImplemented
        return (
            self._name == other._name
            and self._filename == other._filename
            and self._minhash == other._minhash
        )

    def __ne__(self, other):
        return not self == other

    @property
    def name(self):
        return self._name if self._name is not None else ""

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def filename(self):
        return self._filename if self._filename is not None else ""

    @filename.setter
    def filename(self, value):
        self._filename = value

    @property
    def license(self):
        return self._license

    def _display_name(self, max_length=0):
        "Best display label: name, else filename, else md5 prefix."
        name, filename = self._name, self._filename
        if name:
            if max_length and len(name) > max_length:
                name = name[: max_length - 3] + "..."
        elif filename:
            name = filename
            if max_length and len(name) > max_length:
                name = "..." + name[3 - max_length:]
        else:
            name = self.md5sum()[:8]
        assert not max_length or len(name) <= max_length
        return name

    # Every pairwise comparison delegates to the MinHash method of the
    # same name, applied to the two signatures' sketches; defaults live on
    # MinHash, so the wrappers forward arguments verbatim.

    def _via_minhash(method, doc):  # noqa: N805 - class-body factory
        def fn(self, other, *args, **kwargs):
            return getattr(self.minhash, method)(other.minhash, *args, **kwargs)

        fn.__name__, fn.__doc__ = method, doc
        return fn

    similarity = _via_minhash(
        "similarity", "Compute similarity with the other signature."
    )
    jaccard_ani = _via_minhash(
        "jaccard_ani", "Use Jaccard to estimate ANI between two FracMinHash signatures."
    )
    contained_by = _via_minhash(
        "contained_by",
        "Compute containment by the other signature. Note: ignores abundance.",
    )
    containment_ani = _via_minhash(
        "containment_ani",
        "Use containment to estimate ANI between two FracMinHash signatures.",
    )
    max_containment = _via_minhash(
        "max_containment",
        "Compute max containment w/other signature. Note: ignores abundance.",
    )
    max_containment_ani = _via_minhash(
        "max_containment_ani",
        "Use max containment to estimate ANI between two FracMinHash signatures.",
    )
    avg_containment = _via_minhash(
        "avg_containment",
        "Compute average containment with other signature. Ignores abundance.",
    )

    del _via_minhash

    def jaccard(self, other):
        "Compute Jaccard similarity with the other signature."
        return self.minhash.similarity(other.minhash, ignore_abundance=True,
                                       downsample=False)

    def avg_containment_ani(self, other, *, downsample=False):
        "Use avg_containment to estimate ANI between two FracMinHash signatures."
        return self.minhash.avg_containment_ani(other.minhash, downsample=downsample)

    def add_sequence(self, sequence, force=False, *, device=None):
        self._minhash.add_sequence(sequence, force, device=device)

    def add_protein(self, sequence, *, device=None):
        self._minhash.add_protein(sequence, device=device)

    def __len__(self):
        # number of sketches in the record, NOT hash count — matches
        # reference signature.py:232 -> Rust Signature::size()
        # (signature.rs:474). Notably this makes every signature truthy,
        # which gather's "found less than ... in common" reporting relies on
        # (reference commands.py:1056).
        return 1

    def __getstate__(self):
        return (
            self.minhash,
            self._name if self._name is not None else "",
            self._filename if self._filename is not None else "",
        )

    def __setstate__(self, tup):
        self.__class__ = SourmashSignature
        mh, name, filename = tup
        self.__init__(mh, name=name, filename=filename)

    def __reduce__(self):
        return (SourmashSignature, self.__getstate__())

    def __copy__(self):
        return SourmashSignature(
            self.minhash,
            name=self._name or "",
            filename=self._filename or "",
        )

    copy = __copy__

    def to_frozen(self):
        "Return a frozen copy of this signature."
        sig = self.__copy__()
        sig.__class__ = FrozenSourmashSignature
        return sig

    def to_mutable(self):
        "Return a mutable copy of this signature."
        sig = self.__copy__()
        sig.__class__ = SourmashSignature
        return sig

    def into_frozen(self):
        self.__class__ = FrozenSourmashSignature

    # -- serialization -----------------------------------------------------

    def _all_minhashes(self):
        "All sketches serialized in this signature record (usually one)."
        return [self._minhash]

    def _to_jsonable(self):
        "Build the dict matching the Rust serde field order exactly."
        d = {
            "class": "sourmash_signature",
            "email": self._email,
            "hash_function": "0.murmur64",
            "filename": self._filename,
        }
        if self._name is not None:
            d["name"] = self._name
        d["license"] = self._license

        sketches = []
        for mh in self._all_minhashes():
            sk = {
                "num": mh.num,
                "ksize": mh._ksize,
                "seed": mh.seed,
                "max_hash": mh._max_hash,
                "mins": [int(x) for x in mh.mins_array()],
                "md5sum": mh.md5sum(),
            }
            ab = mh.abunds_array()
            if ab is not None:
                sk["abundances"] = [int(x) for x in ab]
            sk["molecule"] = mh.moltype
            sketches.append(sk)
        d["signatures"] = sketches
        d["version"] = SIGNATURE_VERSION
        return d


class FrozenSourmashSignature(SourmashSignature):
    "Frozen (immutable) signature class."

    def _frozen_error(self, *args, **kwargs):
        raise ValueError("cannot modify FrozenSourmashSignature")

    @SourmashSignature.minhash.setter
    def minhash(self, value):
        raise ValueError("cannot set .minhash on FrozenSourmashSignature")

    @SourmashSignature.name.setter
    def name(self, value):
        raise ValueError("cannot set .name on FrozenSourmashSignature")

    @SourmashSignature.filename.setter
    def filename(self, value):
        raise ValueError("cannot set .filename on FrozenSourmashSignature")

    add_sequence = _frozen_error
    add_protein = _frozen_error

    def __copy__(self):
        return self

    copy = __copy__

    def to_frozen(self):
        return self

    def into_frozen(self):
        pass

    def to_mutable(self):
        sig = SourmashSignature.__new__(SourmashSignature)
        sig._name = self._name
        sig._filename = self._filename
        sig._minhash = self._minhash
        sig._license = self._license
        sig._email = self._email
        return sig

    @contextlib.contextmanager
    def update(self):
        "Make a mutable copy, then freeze on exit (reference :332-348)."
        new_sig = self.to_mutable()
        yield new_sig
        new_sig.into_frozen()


class MultiSketchSignature(SourmashSignature):
    """A signature carrying several sketches (e.g. one per ksize) that
    serialize into a single `.sig` record, mirroring the reference's
    multi-sketch Rust Signature (one record, N entries under 'signatures').
    `minhash` is the first sketch; sequence adds go to all sketches."""

    def __init__(self, minhashes, name="", filename=""):
        minhashes = list(minhashes)
        # base __init__ assigns via the overridden `minhash` setter, which
        # collapses _minhashes to one entry — restore the full list after.
        super().__init__(minhashes[0], name=name, filename=filename)
        self._minhashes = minhashes

    @property
    def minhash(self):
        return self._minhashes[0]

    @minhash.setter
    def minhash(self, value):
        self._minhashes = [value]
        self._minhash = value

    def _all_minhashes(self):
        return list(self._minhashes)

    def __len__(self):
        return len(self._minhashes)

    def add_sequence(self, sequence, force=False, *, device=None):
        for mh in self._minhashes:
            mh.add_sequence(sequence, force, device=device)
        self._minhash = self._minhashes[0]

    def add_protein(self, sequence, *, device=None):
        for mh in self._minhashes:
            mh.add_protein(sequence, device=device)
        self._minhash = self._minhashes[0]


def expand_signatures(ss):
    "Yield one single-sketch SourmashSignature per sketch in this signature."
    mhs = ss._all_minhashes()
    if len(mhs) == 1:
        yield ss
        return
    for mh in mhs:
        one = SourmashSignature(mh)
        one._name = ss._name
        one._filename = ss._filename
        yield one.to_frozen()


def _molecule_to_kwargs(molecule):
    m = molecule.lower()
    if m == "dna":
        return {}
    if m == "protein":
        return {"is_protein": True}
    if m == "dayhoff":
        return {"dayhoff": True}
    if m == "hp":
        return {"hp": True}
    raise SourmashError(f"unknown molecule type: {molecule}")


def _sig_from_dict(d, ignore_md5sum=False, native_arrays=None):
    """One JSON signature record -> list-of-one FrozenSourmashSignature per
    sketch. `native_arrays` optionally supplies the natively-extracted
    mins/abundances (a deque of (kind, np.uint64 array) in document
    order) when the JSON was pre-spliced (see load_signatures_from_json);
    a mismatch between the dict's keys and the queue raises KeyError and
    the caller re-parses through the plain path."""
    out = []
    name = d.get("name")
    filename = d.get("filename")
    for sk in d.get("signatures", []):
        max_hash = int(sk.get("max_hash", 0))
        num = int(sk.get("num", 0))
        if max_hash != 0:
            num = 0
        mol_kwargs = _molecule_to_kwargs(sk.get("molecule", "DNA"))
        abund = sk.get("abundances")
        ksize = int(sk["ksize"])
        if mol_kwargs:
            # protein-family sketches serialize ksize as 3x the aa ksize
            assert ksize % 3 == 0, ksize
            ksize = ksize // 3
        mh = MinHash(
            num,
            ksize,
            seed=int(sk.get("seed", 42)),
            max_hash=max_hash,
            track_abundance=abund is not None,
            **mol_kwargs,
        )
        if native_arrays is None:
            mins = np.array(sk.get("mins", []), dtype=np.uint64)
            ab = np.array(abund, dtype=np.uint64) if abund is not None else None
        else:
            # consume this sketch's arrays from the document-order queue:
            # one per key present, matched by kind (field order may vary)
            want = ("mins" in sk) + (abund is not None)
            got = {}
            for _ in range(want):
                kind, arr = native_arrays.popleft()
                if kind in got:
                    raise KeyError("duplicate array kind for one sketch")
                got[kind] = arr
            mins = got.get(0)
            if mins is None:
                if "mins" in sk:
                    raise KeyError("missing native mins")
                mins = np.zeros(0, dtype=np.uint64)
            ab = got.get(1)
            if (ab is None) != (abund is None):
                raise KeyError("abundances key/array mismatch")
        if ab is not None:
            order = np.argsort(mins, kind="stable")
            mh._set_mins_internal(
                np.ascontiguousarray(mins[order]),
                np.ascontiguousarray(ab[order]),
            )
        else:
            mh._set_mins_internal(np.sort(mins))
        if not ignore_md5sum:
            expected = sk.get("md5sum")
            if expected is not None:
                mh._md5cache = None
                if mh.md5sum() != expected:
                    raise SourmashError("md5sum mismatch in loaded signature")
        else:
            mh._md5cache = sk.get("md5sum")
        sig = SourmashSignature(
            mh, name=name or "", filename=filename or ""
        )
        # preserve None-ness of name for round-tripping
        sig._name = name
        sig._filename = filename
        out.append(sig.to_frozen())
    return out


def load_signatures_from_json(
    data,
    ksize=None,
    select_moltype=None,
    ignore_md5sum=False,
    do_raise=False,
):
    """Load signatures from JSON data: file-like object, JSON string/bytes,
    (gzipped) buffer, or path. Yields FrozenSourmashSignature objects."""
    if ksize is not None:
        ksize = int(ksize)
    else:
        ksize = 0

    if data is None or (hasattr(data, "__len__") and len(data) == 0):
        return

    try:
        buf = None
        if hasattr(data, "read") or hasattr(data, "fileno") or hasattr(data, "mode"):
            import io as _io

            if isinstance(data, _io.TextIOBase) and hasattr(data, "buffer"):
                data = data.buffer  # text-mode file handle: use raw bytes
            buf = data.read()
            if isinstance(buf, str):
                buf = buf.encode("utf-8")
            data.close()
        elif isinstance(data, (str, bytes)):
            probe = data if isinstance(data, bytes) else data.encode("utf-8", "ignore")
            if b"sourmash_signature" in probe:
                buf = probe
            elif probe.startswith(b"\x1f\x8b"):
                buf = probe
            else:
                try:
                    exists = os.path.exists(data)
                except (ValueError, TypeError):
                    exists = False
                if exists:
                    with open(data, "rb") as f:
                        buf = f.read()
                else:
                    if do_raise:
                        raise ValueError(
                            "Error in parsing signature; quitting. Cannot open file or invalid signature"
                        )
                    return
        else:
            if do_raise:
                raise ValueError(
                    "Error in parsing signature; quitting. Cannot open file or invalid signature"
                )
            return

        if buf.startswith(b"\x1f\x8b"):
            buf = gzip.decompress(buf)

        # fast path: the mins/abundances arrays are ~99% of the bytes;
        # extract them natively and json-parse only the small remainder
        # (sigjson.cpp bails to None on anything unusual)
        native_arrays = None
        if len(buf) > (1 << 14):
            from . import native

            ext = native.extract_sig_arrays(bytes(buf))
            if ext is not None:
                values, arr_off, spans, kinds = ext
                parts = []
                pos = 0
                for i in range(len(kinds)):
                    parts.append(buf[pos : spans[i, 0]])
                    parts.append(b"[]")
                    pos = int(spans[i, 1])
                parts.append(buf[pos:])
                slim = b"".join(parts)
                try:
                    records = json.loads(slim)
                except Exception:
                    ext = None
                else:
                    from collections import deque

                    native_arrays = deque(
                        (int(kinds[i]),
                         values[arr_off[i] : arr_off[i + 1]])
                        for i in range(len(kinds))
                    )
        if native_arrays is None:
            records = json.loads(buf)
        if isinstance(records, dict):
            records = [records]
        # an SBT index JSON also has a top-level "signatures" key (leaf map),
        # so require the value to be a list of sketch dicts
        if not isinstance(records, list) or not all(
            isinstance(rec, dict)
            and isinstance(rec.get("signatures"), list)
            and all(isinstance(sk, dict) for sk in rec["signatures"])
            for rec in records
        ):
            raise ValueError("JSON data is not a list of sourmash signatures")

        if native_arrays is not None:
            try:
                parsed = [
                    _sig_from_dict(
                        rec, ignore_md5sum=ignore_md5sum,
                        native_arrays=native_arrays,
                    )
                    for rec in records
                ]
                if native_arrays:  # leftovers: an array we mis-attributed
                    raise KeyError("unconsumed native arrays")
            except KeyError:
                # queue/dict mismatch (exotic layout): plain path, from
                # scratch — behavior identical, just slower
                records = json.loads(buf)
                if isinstance(records, dict):
                    records = [records]
                parsed = [
                    _sig_from_dict(rec, ignore_md5sum=ignore_md5sum)
                    for rec in records
                ]
        else:
            parsed = [
                _sig_from_dict(rec, ignore_md5sum=ignore_md5sum)
                for rec in records
            ]
        sigs = []
        for rec_sigs in parsed:
            for sig in rec_sigs:
                mh = sig.minhash
                # compare against the SERIALIZED ksize (3x aa-ksize for
                # protein family sketches) — reference signature.rs:613
                # filters on the raw KmerMinHash::ksize value
                if ksize and mh._ksize != ksize:
                    continue
                if select_moltype is not None:
                    if mh.moltype.lower() != str(select_moltype).lower():
                        continue
                sigs.append(sig)
        yield from sigs
    except Exception:
        if do_raise:
            raise


def load_one_signature_from_json(
    data, ksize=None, select_moltype=None, ignore_md5sum=False
):
    # materialize at most two: exactly-one is the only acceptable count
    pair = list(
        itertools.islice(
            load_signatures_from_json(
                data,
                ksize=ksize,
                select_moltype=select_moltype,
                ignore_md5sum=ignore_md5sum,
            ),
            2,
        )
    )
    if not pair:
        raise ValueError("no signatures to load")
    if len(pair) > 1:
        raise ValueError("expected to load exactly one signature")
    return pair[0]


def _dumps(siglist) -> bytes:
    "Compact JSON, byte-identical to serde_json output."
    records = [sig._to_jsonable() for sig in siglist]
    return json.dumps(records, separators=(",", ":"), ensure_ascii=False).encode(
        "utf-8"
    )


def save_signatures_to_json(siglist, fp=None, compression=0):
    "Save multiple signatures into a JSON string (or file handle 'fp')."
    result = _dumps(siglist)
    if compression:
        # mtime=0 keeps the gzip bytes deterministic: savers deduplicate
        # repeated signatures by comparing compressed content (reference
        # niffler/flate2 output carries no timestamp either)
        result = gzip.compress(result, compresslevel=int(compression), mtime=0)

    if fp is None:
        return result
    try:
        fp.write(result)
    except TypeError:
        fp.write(result.decode("utf-8"))
    return None


def signature_from_arrays(params: dict, mins, abunds=None, *, name="", filename=""):
    """Build a SourmashSignature from plain values: the sketch state of
    `minhash_from_arrays` plus the signature's name and filename."""
    return SourmashSignature(
        minhash_from_arrays(params, mins, abunds), name=name, filename=filename
    )
