"""Index: the search protocol over collections of signatures.

The port of `sourmash_tpu/index/__init__.py`. An Index is anything that can
enumerate signatures and answer search/prefetch/gather queries against
them. This module provides the abstract protocol plus the in-memory family:

* ``LinearIndex`` — a plain list of signatures,
* ``LazyLinearIndex`` — deferred selection over another index,
* ``ZipFileLinearIndex`` — read-only manifest-driven zip collections,
* ``MultiIndex`` — manifest aggregations of files and directories,
* ``StandaloneManifestIndex`` — a manifest file (CSV or sqlite) whose
  rows name signature files loaded lazily,
* ``CounterGather`` — the per-database counter engine behind gather.

API parity: reference ``src/sourmash/index/__init__.py`` (Index ABC :61,
LinearIndex:397, ZipFileLinearIndex:529, CounterGather:735,
MultiIndex:912, StandaloneManifestIndex:1040).

Every in-memory index funnels its subjects into ``Index._find_batched``,
which computes all (intersection, union) counts in one batched call per
chunk (``ops/intersect.query_vs_many_cutoff_counts``: the ``counts_rows``
kernel on CUDA), with per-pair scaled cutoffs replicating the reference's
pairwise-downsampling numerics bit for bit. Collections of at least
SOURMASH_TORCH_FLAT_VIEW signatures (default 512) gather through a
``index/flat.py`` FlatIndex view on the device; zip collections and
standalone manifests keep that view's signatures in a sidecar cache
(``index/view_cache.py``). Sqlite databases are in ``index/sqlite_index.py``
and disk revindexes in ``index/revindex.py``; SBT and LCA databases are not
ported yet.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from collections import namedtuple, Counter

import numpy as np

from ..search import (
    make_jaccard_search_query,
    make_containment_query,
    calc_threshold_from_bp,
)
from ..manifest import CollectionManifest
from ..logging import debug_literal
from ..signature import load_signatures_from_json, save_signatures_to_json
from ..minhash import (
    _get_max_hash_for_scaled,
    flatten_and_downsample_scaled,
    flatten_and_downsample_num,
    flatten_and_intersect_scaled,
)

IndexSearchResult = namedtuple("Result", "score, signature, location")

# the full set of selection criteria understood by Index.select()
_SELECT_KEYS = frozenset(
    ["ksize", "num", "moltype", "scaled", "abund", "picklist", "containment"]
)

# collections at or above this many signatures route gather through the
# device engine (a FlatIndex view); smaller ones stay on the host path,
# where numpy latency beats a device dispatch round-trip
_FLAT_VIEW_DEFAULT_MIN = 512


def _flat_view_threshold():
    """Minimum collection size for the device-view route, or None when
    disabled. SOURMASH_TORCH_FLAT_VIEW: '0' disables, '1' forces (any
    size), any other integer overrides the default threshold."""
    env = os.environ.get("SOURMASH_TORCH_FLAT_VIEW", "").strip()
    if env == "0":
        return None
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return _FLAT_VIEW_DEFAULT_MIN


def _check_select_parameters(**kw):
    "Validate types of Index.select() keyword arguments."
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


def select_signature(
    ss,
    *,
    ksize=None,
    moltype=None,
    scaled=0,
    num=0,
    containment=False,
    abund=None,
    picklist=None,
):
    "Does this signature satisfy all of the given selection criteria?"
    mh = ss.minhash
    if ksize and ksize != mh.ksize:
        return False
    if moltype and moltype != mh.moltype:
        return False
    if containment:
        if not scaled:
            raise ValueError("'containment' requires 'scaled' in Index.select'")
        if not mh.scaled:
            return False
    if scaled and mh.num:
        return False
    if num and (mh.scaled or num != mh.num):
        return False
    if abund and not mh.track_abundance:
        return False
    if picklist is not None and ss not in picklist:
        return False
    return True


class Index(ABC):
    is_database = False
    manifest = None

    @property
    def location(self):
        "Return a resolvable location for this index, if possible."
        return None

    # -- subclass contract ---------------------------------------------

    @abstractmethod
    def __len__(self):
        "Return the number of signatures in this Index object."

    @abstractmethod
    def signatures(self):
        "Return an iterator over all signatures in the Index object."

    @abstractmethod
    def insert(self, signature):
        "Add a signature (mutable indexes only)."

    @abstractmethod
    def save(self, path, storage=None, sparseness=0.0, structure_only=False):
        "Persist this index to `path`."

    @classmethod
    @abstractmethod
    def load(cls, location, leaf_loader=None, storage=None, print_version_warning=True):
        "Load an index of this type from `location`."

    # -- shared behavior -----------------------------------------------

    def signatures_with_location(self):
        "Return an iterator over tuples (signature, location) in the Index."
        yield from ((ss, self.location) for ss in self.signatures())

    def _signatures_with_internal(self):
        "Iterator of (ss, internal_location) over ALL signatures (pre-select)."
        raise NotImplementedError

    @abstractmethod
    def select(
        self,
        ksize=None,
        moltype=None,
        scaled=None,
        num=None,
        abund=None,
        containment=None,
    ):
        "Return Index containing only signatures that match requirements."

    # -- find: the core scoring loop ----------------------------------------

    def find(self, search_fn, query, **kwargs):
        """Yield IndexSearchResult for each signature search_fn accepts.

        Default implementation: generic one-at-a-time loop.  In-memory
        subclasses override this to route through ``_find_batched``.
        """
        yield from self._find_over(search_fn, query, self.signatures_with_location())

    def _find_over(self, search_fn, query, subjects_and_locations):
        "Score (signature, location) pairs one at a time on the host."
        search_fn.check_is_compatible(query)

        query_mh = query.minhash
        assert not query_mh.track_abundance

        # the reference semantics: each pair is compared after flattening
        # and downsampling both sides to the coarser resolution.
        if query_mh.scaled:
            fit_subject = lambda s_mh: flatten_and_downsample_scaled(
                s_mh, query_mh.scaled
            )
            fit_query = lambda q_mh, s_mh: flatten_and_downsample_scaled(
                q_mh, s_mh.scaled
            )
        else:
            fit_subject = lambda s_mh: flatten_and_downsample_num(s_mh, query_mh.num)
            fit_query = lambda q_mh, s_mh: flatten_and_downsample_num(q_mh, s_mh.num)

        for subj, location in subjects_and_locations:
            subj_mh = fit_subject(subj.minhash)
            q_mh = fit_query(query.minhash, subj_mh)

            assert not q_mh.track_abundance
            assert not subj_mh.track_abundance

            shared, union = q_mh.intersection_and_union_size(subj_mh)
            score = search_fn.score_fn(len(q_mh), shared, len(subj_mh), union)

            if search_fn.passes(score) and search_fn.collect(score, subj):
                yield IndexSearchResult(score, subj, location)

    def _find_batched(self, search_fn, query, subjects_and_locations):
        """Batched scoring of a query against subjects, in lazy chunks.

        Computes per-pair (shared, union) counts in one device call per
        chunk with per-pair scaled cutoffs, reproducing the reference's
        pairwise flatten/downsample numerics exactly. Falls back to the
        generic loop for num queries. Subjects are only touched as their
        chunk is reached, and a subject raising mid-stream flushes the
        results gathered so far before propagating (the reference's
        per-item laziness contract).
        """
        from ..ops.intersect import query_vs_many_cutoff_counts

        query_mh = query.minhash
        search_fn.check_is_compatible(query)
        q_scaled = query_mh.scaled

        def process(chunk):
            if not chunk:
                return
            if not q_scaled or any(not s.minhash.scaled for s, _ in chunk):
                yield from self._find_over(search_fn, query, chunk)
                return
            q_mins = query_mh.mins_array()
            sub_mins = [s.minhash.mins_array() for s, _ in chunk]
            cutoffs = np.zeros(len(chunk), dtype=np.uint64)
            for i, (s, _) in enumerate(chunk):
                pair_scaled = max(q_scaled, s.minhash.scaled)
                cutoffs[i] = _get_max_hash_for_scaled(pair_scaled)

            shared, q_sizes, s_sizes = query_vs_many_cutoff_counts(
                q_mins, sub_mins, cutoffs
            )

            for i, (subj, location) in enumerate(chunk):
                shared_size = int(shared[i])
                query_size = int(q_sizes[i])
                subj_size = int(s_sizes[i])
                total_size = query_size + subj_size - shared_size
                score = search_fn.score_fn(
                    query_size, shared_size, subj_size, total_size
                )
                if search_fn.passes(score):
                    if search_fn.collect(score, subj):
                        yield IndexSearchResult(score, subj, location)

        CHUNK = 1024
        pending = []
        for item in subjects_and_locations:
            try:
                subj, _loc = item
                _ = subj.minhash.scaled  # may raise for lazy/fake subjects
            except Exception:
                yield from process(pending)
                raise
            pending.append(item)
            if len(pending) >= CHUNK:
                yield from process(pending)
                pending = []
        yield from process(pending)

    # -- public search entry points ------------------------------------------

    def search(self, query, *, threshold=None, do_containment=False,
               do_max_containment=False, best_only=False, **kwargs):
        "Flat search; returns list of IndexSearchResult sorted by score."
        if threshold is None:
            raise TypeError("'search' requires 'threshold'")

        search_obj = make_jaccard_search_query(
            do_containment=do_containment,
            do_max_containment=do_max_containment,
            best_only=best_only,
            threshold=float(threshold),
        )

        hits = list(self.find(search_obj, query, **kwargs))
        hits.sort(key=lambda r: -r.score)
        return hits

    def search_abund(self, query, *, threshold=None, **kwargs):
        "Angular-similarity search over abundance sketches."
        if not query.minhash.track_abundance:
            raise TypeError(
                "'search_abund' requires query signature with abundance information"
            )
        if threshold is None:
            raise TypeError("'search_abund' requires 'threshold'")
        threshold = float(threshold)

        hits = []
        for subj, loc in self.signatures_with_location():
            if not subj.minhash.track_abundance:
                raise TypeError(
                    "'search_abund' requires subject signatures with abundance information"
                )
            score = query.similarity(subj, downsample=True)
            if score >= threshold:
                hits.append(IndexSearchResult(score, subj, loc))

        hits.sort(key=lambda r: -r.score)
        return hits

    def prefetch(self, query, threshold_bp, **kwargs):
        "Yield every match overlapping the query by >= threshold_bp."
        if not self:
            raise ValueError("no signatures to search")

        search_fn = make_containment_query(
            query.minhash, threshold_bp, best_only=kwargs.get("best_only", False)
        )
        yield from self.find(search_fn, query, **kwargs)

    def best_containment(self, query, threshold_bp=None, **kwargs):
        "Return the single best containment match, or None."
        hits = self.prefetch(query, threshold_bp, best_only=True, **kwargs)
        hits = sorted(hits, key=lambda r: (-r.score, r.signature.md5sum()))
        for hit in hits:
            return hit
        return None

    # -- gather protocol (CounterGather-compatible surface) --------------------

    def peek(self, query_mh, *, threshold_bp=0):
        "Mimic CounterGather.peek() on top of this Index."
        from ..signature import SourmashSignature

        try:
            best = self.best_containment(
                SourmashSignature(query_mh), threshold_bp=threshold_bp
            )
        except ValueError:
            best = None
        if not best:
            return []
        intersect_mh = flatten_and_intersect_scaled(best.signature.minhash, query_mh)
        return [best, intersect_mh]

    def consume(self, intersect_mh):
        "Mimic CounterGather.consume(): plain indexes have no state to update."
        pass

    def counter_gather(self, query, threshold_bp, **kwargs):
        "Prefetch all overlapping signatures into a CounterGather."
        if not kwargs:
            # device engine for any uniform-scaled collection large enough:
            # a memoized FlatIndex view whose counter queries and gather
            # rounds run on the device (the reference accelerates every
            # container through its Rust core, src/core/src/index/linear.rs)
            view = self._as_flat_view()
            if view is not None:
                return view.counter_gather(query, threshold_bp)
        with query.update() as prefetch_query:
            prefetch_query.minhash = prefetch_query.minhash.flatten()

        counter = CounterGather(prefetch_query)
        for hit in self.prefetch(prefetch_query, threshold_bp, **kwargs):
            counter.add(hit.signature, location=hit.location)
        return counter

    def _as_flat_view(self):
        """A memoized device-engine view (``index.flat.FlatIndex``) over
        this index's signatures, or None when ineligible.

        Eligible when every signature shares one nonzero scaled and the
        collection has at least SOURMASH_TORCH_FLAT_VIEW signatures
        (default 512; set "1" to force for any size, "0" to disable).
        This is what puts the reference's default user flow —
        ``gather meta.sig db.zip`` / ``.sig`` lists — on the device gather
        engine instead of host numpy.
        """
        threshold = _flat_view_threshold()
        if threshold is None:
            return None
        cached = getattr(self, "_flat_view_cache", None)
        if cached is not None:
            return cached or None  # False caches ineligibility
        view = self._build_flat_view(threshold)
        try:
            self._flat_view_cache = view if view is not None else False
        except AttributeError:
            pass  # __slots__ classes simply rebuild per call
        return view

    def _build_flat_view(self, threshold):
        from .flat import FlatIndex

        try:
            if len(self) < threshold:
                return None
        except (TypeError, NotImplementedError):
            return None
        sigs, locs, scaleds = [], [], set()
        try:
            for ss, loc in self.signatures_with_location():
                scaled = ss.minhash.scaled
                if not scaled:
                    return None  # num sketches stay on the host path
                scaleds.add(scaled)
                if len(scaleds) > 1:
                    return None  # mixed scaled: pairwise host semantics
                sigs.append(ss)
                locs.append(loc)
        except Exception:
            return None  # unreadable members: keep the lazy host path
        if not sigs:
            return None
        return FlatIndex(sigs, self.location, locations=locs)


class LinearIndex(Index):
    "In-memory list of signatures, scored via the batched device path."

    def __init__(self, _signatures=None, filename=None):
        self._signatures = list(_signatures) if _signatures else []
        self.filename = filename

    location = property(lambda self: self.filename)

    def signatures(self):
        return iter(self._signatures)

    def __bool__(self):
        return bool(self._signatures)

    def __len__(self):
        return len(self._signatures)

    def insert(self, node):
        self._signatures.append(node)

    def save(self, path):
        with open(path, "w") as fp:
            save_signatures_to_json(self.signatures(), fp)

    @classmethod
    def load(cls, location, filename=None):
        "Load signatures from a JSON signature file."
        sigs = load_signatures_from_json(location, do_raise=True)
        return LinearIndex(sigs, filename=filename or location)

    def find(self, search_fn, query, **kwargs):
        view = self._as_flat_view()
        if view is not None:  # big uniform-scaled list: cached device banks
            yield from view.find(search_fn, query, **kwargs)
            return
        pairs = [(ss, self.location) for ss in self._signatures]
        yield from self._find_batched(search_fn, query, pairs)

    def select(self, **kwargs):
        "New LinearIndex with only the signatures matching the criteria."
        _check_select_parameters(**kwargs)
        keep = [ss for ss in self._signatures if select_signature(ss, **kwargs)]
        return LinearIndex(keep, self.location)


class LazyLinearIndex(Index):
    """Deferred-selection wrapper around another index.

    Selection criteria accumulate in a dict and are applied to the wrapped
    index only when signatures are actually requested; find() stays the
    generic linear loop.
    """

    def __init__(self, db, selection_dict={}):
        self.db = db
        self.selection_dict = dict(selection_dict)

    def _resolve(self):
        return self.db.select(**self.selection_dict)

    def signatures(self):
        yield from self._resolve().signatures()

    def signatures_with_location(self):
        yield from self._resolve().signatures_with_location()

    def __bool__(self):
        return any(True for _ in self.signatures())

    def __len__(self):
        return len(self._resolve())

    # immutable view: no insert/save
    def insert(self, node):
        raise NotImplementedError

    def save(self, path):
        raise NotImplementedError

    @classmethod
    def load(cls, path):
        raise NotImplementedError

    def select(self, **kwargs):
        "Stack further selection criteria (without touching the wrapped db)."
        _check_select_parameters(**kwargs)
        merged = dict(self.selection_dict)
        for key, value in kwargs.items():
            if key in merged and merged[key] != value:
                raise ValueError(f"cannot select on two different values for {key}")
            merged[key] = value
        return LazyLinearIndex(self.db, merged)


class ZipFileLinearIndex(Index):
    """Read-only signature collection inside a zip file.

    With a manifest (the normal case) selection happens purely on manifest
    rows and only the needed members are decompressed; without one, members
    are scanned and filtered on load.
    """

    is_database = True

    def __init__(
        self,
        storage,
        *,
        selection_dict=None,
        traverse_yield_all=False,
        manifest=None,
        use_manifest=True,
    ):
        self.storage = storage
        self.selection_dict = selection_dict
        self.traverse_yield_all = traverse_yield_all
        self.use_manifest = use_manifest

        if not use_manifest:
            self.manifest = None
        elif manifest is not None:
            debug_literal("ZipFileLinearIndex using passed-in manifest")
            self.manifest = manifest
        else:
            self._load_manifest()

        # exactly one of (manifest, selection_dict) may be active
        if self.manifest is not None:
            assert not self.selection_dict, self.selection_dict
        if self.selection_dict:
            assert self.manifest is None

    @classmethod
    def load(cls, location, traverse_yield_all=False, use_manifest=True):
        "Open a zipfile collection from disk."
        from ..sbt_storage import ZipStorage

        if not os.path.exists(location):
            raise FileNotFoundError(location)

        return cls(
            ZipStorage(location),
            traverse_yield_all=traverse_yield_all,
            use_manifest=use_manifest,
        )

    def _load_manifest(self):
        "Pull SOURMASH-MANIFEST.csv out of the zip, if present."
        try:
            raw = self.storage.load("SOURMASH-MANIFEST.csv")
        except (KeyError, FileNotFoundError):
            self.manifest = None
        else:
            from io import StringIO

            debug_literal(f"found manifest on load for {self.storage.path}")
            self.manifest = CollectionManifest.load_from_csv(
                StringIO(raw.decode("utf-8"))
            )

    @property
    def location(self):
        return self.storage.path

    def __bool__(self):
        for _ in self.signatures():
            return True
        return False

    def __len__(self):
        if self.manifest is not None:
            return len(self.manifest)
        return sum(1 for _ in self.signatures())

    def insert(self, signature):
        raise NotImplementedError

    def save(self, path):
        raise NotImplementedError

    def _iter_member_sigs(self):
        "Scan zip members that look like signature files; yield (ss, name)."
        for name in self.storage._filenames():
            if (
                name.endswith(".sig")
                or name.endswith(".sig.gz")
                or self.traverse_yield_all
            ):
                data = self.storage.load(name)
                for ss in load_signatures_from_json(data):
                    yield ss, name

    def _signatures_with_internal(self):
        "All signatures + internal locations (ignores any selection)."
        yield from self._iter_member_sigs()

    def signatures(self):
        "Yield the signatures this (possibly selected) view contains."
        if self.manifest is not None:
            assert not self.selection_dict
            # decompress only the members the manifest names; the manifest
            # also filters multi-sig members down to the selected rows.
            for name in self.manifest.locations():
                data = self.storage.load(name)
                for ss in load_signatures_from_json(data):
                    if ss in self.manifest:
                        yield ss
        else:
            criteria = self.selection_dict
            for ss, _name in self._iter_member_sigs():
                if not criteria or select_signature(ss, **criteria):
                    yield ss

    def _build_flat_view(self, threshold):
        """Zip collections key a sidecar payload cache (view_cache.py):
        a warm run rebuilds the device view straight from concatenated
        hash arrays, skipping zip decompress + JSON + md5 verification."""
        if self.manifest is None:
            return super()._build_flat_view(threshold)
        if len(self.manifest) < threshold:
            return None
        from . import view_cache
        from .flat import FlatIndex

        key = view_cache.collection_cache_key(self.location, self.manifest.rows)
        hit = view_cache.load(key)
        if hit is not None:
            sigs, _locs = hit
            return FlatIndex(sigs, self.location, locations=[self.location] * len(sigs))
        view = super()._build_flat_view(threshold)
        if view is not None:
            view_cache.store(key, view._signatures)
        return view

    def find(self, search_fn, query, **kwargs):
        view = self._as_flat_view()
        if view is not None:  # big uniform-scaled zip: cached device banks
            yield from view.find(search_fn, query, **kwargs)
            return
        pairs = [(ss, self.location) for ss in self.signatures()]
        yield from self._find_batched(search_fn, query, pairs)

    def select(self, **kwargs):
        "Select signatures by ksize/moltype/etc."
        _check_select_parameters(**kwargs)

        if self.manifest is not None:
            return ZipFileLinearIndex(
                self.storage,
                selection_dict=None,
                traverse_yield_all=self.traverse_yield_all,
                manifest=self.manifest.select_to_manifest(**kwargs),
                use_manifest=True,
            )

        if self.selection_dict:
            merged = dict(self.selection_dict)
            for key, value in kwargs.items():
                if key in merged and merged[key] is not None and merged[key] != value:
                    raise ValueError(f"incompatible select on '{key}'")
                merged[key] = value
            kwargs = merged
        return ZipFileLinearIndex(
            self.storage,
            selection_dict=kwargs,
            traverse_yield_all=self.traverse_yield_all,
            manifest=None,
            use_manifest=False,
        )


class CounterGather:
    """Overlap counters for gather, built by prefetch.

    Maps each candidate signature (keyed by md5; duplicates collapse) to its
    overlap with the original query.  ``peek`` reports the current best
    candidate without mutating anything; ``consume`` subtracts a committed
    intersection from every counter and drops the ones that hit zero.

    Tie-breaking on peek inherits Counter.most_common() semantics — ties
    resolve by insertion order — which is part of gather-output parity.
    """

    def __init__(self, query):
        query_mh = query.minhash
        if not query_mh.scaled:
            raise ValueError("gather requires scaled signatures")

        self.orig_query_mh = query_mh.copy().flatten()
        self.scaled = query_mh.scaled

        # md5 -> signature / location / overlap count
        self.siglist = {}
        self.locations = {}
        self.counter = Counter()

        # once peek/consume has happened, the candidate set is frozen
        self.query_started = 0

    def add(self, ss, *, location=None, require_overlap=True):
        "Register a candidate match."
        if self.query_started:
            raise ValueError("cannot add more signatures to counter after peek/consume")

        overlap = self.orig_query_mh.count_common(ss.minhash, True)
        if not overlap:
            if require_overlap:
                raise ValueError("no overlap between query and signature!?")
            return

        md5 = ss.md5sum()
        self.counter[md5] = overlap
        self.siglist[md5] = ss
        self.locations[md5] = location
        self.downsample(ss.minhash.scaled)

    def downsample(self, scaled):
        "Ratchet the working scaled up to the coarsest candidate seen."
        self.scaled = max(self.scaled, scaled)
        return self.scaled

    def signatures(self):
        "All candidate signatures."
        yield from self.siglist.values()

    @property
    def union_found(self):
        "Hashes of the original query covered by any candidate."
        found_mh = self.orig_query_mh.copy_and_clear()
        for ss in self.siglist.values():
            found_mh.add_many(
                flatten_and_intersect_scaled(ss.minhash, self.orig_query_mh)
            )
        return found_mh

    def peek(self, cur_query_mh, *, threshold_bp=0):
        "Report the best remaining candidate; [] if none clears the bar."
        self.query_started = 1

        if not self.counter:
            return []
        assert self.siglist

        scaled = self.downsample(cur_query_mh.scaled)
        cur_query_mh = cur_query_mh.downsample(scaled=scaled)
        if not cur_query_mh:
            return []

        if cur_query_mh.contained_by(self.orig_query_mh, downsample=True) < 1:
            raise ValueError("current query not a subset of original query")

        try:
            threshold, n_threshold_hashes = calc_threshold_from_bp(
                threshold_bp, scaled, len(cur_query_mh)
            )
        except ValueError:
            # threshold unattainable with the remaining query
            return []

        best_md5, best_count = self.counter.most_common()[0]
        if best_count < n_threshold_hashes:
            return []

        match = self.siglist[best_md5]
        cont = cur_query_mh.contained_by(match.minhash, downsample=True)
        assert cont and cont >= threshold

        match_mh = match.minhash.downsample(scaled=scaled).flatten()
        intersect_mh = cur_query_mh & match_mh

        return (
            IndexSearchResult(cont, match, self.locations[best_md5]),
            intersect_mh,
        )

    def consume(self, intersect_mh):
        "Commit an intersection: decrement every counter it overlaps."
        self.query_started = 1
        if not intersect_mh:
            return

        for md5, _count in self.counter.most_common():
            overlap = intersect_mh.count_common(
                self.siglist[md5].minhash, downsample=True
            )
            if overlap:
                self.counter[md5] -= overlap
                if self.counter[md5] == 0:
                    del self.counter[md5]


class MultiIndex(Index):
    """Aggregation of signatures from several sources, held in memory.

    A manifest records every signature's original location; search runs
    batched over the full set.
    """

    def __init__(self, manifest, parent, *, prepend_location=False):
        if prepend_location and parent is None:
            raise ValueError("must set 'parent' if 'prepend_location' is set")
        self.manifest = manifest
        self.parent = parent
        self.prepend_location = prepend_location

    @property
    def location(self):
        return self.parent

    def signatures(self):
        for row in self.manifest.rows:
            yield row["signature"]

    def signatures_with_location(self):
        for row in self.manifest.rows:
            loc = row["internal_location"]
            if self.prepend_location:
                loc = os.path.join(self.parent, loc)
            yield row["signature"], loc

    def _signatures_with_internal(self):
        for row in self.manifest.rows:
            yield row["signature"], row["internal_location"]

    def __len__(self):
        return len(self.manifest) if self.manifest is not None else 0

    def insert(self, *args):
        raise NotImplementedError

    def save(self, *args):
        raise NotImplementedError

    def find(self, search_fn, query, **kwargs):
        view = self._as_flat_view()
        if view is not None:
            yield from view.find(search_fn, query, **kwargs)
            return
        pairs = list(self.signatures_with_location())
        yield from self._find_batched(search_fn, query, pairs)

    @classmethod
    def load(cls, index_list, source_list, parent, *, prepend_location=False):
        "Build a MultiIndex from already-loaded indices + their sources."
        assert len(index_list) == len(source_list)

        def walk():
            for idx, src in zip(index_list, source_list):
                src = idx.location if src is None else src
                for ss in idx.signatures():
                    yield ss, src

        manifest = CollectionManifest.create_manifest(walk())
        return cls(manifest, parent, prepend_location=prepend_location)

    @classmethod
    def load_from_directory(cls, pathname, *, force=False):
        "Gather all .sig/.sig.gz files under a directory into a MultiIndex."
        from ..sourmash_args import traverse_find_sigs
        from ..exceptions import SourmashError

        if not os.path.isdir(pathname):
            raise ValueError(f"'{pathname}' must be a directory.")

        loaded, sources = [], []
        for filename in traverse_find_sigs([pathname], yield_all_files=force):
            try:
                loaded.append(LinearIndex.load(filename))
                sources.append(os.path.relpath(filename, pathname))
            except (OSError, SourmashError, ValueError) as exc:
                # drop the partial append if load itself raised
                del loaded[len(sources):]
                if not force:
                    raise ValueError(exc)

        if not loaded:
            raise ValueError(f"no signatures to load under directory '{pathname}'")

        return cls.load(loaded, sources, pathname, prepend_location=True)

    @classmethod
    def load_from_path(cls, pathname, force=False):
        "Build a MultiIndex from a filename or directory path."
        from ..exceptions import SourmashError

        if not os.path.exists(pathname):
            raise ValueError(f"'{pathname}' must exist.")

        if os.path.isdir(pathname):
            return cls.load_from_directory(pathname, force=force)

        try:
            idx = LinearIndex.load(pathname)
        except (OSError, SourmashError, ValueError):
            if not force:
                raise ValueError(f"no signatures to load from '{pathname}'")
            return None

        return cls.load([idx], [pathname], pathname)

    @classmethod
    def load_from_pathlist(cls, filename):
        "Build a MultiIndex from every path listed in a text file."
        from ..sourmash_args import load_pathlist_from_file, load_file_as_index

        paths = list(load_pathlist_from_file(filename))
        indices = [load_file_as_index(p) for p in paths]
        return cls.load(indices, paths, filename)

    def select(self, **kwargs):
        "Selection applies directly to the manifest."
        _check_select_parameters(**kwargs)
        return MultiIndex(
            self.manifest.select_to_manifest(**kwargs),
            self.parent,
            prepend_location=self.prepend_location,
        )


class StandaloneManifestIndex(Index):
    """Index over a free-standing manifest file.

    Selection and enumeration work purely on manifest rows; the actual
    signatures are loaded lazily from their recorded locations (made
    absolute against ``prefix`` when relative) only when iterated.
    """

    is_database = True

    def __init__(self, manifest, location, *, prefix=None):
        assert manifest is not None
        self.manifest = manifest
        self._location = location
        self.prefix = prefix

    @classmethod
    def load(cls, location, *, prefix=None):
        "Load a manifest CSV/sqlite file as an index."
        if not os.path.isfile(location):
            raise ValueError(f"provided manifest location '{location}' is not a file")

        manifest = CollectionManifest.load_from_filename(location)
        if prefix is None:
            prefix = os.path.dirname(location)
        return cls(manifest, location, prefix=prefix)

    @property
    def location(self):
        return self._location

    def __len__(self):
        return len(self.manifest)

    def __bool__(self):
        return bool(self.manifest)

    def signatures(self):
        for ss, _loc in self._signatures_with_internal():
            yield ss

    def signatures_with_location(self):
        yield from self._signatures_with_internal()

    def _member_path(self, loc):
        "A manifest location, made absolute against the prefix when relative."
        if not loc.startswith("/") and self.prefix:
            return os.path.join(self.prefix, loc)
        return loc

    def _signatures_with_internal(self):
        "Lazily load each manifest location, filtered back through a picklist."
        from ..sourmash_args import load_file_as_index

        picklist = self.manifest.to_picklist()
        for loc in self.manifest.locations():
            loc = self._member_path(loc)
            idx = load_file_as_index(loc).select(picklist=picklist)
            for ss in idx.signatures():
                yield ss, loc

    def save(self, *args):
        raise NotImplementedError

    def insert(self, *args):
        raise NotImplementedError

    def _build_flat_view(self, threshold):
        """Standalone manifests key the sidecar payload cache like zips
        (view_cache.py); referenced member files are pinned by
        (size, mtime) so editing a member invalidates the entry."""
        if len(self.manifest) < threshold:
            return None
        from . import view_cache
        from .flat import FlatIndex

        locs = {self._member_path(loc) for loc in self.manifest.locations()}
        key = view_cache.collection_cache_key(
            self.location, self.manifest.rows, extra_stat_paths=sorted(locs)
        )
        hit = view_cache.load(key)
        if hit is not None and hit[1] is not None:
            sigs, locations = hit
            return FlatIndex(sigs, self.location, locations=locations)
        view = super()._build_flat_view(threshold)
        if view is not None:
            view_cache.store(key, view._signatures, locations=view._locations)
        return view

    def find(self, search_fn, query, **kwargs):
        view = self._as_flat_view()
        if view is not None:  # device banks beat per-sig host scoring
            yield from view.find(search_fn, query, **kwargs)
            return
        yield from super().find(search_fn, query, **kwargs)

    def select(self, **kwargs):
        "Selection applies directly to the manifest."
        _check_select_parameters(**kwargs)
        return StandaloneManifestIndex(
            self.manifest.select_to_manifest(**kwargs),
            self._location,
            prefix=self.prefix,
        )
