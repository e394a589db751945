"""Scoring protocols, result-row assembly, and the greedy gather driver.

This module is the host-side brain of query execution.  The actual heavy
lifting — intersecting a query against thousands of database sketches —
happens inside the Index implementations on device (see ``index/`` and
``ops/bucketed.py``); what lives here is everything that is cheap but
semantically intricate:

* the ``JaccardSearch`` scoring protocol that Index.find() consults,
* the CSV row schemas and ANI bookkeeping for search/prefetch/gather output,
* ``GatherDatabases`` — the greedy minimum-set-cover loop, where each
  iteration consumes one device round (peek/consume on CounterGather-style
  counters) and ratchets the working scaled upward.

Behavioral parity targets: reference ``src/sourmash/search.py``
(threshold math :15, scoring protocol :90, result rows :284/:361/:473,
greedy driver :782) and the gather-stat block in
``src/core/src/index/mod.rs:210-353``.  The CSV column lists and user-facing
error strings are part of the parity surface and intentionally identical.

The port's copy of `sourmash_tpu/search.py`.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from enum import Enum

from .minhash import MinHash
from .signature import SourmashSignature
from .sketchcomparison import FracMinHashComparison, NumMinHashComparison

__all__ = [
    "SearchType",
    "JaccardSearch",
    "JaccardSearchBestOnly",
    "make_jaccard_search_query",
    "make_containment_query",
    "calc_threshold_from_bp",
    "format_bp",
    "SearchResult",
    "PrefetchResult",
    "GatherResult",
    "GatherDatabases",
    "search_databases_with_flat_query",
    "search_databases_with_abund_query",
    "prefetch_database",
]


class GatherRoundRestart(Exception):
    """Raised by a counter's peek() when its answer mode changed mid-round
    (e.g. a scheduled device gather fell back to host rounds) — counters
    peeked EARLIER in the same round answered under the old mode, so the
    round must re-peek every counter to pick the true global best."""


def format_bp(bp):
    "Render a basepair count with a human unit (bp/kbp/Mbp/Gbp)."
    bp = float(bp)
    for cutoff, div, unit in (
        (500, None, "bp"),
        (500e3, 1e3, "kbp"),
        (500e6, 1e6, "Mbp"),
        (500e9, 1e9, "Gbp"),
    ):
        if bp < cutoff or (unit == "kbp" and bp <= cutoff):
            if div is None:
                return f"{bp:.0f} {unit}"
            return f"{round(bp / div, 1):.1f} {unit}"
    return "???"


def calc_threshold_from_bp(threshold_bp, scaled, query_size):
    """Translate a --threshold-bp value into (fraction, hash count).

    A threshold of B basepairs at a given scaled corresponds to B/scaled
    sketch hashes; as a containment fraction that is (B/scaled)/|query|.
    Raises if the request is negative or exceeds the whole query.
    """
    if not threshold_bp:
        return 0.0, 0
    if threshold_bp < 0:
        raise TypeError("threshold_bp must be non-negative")

    n_threshold_hashes = float(threshold_bp) / scaled
    threshold = n_threshold_hashes / query_size
    if threshold > 1.0:
        raise ValueError("requested threshold_bp is unattainable with this query")
    return threshold, n_threshold_hashes


class SearchType(Enum):
    JACCARD = 1
    CONTAINMENT = 2
    MAX_CONTAINMENT = 3


class JaccardSearch:
    """The scoring protocol consulted by Index.find().

    An instance carries a score function (one of the three ``score_*``
    methods, selected by SearchType), a threshold, and a ``collect`` hook
    that subclasses may override to prune as matches accumulate.
    """

    # SearchType -> (score method name, does this search demand scaled sketches)
    _DISPATCH = {
        SearchType.JACCARD: ("score_jaccard", False),
        SearchType.CONTAINMENT: ("score_containment", True),
        SearchType.MAX_CONTAINMENT: ("score_max_containment", True),
    }

    def __init__(self, search_type, threshold=None):
        method_name, needs_scaled = self._DISPATCH.get(search_type, (None, False))
        self.score_fn = getattr(self, method_name) if method_name else None
        self.require_scaled = needs_scaled
        self.threshold = float(threshold) if threshold is not None else 0.0

    def check_is_compatible(self, sig):
        "Reject query signatures this search cannot score."
        mh = sig.minhash
        if self.require_scaled and not mh.scaled:
            raise TypeError("this search requires a scaled signature")
        if mh.track_abundance:
            raise TypeError("this search cannot be done with an abund signature")

    def passes(self, score):
        "Does a (nonzero) score clear the current threshold?"
        return bool(score and score >= self.threshold)

    def collect(self, score, match_sig):
        "Hook: called for each passing match; return False to drop it."
        return True

    # score functions take (query_size, shared_size, subject_size, union_size)
    def score_jaccard(self, q_size, shared, s_size, union_size):
        return shared / union_size if union_size else 0

    def score_containment(self, q_size, shared, s_size, union_size):
        return shared / q_size if q_size else 0

    def score_max_containment(self, q_size, shared, s_size, union_size):
        denom = min(q_size, s_size)
        return shared / denom if denom else 0


class JaccardSearchBestOnly(JaccardSearch):
    "Variant whose threshold ratchets up to the best score collected so far."

    def collect(self, score, match):
        self.threshold = max(self.threshold, score)
        return True


def make_jaccard_search_query(
    *, do_containment=False, do_max_containment=False, best_only=False, threshold=None
):
    "Build a JaccardSearch for the requested flat-search flavor."
    if do_containment and do_max_containment:
        raise TypeError("'do_containment' and 'do_max_containment' cannot both be True")

    if do_containment:
        kind = SearchType.CONTAINMENT
    elif do_max_containment:
        kind = SearchType.MAX_CONTAINMENT
    else:
        kind = SearchType.JACCARD

    factory = JaccardSearchBestOnly if best_only else JaccardSearch
    return factory(kind, threshold)


def make_containment_query(query_mh, threshold_bp, *, best_only=True):
    "Build a containment search object, converting threshold_bp to a fraction."
    if not query_mh:
        raise ValueError("query is empty!?")
    if not query_mh.scaled:
        raise TypeError("query signature must be calculated with scaled")

    threshold, _ = calc_threshold_from_bp(threshold_bp, query_mh.scaled, len(query_mh))

    factory = JaccardSearchBestOnly if best_only else JaccardSearch
    return factory(SearchType.CONTAINMENT, threshold=threshold)


# --------------------------------------------------------------------------
# result rows
#
# Each CLI command writes a fixed CSV schema (the parity surface).  The
# schemas are declared once here; the result dataclasses attach them as the
# historical ``*_write_cols`` class attributes that downstream code and the
# reference test-suite key off.
# --------------------------------------------------------------------------

_ANI_CI_COLUMNS = [
    "query_containment_ani_low",
    "query_containment_ani_high",
    "match_containment_ani_low",
    "match_containment_ani_high",
]

_SEARCH_COLUMNS = [
    "similarity", "md5", "filename", "name",
    "query_filename", "query_name", "query_md5", "ani",
]  # fmt: skip

_PREFETCH_COLUMNS = [
    "intersect_bp", "jaccard", "max_containment", "f_query_match",
    "f_match_query", "match_filename", "match_name", "match_md5", "match_bp",
    "query_filename", "query_name", "query_md5", "query_bp", "ksize",
    "moltype", "scaled", "query_n_hashes", "query_abundance",
    "query_containment_ani", "match_containment_ani",
    "average_containment_ani", "max_containment_ani",
    "potential_false_negative",
]  # fmt: skip

_GATHER_COLUMNS = [
    "intersect_bp", "f_orig_query", "f_match", "f_unique_to_query",
    "f_unique_weighted", "average_abund", "median_abund", "std_abund",
    "filename", "name", "md5", "f_match_orig", "unique_intersect_bp",
    "gather_result_rank", "remaining_bp",
    "query_filename", "query_name", "query_md5", "query_bp", "ksize",
    "moltype", "scaled", "query_n_hashes", "query_abundance",
    "query_containment_ani", "match_containment_ani",
    "average_containment_ani", "max_containment_ani",
    "potential_false_negative",
    "n_unique_weighted_found", "sum_weighted_found", "total_weighted_hashes",
]  # fmt: skip


@dataclass
class BaseResult:
    """Common result-row machinery: comparison setup, identity fields, CSV IO.

    Subclasses declare their column schema via ``write_cols`` and populate
    row attributes in ``__post_init__``; anything named in the schema and
    non-None is emitted by ``write()`` / ``resultdict``.
    """

    query: SourmashSignature
    match: SourmashSignature
    filename: str = None
    ignore_abundance: bool = False
    estimate_ani_ci: bool = False
    ani_confidence: float = 0.95
    threshold_bp: int = None
    cmp_scaled: int = None
    write_cols: list = None
    potential_false_negative: bool = False

    # -- comparison plumbing ------------------------------------------------

    def init_result(self):
        self.mh1 = self.query.minhash
        self.mh2 = self.match.minhash

    def build_fracminhashcomparison(self):
        "Attach a scaled (FracMinHash) comparison between query and match."
        cmp = FracMinHashComparison(
            self.mh1,
            self.mh2,
            cmp_scaled=self.cmp_scaled,
            threshold_bp=self.threshold_bp,
            ignore_abundance=self.ignore_abundance,
            estimate_ani_ci=self.estimate_ani_ci,
            ani_confidence=self.ani_confidence,
        )
        self.cmp = cmp
        self.cmp_scaled = cmp.cmp_scaled
        self.query_scaled = self.mh1.scaled
        self.match_scaled = self.mh2.scaled
        self.size_may_be_inaccurate = cmp.size_may_be_inaccurate

    def build_numminhashcomparison(self, cmp_num=None):
        "Attach a num-MinHash comparison between query and match."
        cmp = NumMinHashComparison(
            self.mh1, self.mh2, cmp_num=cmp_num, ignore_abundance=self.ignore_abundance
        )
        self.cmp = cmp
        self.cmp_num = cmp.cmp_num
        self.query_num = self.mh1.num
        self.match_num = self.mh2.num
        self.size_may_be_inaccurate = cmp.size_may_be_inaccurate

    def get_cmpinfo(self):
        "Copy identity metadata (names, md5s, sizes) onto the row."
        q, m = self.query, self.match
        self.ksize, self.moltype = self.mh1.ksize, self.mh1.moltype

        self.query_name, self.query_filename = q.name, q.filename
        self.query_md5 = q.md5sum()
        self.query_abundance, self.query_n_hashes = (
            self.mh1.track_abundance,
            len(self.mh1),
        )

        self.match_name, self.match_filename = m.name, m.filename
        self.match_md5 = m.md5sum()
        self.match_abundance, self.match_n_hashes = (
            self.mh2.track_abundance,
            len(self.mh2),
        )

        # aliases used by the search CSV schema
        self.md5, self.name = self.match_md5, self.match_name
        if self.filename is None and self.match_filename is not None:
            self.filename = self.match_filename

    @property
    def pass_threshold(self):
        return self.cmp.pass_threshold

    # -- CSV emission ---------------------------------------------------------

    @staticmethod
    def shorten_md5(md5):
        return md5[:8]

    def prep_result(self):
        "Final per-row touch-ups before serialization (md5 shortening etc)."
        self.query_md5 = self.shorten_md5(self.query_md5)

    def to_write(self, columns=[]):
        vals = self.__dict__
        return {c: vals[c] for c in vals if c in columns and vals[c] is not None}

    def init_dictwriter(self, csv_handle):
        w = csv.DictWriter(csv_handle, fieldnames=self.write_cols)
        w.writeheader()
        return w

    def write(self, w):
        self.prep_result()
        w.writerow(self.to_write(columns=w.fieldnames))

    @property
    def resultdict(self):
        self.prep_result()
        return self.to_write(columns=self.write_cols)


@dataclass
class SearchResult(BaseResult):
    "One `sourmash search` hit: similarity plus (optionally) search-type ANI."

    similarity: float = None
    cmp_num: int = None
    searchtype: SearchType = None

    search_write_cols = _SEARCH_COLUMNS
    ci_cols = ["ani_low", "ani_high"]
    search_write_cols_ci = _SEARCH_COLUMNS + ci_cols

    def __post_init__(self):
        self.init_sigcomparison()
        self.check_similarity()
        if self.cmp_scaled is not None and self.searchtype is not None:
            self.estimate_search_ani()
        self.write_cols = (
            self.search_write_cols_ci if self.estimate_ani_ci else self.search_write_cols
        )

    def init_sigcomparison(self):
        self.init_result()
        if self.mh1.scaled or self.mh2.scaled:
            self.build_fracminhashcomparison()
        elif self.mh1.num or self.mh2.num:
            self.build_numminhashcomparison(cmp_num=self.cmp_num)
        self.get_cmpinfo()

    def check_similarity(self):
        if self.similarity is None:
            raise ValueError("Error: Must provide 'similarity' for SearchResult.")

    def estimate_search_ani(self):
        "Fill the `ani` column according to the search type used."
        if self.cmp_scaled is None:
            raise TypeError("Error: ANI can only be estimated from scaled signatures.")
        cmp = self.cmp
        if self.searchtype == SearchType.CONTAINMENT:
            cmp.estimate_ani_from_mh1_containment_in_mh2(containment=self.similarity)
            self.ani = cmp.ani_from_mh1_containment_in_mh2
            if self.estimate_ani_ci:
                self.ani_low = cmp.ani_from_mh1_containment_in_mh2_low
                self.ani_high = cmp.ani_from_mh1_containment_in_mh2_high
        elif self.searchtype == SearchType.MAX_CONTAINMENT:
            cmp.estimate_max_containment_ani()
            self.ani = cmp.max_containment_ani
            if self.estimate_ani_ci:
                self.ani_low = cmp.max_containment_ani_low
                self.ani_high = cmp.max_containment_ani_high
        elif self.searchtype == SearchType.JACCARD:
            cmp.estimate_jaccard_ani(jaccard=self.similarity)
            self.jaccard_ani_untrustworthy = cmp.jaccard_ani_untrustworthy
            self.ani = cmp.jaccard_ani
        self.potential_false_negative = cmp.potential_false_negative


@dataclass
class PrefetchResult(BaseResult):
    "One `sourmash prefetch` hit: containments both ways + all-ANI block."

    prefetch_write_cols = _PREFETCH_COLUMNS
    ci_cols = _ANI_CI_COLUMNS
    prefetch_write_cols_ci = _PREFETCH_COLUMNS + _ANI_CI_COLUMNS

    def __post_init__(self):
        self.init_sigcomparison()
        self.build_prefetch_result()

    def init_sigcomparison(self):
        self.init_result()
        if not (self.mh1.scaled and self.mh2.scaled):
            raise TypeError(
                "Error: prefetch and gather results must be between scaled signatures."
            )
        self.build_fracminhashcomparison()
        self.get_cmpinfo()
        cmp = self.cmp
        self.intersect_bp = cmp.total_unique_intersect_hashes
        self.max_containment = cmp.max_containment
        self.query_bp, self.match_bp = (
            self.mh1.unique_dataset_hashes,
            self.mh2.unique_dataset_hashes,
        )
        self.threshold = self.threshold_bp
        self.estimate_containment_ani()

    def estimate_containment_ani(self):
        cmp = self.cmp
        cmp.estimate_all_containment_ani()
        self.query_containment_ani = cmp.ani_from_mh1_containment_in_mh2
        self.match_containment_ani = cmp.ani_from_mh2_containment_in_mh1
        self.average_containment_ani = cmp.avg_containment_ani
        self.max_containment_ani = cmp.max_containment_ani
        self.potential_false_negative = cmp.potential_false_negative
        if self.estimate_ani_ci:
            self.handle_ani_ci()

    def handle_ani_ci(self):
        cmp = self.cmp
        self.query_containment_ani_low = cmp.ani_from_mh1_containment_in_mh2_low
        self.query_containment_ani_high = cmp.ani_from_mh1_containment_in_mh2_high
        self.match_containment_ani_low = cmp.ani_from_mh2_containment_in_mh1_low
        self.match_containment_ani_high = cmp.ani_from_mh2_containment_in_mh1_high

    def build_prefetch_result(self):
        cmp = self.cmp
        self.jaccard = cmp.jaccard
        self.f_query_match = cmp.mh2_containment_in_mh1
        self.f_match_query = cmp.mh1_containment_in_mh2
        self.write_cols = (
            self.prefetch_write_cols_ci
            if self.estimate_ani_ci
            else self.prefetch_write_cols
        )

    def prep_prefetch_result(self):
        self.scaled = self.cmp_scaled
        self.query_md5 = self.shorten_md5(self.query_md5)
        self.md5 = self.shorten_md5(self.md5)
        self.match_md5 = self.shorten_md5(self.match_md5)

    def prep_result(self):
        self.prep_prefetch_result()

    @property
    def prefetchresultdict(self):
        self.prep_prefetch_result()
        return self.to_write(columns=self.write_cols)


@dataclass
class GatherResult(PrefetchResult):
    """One gather round's result row.

    Inherits the prefetch comparison (orig query vs match) and layers on the
    round-specific stats: containments relative to the *remaining* query
    (``gather_querymh``), abundance-weighted uniqueness, and the running
    rank/remaining-bp bookkeeping.  Semantics follow the reference's
    calculate_gather_stats (src/core/src/index/mod.rs:210-353).
    """

    gather_querymh: MinHash = None
    gather_result_rank: int = None
    orig_query_len: int = None
    orig_query_abunds: list = None
    sum_weighted_found: int = None
    total_weighted_hashes: int = None
    noident_len: int = 0

    gather_write_cols = _GATHER_COLUMNS
    ci_cols = _ANI_CI_COLUMNS
    gather_write_cols_ci = _GATHER_COLUMNS + _ANI_CI_COLUMNS

    _REQUIRED = [
        ("cmp_scaled", "must provide comparison scaled value ('cmp_scaled') for GatherResult"),
        ("gather_querymh", "must provide current gather sketch (remaining hashes) for GatherResult"),
        ("gather_result_rank", "must provide 'gather_result_rank' to GatherResult"),
        ("total_weighted_hashes", "must provide sum of all abundances ('total_weighted_hashes') to GatherResult"),
        ("orig_query_abunds", "must provide original query abundances ('orig_query_abunds') to GatherResult"),
    ]  # fmt: skip

    def __post_init__(self):
        self.check_gatherresult_input()
        self.init_sigcomparison()
        self.init_gathersketchcomparison()
        self.build_gather_result()
        self.write_cols = (
            self.gather_write_cols_ci if self.estimate_ani_ci else self.gather_write_cols
        )

    def check_gatherresult_input(self):
        for i, (attr, msg) in enumerate(self._REQUIRED):
            value = getattr(self, attr)
            # the first three must merely be present; the last two must be truthy
            missing = value is None if i < 3 else not value
            if missing:
                raise ValueError(f"Error: {msg}")

    def init_gathersketchcomparison(self):
        "Compare the remaining query hashes against the (flattened) match."
        self.gather_comparison = FracMinHashComparison(
            self.gather_querymh, self.match.minhash.flatten()
        )

    def build_gather_result(self):
        # `query` as passed to gather holds only identified hashes; whole-query
        # stats therefore come from orig_query_len / orig_query_abunds.
        gcmp, n_orig = self.gather_comparison, self.orig_query_len
        self.query_bp = n_orig * self.query.minhash.scaled
        self.query_n_hashes = n_orig

        self.unique_intersect_bp = gcmp.total_unique_intersect_hashes
        self.f_match_orig = self.cmp.mh2_containment_in_mh1
        self.f_match = gcmp.mh2_containment_in_mh1
        self.f_orig_query = len(self.cmp.intersect_mh) / n_orig
        self.f_unique_to_query = len(gcmp.intersect_mh) / n_orig

        self.remaining_bp = (
            self.noident_len
            + gcmp.mh1_cmp.unique_dataset_hashes
            - gcmp.total_unique_intersect_hashes
        )

        self.average_abund = self.median_abund = self.std_abund = None
        if self.ignore_abundance:
            self.f_unique_weighted = self.f_unique_to_query
            self.query_abundance = False
        else:
            weighted = gcmp.weighted_intersection(from_abundD=self.orig_query_abunds)
            self.query_weighted_unique_intersection = weighted
            self.average_abund = weighted.mean_abundance
            self.median_abund = weighted.median_abundance
            self.std_abund = weighted.std_abundance
            self.query_abundance = weighted.track_abundance
            self.n_unique_weighted_found = weighted.sum_abundances
            self.f_unique_weighted = (
                self.n_unique_weighted_found / self.total_weighted_hashes
            )

    def prep_gather_result(self):
        self.scaled = self.cmp_scaled
        self.query_md5 = self.shorten_md5(self.query_md5)

    def prep_result(self):
        self.prep_gather_result()

    @property
    def gatherresultdict(self):
        self.prep_gather_result()
        return self.to_write(columns=self.write_cols)

    @property
    def prefetchresultdict(self):
        "Render this gather row under the prefetch schema (for multigather)."
        cols = (
            self.prefetch_write_cols_ci
            if self.estimate_ani_ci
            else self.prefetch_write_cols
        )
        cmp = self.cmp
        self.jaccard = cmp.jaccard
        self.f_query_match = cmp.mh2_containment_in_mh1
        self.f_match_query = cmp.mh1_containment_in_mh2
        self.prep_prefetch_result()
        return self.to_write(columns=cols)


# --------------------------------------------------------------------------
# database-level search drivers
# --------------------------------------------------------------------------


def _dedup_and_rank(hits):
    "Drop duplicate matches (by md5), then order by descending score."
    unique = []
    seen = set()
    for score, match, filename in hits:
        key = match.md5sum()
        if key in seen:
            continue
        seen.add(key)
        unique.append((score, match, filename))
    unique.sort(key=lambda tup: -tup[0])
    return unique


def search_databases_with_flat_query(query, databases, **kwargs):
    "Run a flat (non-abundance) search over databases; return SearchResults."

    def all_hits():
        for db in databases:
            yield from db.search(query, **kwargs)

    ranked = _dedup_and_rank(all_hits())

    # ANI is only defined for the scaled search types; CI only when asked.
    if kwargs.get("do_containment"):
        searchtype = SearchType.CONTAINMENT
    elif kwargs.get("do_max_containment"):
        searchtype = SearchType.MAX_CONTAINMENT
    else:
        searchtype = SearchType.JACCARD
    want_ci = bool(
        searchtype is not SearchType.JACCARD and kwargs.get("estimate_ani_ci")
    )

    return [
        SearchResult(
            query,
            match,
            similarity=score,
            filename=filename,
            searchtype=searchtype,
            estimate_ani_ci=want_ci,
        )
        for score, match, filename in ranked
    ]


def search_databases_with_abund_query(query, databases, **kwargs):
    "Run an angular-similarity search (abund query) over databases."
    if kwargs.get("do_containment") or kwargs.get("do_max_containment"):
        raise TypeError("containment searches cannot be done with abund sketches")

    def all_hits():
        for db in databases:
            yield from db.search_abund(query, **kwargs)

    return [
        SearchResult(query, match, similarity=score, filename=filename)
        for score, match, filename in _dedup_and_rank(all_hits())
    ]


def prefetch_database(query, database, threshold_bp, *, estimate_ani_ci=False):
    "Yield a PrefetchResult for every db match above threshold_bp."
    assert query.minhash.scaled
    for hit in database.prefetch(query, threshold_bp):
        row = PrefetchResult(
            query,
            hit.signature,
            threshold_bp=threshold_bp,
            estimate_ani_ci=estimate_ani_ci,
        )
        assert row.pass_threshold
        yield row


# --------------------------------------------------------------------------
# gather: the greedy min-set-cover loop
# --------------------------------------------------------------------------


class GatherDatabases:
    """Iterator yielding GatherResult rows for a greedy gather decomposition.

    Each ``next()`` performs one round: ask every counter for its best
    remaining containment match (``peek``), commit the winner
    (``consume`` on all counters), subtract the found hashes from the
    working query, and assemble the stat row.  The comparison scaled
    ratchets up whenever a match was sketched coarser than the query.

    Hashes with no database match at all can be pre-partitioned out by the
    caller (``noident_mh``/``ident_mh``) so per-round stats still account
    for them in remaining-bp and the weighted totals.
    """

    def __init__(
        self,
        query,
        counters,
        *,
        threshold_bp=0,
        ignore_abundance=False,
        noident_mh=None,
        ident_mh=None,
        estimate_ani_ci=False,
    ):
        self.orig_query = query
        self.orig_query_bp = query.minhash.unique_dataset_hashes
        self.orig_query_filename = query.filename
        self.orig_query_name = query.name
        self.orig_query_md5 = query.md5sum()[:8]

        use_abund = query.minhash.track_abundance and not ignore_abundance
        self.track_abundance = use_abund

        # abundance lookup for every original hash (1s when flat)
        hashes = query.minhash.hashes
        self.orig_query_abunds = (
            hashes if use_abund else {h: 1 for h in hashes}
        )

        # split the query into identified / unidentified parts
        if noident_mh is None:
            noident_mh = query.minhash.copy_and_clear()
        self.noident_mh = noident_mh.to_frozen()

        if ident_mh is not None:
            working_mh = ident_mh.to_mutable()
        else:
            working_mh = query.minhash.to_mutable()
            working_mh.remove_many(noident_mh)

        self.orig_query_mh = working_mh.flatten()

        working_query = query.to_mutable()
        working_query.minhash = self.orig_query_mh
        self.query = working_query

        self.counters = counters
        self.threshold_bp = threshold_bp
        self.estimate_ani_ci = estimate_ani_ci
        self.result_n = 0

        self.cmp_scaled = 0
        self._update_scaled(working_query.minhash.scaled)

    # -- scaled ratcheting ---------------------------------------------------

    def _update_scaled(self, scaled):
        "Raise cmp_scaled to `scaled` if larger; re-derive weighted totals."
        new_scaled = max(self.cmp_scaled, scaled)
        if new_scaled != self.cmp_scaled:
            self.cmp_scaled = new_scaled

            self.orig_query_mh = self.orig_query_mh.downsample(scaled=scaled)
            self.noident_mh = self.noident_mh.downsample(scaled=scaled)

            abunds = self.orig_query_abunds
            self.noident_query_sum_abunds = sum(
                abunds[h] for h in self.noident_mh.hashes
            )
            self.total_weighted_hashes = (
                sum(abunds[h] for h in self.orig_query_mh.hashes)
                + self.noident_query_sum_abunds
            )
            # a scaled ratchet invalidates the incrementally-tracked
            # remaining-abundance sum (hash sets shrink to the new scale)
            self._weighted_remaining = None
        return new_scaled

    @property
    def scaled(self):
        return self.cmp_scaled

    # -- per-round selection ---------------------------------------------------

    def _select_best(self):
        "One device round: peek all counters, consume the global winner."
        for _attempt in range(12):
            winner = None
            winner_isect = None
            try:
                for counter in self.counters:
                    peeked = counter.peek(
                        self.query.minhash, threshold_bp=self.threshold_bp
                    )
                    if peeked:
                        sr, isect_mh = peeked
                        if winner is None or sr.score > winner.score:
                            winner, winner_isect = sr, isect_mh
            except GatherRoundRestart:
                # a counter switched answer modes mid-round (capped
                # schedule rebuilt, or scheduled -> host fallback);
                # earlier counters answered under the old mode, so restart
                # the round and re-peek everyone. Bounded: coordinators
                # allow at most 8 reschedules, then a one-way host
                # fallback — strictly fewer restarts than this loop allows
                continue
            break

        if winner is None:
            return None, None
        for counter in self.counters:
            counter.consume(winner_isect)
        return winner, winner_isect

    def __iter__(self):
        return self

    def __next__(self):
        query = self.query
        if not query.minhash:
            raise StopIteration

        best, winner_isect = self._select_best()
        if best is None:
            raise StopIteration

        best_match = best.signature
        match_scaled = best_match.minhash.scaled
        assert match_scaled
        scaled = self._update_scaled(match_scaled)

        orig_query_len = len(self.orig_query_mh) + len(self.noident_mh)

        # subtract the found hashes to form next round's query
        cur_mh = query.minhash.downsample(scaled=scaled)
        found_mh = best_match.minhash.downsample(scaled=scaled).flatten()
        next_mh = cur_mh.to_mutable()
        next_mh.remove_many(found_mh)

        # weighted-found bookkeeping: total minus what remains (incl.
        # noident). The remaining-abundance sum is maintained
        # INCREMENTALLY — this round's removed set is exactly the winner's
        # peek intersection whenever scales line up (checked), so only
        # those few hashes are looked up; a full re-sum of the remaining
        # query every round was the single largest per-round cost at
        # database scale. Scaled ratchets reset the tracker (rare).
        abunds = self.orig_query_abunds
        can_increment = (
            self._weighted_remaining is not None
            and winner_isect is not None
            and winner_isect.scaled == scaled
            and len(next_mh) == len(cur_mh) - len(winner_isect)
        )
        if can_increment:
            self._weighted_remaining -= sum(
                abunds[h] for h in winner_isect.hashes
            )
        else:
            self._weighted_remaining = sum(
                abunds[h] for h in set(next_mh.hashes)
            )
        n_weighted_missed = (
            self.noident_query_sum_abunds + self._weighted_remaining
        )
        sum_weighted_found = self.total_weighted_hashes - n_weighted_missed

        row = GatherResult(
            self.orig_query,
            best_match,
            cmp_scaled=scaled,
            filename=best.location,
            gather_result_rank=self.result_n,
            gather_querymh=query.minhash,
            ignore_abundance=not self.track_abundance,
            threshold_bp=self.threshold_bp,
            orig_query_len=orig_query_len,
            orig_query_abunds=abunds,
            estimate_ani_ci=self.estimate_ani_ci,
            sum_weighted_found=sum_weighted_found,
            total_weighted_hashes=self.total_weighted_hashes,
            noident_len=len(self.noident_mh) * self.noident_mh.scaled,
        )

        self.result_n += 1
        self.query = SourmashSignature(next_mh)
        return row
