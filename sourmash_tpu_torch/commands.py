"""Top-level command drivers of the port: `gather` (the port of
`sourmash_tpu/commands.py:791-957`, reference `src/sourmash/commands.py`
gather:836).

The command is organized around reusable pipeline stages:

* ``_Selectors`` / ``_load_announced_query`` — shared input selection,
* ``_PrefetchSweep`` — the one-pass-per-database overlap sweep that seeds
  gather with per-database counters plus identified/unidentified hash
  bookkeeping,
* ``_GatherReport`` — incremental console-table + CSV row emission for the
  greedy rounds.

Console strings and CSV schemas are parity surface and match the reference
exactly. At or above the flat-view threshold a database gathers on the
device (`index/flat.py`); the other commands are not ported yet.
"""

from __future__ import annotations

import io
import shutil
import sys
from dataclasses import dataclass

from . import sourmash_args
from .logging import notify, error, print_results, set_quiet
from .sourmash_args import FileOutputCSV
from .save_load import SaveSignaturesToLocation

DEFAULT_N = 3
WATERMARK_SIZE = 10000

_SIZE_WARN = (
    "WARNING: size estimation for at least one of these sketches may be"
    " inaccurate. ANI values will not be reported for these comparisons."
)


# ---------------------------------------------------------------------------
# shared input-selection stages
# ---------------------------------------------------------------------------


@dataclass
class _Selectors:
    """The three standard database/signature subsetting knobs, parsed once."""

    moltype: str | None
    picklist: object
    pattern: object

    @classmethod
    def parse(cls, args):
        return cls(
            moltype=sourmash_args.calculate_moltype(args),
            picklist=sourmash_args.load_picklist(args),
            pattern=sourmash_args.load_include_exclude_db_patterns(args),
        )

    def report_picklist(self, args):
        if self.picklist:
            sourmash_args.report_picklist(args, self.picklist)


def _announce_query(query, *, first=False):
    "Standard 'loaded query' console line."
    which = "first query" if first else "query"
    notify(
        f"loaded {which}: {str(query)[:30]}... "
        f"(k={query.minhash.ksize}, {sourmash_args.get_moltype(query)})"
    )


def _load_announced_query(args, moltype):
    "Load the single query signature named by args.query and announce it."
    query = sourmash_args.load_query_signature(
        args.query, ksize=args.ksize, select_moltype=moltype, select_md5=args.md5
    )
    _announce_query(query)
    return query


def _downsample_query_inplace(query, target_scaled):
    "Downsample a scaled query signature, with the standard notification."
    if target_scaled and target_scaled != query.minhash.scaled:
        notify(
            f"downsampling query from scaled={query.minhash.scaled} to {int(target_scaled)}"
        )
        with query.update() as query:
            query.minhash = query.minhash.downsample(scaled=target_scaled)
    return query


def _flattened_copy(query):
    "A copy of `query` with abundances stripped (if any)."
    out = query.copy()
    if out.minhash.track_abundance:
        with out.update() as out:
            out.minhash = out.minhash.flatten()
    return out


def _screen_width():
    col, _ = shutil.get_terminal_size()
    return col



# ===========================================================================
# gather
# ===========================================================================


class _PrefetchSweep:
    """One pass over every database building a CounterGather per database.

    Partitions the (flattened) query hashes into identified (`ident_mh`,
    found in at least one database entry above threshold) and unidentified
    (`noident_mh`) sets as it goes; optionally streams the per-match
    PrefetchResult rows / matched signatures out.
    """

    def __init__(self, query, threshold_bp):
        self.threshold_bp = threshold_bp
        flat = _flattened_copy(query)
        self.query = flat
        self.noident_mh = flat.minhash.to_mutable()
        self.ident_mh = self.noident_mh.copy_and_clear()
        self.counters = []

    def sweep_one(self, db, *, sink=None):
        "Run the counter_gather sweep on a single database."
        try:
            counter = db.counter_gather(self.query, self.threshold_bp)
        except ValueError:  # no matches in this database
            return None

        union_found = counter.union_found
        self.ident_mh.add_many(union_found)
        self.noident_mh.remove_many(union_found)
        self.counters.append(counter)

        if sink is not None:
            sink(counter)
        return counter


class _GatherReport:
    """Accumulates gather rounds: prints the console table incrementally,
    buffers CSV rows, tracks the summary statistics."""

    def __init__(self, is_abundance, *, csv_fp=None):
        self.is_abundance = is_abundance
        self.screen_width = _screen_width()
        self.found = 0
        self.sum_f_uniq = 0.0
        self.last = None
        self.csv_fp = csv_fp
        self._csv_writer = None

    def _header(self):
        print_results("")
        if self.is_abundance:
            print_results("overlap     p_query p_match avg_abund")
            print_results("---------   ------- ------- ---------")
        else:
            print_results("overlap     p_query p_match")
            print_results("---------   ------- -------")

    def row(self, result):
        from .search import format_bp

        self.found += 1
        self.sum_f_uniq += result.f_unique_to_query
        self.last = result
        if self.found == 1:
            self._header()

        pct_query = f"{result.f_unique_weighted * 100:.1f}%"
        pct_genome = f"{result.f_match * 100:.1f}%"
        if self.is_abundance:
            name = result.match._display_name(self.screen_width - 41)
            print_results(
                "{:9}   {:>7} {:>7} {:>9}    {}",
                format_bp(result.intersect_bp),
                pct_query,
                pct_genome,
                f"{result.average_abund:.1f}",
                name,
            )
        else:
            name = result.match._display_name(self.screen_width - 31)
            print_results(
                "{:9}   {:>7} {:>7}    {}",
                format_bp(result.intersect_bp),
                pct_query,
                pct_genome,
                name,
            )

        if self.csv_fp is not None:
            if self._csv_writer is None:
                self._csv_writer = result.init_dictwriter(self.csv_fp)
            result.write(self._csv_writer)

    def coverage_summary(self):
        "The 'recovered matches hit X%' lines after a gather run."
        if self.is_abundance and self.last:
            p_covered = 100 * self.last.sum_weighted_found / self.last.total_weighted_hashes
            print_results(
                f"the recovered matches hit {p_covered:.1f}% of the abundance-weighted query."
            )
        print_results(
            f"the recovered matches hit {self.sum_f_uniq*100:.1f}% of the query k-mers (unweighted)."
        )


def _assemble_unassigned(gather_iter, noident_mh, is_abundance, orig_query_mh, *, downsample_noident):
    """The leftover-signature construction shared by gather/multigather:
    remaining query hashes + never-identified hashes, reinflated with the
    original abundances when tracking them."""
    remaining_query = gather_iter.query
    if noident_mh:
        remaining_mh = remaining_query.minhash.to_mutable()
        if downsample_noident:
            remaining_mh += noident_mh.downsample(scaled=remaining_mh.scaled)
        else:
            remaining_mh += noident_mh
        remaining_query.minhash = remaining_mh
    if is_abundance:
        remaining_query.minhash = remaining_query.minhash.inflate(orig_query_mh)
    return remaining_query


def gather(args):
    "Greedy min-set-cov decomposition of a query against databases."
    from .index import LazyLinearIndex
    from .search import GatherDatabases, PrefetchResult, format_bp

    set_quiet(args.quiet, args.debug)
    sel = _Selectors.parse(args)

    query = _load_announced_query(args, sel.moltype)

    if not query.minhash.scaled:
        error("query signature needs to be created with --scaled")
        sys.exit(-1)

    query = _downsample_query_inplace(query, args.scaled)

    if not len(query.minhash):
        error("no query hashes!? exiting.")
        sys.exit(-1)

    databases = sourmash_args.load_dbs_and_sigs(
        args.databases,
        query,
        False,
        cache_size=args.cache_size or None,
        picklist=sel.picklist,
        pattern=sel.pattern,
        fail_on_empty_database=args.fail_on_empty_database,
    )

    if args.linear:
        databases = [LazyLinearIndex(db) for db in databases]

    size_may_be_inaccurate = False
    if args.prefetch:  # on by default
        notify("Starting prefetch sweep across databases.")
        sweep = _PrefetchSweep(query, args.threshold_bp)

        save_prefetch = SaveSignaturesToLocation(args.save_prefetch)
        save_prefetch.open()

        prefetch_csvout_fp = None
        prefetch_csvout_w = None
        if args.save_prefetch_csv:
            prefetch_csvout_fp = FileOutputCSV(args.save_prefetch_csv).open()
            scaled = sweep.query.minhash.scaled

        def per_counter(counter):
            nonlocal prefetch_csvout_w
            save_prefetch.add_many(counter.signatures())
            if prefetch_csvout_fp:
                for found_sig in counter.signatures():
                    prefetch_result = PrefetchResult(
                        sweep.query, found_sig, cmp_scaled=scaled,
                        threshold_bp=args.threshold_bp,
                        estimate_ani_ci=args.estimate_ani_ci,
                    )
                    if prefetch_csvout_w is None:
                        prefetch_csvout_w = \
                            prefetch_result.init_dictwriter(prefetch_csvout_fp)
                    prefetch_result.write(prefetch_csvout_w)
                prefetch_csvout_fp.flush()

        for db in databases:
            sweep.sweep_one(db, sink=per_counter)

        notify(
            f"Prefetch found {len(save_prefetch)} signatures with overlap >= {format_bp(args.threshold_bp)}."
        )
        save_prefetch.close()
        if prefetch_csvout_fp:
            prefetch_csvout_fp.close()

        counters = sweep.counters
        noident_mh = sweep.noident_mh
        ident_mh = sweep.ident_mh

        # at-scale device path (flat-index databases): replay every greedy
        # round on the device instead of one peek/consume round-trip per
        # match; with several databases one schedule spans them all
        # (index/flat.py DeviceGatherSchedule)
        if counters:
            from .index.flat import schedule_device_gather

            schedule_device_gather(counters)
    else:
        counters = databases
        noident_mh = None
        ident_mh = None

    notify("Doing gather to generate minimum metagenome cover.")

    is_abundance = query.minhash.track_abundance and not args.ignore_abundance
    orig_query_mh = query.minhash
    if not orig_query_mh.size_is_accurate():
        size_may_be_inaccurate = True

    gather_iter = GatherDatabases(
        query, counters,
        threshold_bp=args.threshold_bp,
        ignore_abundance=args.ignore_abundance,
        noident_mh=noident_mh, ident_mh=ident_mh,
        estimate_ani_ci=args.estimate_ani_ci,
    )

    csv_buffer = io.StringIO()
    report = _GatherReport(is_abundance, csv_fp=csv_buffer if args.output else None)

    save_sig_obj = save_sig = None
    if args.save_matches:
        notify(f"saving all matches to '{args.save_matches}'")
        save_sig_obj = SaveSignaturesToLocation(args.save_matches)
        save_sig = save_sig_obj.__enter__()

    try:
        for result in gather_iter:
            report.row(result)
            if save_sig is not None:
                save_sig.add(result.match)
            if args.num_results and report.found >= args.num_results:
                break
    finally:
        if save_sig_obj:
            save_sig_obj.close()
            save_sig_obj = None
            save_sig = None

    if gather_iter.query:
        notify(f"found less than {format_bp(args.threshold_bp)} in common. => exiting")

    if report.found:
        print_results(f"\nfound {report.found} matches total;")
        if report.found == args.num_results:
            print_results(
                f"(truncated gather because --num-results={args.num_results})"
            )
        report.coverage_summary()
    else:
        notify(f"\nNo matches found for --threshold-bp at {format_bp(args.threshold_bp)}.")

    print_results("")
    if gather_iter.scaled != query.minhash.scaled:
        print_results(
            f"WARNING: final scaled was {gather_iter.scaled}, vs query scaled of {query.minhash.scaled}"
        )

    if (report.found and args.output) or args.create_empty_results:
        with FileOutputCSV(args.output) as fp:
            fp.write(csv_buffer.getvalue())

    if args.output_unassigned:
        if not (gather_iter.query.minhash or noident_mh):
            notify("no unassigned hashes to save with --output-unassigned!")
        else:
            notify(f"saving unassigned hashes to '{args.output_unassigned}'")
            remaining_query = _assemble_unassigned(
                gather_iter, noident_mh, is_abundance, orig_query_mh,
                downsample_noident=False,
            )
            with SaveSignaturesToLocation(args.output_unassigned) as save_sig:
                save_sig.add(remaining_query)

    sel.report_picklist(args)

    if size_may_be_inaccurate:
        notify(_SIZE_WARN)
