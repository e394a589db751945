"""Top-level commands of the port: `compare`, `plot`, `search`,
`categorize`, `gather`, `multigather`, `prefetch`, `index`, `sbt_combine`,
`migrate`, `import_csv`, `watch` and `info` (the port of
`sourmash_tpu/commands.py`, reference `src/sourmash/commands.py`). `index`
builds an SBT by default and a disk revindex with `-F revindex`.

The command is organized around reusable pipeline stages:

* ``_Selectors`` / ``_load_announced_query`` — shared input selection,
* ``_PrefetchSweep`` — the one-pass-per-database overlap sweep that seeds
  gather with per-database counters plus identified/unidentified hash
  bookkeeping,
* ``_GatherReport`` — incremental console-table + CSV row emission for the
  greedy rounds.

Console strings and CSV schemas are parity surface and match the reference
exactly. At or above the flat-view threshold a database searches and
gathers on the device (`index/flat.py`); multigather counts and schedules
its queries in batches there.
"""

from __future__ import annotations

import csv
import io
import os
import shutil
import sys
from dataclasses import dataclass, field

import numpy

from . import signature as sig
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
# compare
# ===========================================================================


@dataclass
class _ComparePool:
    """Signatures collected for an all-pairs comparison, with provenance and
    the parameter sets observed while loading (used for consistency checks)."""

    sigs: list = field(default_factory=list)  # (signature, source filename)
    ksizes: set = field(default_factory=set)
    moltypes: set = field(default_factory=set)

    def absorb(self, ss, filename):
        self.sigs.append((ss, filename))
        self.ksizes.add(ss.minhash.ksize)
        self.moltypes.add(sourmash_args.get_moltype(ss))

    @property
    def inconsistent(self):
        return len(self.ksizes) > 1 or len(self.moltypes) > 1

    def fail_if_mixed_params(self):
        if len(self.ksizes) > 1:
            error("multiple k-mer sizes loaded; please specify one with -k.")
            error("(saw k-mer sizes {})".format(", ".join(map(str, sorted(self.ksizes)))))
            sys.exit(-1)
        if len(self.moltypes) > 1:
            error("multiple molecule types loaded; please specify --dna, --protein")
            sys.exit(-1)


def _fill_compare_pool(args, sel):
    "Load every input file for `compare` into a _ComparePool."
    inp_files = list(args.signatures)
    if args.from_file:
        inp_files.extend(sourmash_args.load_pathlist_from_file(args.from_file))

    progress = sourmash_args.SignatureLoadingProgress()
    pool = _ComparePool()

    for filename in inp_files:
        notify(f"loading '{filename}'", end="\r")
        loaded = list(
            sourmash_args.load_file_as_signatures(
                filename,
                ksize=args.ksize,
                select_moltype=sel.moltype,
                picklist=sel.picklist,
                yield_all_files=args.force,
                progress=progress,
                pattern=sel.pattern,
            )
        )
        if not loaded:
            notify(
                f"\nwarning: no signatures loaded at given ksize/molecule type/picklist from {filename}"
            )
        for ss in loaded:
            pool.absorb(ss, filename)

        # once inconsistency is guaranteed, further loading is pointless
        if pool.inconsistent:
            break

    if not pool.sigs:
        error("no signatures found! exiting.")
        sys.exit(-1)

    notify(" " * 79, end="\r")
    notify(f"loaded {len(pool.sigs)} signatures total.")
    return pool


def _common_scaled_for(siglist, args):
    "Pick the scaled value every signature will be brought to."
    target = max(s.minhash.scaled for s, _ in siglist)
    if args.scaled:
        args.scaled = int(args.scaled)
        target = max(target, args.scaled)
        if target > args.scaled:
            notify(
                f"WARNING: --scaled specified {args.scaled}, but max scaled of sketches is {target}"
            )
            notify(f"WARNING: continuing with scaled value of {target}.")
    return target


def compare(args):
    "Compare multiple signature files and create a similarity matrix."
    from .compare import (
        compare_all_pairs,
        compare_serial_containment,
        compare_serial_max_containment,
        compare_serial_avg_containment,
    )

    set_quiet(args.quiet)
    sel = _Selectors.parse(args)

    pool = _fill_compare_pool(args, sel)
    pool.fail_if_mixed_params()
    sel.report_picklist(args)
    siglist = pool.sigs

    # signatures must be uniformly scaled or uniformly num
    scaled_vals = [s.minhash.scaled for (s, _) in siglist]
    is_scaled = all(scaled_vals)
    if is_scaled != any(scaled_vals):
        error("ERROR: cannot mix scaled signatures with num signatures")
        sys.exit(-1)

    # comparison-mode flags: at most one containment variant
    cont_flags = [args.containment, args.max_containment, args.avg_containment]
    is_containment = any(cont_flags)
    if sum(cont_flags) > 1:
        notify("ERROR: cannot specify more than one containment argument!")
        sys.exit(-1)
    if is_containment and not is_scaled:
        error(
            "must use scaled signatures with --containment, --max-containment, and --avg-containment"
        )
        sys.exit(-1)

    return_ani = bool(args.estimate_ani)
    if return_ani and not is_scaled:
        error("must use scaled signatures with --estimate-ani")
        sys.exit(-1)

    if (is_containment or return_ani) and any(
        s.minhash.track_abundance for s, _ in siglist
    ):
        notify(
            "NOTE: --containment, --max-containment, --avg-containment, and --estimate-ani ignore signature abundances."
        )

    # harmonize all scaled sketches to one common (max) scaled
    size_may_be_inaccurate = False
    if is_scaled:
        target_scaled = _common_scaled_for(siglist, args)
        printed_scaled_msg = False
        for i, (ss, filename) in enumerate(siglist):
            if not size_may_be_inaccurate and not ss.minhash.size_is_accurate():
                size_may_be_inaccurate = True
            if ss.minhash.scaled != target_scaled:
                if not printed_scaled_msg:
                    notify(f"NOTE: downsampling to scaled value of {target_scaled}")
                    printed_scaled_msg = True
                # sig.update() hands back a fresh frozen signature — rebind
                with ss.update() as ss:
                    ss.minhash = ss.minhash.downsample(scaled=target_scaled)
                siglist[i] = (ss, filename)
    elif args.scaled is not None:
        error("ERROR: cannot specify --scaled with non-scaled signatures.")
        sys.exit(-1)

    if not siglist:
        error("no signatures!")
        sys.exit(-1)
    notify("")
    numpy.set_printoptions(precision=3, suppress=True)

    labeltext = [str(ss) for ss, _ in siglist]
    sigsonly = [ss for ss, _ in siglist]

    # pick the device-batched all-pairs engine for the requested metric
    if args.containment:
        engine = lambda: compare_serial_containment(sigsonly, return_ani=return_ani)  # noqa: E731
    elif args.max_containment:
        engine = lambda: compare_serial_max_containment(sigsonly, return_ani=return_ani)  # noqa: E731
    elif args.avg_containment:
        engine = lambda: compare_serial_avg_containment(sigsonly, return_ani=return_ani)  # noqa: E731
    else:
        engine = lambda: compare_all_pairs(  # noqa: E731
            sigsonly, args.ignore_abundance,
            n_jobs=args.processes, return_ani=return_ani,
        )
    similarity = engine()

    matrix = 1 - similarity if args.distance_matrix else similarity

    if len(siglist) < 30:
        for i, (ss, _) in enumerate(siglist):
            name_num = f"{i}-{str(ss)}"
            if len(name_num) > 20:
                name_num = name_num[:17] + "..."
            print_results("{:20s}\t{}".format(name_num, matrix[i, :]))

    summary_stat = (
        ("max distance in matrix: {:.3f}", numpy.max)
        if args.distance_matrix
        else ("min similarity in matrix: {:.3f}", numpy.min)
    )
    print_results(summary_stat[0], summary_stat[1](matrix))

    _write_compare_outputs(args, matrix, siglist, labeltext)

    if size_may_be_inaccurate:
        kind = "ANI distances" if args.distance_matrix else "ANI values"
        notify(
            f"WARNING: size estimation for at least one of these sketches may be inaccurate. {kind} will be set to 1 for these comparisons."
        )


def _write_compare_outputs(args, matrix, siglist, labeltext):
    "All the optional file outputs of `compare`: .npy matrix, labels, CSVs."
    if args.output:
        labeloutname = args.output + ".labels.txt"
        notify(f"saving labels to: {labeloutname}")
        with open(labeloutname, "w") as fp:
            fp.write("\n".join(labeltext))

        notify(f"saving comparison matrix to: {args.output}")
        with open(args.output, "wb") as matrix_fp:
            numpy.save(matrix_fp, matrix)

    if args.labels_to:
        notify(f"saving labels to: {args.labels_to}")
        with sourmash_args.FileOutputCSV(args.labels_to) as fp:
            w = csv.writer(fp)
            w.writerow(
                ["sort_order", "md5", "label", "name", "filename", "signature_file"]
            )
            for n, (ss, location) in enumerate(siglist):
                w.writerow(
                    [str(n + 1), ss.md5sum(), str(ss), ss.name, ss.filename, location]
                )

    if args.csv:
        with FileOutputCSV(args.csv) as csv_fp:
            w = csv.writer(csv_fp)
            w.writerow(labeltext)
            for row in matrix:
                w.writerow([str(v) for v in row])


def _resolve_plot_labels(args, n_rows):
    """Work out the label list + whether to display labels at all
    (reference commands.py:325-372, sourmash#2790): full labels by default,
    bare indices with --indices, nothing with --no-labels."""
    if args.labeltext or args.labels or args.labels_from:
        if args.labeltext and args.labels_from:
            notify("ERROR: cannot supply both --labeltext and --labels-from")
            sys.exit(-1)
        display = True
        args.labels = True  # override => labels always true
    elif args.labels is None and not args.indices:
        args.labels = True
        display = True
    elif args.indices or (not args.labels and args.indices is None):
        args.indices = True
        display = True
    else:
        display = False

    if args.labels_from:
        notify(f"loading labels from CSV file '{args.labels_from}'")
        with sourmash_args.FileInputCSV(args.labels_from) as r:
            ordered = sorted((int(row["sort_order"]), row["label"]) for row in r)
        labeltext = [label for _, label in ordered]
    elif args.labels:
        labelfilename = args.labeltext or (args.distances + ".labels.txt")
        notify(f"loading labels from text file '{labelfilename}'")
        with open(labelfilename) as f:
            labeltext = [x.strip() for x in f]
        if len(labeltext) != n_rows:
            error("{} labels != matrix size, exiting", len(labeltext))
            sys.exit(-1)
    elif args.indices:
        labeltext = [str(i + 1) for i in range(n_rows)]
    else:
        assert not display
        labeltext = [""] * n_rows

    return labeltext, display


def plot(args):
    "Produce a clustering matrix and plot."
    import matplotlib as mpl

    mpl.use("Agg")
    import pylab
    import scipy.cluster.hierarchy as sch

    from . import fig as sourmash_fig

    D_filename = args.distances

    notify(f"loading comparison matrix from {D_filename}...")
    with open(D_filename, "rb") as f:
        D = numpy.load(f)
    notify(f"...got {D.shape[0]} x {D.shape[1]} matrix.", *D.shape)

    labeltext, display_labels = _resolve_plot_labels(args, D.shape[0])

    # output file naming: <basename>.{dendro,matrix,hist}.{png,pdf}
    ext = ".pdf" if args.pdf else ".png"
    basename = os.path.basename(D_filename)
    outnames = {
        kind: basename + "." + kind + ext for kind in ("dendro", "matrix", "hist")
    }
    if args.output_dir:
        if not os.path.isdir(args.output_dir):
            os.mkdir(args.output_dir)
        outnames = {
            kind: os.path.join(args.output_dir, name)
            for kind, name in outnames.items()
        }

    # histogram of matrix values
    notify(f"saving histogram of matrix values => {outnames['hist']}")
    fig = pylab.figure(figsize=(8, 5))
    pylab.hist(numpy.array(D.flat), bins=100)
    fig.savefig(outnames["hist"])

    # optional random subsample of the rows before clustering
    if args.subsample:
        numpy.random.seed(args.subsample_seed)
        sample_idx = list(range(len(labeltext)))
        numpy.random.shuffle(sample_idx)
        sample_idx = sample_idx[: args.subsample]
        np_idx = numpy.array(sample_idx)
        D = D[numpy.ix_(np_idx, np_idx)]
        labeltext = [labeltext[idx] for idx in sample_idx]

    # dendrogram alone
    fig = pylab.figure(figsize=(8, 5))
    ax1 = fig.add_axes([0.1, 0.1, 0.7, 0.8])
    ax1.set_xticks([])
    ax1.set_yticks([])
    Y = sch.linkage(D, method="single")
    sch.dendrogram(
        Y, orientation="right", labels=labeltext, no_labels=not display_labels
    )
    fig.savefig(outnames["dendro"])
    notify(f"wrote dendrogram to: {outnames['dendro']}")

    # dendrogram + matrix composite
    fig, rlabels, rmat = sourmash_fig.plot_composite_matrix(
        D, labeltext, show_labels=display_labels,
        vmin=args.vmin, vmax=args.vmax, force=args.force,
    )
    fig.savefig(outnames["matrix"])
    notify(f"wrote numpy distance matrix to: {outnames['matrix']}")

    if len(labeltext) < 30:
        # for small matrices, print out sample numbering for FYI.
        for i, name in enumerate(labeltext):
            print_results("{}\t{}", i, name)

    if args.csv:
        with FileOutputCSV(args.csv) as csv_fp:
            w = csv.writer(csv_fp)
            w.writerow(rlabels)
            for row in rmat:
                w.writerow([f"{v}" for v in row])
        notify(f"Wrote clustered matrix and labels out to {args.csv}")


# ===========================================================================
# search & categorize
# ===========================================================================


def search(args):
    "Search a query signature against databases."
    from .search import (
        search_databases_with_flat_query,
        search_databases_with_abund_query,
    )

    set_quiet(args.quiet, args.debug)
    sel = _Selectors.parse(args)

    query = _load_announced_query(args, sel.moltype)

    if args.scaled:
        if not query.minhash.scaled:
            error("cannot downsample a signature not created with --scaled")
            sys.exit(-1)
        query = _downsample_query_inplace(query, args.scaled)

    if args.containment and args.max_containment:
        notify("ERROR: cannot specify both --containment and --max-containment!")
        sys.exit(-1)
    is_containment = args.containment or args.max_containment

    databases = sourmash_args.load_dbs_and_sigs(
        args.databases,
        query,
        not is_containment,
        picklist=sel.picklist,
        pattern=sel.pattern,
        fail_on_empty_database=args.fail_on_empty_database,
    )

    # abundance handling: flatten on request; forbid containment w/ abund
    if not query.minhash.track_abundance:
        args.ignore_abundance = True
    elif args.ignore_abundance:
        with query.update() as query:
            query.minhash = query.minhash.flatten()
    elif is_containment:
        notify(
            "ERROR: cannot do containment searches on an abund signature; maybe specify --ignore-abundance?"
        )
        sys.exit(-1)

    common = dict(
        threshold=args.threshold,
        do_containment=args.containment,
        do_max_containment=args.max_containment,
        best_only=args.best_only,
        unload_data=True,
    )
    if query.minhash.track_abundance:
        try:
            results = search_databases_with_abund_query(query, databases, **common)
        except TypeError as exc:
            error(f"ERROR: {str(exc)}")
            sys.exit(-1)
    else:
        results = search_databases_with_flat_query(
            query, databases, estimate_ani_ci=args.estimate_ani_ci, **common
        )

    n_shown = len(results)
    if args.best_only:
        args.num_results = 1

    if not args.num_results or n_shown <= args.num_results:
        print_results(f"{len(results)} matches above threshold {args.threshold:0.3f}:")
    else:
        print_results(
            f"{len(results)} matches above threshold {args.threshold:0.3f}; showing first {args.num_results}:"
        )
        n_shown = args.num_results

    size_may_be_inaccurate = False
    jaccard_ani_untrustworthy = False

    print_results("similarity   match")
    print_results("----------   -----")
    for sr in results[:n_shown]:
        pct = f"{sr.similarity * 100:.1f}%"
        name = sr.match._display_name(60)
        print_results("{:>6}       {}", pct, name)
        if sr.cmp_scaled is not None:
            size_may_be_inaccurate = size_may_be_inaccurate or sr.size_may_be_inaccurate
            if not is_containment and sr.cmp.jaccard_ani_untrustworthy:
                jaccard_ani_untrustworthy = True

    if args.best_only:
        notify("** reporting only one match because --best-only was set")

    if args.output:
        with FileOutputCSV(args.output) as fp:
            writer = None
            for sr in results:
                if writer is None:
                    writer = sr.init_dictwriter(fp)
                sr.write(writer)

    if args.save_matches:
        notify(f'saving all matched signatures to "{args.save_matches}"')
        with SaveSignaturesToLocation(args.save_matches) as save_sig:
            for sr in results:
                save_sig.add(sr.match)

    sel.report_picklist(args)

    if size_may_be_inaccurate:
        notify(_SIZE_WARN)
    if jaccard_ani_untrustworthy:
        notify("WARNING: Jaccard estimation for at least one of these comparisons"
               " is likely inaccurate. Could not estimate ANI for these comparisons.")


def categorize(args):
    "Use a database to find the best match to many signatures."
    from .index import MultiIndex
    from .search import make_jaccard_search_query

    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)  # from --dna/--protein/...

    # skip any queries already present in --load-csv
    already_names = set()
    if args.load_csv:
        with open(args.load_csv, newline="") as fp:
            already_names.update(row[0] for row in csv.reader(fp))

    db = sourmash_args.load_file_as_index(args.database)
    if args.ksize or moltype:
        db = db.select(ksize=args.ksize, moltype=moltype)

    def queries_with_locations():
        for filename in args.queries:
            mi = MultiIndex.load_from_path(filename, False)
            mi = mi.select(ksize=args.ksize, moltype=moltype)
            yield from mi.signatures_with_location()

    csv_w = csv_fp = None
    if args.csv:
        csv_fp = open(args.csv, "w", newline="")
        csv_w = csv.writer(csv_fp)

    search_obj = make_jaccard_search_query(threshold=args.threshold)
    for orig_query, loc in queries_with_locations():
        if loc in already_names:
            continue

        notify(
            f"loaded query: {str(orig_query)[:30]}... (k={orig_query.minhash.ksize}, {orig_query.minhash.moltype})"
        )

        if orig_query.minhash.track_abundance and not args.ignore_abundance:
            notify(
                "ERROR: this search cannot be done on signatures calculated with abundance."
            )
            notify("ERROR: please specify --ignore-abundance.")
            sys.exit(-1)

        query = _flattened_copy(orig_query) if args.ignore_abundance else orig_query.copy()

        # best match, excluding self-hits by md5
        hits = []
        for sr in db.find(search_obj, query):
            match = sr.signature
            if match.md5sum() != query.md5sum():
                hits.append((orig_query.similarity(match), match))

        if hits:
            hits.sort(key=lambda x: -x[0])
            best_sim, best_match = hits[0]
            notify(f"for {query}, found: {best_sim:.2f} {best_match}")
            if csv_w:
                csv_w.writerow([loc, query, best_match.name, best_sim])
        else:
            notify(f"for {query}, no match found")

    if csv_fp:
        csv_fp.close()


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


# ===========================================================================
# multigather
# ===========================================================================


def _multigather_output_base(query, args, used_output_bases):
    "Per-query output naming for multigather, refusing accidental overwrites."
    query_filename = query.filename
    if not query_filename or query_filename == "-":
        base = query.md5sum()
    elif args.output_add_query_md5sum:
        base = os.path.basename(query_filename) + "." + query.md5sum()
    else:
        base = os.path.basename(query_filename)

    if args.output_dir:
        base = os.path.join(args.output_dir, base)

    if base in used_output_bases:
        error(
            f"ERROR: detected overwritten outputs! '{base}' has already been used. Failing."
        )
        if args.force_allow_overwrite_output:
            error("continuing because --force-allow-overwrite was specified")
        else:
            error(
                "Consider using '-U/--output-add-query-md5sum' to build unique outputs"
            )
            error("and/or '--force-allow-overwrite-output'")
            sys.exit(-1)
    used_output_bases.add(base)
    return base


def _multigather_prepare(all_queries, databases, args):
    """Phase 1 of multigather, silent: build each eligible query's prefetch
    sweep (its counters take the batched warm counts) and compute every
    query's round schedule in batches (`index.flat.converge_schedules_batch`).
    Returns {query index -> _PrefetchSweep}; a query skipped here (no
    scaled, empty after downsampling, a ValueError from its sweep) goes
    through the output loop's own path, so its messages and ordering stay
    as they are. Any other error of the batched phase propagates.

    `sourmash_tpu` skips a query whose sweep raises anything and lets the
    output loop's rerun fail after the earlier queries' outputs are
    written. No input makes the two differ in what they write: the
    SourmashErrors that are not ValueErrors (MismatchSignatureType,
    CannotUpsampleScaled, NeedsAbundanceTracking) are raised nowhere in
    either package, and the one other error a sweep raises from its
    inputs, the TypeError of a negative --threshold-bp, is every query's,
    so both stop before the first query's output
    (`test_multigather_negative_threshold_fails_alike`)."""
    from .index.flat import converge_schedules_batch, schedule_device_gather

    pre = {}
    coords = []
    for qi, query in enumerate(all_queries):
        mh = query.minhash
        if not mh.scaled:
            continue
        if args.scaled and int(args.scaled) != mh.scaled:
            try:
                mh = mh.downsample(scaled=int(args.scaled))
            except ValueError:
                continue
        if not len(mh):
            continue
        q2 = query.to_mutable()
        q2.minhash = mh
        # frozen, as loaded queries are: the sweep's flattened copy of a
        # sample with abundances goes through update(), which a mutable
        # signature lacks (sourmash_tpu leaves such samples to the output loop)
        q2.into_frozen()
        try:
            sweep = _PrefetchSweep(q2, args.threshold_bp)
            for db in databases:
                sweep.sweep_one(db)
        except ValueError:
            continue  # the output loop runs this query again and reports
        pre[qi] = sweep
        if sweep.counters:
            coord = schedule_device_gather(sweep.counters)
            if coord is not None:
                coords.append(coord)
    if coords:
        converge_schedules_batch(coords, args.threshold_bp)
    return pre


def multigather(args):
    """Gather many signatures against multiple databases.

    Per query, writes one `.csv`, one `.matches.sig`, and one
    `.unassigned<ext>` output named after the query filename
    (reference `commands.py:1124-1382`).
    """
    from .search import GatherDatabases, format_bp

    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)

    required = (
        (args.db, "Error! must specify at least one database with --db"),
        (
            args.query or args.query_from_file,
            "Error! must specify at least one query signature with --query",
        ),
    )
    for present, message in required:
        if not present:
            error(message)
            sys.exit(-1)

    args.db = [item for sublist in args.db for item in sublist]
    inp_files = [item for sublist in args.query for item in sublist]
    if args.query_from_file:
        inp_files.extend(sourmash_args.load_pathlist_from_file(args.query_from_file))

    # one representative query pins ksize/moltype for database loading
    first_query = next(
        iter(
            sourmash_args.load_file_as_signatures(
                inp_files[0], ksize=args.ksize, select_moltype=moltype
            )
        )
    )
    _announce_query(first_query, first=True)

    databases = sourmash_args.load_dbs_and_sigs(
        args.db, first_query, False, fail_on_empty_database=args.fail_on_empty_database
    )

    # every query up front, so a flat database counts them in batched passes
    all_queries = []
    for queryfile in inp_files:
        for query in sourmash_args.load_file_as_signatures(
            queryfile, ksize=args.ksize, select_moltype=moltype
        ):
            all_queries.append(query)

    warm_mhs = []
    for query in all_queries:
        mh = query.minhash
        if not mh.scaled:
            continue
        if args.scaled and args.scaled != mh.scaled:
            try:
                # silent twin of the loop's downsample (which notifies);
                # only the cache key needs the downsampled mins
                mh = mh.downsample(scaled=int(args.scaled))
            except ValueError:
                continue
        if len(mh):
            warm_mhs.append(mh.flatten())
    if warm_mhs:
        for db in databases:
            view = db._as_flat_view()  # a FlatIndex returns itself
            if view is not None:
                view.warm_gather_counts(warm_mhs)

    # phase 1 (silent): every query's prefetch sweep and round schedule up
    # front, the schedules computed in batches; the output loop below
    # reuses them, so console and CSV ordering are unchanged
    pre_sweeps = _multigather_prepare(all_queries, databases, args)

    n = 0
    size_may_be_inaccurate = False
    used_output_bases = set()
    for qi, query in enumerate(all_queries):
        _announce_query(query)

        if not query.minhash.scaled:
            error("query signature needs to be created with --scaled; skipping")
            continue

        query = _downsample_query_inplace(query, args.scaled)

        if not len(query.minhash):
            error("no query hashes!? skipping to next..")
            continue

        # per-query prefetch sweep (always on for multigather); phase 1
        # usually built it already, with its round schedule
        sweep = pre_sweeps.pop(qi, None)
        if sweep is None:
            sweep = _PrefetchSweep(query, args.threshold_bp)
            for db in databases:
                sweep.sweep_one(db)

            if sweep.counters:
                from .index.flat import schedule_device_gather

                schedule_device_gather(sweep.counters)

        is_abundance = query.minhash.track_abundance and not args.ignore_abundance
        orig_query_mh = query.minhash
        gather_iter = GatherDatabases(
            query,
            sweep.counters,
            threshold_bp=args.threshold_bp,
            ignore_abundance=args.ignore_abundance,
            noident_mh=sweep.noident_mh,
            ident_mh=sweep.ident_mh,
        )

        output_base = _multigather_output_base(query, args, used_output_bases)

        output_matches = output_base + ".matches.sig"
        save_sig_obj = SaveSignaturesToLocation(output_matches)
        save_sig = save_sig_obj.__enter__()
        notify(f"saving all matching signatures to '{output_matches}'")

        output_csv = output_base + ".csv"
        notify(f'saving all CSV matches to "{output_csv}"')
        csv_out_obj = FileOutputCSV(output_csv)
        csv_outfp = csv_out_obj.__enter__()

        report = _GatherReport(is_abundance, csv_fp=csv_outfp)

        for result in gather_iter:
            report.row(result)
            save_sig.add(result.match)
            if not size_may_be_inaccurate and result.size_may_be_inaccurate:
                size_may_be_inaccurate = True

        if gather_iter.query.minhash:
            notify(
                f"found less than {format_bp(args.threshold_bp)} in common. => exiting"
            )

        print_results("\nfound {} matches total;", report.found)

        save_sig_obj.close()
        save_sig_obj = save_sig = None

        csv_out_obj.close()
        csv_out_obj = csv_outfp = None

        report.coverage_summary()
        print_results("")

        if report.found == 0:
            notify("nothing found... skipping.")
            continue

        # save unassigned (remaining + unidentified) hashes
        output_unassigned = output_base + f".unassigned{args.extension}"
        remaining_query = _assemble_unassigned(
            gather_iter, sweep.noident_mh, is_abundance, orig_query_mh,
            downsample_noident=True,
        )

        if remaining_query:
            notify(f'saving unassigned hashes to "{output_unassigned}"')
        else:
            notify("no unassigned hashes! not saving.")

        with SaveSignaturesToLocation(output_unassigned) as save_sig:
            save_sig.add(remaining_query)

        n += 1

    notify(f"\nconducted gather searches on {n} signatures")
    if size_may_be_inaccurate:
        notify(_SIZE_WARN)


# ===========================================================================
# prefetch
# ===========================================================================


class _RatchetedPartition:
    """prefetch's matched/unmatched hash split, under a scaled value that
    ratchets up to the max of query + every match seen so far."""

    def __init__(self, query_mh):
        self.scaled = query_mh.scaled
        self.ident_mh = query_mh.copy_and_clear()
        self.noident_mh = query_mh.to_mutable()

    def absorb_match(self, query, match):
        "Fold one matching signature in; returns the (ratcheted) scaled."
        self.scaled = max(match.minhash.scaled, query.minhash.scaled, self.scaled)

        query_mh = query.minhash.downsample(scaled=self.scaled)
        match_mh = match.minhash.downsample(scaled=self.scaled)

        if self.ident_mh.scaled != self.scaled:
            self.ident_mh = self.ident_mh.downsample(scaled=self.scaled)
        if self.noident_mh.scaled != self.scaled:
            self.noident_mh = self.noident_mh.downsample(scaled=self.scaled)

        self.ident_mh += query_mh & match_mh.flatten()
        self.noident_mh.remove_many(match_mh)
        return query_mh


def prefetch(args):
    "Output the raw results of a containment/overlap search."
    from .index import LazyLinearIndex
    from .search import prefetch_database

    if args.db_from_file:
        args.databases.extend(sourmash_args.load_pathlist_from_file(args.db_from_file))

    if not args.databases:
        notify("ERROR: no databases or signatures to search!?")
        sys.exit(-1)

    any_output = (args.save_unmatched_hashes or args.save_matching_hashes
                  or args.save_matches or args.output)
    if not any_output:
        notify(
            "WARNING: no output(s) specified! Nothing will be saved from this prefetch!"
        )

    sel = _Selectors.parse(args)

    query = _load_announced_query(args, sel.moltype)

    if not query.minhash.scaled:
        error("query signature needs to be created with --scaled")
        sys.exit(-1)

    # flatten + optionally downsample the working query sketch
    orig_query_mh = query.minhash
    query_mh = orig_query_mh.flatten() if orig_query_mh.track_abundance else orig_query_mh

    if args.scaled and args.scaled != query_mh.scaled:
        notify(f"downsampling query from scaled={query_mh.scaled}"
               f" to {int(args.scaled)}")
        query_mh = query_mh.downsample(scaled=args.scaled)

    notify(f"query sketch has scaled={query_mh.scaled};"
           " will be dynamically downsampled as needed.")

    if not len(query_mh):
        error("no query hashes!? exiting.")
        sys.exit(-1)

    with query.update() as query:
        query.minhash = query_mh
    ksize = query_mh.ksize

    csvout_w = None
    csvout_fp = FileOutputCSV(args.output).open() if args.output else None

    matches_out = SaveSignaturesToLocation(args.save_matches)
    matches_out.open()
    if args.save_matches:
        notify(f"saving all matching database signatures to '{args.save_matches}'")

    part = _RatchetedPartition(query_mh)

    did_a_search = size_may_be_inaccurate = False
    total_signatures_loaded = sum_signatures_after_select = 0
    for dbfilename in args.databases:
        notify(f"loading signatures from '{dbfilename}'", end="\r")

        db = sourmash_args.load_file_as_index(dbfilename)
        total_signatures_loaded += len(db)

        if args.linear:
            db = LazyLinearIndex(db)

        db = db.select(ksize=ksize, moltype=sel.moltype, containment=True)
        sum_signatures_after_select += len(db)

        db = sourmash_args.apply_picklist_and_pattern(db, sel.picklist, sel.pattern)

        if not db:
            notify(f"...no compatible signatures in '{dbfilename}'; skipping")
            continue

        hits = prefetch_database(query, db, args.threshold_bp,
                                 estimate_ani_ci=args.estimate_ani_ci)
        for result in hits:
            match = result.match
            query_mh = part.absorb_match(query, match)

            if csvout_fp:
                if csvout_w is None:
                    csvout_w = result.init_dictwriter(csvout_fp)
                result.write(csvout_w)

            matches_out.add(match)
            if matches_out.count % 10 == 0:
                notify(f"total of {matches_out.count} matching signatures so far.",
                       end="\r")

            if not size_may_be_inaccurate and result.size_may_be_inaccurate:
                size_may_be_inaccurate = True

        did_a_search = True
        if csvout_fp:
            csvout_fp.flush()
        del db

    notify("--")
    loaded_line = (
        f"loaded {total_signatures_loaded} total signatures"
        f" from {len(args.databases)} locations."
    )
    notify(loaded_line)
    notify(f"after selecting signatures compatible with search,"
           f" {sum_signatures_after_select} remain.")

    if not did_a_search:
        notify("ERROR in prefetch: after picklists and patterns,"
               " no signatures to search!?")
        sys.exit(-1)

    notify("--")
    notify(f"total of {matches_out.count} matching signatures.")
    matches_out.close()

    if csvout_fp:
        notify(f"saved {matches_out.count} matches to CSV file '{args.output}'")
        csvout_fp.close()

    ident_mh, noident_mh = part.ident_mh, part.noident_mh
    assert len(query_mh) == len(ident_mh) + len(noident_mh)
    notify(
        f"of {len(query_mh)} distinct query hashes, {len(ident_mh)} were found in matches above threshold."
    )
    notify(f"a total of {len(noident_mh)} query hashes remain unmatched.")
    notify(f"final scaled value (max across query and all matches) is {part.scaled}")

    def _save_hash_subset(filename, subset_mh, suffix):
        "Write a matched/unmatched hash subset as a standalone signature."
        sig_name = f"{query.name}-{suffix}" if query.name else ""
        if orig_query_mh.track_abundance:
            subset_mh = subset_mh.inflate(orig_query_mh)
        ss = sig.SourmashSignature(subset_mh, name=sig_name)
        with SaveSignaturesToLocation(filename) as save_sig:
            save_sig.add(ss)

    if args.save_matching_hashes:
        notify(
            f"saving {len(ident_mh)} matched hashes to '{args.save_matching_hashes}'"
        )
        _save_hash_subset(args.save_matching_hashes, ident_mh, "known")

    if args.save_unmatched_hashes:
        notify(
            f"saving {len(noident_mh)} unmatched hashes to '{args.save_unmatched_hashes}'"
        )
        _save_hash_subset(args.save_unmatched_hashes, noident_mh, "unknown")

    sel.report_picklist(args)

    if size_may_be_inaccurate:
        notify(_SIZE_WARN)

    return 0


class _SketchParamTracker:
    "Accumulates sketch params seen during an SBT build; fails on mixtures."

    def __init__(self):
        self.ksizes = set()
        self.moltypes = set()
        self.nums = set()
        self.scaleds = set()

    def note_pre(self, ss):
        self.ksizes.add(ss.minhash.ksize)
        self.moltypes.add(sourmash_args.get_moltype(ss))
        self.nums.add(ss.minhash.num)

    def note_post(self, ss):
        self.scaleds.add(ss.minhash.scaled)

    def fail_if_mixed(self):
        if len(self.ksizes) > 1 or len(self.moltypes) > 1:
            error("multiple k-mer sizes or molecule types present; fail.")
            error("specify --dna/--protein and --ksize as necessary")
            error(
                "ksizes: {}; moltypes: {}",
                ", ".join(map(str, self.ksizes)),
                ", ".join(self.moltypes),
            )
            sys.exit(-1)

        all_num = self.scaleds == {0} and len(self.nums) == 1
        all_scaled = self.nums == {0} and len(self.scaleds) == 1
        if not (all_num or all_scaled):
            error("trying to build an SBT with incompatible signatures.")
            error("nums = {}; scaleds = {}", repr(self.nums), repr(self.scaleds))
            sys.exit(-1)


def _index_revindex(args):
    """Build a revindex directory (`sourmash index -F revindex`): the flat
    index's on-disk form, packed bucketed planes + sigs.zip, which `gather`
    and `search` load onto the device (`index/revindex.py`). The scaling
    analog of the reference's branchwater RocksDB revindex
    (`disk_revindex.rs:240-274`)."""
    from .index.flat import FlatIndex
    from .index.revindex import save_revindex

    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)
    picklist = sourmash_args.load_picklist(args)

    inp_files = list(args.signatures)
    if args.from_file:
        inp_files.extend(sourmash_args.load_pathlist_from_file(args.from_file))

    if not inp_files:
        error("ERROR: no files to index!? Supply on command line or use --from-file")
        sys.exit(-1)

    notify(f"loading {len(inp_files)} files into revindex")

    progress = sourmash_args.SignatureLoadingProgress()
    sigs = []
    for f in inp_files:
        for ss in sourmash_args.load_file_as_signatures(
            f,
            ksize=args.ksize,
            select_moltype=moltype,
            yield_all_files=args.force,
            picklist=picklist,
            progress=progress,
        ):
            with ss.update() as ss:
                if args.scaled:
                    ss.minhash = ss.minhash.downsample(scaled=int(args.scaled))
                if ss.minhash.track_abundance:
                    ss.minhash = ss.minhash.flatten()
            if not ss.minhash.scaled:
                error("ERROR: can only build revindexes from scaled signatures.")
                sys.exit(-1)
            sigs.append(ss)

    notify("")
    if not sigs:
        error("no signatures found to load into tree!? failing.")
        sys.exit(-1)

    if picklist:
        sourmash_args.report_picklist(args, picklist)

    notify(f'loaded {len(sigs)} sigs; saving revindex under "{args.sbt_name}"')
    save_revindex(FlatIndex(sigs), args.sbt_name)


def index(args):
    "Build a Sequence Bloom Tree (or, with `-F revindex`, a revindex) of the given signatures."
    from .sbtmh import load_sbt_index, create_sbt_index

    if args.index_type == "revindex":
        return _index_revindex(args)

    set_quiet(args.quiet)
    moltype = sourmash_args.calculate_moltype(args)
    picklist = sourmash_args.load_picklist(args)

    tree = (
        load_sbt_index(args.sbt_name)
        if args.append
        else create_sbt_index(args.bf_size, n_children=args.n_children)
    )

    if not 0.0 <= args.sparseness <= 1.0:
        error("sparseness must be in range [0.0, 1.0].")

    if args.scaled:
        args.scaled = int(args.scaled)
        notify(f"downsampling signatures to scaled={args.scaled}")

    inp_files = list(args.signatures)
    if args.from_file:
        inp_files.extend(sourmash_args.load_pathlist_from_file(args.from_file))

    if not inp_files:
        error("ERROR: no files to index!? Supply on command line or use --from-file")
        sys.exit(-1)

    notify(f"loading {len(inp_files)} files into SBT")

    progress = sourmash_args.SignatureLoadingProgress()
    tracker = _SketchParamTracker()

    n = 0
    load_opts = dict(
        ksize=args.ksize,
        select_moltype=moltype,
        yield_all_files=args.force,
        picklist=picklist,
        progress=progress,
    )
    for f in inp_files:
        siglist = sourmash_args.load_file_as_signatures(f, **load_opts)

        ss = None
        for ss in siglist:
            tracker.note_pre(ss)

            with ss.update() as ss:
                if args.scaled:
                    ss.minhash = ss.minhash.downsample(scaled=args.scaled)
                if ss.minhash.track_abundance:
                    ss.minhash = ss.minhash.flatten()

            tracker.note_post(ss)

            tree.insert(ss)
            n += 1

        if not ss:
            continue

        tracker.fail_if_mixed()

    notify("")

    if not n:
        error("no signatures found to load into tree!? failing.")
        sys.exit(-1)
    if picklist:
        sourmash_args.report_picklist(args, picklist)

    notify(f'loaded {n} sigs; saving SBT under "{args.sbt_name}"')
    tree.save(args.sbt_name, sparseness=args.sparseness)
    if tree.storage:
        tree.storage.close()


def sbt_combine(args):
    "Combine multiple SBTs into one."
    from .sbtmh import load_sbt_index

    inp_files = list(args.sbts)
    notify(f"combining {len(inp_files)} SBTs")

    tree = load_sbt_index(inp_files.pop(0))
    for f in inp_files:
        tree.combine(load_sbt_index(f))

    notify(f'saving SBT under "{args.sbt_name}".')
    tree.save(args.sbt_name)


def migrate(args):
    "Migrate an SBT database to the latest version."
    from .sbtmh import load_sbt_index

    tree = load_sbt_index(args.sbt_name, print_version_warning=False)

    notify(f'saving SBT under "{args.sbt_name}".')
    tree.save(args.sbt_name, structure_only=True)


# ===========================================================================
# odds and ends: import_csv, watch, info
# ===========================================================================


def import_csv(args):
    "Import a mash CSV file full of signatures/hashes."
    from .minhash import MinHash

    set_quiet(args.quiet)

    with open(args.mash_csvfile, newline="") as fp:
        siglist = []
        for row in csv.reader(fp):
            hashfn = row[0]
            hashseed = int(row[1])

            assert hashfn == "murmur64"
            assert hashseed == 42

            _, _, ksize, name, hashes = row
            mins = [int(h) for h in hashes.strip().split(" ")]

            e = MinHash(len(mins), int(ksize))
            e.add_many(mins)
            s = sig.SourmashSignature(e, filename=name)
            siglist.append(s)
            notify(f"loaded signature: {name} {s.md5sum()[:8]}")

        notify(f"saving {len(siglist)} signatures to JSON")
        with SaveSignaturesToLocation(args.output) as save_sig:
            save_sig.add_many(siglist)


# watch's moltype flag resolution: (moltype name, is_protein, dayhoff, hp)
_WATCH_MOLTYPES = {
    "dna": ("DNA", False, False, False),
    "protein": ("protein", True, False, False),
    "dayhoff": ("dayhoff", True, True, False),
    "hp": ("hp", True, False, True),
}


def watch(args):
    "Build a signature from raw FASTA/FASTQ on stdin; search an SBT."
    from .minhash import MinHash
    from .sbtmh import load_sbt_index
    from .sequence_io import iter_records

    set_quiet(args.quiet)

    if args.input_is_protein and args.dna:
        notify("WARNING: input is protein, turning off nucleotide hashing.")
        args.dna = False
        args.protein = True

    if args.dna and args.protein:
        notify('ERROR: cannot use "watch" with both nucleotide and protein.')

    for flag in ("dna", "protein", "dayhoff", "hp"):
        if getattr(args, flag, False):
            moltype, is_protein, dayhoff, hp = _WATCH_MOLTYPES[flag]
            break
    else:
        moltype, is_protein, dayhoff, hp = _WATCH_MOLTYPES["hp"]

    tree = load_sbt_index(args.sbt_name)

    ksize = args.ksize
    if ksize is None:
        # pick up the tree's ksize from any leaf
        leaf = next(iter(tree.leaves()))
        ksize = leaf.data.minhash.ksize

    notify(f"Computing signature for k={ksize}, {moltype} from stdin")

    clf = _StreamClassifier(
        tree,
        MinHash(
            ksize=ksize, n=args.num_hashes, is_protein=is_protein,
            dayhoff=dayhoff, hp=hp,
        ),
        name=args.name,
        threshold=args.threshold,
        add=(
            (lambda mh, s: mh.add_protein(s))
            if args.input_is_protein
            else (lambda mh, s: mh.add_sequence(s, False))
        ),
    )

    notify("reading sequences from stdin")
    n_read = clf.feed(iter_records(args.inp_file), check_every=WATERMARK_SIZE)

    hits = clf.matches()
    if hits:
        similarity, found_sig = max(hits, key=lambda x: x[0])
        print_results("FOUND: {}, at {:.3f}", found_sig, similarity)
    else:
        notify(f"... read {n_read} sequences, no matches found.")

    if args.output:
        notify(f"saving signature to '{args.output}'")
        with SaveSignaturesToLocation(args.output) as save_sig:
            save_sig.add(clf.signature())


class _StreamClassifier:
    """Incremental classify-against-SBT state for `watch`: accumulate
    records into a growing MinHash, re-search the tree every
    `check_every` records, stop at the first hit (reference semantics,
    `src/sourmash/commands.py:1389-1483`)."""

    def __init__(self, tree, mh, *, name, threshold, add):
        self.tree = tree
        self.mh = mh
        self.name = name
        self.threshold = threshold
        self._add = add

    def signature(self):
        return sig.SourmashSignature(self.mh, filename="stdin", name=self.name)

    def matches(self):
        "(similarity, match) pairs for the current accumulated sketch."
        found = self.tree.search(
            self.signature(),
            threshold=self.threshold,
            best_only=True,
            ignore_abundance=True,
            do_containment=False,
        )
        return [(similarity, match) for similarity, match, _ in found]

    def feed(self, records, *, check_every):
        "Consume records until a periodic check hits; return records read."
        n = 0
        next_check = check_every
        for n, record in enumerate(records):
            if n >= next_check:
                notify(f"\r... read {n} sequences", end="")
                next_check += check_every
                if self.matches():
                    break
            self._add(self.mh, record.sequence)
        return n


def _torch_devices():
    "The visible CUDA cards by name, or that there is none."
    import torch

    if not torch.cuda.is_available():
        return "none (no CUDA device)"
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


def info(args):
    "Report version and environment information."
    from . import VERSION

    notify(f"sourmash version {VERSION}")
    notify("- loaded from path: {}".format(os.path.dirname(__file__)))
    notify("")

    if args.verbose:
        # reference cli/info.py:27-33 reports dependency versions; khmer is
        # not a dependency here (internal Nodegraph), and neither is screed:
        # sequence files are read by the port's own sequence_io.
        notify("khmer version: None (internal Nodegraph)")
        notify("")
        notify("screed version: None (internal sequence_io)")

        import torch

        notify(f"torch version {torch.__version__}")
        notify(f"torch devices: {_torch_devices()}")

        from .plugins import list_all_plugins

        list_all_plugins()
