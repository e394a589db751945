"""'sourmash tax' subcommands: taxonomic integration on gather CSVs (the
port's copy of `sourmash_tpu/tax/__main__.py`).

`metagenome` and `genome` share one input pipeline — output-format
validation, taxonomy loading, gather-CSV collection — factored into the
``_load_*``/``_require_*`` helpers below; their per-format emission is
table-driven over small writer functions.

Behavior parity: reference `src/sourmash/tax/__main__.py` (metagenome:73,
genome:257, annotate:419, prepare:533, grep:561, summarize:617), including
output formats csv_summary/krona/lineage_summary/human/kreport/lingroup/
bioboxes/lineage_csv.
"""

from __future__ import annotations

import csv
import os
import re
import sys
from collections import defaultdict, Counter

from ..sourmash_args import FileOutputCSV, FileInputCSV, FileOutput
from ..logging import set_quiet, error, notify, print_results

from . import tax_utils
from .tax_utils import (
    MultiLineageDB,
    RankLineageInfo,
    LINLineageInfo,
    ICTVRankLineageInfo,
    AnnotateTaxResult,
)

# filename suffix per output format
_output_type_to_ext = dict(
    csv_summary=".summarized.csv",
    classification=".classifications.csv",
    krona=".krona.tsv",
    lineage_summary=".lineage_summary.tsv",
    annotate=".with-lineages.csv",
    human=".human.txt",
    lineage_csv=".lineage.csv",
    kreport=".kreport.txt",
    lingroup=".lingroup.tsv",
    bioboxes=".bioboxes.profile",
)


def make_outfile(base, output_type, *, output_dir=""):
    "Output path for one output type; '-' means stdout (+ float limiting)."
    if base == "-":
        return base, True

    fname = base + _output_type_to_ext[output_type]
    if output_dir:
        fname = os.path.join(output_dir, fname)
    notify(f"saving '{output_type}' output to '{fname}'.")
    return fname, False


def _die(exc):
    error(f"ERROR: {str(exc)}")
    sys.exit(-1)


# ---------------------------------------------------------------------------
# the shared metagenome/genome input pipeline
# ---------------------------------------------------------------------------


def _validated_formats(args, **check_kwargs):
    "Check gather-CSV presence, --rank, and the requested output formats."
    from ..cli.utils import check_tax_outputs, check_rank

    try:
        if not args.gather_csv and not args.from_file:
            raise ValueError(
                "No gather CSVs found! Please input via '-g' or '--from-file'."
            )
        if args.rank:
            args.rank = check_rank(args)
        return check_tax_outputs(args, **check_kwargs)
    except ValueError as exc:
        _die(exc)


def _load_taxonomy(args, *, paths=None, lins=False, ictv=False):
    "Load the taxonomy database(s), failing with the standard messages."
    paths = paths if paths is not None else args.taxonomy_csv
    try:
        tax_assign = MultiLineageDB.load(
            paths,
            keep_full_identifiers=args.keep_full_identifiers,
            keep_identifier_versions=args.keep_identifier_versions,
            force=args.force,
            lins=lins,
            ictv=ictv,
        )
    except ValueError as exc:
        _die(exc)

    if not tax_assign:
        error(
            f'ERROR: No taxonomic assignments loaded from {",".join(args.taxonomy_csv)}. Exiting.'
        )
        sys.exit(-1)
    return tax_assign


def _require_rank_available(args, available_ranks, action):
    if args.rank and args.rank not in available_ranks:
        error(
            f"ERROR: No taxonomic information provided for rank {args.rank}: cannot {action} at this rank"
        )
        sys.exit(-1)


def _load_gather_results(args, tax_assign, *, empty_msg):
    "Collect + parse every gather CSV against the taxonomy."
    gather_csvs = tax_utils.collect_gather_csvs(args.gather_csv,
                                                from_file=args.from_file)
    load_opts = dict(
        force=args.force,
        fail_on_missing_taxonomy=args.fail_on_missing_taxonomy,
        keep_full_identifiers=args.keep_full_identifiers,
        keep_identifier_versions=args.keep_identifier_versions,
        lins=args.lins,
        ictv=args.ictv,
    )
    try:
        query_gather_results = tax_utils.check_and_load_gather_csvs(
            gather_csvs, tax_assign, **load_opts
        )
    except ValueError as exc:
        _die(exc)

    if not query_gather_results:
        notify(empty_msg)
        sys.exit(-1)
    return query_gather_results


def _read_lingroups_or_die(path):
    try:
        return tax_utils.read_lingroups(path)
    except ValueError as exc:
        _die(exc)


# ---------------------------------------------------------------------------
# metagenome + its per-format writers
# ---------------------------------------------------------------------------

_SINGLE_QUERY_FORMATS = ["kreport", "lingroup", "bioboxes"]


def _drop_single_query_formats(args, query_gather_results):
    "Multi-query runs cannot emit the single-query-only formats."
    if len(query_gather_results) <= 1:
        return
    dropped = [x for x in args.output_format if x in _SINGLE_QUERY_FORMATS]
    if dropped:
        notify(
            f"WARNING: found results for multiple gather queries. Can only output multi-query result formats: skipping {', '.join(dropped)}"
        )
    args.output_format = [
        x for x in args.output_format if x not in _SINGLE_QUERY_FORMATS
    ]
    if not args.output_format:
        error("ERROR: No output formats remaining.")
        sys.exit(-1)


def _mg_lineage_summary(args, results, lingroups):
    outfile, _ = make_outfile(
        args.output_base, "lineage_summary", output_dir=args.output_dir
    )
    lineageD, query_names = tax_utils.aggregate_by_lineage_at_rank(
        query_gather_results=results, rank=args.rank, by_query=True
    )
    with FileOutputCSV(outfile) as out_fp:
        tax_utils.write_lineage_sample_frac(query_names, lineageD, out_fp, sep="\t")


def _mg_krona(args, results, lingroups):
    krona_results, header = tax_utils.format_for_krona(results, rank=args.rank)
    outfile, _ = make_outfile(args.output_base, "krona", output_dir=args.output_dir)
    with FileOutputCSV(outfile) as out_fp:
        tax_utils.write_krona(header, krona_results, out_fp)


def _mg_human(args, results, lingroups):
    outfile, _ = make_outfile(args.output_base, "human", output_dir=args.output_dir)
    with FileOutput(outfile) as out_fp:
        display_rank = args.rank or "species"
        if args.lins and not args.rank:
            display_rank = results[0].ranks[-1]
        tax_utils.write_human_summary(results, out_fp, display_rank)


def _mg_csv_summary(args, results, lingroups):
    outfile, limit_float = make_outfile(
        args.output_base, "csv_summary", output_dir=args.output_dir
    )
    with FileOutputCSV(outfile) as out_fp:
        tax_utils.write_summary(
            results, out_fp, limit_float_decimals=limit_float, lingroups=lingroups
        )


def _mg_kreport(args, results, lingroups):
    outfile, _ = make_outfile(args.output_base, "kreport", output_dir=args.output_dir)
    with FileOutputCSV(outfile) as out_fp:
        header, kreport_results = results[0].make_kreport_results()
        tax_utils.write_output(
            header, kreport_results, out_fp, sep="\t", write_header=False
        )


def _mg_lingroup(args, results, lingroups):
    if lingroups is None:
        return
    outfile, _ = make_outfile(args.output_base, "lingroup", output_dir=args.output_dir)
    with FileOutputCSV(outfile) as out_fp:
        header, lgreport_results = results[0].make_lingroup_results(
            LINgroupsD=lingroups
        )
        tax_utils.write_output(
            header, lgreport_results, out_fp, sep="\t", write_header=True
        )


def _mg_bioboxes(args, results, lingroups):
    outfile, _ = make_outfile(args.output_base, "bioboxes", output_dir=args.output_dir)
    with FileOutputCSV(outfile) as out_fp:
        header_lines, bb_results = results[0].make_cami_bioboxes()
        tax_utils.write_bioboxes(header_lines, bb_results, out_fp, sep="\t")


# emission order is part of the console-output parity surface
_METAGENOME_WRITERS = [
    ("lineage_summary", _mg_lineage_summary),
    ("krona", _mg_krona),
    ("human", _mg_human),
    ("csv_summary", _mg_csv_summary),
    ("kreport", _mg_kreport),
    ("lingroup", _mg_lingroup),
    ("bioboxes", _mg_bioboxes),
]


def metagenome(args):
    "Summarize taxonomic information for metagenome gather results."
    set_quiet(args.quiet)
    args.output_format = _validated_formats(
        args,
        rank_required=["krona", "lineage_summary"],
        incompatible_with_lins=["bioboxes", "kreport"],
        use_lingroup_format=True,
    )

    tax_assign = _load_taxonomy(args, lins=args.lins, ictv=args.ictv)
    _require_rank_available(args, tax_assign.available_ranks, "summarize")

    query_gather_results = _load_gather_results(
        args, tax_assign, empty_msg="No gather results loaded. Exiting."
    )

    _drop_single_query_formats(args, query_gather_results)

    for queryResult in query_gather_results:
        try:
            queryResult.build_summarized_result()
        except ValueError as exc:
            _die(exc)

    lingroups = None
    if args.lingroup is not None:
        lingroups = _read_lingroups_or_die(args.lingroup)

    for fmt, write_fmt in _METAGENOME_WRITERS:
        if fmt in args.output_format:
            write_fmt(args, query_gather_results, lingroups)


# ---------------------------------------------------------------------------
# genome + its per-format writers
# ---------------------------------------------------------------------------


def _cls_csv_summary(args, classified, all_results):
    outfile, limit_float = make_outfile(
        args.output_base, "classification", output_dir=args.output_dir
    )
    with FileOutputCSV(outfile) as out_fp:
        tax_utils.write_summary(
            classified, out_fp, limit_float_decimals=limit_float, classification=True
        )


def _cls_human(args, classified, all_results):
    outfile, _ = make_outfile(args.output_base, "human", output_dir=args.output_dir)
    with FileOutput(outfile) as out_fp:
        tax_utils.write_human_summary(
            all_results, out_fp, args.rank or "species", classification=True
        )


def _cls_krona(args, classified, all_results):
    krona_results, header = tax_utils.format_for_krona(
        query_gather_results=all_results, rank=args.rank, classification=True
    )
    outfile, _ = make_outfile(args.output_base, "krona", output_dir=args.output_dir)
    with FileOutputCSV(outfile) as out_fp:
        tax_utils.write_krona(header, krona_results, out_fp)


def _cls_lineage_csv(args, classified, all_results):
    outfile, _ = make_outfile(
        args.output_base, "lineage_csv", output_dir=args.output_dir
    )
    lineage_results = []
    header = None
    for q_res in all_results:
        if not header:
            ranks = list(q_res.ranks)
            if "strain" in ranks:
                ranks.remove("strain")
            header = ["ident", *ranks]
        lineageD = q_res.classification_result.as_lineage_dict(q_res.query_info, ranks)
        lineage_results.append(lineageD)
    with FileOutputCSV(outfile) as out_fp:
        tax_utils.write_output(header, lineage_results, out_fp)


_GENOME_WRITERS = [
    ("csv_summary", _cls_csv_summary),
    ("human", _cls_human),
    ("krona", _cls_krona),
    ("lineage_csv", _cls_lineage_csv),
]


def genome(args):
    "Taxonomic classification of genomes from gather results."
    set_quiet(args.quiet)
    args.output_format = _validated_formats(args, rank_required=["krona"])

    try:
        tax_assign = _load_taxonomy(args, lins=args.lins, ictv=args.ictv)

        lg_ranks = None
        all_lgs = None
        if args.lingroup:
            lingroups = tax_utils.read_lingroups(args.lingroup)
            lg_ranks, all_lgs = tax_utils.parse_lingroups(lingroups)
    except ValueError as exc:
        _die(exc)

    _require_rank_available(args, tax_assign.available_ranks, "classify")

    query_gather_results = _load_gather_results(
        args, tax_assign, empty_msg="No results for classification. Exiting."
    )

    n_total = len(query_gather_results)
    classify_opts = dict(
        rank=args.rank,
        ani_threshold=args.ani_threshold,
        containment_threshold=args.containment_threshold,
        lingroup_ranks=lg_ranks,
        lingroups=all_lgs,
    )
    classified_results = []
    found_error = False
    for queryResult in query_gather_results:
        try:
            queryResult.build_classification_result(**classify_opts)
            classified_results.append(queryResult)
        except ValueError as exc:
            found_error = True
            notify(f"ERROR: {str(exc)}")

    n_classified = len(classified_results)
    if n_classified == 0:
        notify("No queries could be classified. Exiting.")
        sys.exit(-1)

    classif_perc = (float(n_classified) / float(n_total)) * 100
    notify(
        f"classified {n_classified}/{n_total} queries ({classif_perc :.2f}%). Writing results"
    )

    for fmt, write_fmt in _GENOME_WRITERS:
        if fmt in args.output_format:
            write_fmt(args, classified_results, query_gather_results)

    if found_error and not args.force:
        sys.exit(-1)


# ---------------------------------------------------------------------------
# annotate
# ---------------------------------------------------------------------------

_ANNOTATE_ID_COLUMNS = ["name", "match_name", "ident", "accession"]


def _annotated_rows(reader, id_col, tax_assign, args):
    "Yield (annotated row dict, missed?) for each input CSV row."
    ident_opts = dict(
        lins=args.lins,
        ictv=args.ictv,
        keep_full_identifiers=args.keep_full_identifiers,
        keep_identifier_versions=args.keep_identifier_versions,
    )
    for row in reader:
        taxres = AnnotateTaxResult(raw=row, id_col=id_col, **ident_opts)
        taxres.get_match_lineage(
            tax_assignments=tax_assign,
            fail_on_missing_taxonomy=args.fail_on_missing_taxonomy,
        )
        yield taxres.row_with_lineages(), taxres.missed_ident


def _annotate_one_csv(in_csv, tax_assign, args):
    "Add a 'lineage' column to one CSV, matching idents against the taxonomy."
    with FileInputCSV(in_csv) as r:
        header = r.fieldnames
        if not header:
            raise ValueError(f"Cannot read from '{in_csv}'. Is file empty?")

        id_col = next((c for c in _ANNOTATE_ID_COLUMNS if c in header), None)
        if not id_col:
            raise ValueError(
                f"Cannot find taxonomic identifier column in '{in_csv}'. Tried: {', '.join(_ANNOTATE_ID_COLUMNS)}"
            )

        notify(f"Starting annotation on '{in_csv}'. Using ID column: '{id_col}'")

        out_base = os.path.basename(in_csv.rsplit(".csv")[0])
        this_outfile, _ = make_outfile(out_base, "annotate", output_dir=args.output_dir)

        with FileOutputCSV(this_outfile) as out_fp:
            w = csv.DictWriter(out_fp, header + ["lineage"])
            w.writeheader()

            total = 0
            n_missed = 0
            for out_row, missed in _annotated_rows(r, id_col, tax_assign, args):
                total += 1
                n_missed += bool(missed)
                w.writerow(out_row)

            # a body-less CSV counts as 1 row (enumerate-default parity
            # with the reference's n+1 accounting)
            total = total or 1
            rows_annotated = total - n_missed
            if not rows_annotated:
                raise ValueError(f"Could not annotate any rows from '{in_csv}'.")
            notify(f"Annotated {rows_annotated} of {total} total rows from '{in_csv}'.")


def annotate(args):
    "Annotate CSVs with a taxonomic lineage column."
    set_quiet(args.quiet)

    if not args.gather_csv and not args.from_file:
        raise ValueError(
            "No gather CSVs found! Please input via '-g' or '--from-file'."
        )

    tax_assign = _load_taxonomy(args, lins=args.lins, ictv=args.ictv)

    input_csvs = tax_utils.collect_gather_csvs(
        args.gather_csv, from_file=args.from_file
    )

    for in_csv in input_csvs:
        try:
            _annotate_one_csv(in_csv, tax_assign, args)
        except ValueError as exc:
            if args.force:
                notify(str(exc))
                notify("--force is set. Attempting to continue to next file.")
            else:
                _die(exc)


# ---------------------------------------------------------------------------
# taxonomy-database maintenance: prepare, grep, summarize
# ---------------------------------------------------------------------------


def _load_taxonomy_files(args, paths, **kwargs):
    "Taxonomy loading with the 'ERROR while loading taxonomies!' wrapper."
    notify("loading taxonomies...")
    try:
        tax_assign = MultiLineageDB.load(paths, force=args.force, **kwargs)
    except ValueError as exc:
        error("ERROR while loading taxonomies!")
        error(str(exc))
        sys.exit(-1)
    notify(f"...loaded {len(tax_assign)} entries.")
    return tax_assign


def prepare(args):
    "Combine taxonomy databases and/or translate formats."
    tax_assign = _load_taxonomy_files(
        args,
        args.taxonomy_csv,
        keep_full_identifiers=args.keep_full_identifiers,
        keep_identifier_versions=args.keep_identifier_versions,
    )

    notify(f"saving to '{args.output}', format {args.database_format}...")
    try:
        tax_assign.save(args.output, args.database_format)
    except ValueError as exc:
        error("ERROR while saving!")
        error(str(exc))
        sys.exit(-1)

    notify("done!")


def grep(args):
    "Grep taxonomies for a pattern; output a matching-ident picklist CSV."
    tax_assign = MultiLineageDB.load(args.taxonomy_csv, force=args.force)
    silent = args.silent or args.count

    notify(f"searching {len(args.taxonomy_csv)} taxonomy files for '{args.pattern}'")
    if args.invert_match:
        notify(
            "-v/--invert-match specified; returning only lineages that do not match."
        )
    if args.rank:
        notify(f"limiting matches to {args.rank} level")

    matcher = re.compile(args.pattern, re.IGNORECASE if args.ignore_case else 0)
    want = not args.invert_match

    def hit(lineage):
        found = any(
            matcher.search(lp.name)
            for lp in lineage
            if args.rank is None or lp.rank == args.rank
        )
        return found == want

    match_ident = [
        (ident, lineage) for ident, lineage in tax_assign.items() if hit(lineage)
    ]

    n_found = len(match_ident)
    if silent:
        notify(f"found {n_found} matches.")
        notify("(no matches will be saved because of --silent/--count")
        return

    picklist_cols = ["ident"] + list(RankLineageInfo().taxlist[:-1])
    with FileOutputCSV(args.output) as fp:
        w = csv.writer(fp)
        w.writerow(picklist_cols)
        w.writerows(
            [ident] + [x.name for x in lineage]
            for ident, lineage in sorted(match_ident)
        )

    notify(
        f"found {n_found} matches; saved identifiers to picklist file '{args.output}'"
    )


def summarize(args):
    "Summarize multiple taxonomy databases."
    tax_assign = _load_taxonomy_files(
        args,
        args.taxonomy_files,
        keep_full_identifiers=args.keep_full_identifiers,
        keep_identifier_versions=args.keep_identifier_versions,
        lins=args.lins,
        ictv=args.ictv,
    )

    print_results(f"number of distinct taxonomic lineages: {len(tax_assign)}")

    # count distinct lineage-pair names per rank (first occurrence wins)
    rank_counts = defaultdict(int)
    name_seen = set()
    for lineage in tax_assign.values():
        for lp in lineage:
            if lp.name not in name_seen:
                rank_counts[lp.rank] += 1
                name_seen.add(lp.name)

    for rank, count in sorted(rank_counts.items(), key=lambda x: x[1]):
        rank_name_str = f"{rank}:"
        print_results(f"rank {rank_name_str:<20s} {count} distinct taxonomic lineages")

    if args.output_lineage_information:
        notify("now calculating detailed lineage counts...")
        lineage_counts = Counter()
        for lineage in tax_assign.values():
            prefix = lineage
            while prefix:
                lineage_counts[prefix] += 1
                prefix = prefix[:-1]
        notify("...done!")

        if args.lins:
            lineage_info = LINLineageInfo
        elif args.ictv:
            lineage_info = ICTVRankLineageInfo
        else:
            lineage_info = RankLineageInfo

        with FileOutputCSV(args.output_lineage_information) as fp:
            w = csv.writer(fp)
            w.writerow(["rank", "lineage_count", "lineage"])

            for lineage, count in lineage_counts.most_common():
                lin = lineage_info(lineage=lineage).display_lineage()
                w.writerow([lineage[-1].rank, str(count), lin])

        n = len(lineage_counts)
        notify(f"saved {n} lineage counts to '{args.output_lineage_information}'")
