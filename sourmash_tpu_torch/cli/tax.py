"""'sourmash tax' CLI subparsers: the port's copy of
`sourmash_tpu/cli/tax.py` (parity: reference `src/sourmash/cli/tax/*.py`)."""

from __future__ import annotations

from .utils import add_rank_arg, add_tax_threshold_arg


def _common_tax(sp, formats, default_format=None):
    sp.add_argument("-g", "--gather-csv", dest="gather_csv", nargs="*", default=[],
                    action="extend", help="CSVs from sourmash gather")
    sp.add_argument("--from-file", metavar="FILE", default=None,
                    help="input many gather results as a text file with paths")
    sp.add_argument("-q", "--quiet", action="store_true",
                    help="suppress non-error output")
    sp.add_argument("-o", "--output-base", default="-",
                    help="base filepath for output files (default stdout)")
    sp.add_argument("--output-dir", default="", help="directory for output files")
    sp.add_argument("-t", "--taxonomy-csv", "--taxonomy", metavar="FILE",
                    dest="taxonomy_csv", nargs="+", required=True, action="extend",
                    help="database lineages CSV")
    sp.add_argument("--keep-full-identifiers", action="store_true",
                    help="do not split identifiers on whitespace")
    sp.add_argument("--keep-identifier-versions", action="store_true",
                    help="after splitting identifiers, do not remove accession versions")
    sp.add_argument("--fail-on-missing-taxonomy", action="store_true",
                    help="fail quickly if taxonomy is not available for an identifier")
    sp.add_argument("-F", "--output-format", default=[], nargs="*", action="extend",
                    choices=formats,
                    help="choose output format(s)")
    sp.add_argument("-f", "--force", action="store_true",
                    help="continue past errors in file and taxonomy loading")
    sp.add_argument("--lins", "--lin-taxonomy", action="store_true", default=False,
                    help="use LIN taxonomy in place of standard taxonomic ranks")
    sp.add_argument("--ictv", "--ictv-taxonomy", action="store_true", default=False,
                    help="use ICTV taxonomy in place of standard taxonomic ranks")
    sp.add_argument("--lingroup", "--lingroups", metavar="FILE", default=None,
                    help="CSV containing 'name', 'lin' columns")


def subparser(subparsers):
    p = subparsers.add_parser(
        "tax", aliases=["taxonomy"],
        description='integrate taxonomy information based on "gather" results',
    )
    p.set_defaults(cmd="tax", func="tax")
    ssub = p.add_subparsers(dest="subcmd", metavar="subcmd")

    # tax metagenome
    sp = ssub.add_parser("metagenome")
    _common_tax(sp, [
        "human", "csv_summary", "krona", "lineage_summary", "kreport",
        "lingroup", "bioboxes",
    ])
    add_rank_arg(sp)
    sp.set_defaults(subfunc="tax_metagenome")

    # tax genome
    sp = ssub.add_parser("genome")
    _common_tax(sp, ["human", "csv_summary", "krona", "lineage_csv"])
    add_rank_arg(sp)
    add_tax_threshold_arg(sp)
    sp.set_defaults(subfunc="tax_genome")

    # tax annotate
    sp = ssub.add_parser("annotate")
    sp.add_argument("-g", "--gather-csv", dest="gather_csv", nargs="*", default=[],
                    action="extend", help="CSVs to annotate")
    sp.add_argument("--from-file", metavar="FILE", default=None,
                    help="input many CSVs as a text file with paths")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("-o", "--output-dir", default="",
                    help="directory for output files")
    sp.add_argument("-t", "--taxonomy-csv", "--taxonomy", metavar="FILE",
                    dest="taxonomy_csv", nargs="+", required=True, action="extend",
                    help="database lineages CSV")
    sp.add_argument("--keep-full-identifiers", action="store_true")
    sp.add_argument("--keep-identifier-versions", action="store_true")
    sp.add_argument("--fail-on-missing-taxonomy", action="store_true")
    sp.add_argument("-f", "--force", action="store_true")
    sp.add_argument("--lins", "--lin-taxonomy", action="store_true", default=False)
    sp.add_argument("--ictv", "--ictv-taxonomy", action="store_true", default=False)
    sp.set_defaults(subfunc="tax_annotate")

    # tax prepare
    sp = ssub.add_parser("prepare")
    sp.add_argument("-t", "--taxonomy-csv", "--taxonomy", metavar="FILE",
                    dest="taxonomy_csv", nargs="+", required=True, action="extend",
                    help="database lineages")
    sp.add_argument("-o", "--output", required=True,
                    help="output file")
    sp.add_argument("-F", "--database-format", default="sql",
                    choices=["csv", "sql"],
                    help="format of output file; default is 'sql'")
    sp.add_argument("--keep-full-identifiers", action="store_true")
    sp.add_argument("--keep-identifier-versions", action="store_true")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("-f", "--force", action="store_true")
    sp.set_defaults(subfunc="tax_prepare")

    # tax grep
    sp = ssub.add_parser("grep")
    sp.add_argument("pattern")
    sp.add_argument("-r", "--rank", help="search only this rank",
                    choices=["superkingdom", "phylum", "class", "order",
                             "family", "genus", "species", "strain"])
    sp.add_argument("-v", "--invert-match", action="store_true",
                    help="select non-matching lineages")
    sp.add_argument("-i", "--ignore-case", action="store_true",
                    help="ignore case distinctions")
    sp.add_argument("--silent", "--no-picklist-output", action="store_true",
                    help="do not output picklist")
    sp.add_argument("-c", "--count", action="store_true",
                    help="only output a count of discovered lineages; implies --silent")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("-t", "--taxonomy-csv", "--taxonomy", metavar="FILE",
                    dest="taxonomy_csv", nargs="+", required=True, action="extend",
                    help="database lineages")
    sp.add_argument("-o", "--output", default="-",
                    help="output file (defaults to stdout)")
    sp.add_argument("-f", "--force", action="store_true")
    sp.set_defaults(subfunc="tax_grep")

    # tax summarize
    sp = ssub.add_parser("summarize")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("taxonomy_files", metavar="FILE", nargs="+",
                    help="database lineages")
    sp.add_argument("-o", "--output-lineage-information",
                    help="output a CSV file containing individual lineage counts")
    sp.add_argument("--keep-full-identifiers", action="store_true")
    sp.add_argument("--keep-identifier-versions", action="store_true")
    sp.add_argument("-f", "--force", action="store_true")
    sp.add_argument("--lins", "--lin-taxonomy", action="store_true", default=False)
    sp.add_argument("--ictv", "--ictv-taxonomy", action="store_true", default=False)
    sp.set_defaults(subfunc="tax_summarize")
