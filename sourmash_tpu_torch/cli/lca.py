"""'sourmash lca' CLI subparsers: the port's copy of
`sourmash_tpu/cli/lca.py` (parity: reference `src/sourmash/cli/lca/*.py`)."""

from __future__ import annotations

from .utils import add_ksize_arg, add_moltype_args, add_picklist_args


def subparser(subparsers):
    p = subparsers.add_parser("lca", description="taxonomic operations")
    p.set_defaults(cmd="lca", func="lca")
    ssub = p.add_subparsers(dest="subcmd", metavar="subcmd")

    # lca index
    sp = ssub.add_parser("index")
    sp.add_argument("csv", help="taxonomy spreadsheet")
    sp.add_argument("lca_db_out", help="output database name")
    sp.add_argument("signatures", nargs="*",
                    help="one or more sourmash signatures")
    sp.add_argument("--from-file",
                    help="a text file containing a list of files to load signatures from")
    sp.add_argument("--scaled", metavar="S", default=10000, type=float)
    sp.add_argument("-q", "--quiet", action="store_true",
                    help="suppress non-error output")
    sp.add_argument("-d", "--debug", action="store_true",
                    help="output debugging output")
    sp.add_argument("-C", "--start-column", metavar="C", default=2, type=int,
                    help="column at which taxonomic assignments start; default=2")
    sp.add_argument("--tabs", action="store_true",
                    help="input spreadsheet is tab-delimited; default is commas")
    sp.add_argument("--no-headers", action="store_true",
                    help="no headers present in taxonomy spreadsheet")
    sp.add_argument("--split-identifiers", action="store_true",
                    help="split names in signatures on whitespace")
    sp.add_argument("--keep-identifier-versions", action="store_true",
                    help="after splitting, keep identifier versions")
    sp.add_argument("-f", "--force", action="store_true")
    sp.add_argument("--report", help="output a report on anomalies, if any")
    sp.add_argument("--require-taxonomy", action="store_true",
                    help="ignore signatures with no taxonomy entry")
    sp.add_argument("--fail-on-missing-taxonomy", action="store_true",
                    help="fail quickly if taxonomy is not available for an identifier")
    sp.add_argument("-F", "--database-format", default="json",
                    choices=["json", "sql"],
                    help="format of output database; default is 'json'")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.set_defaults(subfunc="lca_index")

    # lca classify
    sp = ssub.add_parser("classify")
    sp.add_argument("--db", nargs="+", action="append", default=[],
                    help="databases to use to classify")
    sp.add_argument("--query", nargs="*", action="append", default=[],
                    help="query signatures to classify")
    sp.add_argument("--query-from-file",
                    help="file containing list of signature files to query")
    sp.add_argument("--threshold", metavar="T", type=int, default=5,
                    help="minimum number of hashes needed for a taxonomic classification (default: 5)")
    sp.add_argument("--majority", action="store_true",
                    help="use majority vote classification instead of lca")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("-d", "--debug", action="store_true")
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output CSV to this file (default stdout)")
    sp.add_argument("--scaled", type=float)
    sp.set_defaults(subfunc="lca_classify")

    # lca summarize
    sp = ssub.add_parser("summarize")
    sp.add_argument("--db", nargs="+", action="append", default=[],
                    help="one or more LCA databases to use")
    sp.add_argument("--query", nargs="*", action="append", default=[],
                    help="one or more signature files to use as queries")
    sp.add_argument("--query-from-file",
                    help="file containing list of signature files to query")
    sp.add_argument("--threshold", metavar="T", type=int, default=5,
                    help="minimum number of hashes to require for a match")
    sp.add_argument("-o", "--output", metavar="FILE",
                    help="file to which CSV output will be written")
    sp.add_argument("--scaled", metavar="FLOAT", type=float,
                    help="scaled value to downsample to")
    sp.add_argument("--ignore-abundance", action="store_true",
                    help="ignore hash abundances in query signatures")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("-d", "--debug", action="store_true")
    sp.set_defaults(subfunc="lca_summarize")

    # lca rankinfo
    sp = ssub.add_parser("rankinfo")
    sp.add_argument("db", nargs="+")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("-d", "--debug", action="store_true")
    sp.add_argument("--scaled", metavar="FLOAT", type=float)
    sp.add_argument("--minimum-num", type=int, default=0,
                    help="minimum number of different lineages a k-mer must be in to be counted")
    sp.set_defaults(subfunc="lca_rankinfo")

    # lca compare_csv
    sp = ssub.add_parser("compare_csv")
    sp.add_argument("csv1", help="taxonomy spreadsheet output by classify")
    sp.add_argument("csv2", help="custom taxonomy spreadsheet")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("-d", "--debug", action="store_true")
    sp.add_argument("-C", "--start-column", metavar="C", default=2, type=int,
                    help="column at which taxonomic assignments start; default=2")
    sp.add_argument("--tabs", action="store_true",
                    help="input spreadsheet is tab-delimited; default is commas")
    sp.add_argument("--no-headers", action="store_true",
                    help="no headers present in taxonomy spreadsheet")
    sp.add_argument("-f", "--force", action="store_true")
    sp.set_defaults(subfunc="lca_compare_csv")
