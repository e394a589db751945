"""Command-line interface of the port: every command of
`sourmash_tpu/cli/__init__.py` (itself reference
`src/sourmash/cli/__init__.py`), with the same command names, flags and
defaults, in the same order (`tests/test_torch_cli_tree.py`). The shared
flag groups are in `utils.py`; `scripts` (alias `ext`) holds the
'sourmash.cli_script' plugins' commands (`scripts.py`).
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser, RawDescriptionHelpFormatter, SUPPRESS

from .. import VERSION
from ..sourmash_args import check_scaled_bounds, check_num_bounds
from .utils import (
    add_ksize_arg,
    add_moltype_args,
    add_construct_moltype_args,
    add_picklist_args,
    add_pattern_args,
    add_scaled_arg,
    add_num_arg,
)


class SourmashParser(ArgumentParser):
    _citation_printed = False

    def __init__(self, citation=True, **kwargs):
        super().__init__(**kwargs)
        self.citation = citation

    @classmethod
    def print_citation(cls):
        if cls._citation_printed:
            return
        from ..logging import notify

        notify(f"\n== This is sourmash-tpu-torch version {VERSION}. ==")
        notify("== Please cite Irber et. al (2024), doi:10.21105/joss.06830. ==\n")
        cls._citation_printed = True

    def _subparser_from_name(self, name):
        if name is None:
            return None
        for action in self._actions:
            if action.choices is None:
                continue
            elif name in action.choices:
                return action.choices[name]

    def print_help(self):
        self.print_citation()
        super().print_help()

    def parse_args(self, args=None, namespace=None):
        given = sys.argv[1:] if args is None else args
        if not len(given):
            self.print_help()
            raise SystemExit(1)

        ns = super().parse_args(args=args, namespace=namespace)
        if self.citation and not getattr(ns, "quiet", False):
            self.print_citation()

        if hasattr(ns, "subcmd"):
            if ns.subcmd is None:
                self._subparser_from_name(ns.cmd).print_help()
                raise SystemExit(1)
            if ns.subcmd == "import":
                ns.subcmd = "ingest"
        return ns


def _add_compare(sub):
    "`compare` (`sourmash_tpu/cli/__init__.py:77`)."
    p = sub.add_parser("compare", description="compare sequence signatures")
    p.add_argument("signatures", nargs="*", default=[],
                   help="list of signatures to compare")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress non-error output")
    p.add_argument("-o", "--output", metavar="F",
                   help="file to which output will be written; default is terminal")
    p.add_argument("--ignore-abundance", action="store_true",
                   help="do NOT use k-mer abundances even if present")
    p.add_argument("--containment", action="store_true",
                   help="calculate containment instead of similarity")
    p.add_argument("--max-containment", action="store_true",
                   help="calculate max containment instead of similarity")
    p.add_argument("--avg-containment", "--average-containment",
                   action="store_true",
                   help="calculate average containment instead of similarity")
    p.add_argument("--estimate-ani", "--ANI", "--ani", action="store_true",
                   help="return ANI estimates instead of similarity/containment")
    p.add_argument("--from-file",
                   help="a text file containing a list of files to load signatures from")
    p.add_argument("-f", "--force", action="store_true",
                   help="continue past errors in file loading")
    p.add_argument("--csv", metavar="F",
                   help="write matrix to specified file in CSV format")
    p.add_argument("--labels-to", "--labels-save",
                   help="a CSV file containing label information")
    p.add_argument("-p", "--processes", metavar="N", type=int, default=None,
                   help="number of processes to use for calculation")
    p.add_argument("--distance-matrix", action="store_true",
                   help="output a distance matrix, instead of a similarity matrix")
    p.add_argument("--similarity-matrix", action="store_false",
                   dest="distance_matrix",
                   help="output a similarity matrix (default)")
    add_ksize_arg(p)
    add_moltype_args(p)
    add_picklist_args(p)
    add_pattern_args(p)
    add_scaled_arg(p)
    p.set_defaults(func="compare")


def _add_plot(sub):
    p = sub.add_parser("plot", description="plot distance matrix")
    p.add_argument("distances", help="output from 'sourmash compare'")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--pdf", action="store_true", help="output PDF, not PNG")
    p.add_argument("--labels", action="store_true", default=None,
                   help="show sample labels on dendrogram/matrix")
    p.add_argument("--no-labels", action="store_false", dest="labels")
    p.add_argument("--labeltext",
                   help="filename containing list of labels; implies --labels")
    p.add_argument("--indices", action="store_true", default=None,
                   help="show sample indices but not labels; overridden by --labels")
    p.add_argument("--no-indices", action="store_false", dest="indices")
    p.add_argument("--labels-from", "--labels-load", dest="labels_from",
                   help="a CSV file containing label information to use on plot;"
                        " implies --labels")
    p.add_argument("--vmax", default=1.0, type=float,
                   help="upper limit of heatmap scale (default: 1.0)")
    p.add_argument("--vmin", default=0.0, type=float,
                   help="lower limit of heatmap scale (default: 0.0)")
    p.add_argument("--subsample", type=int, metavar="N",
                   help="randomly downsample to this many samples, max")
    p.add_argument("--subsample-seed", type=int, default=1, metavar="S",
                   help="random seed for --subsample; default=1")
    p.add_argument("-f", "--force", action="store_true",
                   help="forcibly plot non-distance matrices")
    p.add_argument("--output-dir", help="directory for output plots")
    p.add_argument("--csv", metavar="F",
                   help="write clustered matrix and labels out in CSV format")
    p.set_defaults(func="plot")


def _add_search(sub):
    "`search` (`sourmash_tpu/cli/__init__.py:151`)."
    p = sub.add_parser("search", description="search a signature against databases")
    p.add_argument("query", help="query signature")
    p.add_argument("databases", nargs="+", help="signatures/SBTs to search")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-t", "--threshold", metavar="T", default=0.08, type=float,
                   help="minimum threshold for reporting matches; default=0.08")
    p.add_argument("--save-matches", metavar="FILE",
                   help="output matching signatures to the specified file")
    p.add_argument("--best-only", action="store_true",
                   help="report only the best match (with greater speed)")
    p.add_argument("-n", "--num-results", default=3, type=int, metavar="N",
                   help="number of results to display; 0 to report all")
    p.add_argument("--containment", action="store_true",
                   help="score based on containment rather than similarity")
    p.add_argument("--max-containment", action="store_true",
                   help="score based on max containment rather than similarity")
    p.add_argument("--estimate-ani-ci", action="store_true",
                   help="output confidence intervals for ANI estimates")
    p.add_argument("--ignore-abundance", action="store_true",
                   help="do NOT use k-mer abundances if present")
    p.add_argument("-o", "--output", metavar="FILE",
                   help="output CSV containing matches to this file")
    p.add_argument("--md5", default=None,
                   help="select the signature with this md5 as query")
    p.add_argument("--fail-on-empty-database", action="store_true",
                   help="stop at databases that contain no compatible signatures")
    p.add_argument("--no-fail-on-empty-database", action="store_false",
                   dest="fail_on_empty_database")
    p.set_defaults(fail_on_empty_database=True)
    add_ksize_arg(p)
    add_moltype_args(p)
    add_picklist_args(p)
    add_pattern_args(p)
    add_scaled_arg(p, 0)
    p.set_defaults(func="search")


def _add_gather(sub):
    "`gather` (`sourmash_tpu/cli/__init__.py:190`)."
    p = sub.add_parser("gather", description="greedy min-set-cov decomposition")
    p.add_argument("query", help="query signature")
    p.add_argument("databases", nargs="+", help="signatures/SBTs to search")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-n", "--num-results", default=None, type=int, metavar="N",
                   help="number of results to report")
    p.add_argument("-o", "--output", metavar="FILE",
                   help="output CSV containing matches to this file")
    p.add_argument("--save-matches", metavar="FILE",
                   help="save gather matched signatures to this file")
    p.add_argument("--save-prefetch", metavar="FILE",
                   help="save all prefetch-matched signatures to this file")
    p.add_argument("--save-prefetch-csv", metavar="FILE",
                   help="save prefetch-matched info CSV to this file")
    p.add_argument("--threshold-bp", metavar="REAL", type=float, default=5e4,
                   help="reporting threshold (in bp); default=50kb")
    p.add_argument("--output-unassigned", metavar="FILE",
                   help="output unassigned portions of the query")
    p.add_argument("--ignore-abundance", action="store_true",
                   help="do NOT use k-mer abundances if present")
    p.add_argument("--md5", default=None,
                   help="select the signature with this md5 as query")
    p.add_argument("--cache-size", default=0, type=int, metavar="N",
                   help="number of internal SBT nodes to cache (default: 0 = all)")
    p.add_argument("--linear", dest="linear", action="store_true",
                   help="force a low-memory but maybe slower database search")
    p.add_argument("--no-linear", dest="linear", action="store_false")
    p.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                   help="do not use prefetch before gather")
    p.add_argument("--prefetch", dest="prefetch", action="store_true",
                   help="use prefetch before gather")
    p.set_defaults(linear=False, prefetch=True)
    p.add_argument("--estimate-ani-ci", action="store_true",
                   help="output confidence intervals for ANI estimates")
    p.add_argument("--fail-on-empty-database", action="store_true")
    p.add_argument("--no-fail-on-empty-database", action="store_false",
                   dest="fail_on_empty_database")
    p.set_defaults(fail_on_empty_database=True)
    p.add_argument("--create-empty-results", action="store_true",
                   help="create an empty results file even if no matches")
    add_ksize_arg(p)
    add_moltype_args(p)
    add_picklist_args(p)
    add_pattern_args(p)
    add_scaled_arg(p, 0)
    p.set_defaults(func="gather")


def _add_multigather(sub):
    "`multigather` (`sourmash_tpu/cli/__init__.py:240`)."
    p = sub.add_parser(
        "multigather",
        description="gather many signatures against multiple databases",
    )
    p.add_argument("--query", nargs="*", default=[], action="append",
                   help="query signature")
    p.add_argument("--query-from-file",
                   help="file containing list of signature files to query")
    p.add_argument("--db", nargs="+", action="append",
                   help="signatures/SBTs to search")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("--threshold-bp", metavar="REAL", type=float, default=5e4,
                   help="threshold (in bp) for reporting results (default=50,000)")
    p.add_argument("--ignore-abundance", action="store_true",
                   help="do NOT use k-mer abundances if present")
    p.add_argument("--estimate-ani-ci", action="store_true",
                   help="output confidence intervals for ANI estimates")
    p.add_argument("--fail-on-empty-database", action="store_true")
    p.add_argument("--no-fail-on-empty-database", action="store_false",
                   dest="fail_on_empty_database")
    p.set_defaults(fail_on_empty_database=True)
    p.add_argument("--force-allow-overwrite-output", action="store_true",
                   help="allow overwriting of output files")
    p.add_argument("--output-dir", "--outdir",
                   help="output CSV results to this directory")
    p.add_argument("-U", "--output-add-query-md5sum", action="store_true",
                   help="add query md5sum to output file names")
    p.add_argument("-E", "--extension", type=str, default=".sig",
                   help="write signature files with this extension ('.sig' by default)")
    add_ksize_arg(p)
    add_moltype_args(p)
    add_scaled_arg(p, 0)
    p.set_defaults(func="multigather")


from . import scripts  # noqa: E402

# alias kept for __main__ dispatch; same dict object as scripts._extension_dict
_scripts_extension_dict = scripts._extension_dict


def _add_scripts(sub):
    """'sourmash scripts' plugin commands (parity: reference
    `cli/scripts/__init__.py`)."""
    scripts.subparser(sub)


def _add_storage(sub):
    "'sourmash storage convert' (parity: reference `cli/storage/convert.py`)."
    p = sub.add_parser("storage", description="SBT storage-backend utilities")
    p.set_defaults(cmd="storage")
    ssub = p.add_subparsers(dest="subcmd", metavar="subcmd")
    sp = ssub.add_parser("convert")
    sp.add_argument("sbt", help="name to save SBT into")
    sp.add_argument("-b", "--backend", type=str, help="Backend to convert to")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.set_defaults(subfunc="storage_convert")


def _ksize_list_parser(value):
    "parse '21,31,51' (or '21 31 51') into a list of ints"
    value = value.replace(" ", ",")
    return [int(k) for k in value.split(",") if k]


def _add_compute(sub):
    p = sub.add_parser(
        "compute", description="compute signatures for sequences (legacy; use 'sketch')"
    )
    p.add_argument("filenames", nargs="+", help="file(s) of sequences")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-k", "--ksizes", default="21,31,51", type=_ksize_list_parser,
                   help="comma-separated list of k-mer sizes; default=%(default)s")
    add_num_arg(p, 500)
    p.add_argument("--track-abundance", action="store_true",
                   help="track k-mer abundances in the generated signature")
    p.add_argument("--scaled", type=float, default=0,
                   help="choose number of hashes as 1 in FRACTION of input k-mers")
    add_construct_moltype_args(p)
    p.add_argument("--input-is-protein", action="store_true",
                   help="Consume protein sequences - no translation needed.")
    p.add_argument("--seed", type=int, default=42,
                   help="seed used by MurmurHash; default=42")
    p.add_argument("-f", "--force", action="store_true",
                   help="recompute signatures even if the file exists")
    p.add_argument("-o", "--output",
                   help="output computed signatures to this file")
    p.add_argument("--output-dir", "--outdir",
                   help="output computed signatures to this directory")
    p.add_argument("--singleton", action="store_true",
                   help="compute a signature for each sequence record individually")
    p.add_argument("--merge", "--name", dest="merge", type=str, default="",
                   help="merge all input files into one signature with this name")
    p.add_argument("--name-from-first", action="store_true",
                   help="name the signature after the first record in each file")
    p.add_argument("--randomize", action="store_true",
                   help="shuffle the list of input filenames randomly")
    p.add_argument("--license", default="CC0", type=str,
                   help="signature license. Currently only CC0 is supported.")
    p.add_argument("--check-sequence", action="store_true",
                   help="complain if input sequence is invalid")
    p.set_defaults(func="compute", from_file=None)


def _add_prefetch(sub):
    "`prefetch` (`sourmash_tpu/cli/__init__.py:346`)."
    p = sub.add_parser("prefetch", description="overlap search")
    p.add_argument("query", help="query signature")
    p.add_argument("databases", nargs="*", help="one or more databases to search")
    p.add_argument("--db-from-file", default=None,
                   help="list of paths containing signatures to search")
    p.add_argument("--linear", action="store_true",
                   help="force linear traversal of indexes")
    p.add_argument("--no-linear", dest="linear", action="store_false")
    p.set_defaults(linear=False)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-o", "--output", metavar="FILE",
                   help="output CSV containing matches to this file")
    p.add_argument("--save-matches", metavar="FILE",
                   help="save all matching signatures to this file/directory")
    p.add_argument("--threshold-bp", metavar="REAL", type=float, default=5e4,
                   help="reporting threshold (in bp); default=50kb")
    p.add_argument("--save-unmatched-hashes", metavar="FILE",
                   help="output unmatched query hashes as a signature")
    p.add_argument("--save-matching-hashes", metavar="FILE",
                   help="output matching query hashes as a signature")
    p.add_argument("--md5", default=None,
                   help="select the signature with this md5 as query")
    p.add_argument("--estimate-ani-ci", action="store_true",
                   help="output confidence intervals for ANI estimates")
    add_ksize_arg(p)
    add_moltype_args(p)
    add_picklist_args(p)
    add_pattern_args(p)
    add_scaled_arg(p, 0)
    p.set_defaults(func="prefetch")


def _add_sketch(sub):
    p = sub.add_parser("sketch", description="create signatures")
    ssub = p.add_subparsers(dest="subcmd", metavar="subcmd")
    p.set_defaults(cmd="sketch", func="sketch")

    def _common(sp):
        sp.add_argument("--license", default="CC0", type=str,
                        help="signature license. Currently only CC0 is supported.")
        sp.add_argument("--check-sequence", action="store_true",
                        help="complain if input sequence is invalid")
        sp.add_argument("-p", "--param-string", default=[], action="append",
                        help="signature parameters to use.")
        sp.add_argument("filenames", nargs="*", help="file(s) of sequences")
        sp.add_argument("-f", "--force", action="store_true",
                        help="recompute signatures even if the file exists")
        sp.add_argument("--from-file",
                        help="a text file containing a list of sequence files to load")
        sp.add_argument("-o", "--output",
                        help="output computed signatures to this file")
        sp.add_argument("--set-name", "--name", "--merge", dest="merge",
                        type=str, default="", metavar="FILE",
                        help="name the output sketch; merges all inputs")
        sp.add_argument("--output-dir", "--outdir",
                        help="output computed signatures to this directory")
        sp.add_argument("--singleton", action="store_true",
                        help="compute a signature for each sequence record individually")
        sp.add_argument("--name-from-first", action="store_true",
                        help="name the signature after the first record in each file")
        sp.add_argument("--randomize", action="store_true",
                        help="shuffle the list of input filenames randomly")
        sp.add_argument("-q", "--quiet", action="store_true")

    sp = ssub.add_parser("dna", aliases=["rna", "nucleotide", "nt"])
    _common(sp)
    sp.set_defaults(subfunc="sketch_dna", subcmd="dna")

    sp = ssub.add_parser("protein", aliases=["aa", "prot"])
    _common(sp)
    add_moltype_args(sp)
    sp.set_defaults(subfunc="sketch_protein", subcmd="protein")

    sp = ssub.add_parser("translate")
    _common(sp)
    add_moltype_args(sp)
    sp.set_defaults(subfunc="sketch_translate", subcmd="translate")

    sp = ssub.add_parser("fromfile")
    sp.add_argument("csvs", nargs="+",
                    help="input CSVs with 'name', 'genome_filename', and 'protein_filename' columns")
    sp.add_argument("-q", "--quiet", action="store_true")
    sp.add_argument("-d", "--debug", action="store_true")
    sp.add_argument("-p", "--param-string", default=[], action="append",
                    help="signature parameters to use.")
    sp.add_argument("--already-done", nargs="+", default=[],
                    help="one or more collections of existing signatures to avoid rebuilding")
    sp.add_argument("--license", default="CC0", type=str,
                    help="signature license. Currently only CC0 is supported.")
    sp.add_argument("--check-sequence", action="store_true",
                    help="complain if input sequence is invalid")
    sp.add_argument("-o", "--output-signatures",
                    help="output computed signatures to this file")
    sp.add_argument("--force-output-already-exists", action="store_true",
                    help="overwrite/append to --output-signatures location")
    sp.add_argument("--ignore-missing", action="store_true",
                    help="proceed with building possible signatures, even if some input files are missing")
    sp.add_argument("--output-csv-info",
                    help="output information about what signatures need to be generated")
    sp.add_argument("--output-manifest-matching",
                    help="output a manifest file of already-existing signatures")
    sp.add_argument("--report-duplicated", action="store_true",
                    help="report duplicated names")
    sp.set_defaults(subfunc="sketch_fromfile", subcmd="fromfile")


def _add_index(sub):
    p = sub.add_parser("index", description="build an SBT index of signatures")
    p.add_argument("sbt_name", help="name to save SBT into")
    p.add_argument("-F", "--index-type", default="sbt",
                   choices=["sbt", "revindex"],
                   help="index format: 'sbt' (reference-compatible Sequence "
                        "Bloom Tree, default) or 'revindex' "
                        "(the flat index's directory of packed planes)")
    p.add_argument("signatures", nargs="*",
                   help="signatures to load into SBT")
    p.add_argument("--from-file",
                   help="a text file containing a list of files to load signatures from")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("--scaled", metavar="FLOAT", type=check_scaled_bounds, default=0,
                   help="downsample signatures to the specified scaled factor")
    p.add_argument("-f", "--force", action="store_true",
                   help="try loading all files with --traverse-directory")
    p.add_argument("-x", "--bf-size", metavar="S", type=float, default=1e5,
                   help="Bloom filter size used for internal nodes")
    p.add_argument("--append", action="store_true", default=False,
                   help="add signatures to an existing SBT")
    p.add_argument("--sparseness", metavar="FLOAT", type=float, default=0.0,
                   help="What percentage of internal nodes will not be saved; ranges from 0.0 (save all nodes) to 1.0 (no nodes saved)")
    p.add_argument("-n", "--n_children", metavar="D", type=int, default=2,
                   help="number of children for internal nodes; default=2")
    add_ksize_arg(p)
    add_moltype_args(p)
    add_picklist_args(p)


def _add_misc(sub):
    p = sub.add_parser("info", description="display sourmash version and other information")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="report versions of software dependencies")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(func="info")

    p = sub.add_parser("import_csv", description="import a mash CSV")
    p.add_argument("mash_csvfile", help="a mash CSV file")
    p.add_argument("-o", "--output", default="-",
                   help="save signature to this file (default stdout)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(func="import_csv")

    p = sub.add_parser("sbt_combine", description="combine multiple SBTs into a new one")
    p.add_argument("sbt_name", help="name to save the new SBT into")
    p.add_argument("sbts", nargs="+", help="SBTs to combine to a new SBT")
    p.add_argument("-x", "--bf-size", metavar="S", type=float, default=1e5)
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(func="sbt_combine")

    p = sub.add_parser("migrate", description="migrate an SBT to the latest version")
    p.add_argument("sbt_name", help="name to save SBT into")
    p.add_argument("-q", "--quiet", action="store_true")
    p.set_defaults(func="migrate")

    p = sub.add_parser("watch", description="watch a stream of sequences and look for matches")
    p.add_argument("sbt_name", help="name of SBT to search")
    p.add_argument("inp_file", nargs="?", default="/dev/stdin",
                   help="input file of sequences")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-o", "--output",
                   help="save the computed signature to this file")
    p.add_argument("--threshold", metavar="T", default=0.05, type=float,
                   help="minimum threshold for matches; default=0.05")
    p.add_argument("--input-is-protein", action="store_true",
                   help="consume protein sequences")
    p.add_argument("-n", "--num-hashes", type=check_num_bounds, default=500,
                   metavar="N",
                   help="number of hashes to use in each sketch; default=500")
    p.add_argument("--name", type=str, default="stdin", metavar="NAME",
                   help="name to use for the signature")
    add_ksize_arg(p)
    add_moltype_args(p)
    p.set_defaults(func="watch")

    p = sub.add_parser("categorize", description="categorize query signatures against a database")
    p.add_argument("database", help="location of signature collection/database to load")
    p.add_argument("queries", nargs="+",
                   help="locations of signatures to categorize")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--threshold", metavar="T", default=0.08, type=float,
                   help="minimum threshold for reporting matches; default=0.08")
    p.add_argument("--ignore-abundance", action="store_true",
                   help="do NOT use k-mer abundances if present")
    p.add_argument("--csv", metavar="F",
                   help="output summary CSV to this file")
    p.add_argument("--load-csv", default=None,
                   help="load a directory CSV from this file")
    add_ksize_arg(p)
    add_moltype_args(p)
    p.set_defaults(func="categorize")


def get_parser():
    desc = (
        "Create, compare, and manipulate k-mer sketches of biological sequences."
    )
    parser = SourmashParser(
        prog="sourmash",
        usage=SUPPRESS,
        description=desc,
        formatter_class=RawDescriptionHelpFormatter,
    )
    parser._optionals.title = "Options"
    parser.add_argument("-v", "--version", action="version",
                        version="sourmash " + VERSION)
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="don't print citation information")
    sub = parser.add_subparsers(title="Instructions", dest="cmd", metavar="cmd",
                                help=SUPPRESS)
    _add_compare(sub)
    _add_plot(sub)
    _add_search(sub)
    _add_gather(sub)
    _add_multigather(sub)
    _add_compute(sub)
    _add_prefetch(sub)
    _add_sketch(sub)
    _add_index(sub)
    _add_misc(sub)
    _add_scripts(sub)
    _add_storage(sub)

    from . import sig as _sig_cli
    from . import lca as _lca_cli
    from . import tax as _tax_cli

    _sig_cli.subparser(sub)
    _lca_cli.subparser(sub)
    _tax_cli.subparser(sub)
    parser._action_groups.reverse()
    return parser


def parse_args(arglist=None):
    return get_parser().parse_args(arglist)
