"""'sourmash signature' CLI subparsers: the port's copy of
`sourmash_tpu/cli/sig.py` (parity: reference `src/sourmash/cli/sig/*.py`)."""

from __future__ import annotations

from .utils import (
    add_ksize_arg,
    add_moltype_args,
    add_picklist_args,
    add_pattern_args,
    add_num_arg,
)
from ..sourmash_args import check_scaled_bounds


def _common(p, *, output_default=None, from_file=True):
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress non-error output")
    p.add_argument("-d", "--debug", action="store_true",
                   help="print debugging output")
    p.add_argument("-f", "--force", action="store_true",
                   help="try to load all files as signatures")
    if from_file:
        p.add_argument("--from-file",
                       help="a text file containing a list of files to load signatures from")


def subparser(subparsers):
    p = subparsers.add_parser(
        "sig", aliases=["signature"], description="signature manipulation utilities"
    )
    p.set_defaults(cmd="sig", func="sig")
    ssub = p.add_subparsers(
        title="Manipulate signature files", dest="subcmd", metavar="subcmd"
    )

    # cat
    sp = ssub.add_parser("cat")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    sp.add_argument("-u", "--unique", action="store_true",
                    help="keep only distinct signatures")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    add_pattern_args(sp)
    sp.set_defaults(subfunc="cat")

    # split
    sp = ssub.add_parser("split")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    sp.add_argument("--output-dir", "--outdir",
                    help="output signatures to this directory")
    sp.add_argument("-E", "--extension", default=".sig",
                    help="write files with this extension ('.sig' by default)")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.set_defaults(subfunc="split")

    # describe
    sp = ssub.add_parser("describe")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    sp.add_argument("--csv", metavar="FILE",
                    help="output information to a CSV file")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    add_pattern_args(sp)
    sp.set_defaults(subfunc="describe")

    # manifest
    sp = ssub.add_parser("manifest")
    sp.add_argument("location")
    _common(sp, from_file=False)
    sp.add_argument("-o", "--output", "--csv", metavar="FILE", required=True,
                    help="output manifest to this file")
    sp.add_argument("--no-rebuild-manifest", "--no-rebuild", action="store_true",
                    help="use existing manifest if available")
    sp.add_argument("-F", "--manifest-format", default="csv",
                    choices=["csv", "sql"],
                    help="format of manifest output")
    sp.set_defaults(subfunc="manifest")

    # overlap
    sp = ssub.add_parser("overlap")
    sp.add_argument("signature1")
    sp.add_argument("signature2")
    _common(sp, from_file=False)
    add_ksize_arg(sp)
    add_moltype_args(sp)
    sp.set_defaults(subfunc="overlap")

    # merge
    sp = ssub.add_parser("merge")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    sp.add_argument("--flatten", action="store_true",
                    help="remove abundances from all signatures while merging")
    sp.add_argument("--set-name", "--name", dest="set_name", default=None,
                    help="rename merged signature")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.set_defaults(subfunc="merge")

    # intersect
    sp = ssub.add_parser("intersect")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    sp.add_argument("-A", "--abundances-from", metavar="FILE",
                    help="intersect with & take abundances from this signature")
    sp.add_argument("--set-name", dest="set_name", default=None,
                    help="set name for output signature")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.set_defaults(subfunc="intersect")

    # inflate
    sp = ssub.add_parser("inflate")
    sp.add_argument("signature_from")
    sp.add_argument("other_sigs", nargs="+")
    _common(sp, from_file=False)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.set_defaults(subfunc="inflate")

    # subtract
    sp = ssub.add_parser("subtract")
    sp.add_argument("signature_from")
    sp.add_argument("subtraction_sigs", nargs="+")
    _common(sp, from_file=False)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    sp.add_argument("--flatten", action="store_true",
                    help="remove abundances from all signatures while subtracting")
    sp.add_argument("-A", "--abundances-from", metavar="FILE",
                    help="take abundances from this signature")
    sp.add_argument("--set-name", dest="set_name", default=None,
                    help="set name for output signature")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    sp.set_defaults(subfunc="subtract")

    # rename
    sp = ssub.add_parser("rename")
    sp.add_argument("signatures", nargs="*")
    sp.add_argument("name")
    _common(sp)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    add_pattern_args(sp)
    sp.set_defaults(subfunc="rename")

    # extract
    sp = ssub.add_parser("extract")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    sp.add_argument("--md5", default=None,
                    help="select signatures whose md5 contains this substring")
    sp.add_argument("--name", default=None,
                    help="select signatures whose name contains this substring")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    add_pattern_args(sp)
    sp.set_defaults(subfunc="extract")

    # filter
    sp = ssub.add_parser("filter")
    sp.add_argument("signatures", nargs="*")
    _common(sp, from_file=False)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    sp.add_argument("--md5", default=None,
                    help="select signatures whose md5 contains this substring")
    sp.add_argument("--name", default=None,
                    help="select signatures whose name contains this substring")
    sp.add_argument("-m", "--min-abundance", type=int, default=1,
                    help="keep hashes >= this minimum abundance")
    sp.add_argument("-M", "--max-abundance", type=int, default=None,
                    help="keep hashes <= this maximum abundance")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    sp.set_defaults(subfunc="filter")

    # flatten
    sp = ssub.add_parser("flatten")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    sp.add_argument("--md5", default=None,
                    help="select signatures whose md5 contains this substring")
    sp.add_argument("--name", default=None,
                    help="select signatures whose name contains this substring")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.set_defaults(subfunc="flatten")

    # downsample
    sp = ssub.add_parser("downsample")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    sp.add_argument("--scaled", type=check_scaled_bounds, default=0,
                    help="scaled value to downsample to")
    add_num_arg(sp, 0)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.set_defaults(subfunc="downsample")

    # fileinfo / summarize
    for name in ("fileinfo", "summarize"):
        sp = ssub.add_parser(name)
        sp.add_argument("path")
        _common(sp, from_file=False)
        sp.add_argument("--rebuild-manifest", action="store_true",
                        help="forcibly rebuild the manifest")
        sp.add_argument("--json-out", action="store_true",
                        help="output JSON rather than text summary")
        sp.set_defaults(subfunc="fileinfo")

    # kmers
    sp = ssub.add_parser("kmers")
    sp.add_argument("--signatures", nargs="*", default=[])
    _common(sp)
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.add_argument("--sequences", nargs="+", required=True,
                    help="FASTA/FASTQ files with sequences")
    sp.add_argument("--save-kmers",
                    help="save k-mers and hash values to a CSV file")
    sp.add_argument("--save-sequences",
                    help="save sequences with matching hashes to a FASTA file")
    sp.add_argument("--translate", action="store_true",
                    help="translate DNA k-mers into amino acids (for protein, dayhoff, and hp sketches)")
    sp.add_argument("--check-sequence", action="store_true",
                    help="complain if input sequence is invalid")
    sp.set_defaults(subfunc="kmers")

    # export
    sp = ssub.add_parser("export")
    sp.add_argument("filename")
    _common(sp, from_file=False)
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output signature to this file (default stdout)")
    sp.add_argument("--md5", default=None,
                    help="select the signature with this md5 as query")
    add_ksize_arg(sp)
    add_moltype_args(sp)
    sp.set_defaults(subfunc="export")

    # import / ingest
    for name in ("import", "ingest"):
        sp = ssub.add_parser(name)
        sp.add_argument("filenames", nargs="+")
        sp.add_argument("-q", "--quiet", action="store_true",
                        help="suppress non-error output")
        sp.add_argument("--csv", action="store_true",
                        help="import in Mash CSV format")
        sp.add_argument("-o", "--output", metavar="FILE", default="-",
                        help="output signature to this file (default stdout)")
        sp.set_defaults(subfunc="ingest")

    # check
    sp = ssub.add_parser("check")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    add_pattern_args(sp)
    sp.add_argument("-o", "--output-missing",
                    help="output picklist with remaining unmatched entries to this file")
    sp.add_argument("-m", "--save-manifest-matching",
                    help="save a manifest of matching entries to this file")
    sp.add_argument("--fail-if-missing", action="store_true",
                    help="exit with an error code if any picklist values are not found")
    sp.add_argument("--no-require-manifest", action="store_true",
                    help="do not require a manifest; generate dynamically if needed")
    sp.add_argument("-F", "--manifest-format", default="csv",
                    choices=["csv", "sql"],
                    help="format of manifest output file; default is 'csv'")
    sp.add_argument("--abspath", "--use-absolute-paths", action="store_true",
                    default=None, help="convert all locations to absolute paths")
    sp.add_argument("--no-abspath", action="store_false", dest="abspath",
                    help="do not convert all locations to absolute paths")
    sp.add_argument("--relpath", "--use-relative-paths", action="store_true",
                    default=None,
                    help="convert all locations to paths relative to the output manifest")
    sp.add_argument("--no-relpath", action="store_false", dest="relpath",
                    help="do not convert all locations to paths relative to the output manifest")
    sp.set_defaults(subfunc="check")

    # collect
    sp = ssub.add_parser("collect")
    sp.add_argument("locations", nargs="*",
                    help="locations of input signatures")
    sp.add_argument("-o", "--output", required=True,
                    help="manifest output file")
    sp.add_argument("-q", "--quiet", action="store_true",
                    help="suppress non-error output")
    sp.add_argument("-d", "--debug", action="store_true",
                    help="provide debugging output")
    sp.add_argument("--from-file",
                    help="a text file containing a list of files to load signatures from")
    sp.add_argument("--no-require-manifest", action="store_true",
                    help="do not require a manifest; generate dynamically if needed")
    sp.add_argument("-F", "--manifest-format", default="sql",
                    choices=["csv", "sql"],
                    help="format of manifest output file; default is 'sql'")
    sp.add_argument("--merge-previous", action="store_true",
                    help="merge new manifests into existing output file")
    sp.add_argument("--abspath", "--use-absolute-paths", action="store_true",
                    default=None, help="convert all locations to absolute paths")
    sp.add_argument("--no-abspath", action="store_false", dest="abspath",
                    help="do not convert all locations to absolute paths")
    sp.add_argument("--relpath", "--use-relative-paths", action="store_true",
                    default=None,
                    help="convert all locations to paths relative to the output manifest")
    sp.add_argument("--no-relpath", action="store_false", dest="relpath",
                    help="do not convert all locations to paths relative to the output manifest")
    sp.set_defaults(subfunc="collect")

    # grep
    sp = ssub.add_parser("grep")
    sp.add_argument("pattern", help="search pattern (string/regex)")
    sp.add_argument("signatures", nargs="*")
    _common(sp)
    add_ksize_arg(sp)
    add_moltype_args(sp)
    add_picklist_args(sp)
    sp.add_argument("-v", "--invert-match", action="store_true",
                    help="select non-matching signatures")
    sp.add_argument("-i", "--ignore-case", action="store_true",
                    help="ignore case distinctions")
    sp.add_argument("-o", "--output", metavar="FILE", default="-",
                    help="output matching signatures to this file (default stdout)")
    sp.add_argument("--silent", "--no-signatures-output", action="store_true",
                    help="do not output signatures")
    sp.add_argument("-c", "--count", action="store_true",
                    help="only print a count of discovered signatures; implies --silent")
    sp.add_argument("--csv",
                    help="save manifest of matching signatures to this CSV file")
    sp.add_argument("--no-require-manifest", action="store_true",
                    help="do not require a manifest; generate dynamically if needed")
    sp.set_defaults(subfunc="grep")
