"""Shared argparse flag groups, expressed as data: the port's copy of
`sourmash_tpu/cli/utils.py`.

Flag/help text is the CLI parity surface (reference
`src/sourmash/cli/utils.py` defines the same options), but the mechanics
here are table-driven: each moltype is one row of `_MOLTYPE_FLAGS` rendered
by `_bool_pair`, and the tax output/rank rules live in small rule tables.
"""

from __future__ import annotations

import argparse

from ..sourmash_args import check_scaled_bounds, check_num_bounds


def _bool_pair(parser, names, dest, on_help, off_help, default):
    "One on/off argparse flag pair sharing a dest (e.g. --hp / --no-hp)."
    parser.add_argument(
        *[f"--{n}" for n in names], dest=dest, action="store_true",
        default=None, help=on_help,
    )
    parser.add_argument(
        *[f"--no-{n}" for n in names], dest=dest, action="store_false",
        help=off_help,
    )
    parser.set_defaults(**{dest: default})


# (flag aliases, dest, on-help, off-help, default)
_MOLTYPE_FLAGS = (
    (("protein",), "protein",
     "choose a protein signature; by default, a nucleotide signature is used",
     "do not choose a protein signature", False),
    (("dayhoff",), "dayhoff",
     "choose Dayhoff-encoded amino acid signatures",
     "do not choose Dayhoff-encoded amino acid signatures", False),
    (("hp", "hydrophobic-polar"), "hp",
     "choose hydrophobic-polar-encoded amino acid signatures",
     "do not choose hydrophobic-polar-encoded amino acid signatures", False),
    (("dna", "rna", "nucleotide"), "dna",
     "choose a nucleotide signature (default: True)",
     "do not choose a nucleotide signature", None),
)


def add_moltype_args(parser):
    for names, dest, on_h, off_h, default in _MOLTYPE_FLAGS:
        _bool_pair(parser, names, dest, on_h, off_h, default)


def add_construct_moltype_args(parser):
    add_moltype_args(parser)
    parser.set_defaults(dna=True)


def add_ksize_arg(parser, *, default=None):
    "Add -k/--ksize with the given default."
    tail = f"default={default}" if default else "no default."
    parser.add_argument(
        "-k", "--ksize", metavar="K", default=default, type=int,
        help=f"k-mer size to select; {tail}",
    )


def range_limited_float_type(arg):
    "Float in [0, 1] for argparse."
    try:
        f = float(arg)
    except ValueError:
        raise argparse.ArgumentTypeError(
            "\n\tERROR: Must be a floating point number."
        )
    if not 0 <= f <= 1:
        raise argparse.ArgumentTypeError(
            "\n\tERROR: Argument must be >0 and <1."
        )
    return f


def add_tax_threshold_arg(parser, containment_default=0.1, ani_default=None):
    for flags, dflt, what in (
        (("--containment-threshold",), containment_default,
         "minimum containment threshold for classification"),
        (("--ani-threshold", "--aai-threshold"), ani_default,
         "minimum ANI threshold (nucleotide gather) or AAI threshold "
         "(protein gather) for classification"),
    ):
        parser.add_argument(
            *flags, default=dflt, type=range_limited_float_type,
            help=f"{what}; default={dflt}",
        )


def add_picklist_args(parser):
    parser.add_argument(
        "--picklist", default=None,
        help="select signatures based on a picklist, i.e. 'file.csv:colname:coltype'",
    )
    parser.add_argument(
        "--picklist-require-all", default=False, action="store_true",
        help="require that all picklist values be found or else fail",
    )


def add_pattern_args(parser):
    for flag, what in (
        ("--include-db-pattern", "search only signatures that match"),
        ("--exclude-db-pattern", "search only signatures that do not match"),
    ):
        parser.add_argument(
            flag, default=None,
            help=f"{what} this pattern in name, filename, or md5",
        )


def add_scaled_arg(parser, default=None):
    parser.add_argument(
        "--scaled", metavar="FLOAT", type=check_scaled_bounds,
        help="downsample to this scaled; value should be between 100 and 1e6",
    )


def add_num_arg(parser, default=0):
    parser.add_argument(
        "-n", "--num-hashes", "--num", metavar="N", type=check_num_bounds,
        default=default,
        help="num value should be between 50 and 50000",
    )


_STANDARD_RANKS = (
    "strain", "species", "genus", "family", "order", "class",
    "phylum", "superkingdom",
)


def add_rank_arg(parser):
    parser.add_argument(
        "-r", "--rank", "--position", "--lin-position",
        help="Classify to this rank (tax genome) or summarize taxonomy at this"
             " rank and above (tax metagenome). Choices: 'strain', 'species',"
             " 'genus', 'family', 'order', 'class', 'phylum', 'superkingdom'"
             " or an integer LIN position",
    )


def check_rank(args):
    "Check that --rank matches the selected taxonomy (LIN => integer position)."
    if getattr(args, "lins", False):
        if args.rank.isdigit():
            return str(args.rank)
        raise argparse.ArgumentTypeError(
            f"Invalid '--rank'/'--position' input: '{args.rank}'. '--lins' is specified. Rank must be an integer corresponding to a LIN position."
        )
    if args.rank in _STANDARD_RANKS:
        return args.rank
    raise argparse.ArgumentTypeError(
        f"Invalid '--rank'/'--position' input: '{args.rank}'. Please choose: 'strain', 'species', 'genus', 'family', 'order', 'class', 'phylum', 'superkingdom'"
    )


def check_tax_outputs(
    args,
    rank_required=["krona"],
    incompatible_with_lins=None,
    use_lingroup_format=False,
):
    """Validate/normalize tax output-format combinations (reference
    `cli/utils.py:227-271`). Rules, applied in order:

    1. formats in `rank_required` demand --rank;
    2. under --lins: no `incompatible_with_lins` formats, and a --lingroup
       CSV turns on the lingroup format (where supported) — while the
       lingroup format without --lingroup, or any lingroup use without
       --lins, is an error;
    3. several formats can't share stdout;
    4. no format at all means csv_summary.
    """
    fmts = args.output_format
    lingroup_csv = getattr(args, "lingroup", None)

    if not args.rank and any(f in rank_required for f in fmts):
        raise ValueError(
            f"Rank (--rank) is required for {', '.join(rank_required)} output formats."
        )

    if args.lins:
        bad = [f for f in (incompatible_with_lins or ()) if f in fmts]
        if bad:
            raise ValueError(
                f"The following outputs are incompatible with '--lins': : {', '.join(incompatible_with_lins)}"
            )
        if lingroup_csv:
            if use_lingroup_format and "lingroup" not in fmts:
                fmts.append("lingroup")
        elif "lingroup" in fmts:
            raise ValueError(
                "Must provide lingroup csv via '--lingroup' in order to output a lingroup report."
            )
    elif lingroup_csv or "lingroup" in fmts:
        raise ValueError(
            "Must enable LIN taxonomy via '--lins' in order to use lingroups."
        )

    if len(fmts) > 1 and args.output_base == "-":
        raise ValueError(
            f"Writing to stdout is incompatible with multiple output formats {fmts}"
        )
    if not fmts:
        fmts = args.output_format = ["csv_summary"]
    return fmts
