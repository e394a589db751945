"""Entry point: `python -m sourmash_tpu_torch sketch dna ...` or
`... gather query.sig db.zip` (counterpart of `sourmash_tpu/__main__.py`;
`sketch` and `gather` are ported)."""

from __future__ import annotations

import sys


def main(arglist=None):
    from . import cli, command_sketch

    args = cli.parse_args(arglist)
    if getattr(args, "cmd", None) == "gather":
        from . import commands

        return commands.gather(args)
    if getattr(args, "cmd", None) != "sketch":
        cli.get_parser().print_help()
        return 1
    subcmd = getattr(args, "subcmd", None)
    if subcmd in ("dna", "rna", "nucleotide", "nt"):
        return command_sketch.dna(args)
    if subcmd in ("protein", "aa", "prot"):
        return command_sketch.protein(args)
    if subcmd == "translate":
        return command_sketch.translate(args)
    if subcmd == "fromfile":
        return command_sketch.fromfile(args)
    cli.get_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main() or 0)
