"""Entry point: `python -m sourmash_tpu_torch sketch dna ...`, `... gather
query.sig db.zip` and so on (counterpart of `sourmash_tpu/__main__.py`;
`sketch`, `compare`, `search`, `gather`, `multigather`, `prefetch` and
`index -F revindex` are ported)."""

from __future__ import annotations

import sys

_COMMANDS = ("compare", "search", "gather", "multigather", "prefetch", "index")


def main(arglist=None):
    from . import cli, command_sketch

    args = cli.parse_args(arglist)
    cmd = getattr(args, "cmd", None)
    if cmd in _COMMANDS:
        from . import commands

        return getattr(commands, cmd)(args)
    if cmd != "sketch":
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
