"""Entry point: `python -m sourmash_tpu_torch sketch dna ...`, `... gather
query.sig db.zip` and so on (counterpart of `sourmash_tpu/__main__.py`;
`sketch`, `compare`, `search`, `gather`, `multigather`, `prefetch`,
`index`, `sbt_combine`, `migrate`, `storage convert`, `sig`, `lca` and
`tax` are ported)."""

from __future__ import annotations

import importlib
import sys

_COMMANDS = (
    "compare", "search", "gather", "multigather", "prefetch", "index",
    "sbt_combine", "migrate",
)

# `lca` subcommand -> (module under lca/, function)
_LCA_COMMANDS = {
    "lca_index": ("command_index", "index"),
    "lca_classify": ("command_classify", "classify"),
    "lca_summarize": ("command_summarize", "summarize_main"),
    "lca_rankinfo": ("command_rankinfo", "rankinfo_main"),
    "lca_compare_csv": ("command_compare_csv", "compare_csv"),
}


def main(arglist=None):
    from . import cli, command_sketch

    args = cli.parse_args(arglist)
    cmd = getattr(args, "cmd", None)
    if cmd in _COMMANDS:
        from . import commands

        return getattr(commands, cmd)(args)
    if cmd == "storage":
        from .sbt import convert_cmd

        return convert_cmd(args.sbt, args.backend)
    if cmd in ("sig", "tax"):
        subfunc = getattr(args, "subfunc", None)
        if subfunc is None:
            cli.get_parser().print_help()
            return 1
        if cmd == "sig":
            from .sig import __main__ as sig_main

            return getattr(sig_main, subfunc)(args)
        from .tax import __main__ as tax_main

        return getattr(tax_main, subfunc[len("tax_"):])(args)
    if cmd == "lca":
        target = _LCA_COMMANDS.get(getattr(args, "subfunc", None))
        if target is None:
            cli.get_parser().print_help()
            return 1
        module = importlib.import_module(f".lca.{target[0]}", __package__)
        return getattr(module, target[1])(args)
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
