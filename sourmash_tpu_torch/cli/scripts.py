"""'sourmash scripts' (alias 'ext') — CLI plugin/extension commands: the
port's copy of `sourmash_tpu/cli/scripts.py`.

Parity: reference `src/sourmash/cli/scripts/__init__.py`. The module is
decorated with the loaded extension objects so `sourmash scripts foo`
resolves attribute `scripts.foo` to the plugin instance.
"""

from argparse import SUPPRESS, RawDescriptionHelpFormatter

_extension_dict = {}


def __getattr__(name):
    if name in _extension_dict:
        return _extension_dict[name]
    raise AttributeError(name)


def subparser(subparsers):
    from .. import plugins

    p = subparsers.add_parser(
        "scripts",
        usage=SUPPRESS,
        formatter_class=RawDescriptionHelpFormatter,
        aliases=["ext"],
    )
    p.set_defaults(cmd="scripts")

    descrs = list(plugins.get_cli_scripts_descriptions())
    description = "\n".join(descrs) if descrs else "(No script plugins detected!)"

    s = p.add_subparsers(
        title="available plugin/extension commands",
        dest="subcmd",
        metavar="subcmd",
        help=SUPPRESS,
        description=description,
    )
    _extension_dict.update(plugins.add_cli_scripts(s))
