"""Entry-point plugin support: the port's copy of `sourmash_tpu/plugins.py`
(API parity: reference `src/sourmash/plugins.py` — groups
'sourmash.load_from', 'sourmash.save_to', 'sourmash.cli_script'). Group
names are kept identical so existing sourmash plugins register against the
port unchanged.

Entry points are collected once at import into module-level lists
(`_plugin_load_from` / `_plugin_save_to` / `_plugin_cli`), which tests and
embedders may replace (reference plugins.py:28-39).
"""

from __future__ import annotations

import argparse
import itertools

from .logging import debug_literal, error, notify, set_quiet

try:
    from importlib.metadata import entry_points
except ImportError:  # pragma: no cover
    entry_points = None

DEFAULT_LOAD_FROM_PRIORITY = 99
DEFAULT_SAVE_TO_PRIORITY = 99

_COMMON_FLAGS = (
    (("-q", "--quiet"), "suppress non-error output"),
    (("-d", "--debug"), "provide debugging output"),
)


def _get_entry_points(group):
    if entry_points is None:
        return []
    try:
        return list(entry_points(group=group))
    except TypeError:  # pragma: no cover - old API
        return list(entry_points().get(group, []))


_plugin_load_from = _get_entry_points("sourmash.load_from")
_plugin_save_to = _get_entry_points("sourmash.save_to")
_plugin_cli = _get_entry_points("sourmash.cli_script")
_plugin_cli_once = False


def _resolve_plugins(plugins, kind, default_priority):
    "Load each entry point, yielding (priority, name, target); skip broken."
    debug_literal(f"{kind} plugins: {plugins}")
    for plugin in plugins:
        try:
            target = plugin.load()
        except (ModuleNotFoundError, AttributeError) as e:
            debug_literal(
                f"plugins.{kind}_functions: got error loading {plugin.name}: {str(e)}"
            )
            continue
        yield getattr(target, "priority", default_priority), plugin.name, target


def get_load_from_functions():
    "Load the 'load_from' plugins and yield tuples (priority, name, fn)."
    yield from _resolve_plugins(
        _plugin_load_from, "load_from", DEFAULT_LOAD_FROM_PRIORITY
    )


def get_save_to_functions():
    "Load the 'save_to' plugins and yield tuples (priority, class)."
    resolved = _resolve_plugins(_plugin_save_to, "save_to", DEFAULT_SAVE_TO_PRIORITY)
    yield from ((priority, cls) for priority, _, cls in resolved)


class CommandLinePlugin:
    """Base class for CLI plugins (subcommands under 'sourmash scripts').

    Receives the already-created argparse subparser; adds the common
    -q/-d flags (reference plugins.py:91-112).
    """

    command = None
    description = None

    def __init__(self, parser):
        for flags, helptext in _COMMON_FLAGS:
            parser.add_argument(*flags, action="store_true", help=helptext)

    def main(self, args):
        set_quiet(args.quiet, args.debug)


def _first_load_failure(plugin):
    "Load a cli_script plugin; returns (cls_or_None, error message or None)."
    try:
        cls = plugin.load()
    except (ModuleNotFoundError, AttributeError):
        return None, (
            f"ERROR: cannot find or load module for cli_script plugin '{plugin.name}'"
        )
    if getattr(cls, "command", None) is None:
        return None, (
            f"ERROR: no command provided by cli_script plugin '{plugin.name}'"
            f" from {plugin.module}; skipping"
        )
    return cls, None


def get_cli_script_plugins():
    "Return CLI script plugin entry points that provide a command."
    global _plugin_cli_once

    usable = []
    for plugin in _plugin_cli:
        cls, problem = _first_load_failure(plugin)
        if cls is not None:
            usable.append(plugin)
        elif not _plugin_cli_once:  # report each problem once per process
            error(problem)

    _plugin_cli_once = True
    return usable


def get_cli_scripts_descriptions():
    "Yield one-line descriptions of CLI script plugins."
    for plugin in get_cli_script_plugins():
        script_cls = plugin.load()
        command = getattr(script_cls, "command")
        description = (getattr(script_cls, "description", "") or "").splitlines()
        summary = description[0] if description and description[0] else (
            f"(no description provided by plugin '{plugin.name}')"
        )
        yield f"sourmash scripts {command:16s} - {summary}"


# optional class attributes forwarded to add_parser()
_SUBPARSER_ATTRS = ("usage", "description", "epilog")


def add_cli_scripts(parser):
    "Create a subparser per CLI script plugin and instantiate the plugin."
    commands = {}
    for plugin in get_cli_script_plugins():
        script_cls = plugin.load()

        kwargs = {a: getattr(script_cls, a, None) for a in _SUBPARSER_ATTRS}
        kwargs["formatter_class"] = getattr(
            script_cls, "formatter_class", argparse.HelpFormatter
        )
        subparser = parser.add_parser(script_cls.command, **kwargs)
        debug_literal(
            f"cls_script plugin '{plugin.name}' adding command '{script_cls.command}'"
        )
        commands[script_cls.command] = script_cls(subparser)

    return commands


_PLUGIN_ROW = "{:<20s} {:<30s} {:<5s} {:<20s}"


def list_all_plugins():
    "Print a table of installed plugins (reference plugins.py:188-209)."
    plugins = list(itertools.chain(_plugin_load_from, _plugin_save_to, _plugin_cli))
    if not plugins:
        notify("\n(no plugins detected)\n")

    header = _PLUGIN_ROW.format(
        "plugin type", "from python module", "v", "entry point name"
    )
    rule = _PLUGIN_ROW.format("-" * 20, "-" * 30, "-" * 5, "-" * 20)
    for line in ("", "the following plugins are installed:", "", header, rule):
        notify(line)

    for plugin in plugins:
        try:
            version = plugin.dist.version
        except Exception:
            version = "?"
        notify(_PLUGIN_ROW.format(plugin.group, plugin.module, version, plugin.name))
