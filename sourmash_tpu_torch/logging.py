"""stderr/stdout logging utilities (API parity: reference
`src/sourmash/logging.py` — notify/error/debug to stderr, print_results to
stdout, global quiet/debug flags)."""

from __future__ import annotations

import sys

_quiet = False
_debug = False


def set_quiet(val, print_debug=False):
    global _quiet, _debug
    _quiet = bool(val)
    _debug = bool(print_debug)


def print_results(s="", *args, **kwargs):
    "Print results to stdout, suppressed by -q (reference logging.py:14-19)."
    if _quiet:
        return
    print(s.format(*args, **kwargs), file=sys.stdout, end=kwargs.get("end", "\n"))
    sys.stdout.flush()


def notify(s="", *args, **kwargs):
    "Print status to stderr unless quiet."
    if not _quiet:
        print(s.format(*args, **kwargs), file=sys.stderr, end=kwargs.get("end", "\n"))
        sys.stderr.flush()


def error(s="", *args, **kwargs):
    "Print error to stderr, always."
    print(s.format(*args, **kwargs), file=sys.stderr)
    sys.stderr.flush()


def debug(s="", *args, **kwargs):
    "Print debug messages to stderr if debug output enabled."
    if _debug:
        print(s.format(*args, **kwargs), file=sys.stderr)
        sys.stderr.flush()


def debug_literal(s="", *args, **kwargs):
    if _debug:
        print(s, file=sys.stderr)
        sys.stderr.flush()
