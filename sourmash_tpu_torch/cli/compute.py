"""'sourmash compute' CLI registration (legacy; use 'sketch'): the port's
copy of `sourmash_tpu/cli/compute.py`.

Parity: reference `src/sourmash/cli/compute.py` — exposes `subparser` and
`main` at module level so embedders (and the reference test suite,
tests/test_sourmash_compute.py:21) can register/run the command directly.
The argument definitions live in cli/__init__.py:_add_compute.
"""

from __future__ import annotations


def subparser(subparsers):
    from . import _add_compute

    _add_compute(subparsers)


def main(args):
    from ..command_compute import compute

    return compute(args)
