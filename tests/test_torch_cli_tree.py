"""The port's argparse tree against the JAX package's, command path by
command path (a path is the names from the top, aliases included:
`("sig", "cat")`, `("signature", "cat")`, `("tax", "metagenome")`).

Every path the port has must take the same options as the reference's:
option strings, dest, default, nargs, action, type and choices of each
argument, in order. The port lacks none of the reference's 96 paths
(`NOT_PORTED` is empty). Only parsers are built.
"""

import argparse

import pytest

from sourmash_tpu.cli import get_parser as jax_parser
from sourmash_tpu_torch.cli import get_parser as torch_parser

NOT_PORTED = set()


def _paths(parser, prefix=()):
    "{path: parser} of every command under `parser`, the root as ()."
    out = {prefix: parser}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_paths(sub, prefix + (name,)))
    return out


def _type_name(t):
    return None if t is None else getattr(t, "__name__", repr(t))


def _options(parser, keep=None):
    """Each argument's option strings, dest, default, nargs, action, type and
    choices; a subcommand group's names in order, those not in `keep` left out."""
    out = []
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out.append(("subcommands", a.dest,
                        tuple(n for n in a.choices if keep is None or n in keep)))
            continue
        choices = tuple(a.choices) if a.choices is not None else None
        out.append((tuple(a.option_strings), a.dest, repr(a.default), a.nargs,
                    type(a).__name__, _type_name(a.type), choices, a.required))
    return out


@pytest.fixture(scope="module")
def trees():
    return _paths(jax_parser()), _paths(torch_parser())


def test_missing_paths_are_the_unported_commands(trees):
    jax, torch = trees
    assert not set(torch) - set(jax)
    missing = set(jax) - set(torch)
    assert {p[:1] for p in missing} == NOT_PORTED
    assert missing == NOT_PORTED  # none of them has a subcommand of its own
    assert len(jax) - 1 == len(torch) - 1 == 96  # the root () aside


def test_sig_and_tax_paths_are_all_there(trees):
    _, torch = trees
    sig = {p[1] for p in torch if len(p) == 2 and p[0] == "sig"}
    assert len(sig) == 23 and {"summarize", "import", "kmers"} <= sig
    assert sig == {p[1] for p in torch if len(p) == 2 and p[0] == "signature"}
    tax = {p[1] for p in torch if len(p) == 2 and p[0] == "tax"}
    assert tax == {"metagenome", "genome", "annotate", "prepare", "grep", "summarize"}
    assert tax == {p[1] for p in torch if len(p) == 2 and p[0] == "taxonomy"}


def test_every_ported_path_takes_the_reference_options(trees):
    jax, torch = trees
    assert len(torch) > 80
    for path, parser in sorted(torch.items()):
        ported = {p[len(path)] for p in torch if len(p) == len(path) + 1 and p[:-1] == path}
        assert _options(parser) == _options(jax[path], keep=ported), path
