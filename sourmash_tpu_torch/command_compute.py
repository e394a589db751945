"""Legacy 'sourmash compute' command: the port's copy of
`sourmash_tpu/command_compute.py`.

Behavior parity: reference `src/sourmash/command_compute.py:28-140` —
option validation, moltype combinations (DNA and/or protein-family in one
run), the v4 protein-ksize warning (raw ksizes divisible by 3), and the
merge/individual split. The console strings are the parity surface; the
flow here is staged: scrub args -> pick the moltype plan from a combo
table -> final checks -> dispatch. Sketching reuses the batched device
path shared with 'sketch' (`command_sketch.py`): K1/K2 for DNA, K3 for
protein, dayhoff and hp on CUDA.
"""

from __future__ import annotations

import random
import sys

from .command_sketch import (
    ComputeParameters,
    _compute_individual,
    _compute_merged,
    signature_from_params,
)
from .logging import error, notify, set_quiet


def _fail(msg, *fmt):
    error(msg, *fmt)
    sys.exit(-1)


# first row whose flags are all set decides the plan: (flags, message,
# signatures-per-ksize)
_MOLTYPE_COMBOS = (
    (("dna", "protein"), "Computing both nucleotide and protein signatures.", 2),
    (("dna", "dayhoff"), "Computing both nucleotide and Dayhoff-encoded protein signatures.", 2),
    (("dna", "hp"), "Computing both nucleotide and hp-encoded protein signatures.", 2),
    (("dna",), "Computing only nucleotide (and not protein) signatures.", 1),
    (("protein",), "Computing only protein (and not nucleotide) signatures.", 1),
    (("dayhoff",), "Computing only Dayhoff-encoded protein (and not nucleotide) signatures.", 1),
    (("hp",), "Computing only hp-encoded protein (and not nucleotide) signatures.", 1),
)


def _scrub_args(args):
    "Pre-flight: license, protein-input override, scaled/num interactions."
    if args.license != "CC0":
        _fail("error: sourmash only supports CC0-licensed signatures. sorry!")

    if args.input_is_protein and args.dna:
        notify("WARNING: input is protein, turning off nucleotide hashing")
        args.dna = False
        args.protein = True

    if args.scaled:
        if args.scaled < 1:
            _fail("ERROR: --scaled value must be >= 1")
        if args.scaled != round(args.scaled, 0):
            _fail("ERROR: --scaled value must be integer value")
        if args.scaled >= 1e9:
            notify("WARNING: scaled value is nonsensical!? Continuing anyway.")
        if args.num_hashes != 0:
            notify("setting num_hashes to 0 because --scaled is set")
            args.num_hashes = 0


def _plan_signatures(args):
    "Announce the moltype combination; return total signatures per input."
    for flags, message, per_ksize in _MOLTYPE_COMBOS:
        if all(getattr(args, f) for f in flags):
            notify(message)
            num_sigs = per_ksize * len(args.ksizes)
            break
    else:
        num_sigs = 0

    if args.protein or args.dayhoff or args.hp:
        notify("")
        notify(
            "WARNING: you are using 'compute' to make a protein/dayhoff/hp signature,"
        )
        notify("WARNING: but the meaning of ksize has changed in 4.0. Please see the")
        notify("WARNING: migration guide to sourmash v4.0 at http://sourmash.rtfd.io/")
        notify("")
        bad_ksizes = [str(k) for k in args.ksizes if k % 3 != 0]
        if bad_ksizes:
            error("protein ksizes must be divisible by 3, sorry!")
            _fail("bad ksizes: {}", ", ".join(bad_ksizes))
    return num_sigs


def compute(args):
    "Compute signature(s) for one or more sequence files."
    set_quiet(args.quiet)
    _scrub_args(args)

    notify("computing signatures for files: {}", ", ".join(args.filenames))
    if args.randomize:
        notify("randomizing file list because of --randomize")
        random.shuffle(args.filenames)
    notify("Computing signature for ksizes: {}", str(args.ksizes))

    num_sigs = _plan_signatures(args)
    notify("Computing a total of {} signature(s) for each input.", num_sigs)

    if num_sigs == 0:
        _fail("...nothing to calculate!? Exiting!")
    if args.merge and not args.output:
        _fail("ERROR: must specify -o with --merge")
    if args.output and args.output_dir:
        _fail("ERROR: --output-dir doesn't make sense with -o/--output")
    if args.track_abundance:
        notify("Tracking abundance of input k-mers.")

    factory = _signatures_for_compute_factory(args)
    (_compute_merged if args.merge else _compute_individual)(args, factory)


class _signatures_for_compute_factory:
    "Build signatures on demand, based on args input to 'compute'."

    def __init__(self, args):
        self.args = args

    def __call__(self):
        a = self.args
        params = ComputeParameters(
            ksizes=a.ksizes, seed=a.seed, protein=a.protein,
            dayhoff=a.dayhoff, hp=a.hp, dna=a.dna, num_hashes=a.num_hashes,
            track_abundance=a.track_abundance, scaled=int(a.scaled),
        )
        return [signature_from_params(params)]
