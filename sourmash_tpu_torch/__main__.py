"""Entry point: `python -m sourmash_tpu_torch sketch dna ...`, `... gather
query.sig db.zip` and so on (counterpart of `sourmash_tpu/__main__.py`;
every command of it is ported).

SOURMASH_TORCH_PROFILE=DIR wraps the whole command in `torch.profiler` and
writes a Chrome trace into DIR (the counterpart of SOURMASH_TPU_PROFILE):
CPU activity always, and CUDA activity when the command's device
(`ops.resolve_device()`) is CUDA."""

from __future__ import annotations

import importlib
import sys

PROFILE_ENV = "SOURMASH_TORCH_PROFILE"

# command -> function of the same name in commands.py
_COMMANDS = (
    "compare", "plot", "search", "gather", "multigather", "prefetch", "categorize",
    "index", "info", "import_csv", "sbt_combine", "migrate", "watch",
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
    import os

    trace_dir = os.environ.get(PROFILE_ENV)
    if trace_dir:
        return _profiled(trace_dir, arglist)
    return _dispatch(arglist)


def _profiled(trace_dir, arglist):
    """The command under torch.profiler, its Chrome trace written into
    `trace_dir` as `sourmash_torch.<pid>.<ns>.pt.trace.json`, also when the
    command fails. CUDA activity is recorded when the command's device is
    CUDA; a profiler that cannot record it raises rather than write a trace
    without the kernels."""
    import os
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    from .ops import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device().type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                f"{PROFILE_ENV} is set and the command runs on CUDA, but this "
                f"torch.profiler cannot record CUDA activity"
            )
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"sourmash_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                return _dispatch(arglist)
            finally:
                if ProfilerActivity.CUDA in activities:
                    torch.cuda.synchronize()
    finally:  # after the profile has stopped, also when the command failed
        prof.export_chrome_trace(path)


def _dispatch(arglist=None):
    from . import cli, command_sketch

    args = cli.parse_args(arglist)
    cmd = getattr(args, "cmd", None)
    if cmd in _COMMANDS:
        from . import commands

        return getattr(commands, cmd)(args)
    if cmd == "compute":
        from .command_compute import compute

        return compute(args)
    if cmd in ("scripts", "ext"):
        obj = cli._scripts_extension_dict.get(getattr(args, "subcmd", None))
        if obj is None:
            cli.get_parser().parse_args([cmd, "--help"])
            return 1
        return obj.main(args)
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
