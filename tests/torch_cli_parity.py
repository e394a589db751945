"""Shared harness of the CLI parity tests of the last slice
(test_torch_compute.py, test_torch_misc_cli.py, test_torch_plot.py,
test_torch_plugins.py): run argv lists through both packages' `main`s, in
this process, from one directory holding a fresh copy of the inputs, and
return what each left behind."""

import os
import shutil

import pytest

from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.cli import SourmashParser as JaxParser
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.cli import SourmashParser as TorchParser

MAINS = (("jax", jax_main), ("torch", torch_main))


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    """The port on the CPU, its flat-view cache in the test's directory, the
    citation out of every case (it goes out once a process and package), and
    the quiet and debug flags off: `plot` and `info` leave them as an
    earlier command in the process set them."""
    from sourmash_tpu import logging as jax_logging
    from sourmash_tpu_torch import logging as torch_logging

    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "_torch_viewcache"))
    for parser in (JaxParser, TorchParser):
        monkeypatch.setattr(parser, "_citation_printed", True)
    for logging in (jax_logging, torch_logging):
        monkeypatch.setattr(logging, "_quiet", False)
        monkeypatch.setattr(logging, "_debug", False)


def setup_run(main, argv, cwd):
    """A command run to make a test's inputs (outside `isolated`): from `cwd`,
    with both packages' citation and quiet and debug flags put back after
    it, so that no later test in the process sees them changed."""
    from sourmash_tpu import logging as jax_logging
    from sourmash_tpu_torch import logging as torch_logging

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        for parser in (JaxParser, TorchParser):
            mp.setattr(parser, "_citation_printed", parser._citation_printed)
        for logging in (jax_logging, torch_logging):
            mp.setattr(logging, "_quiet", logging._quiet)
            mp.setattr(logging, "_debug", logging._debug)
        return main(list(argv))


def snapshot(root):
    "{relative path: bytes} of every file under root."
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fp:
                out[os.path.relpath(path, root)] = fp.read()
    return out


def run(main, argv):
    "The exit code, or the type and text of the exception that ended the command."
    try:
        return main(list(argv))
    except SystemExit as exc:
        return exc.code
    except Exception as exc:  # noqa: BLE001 - both packages must raise alike
        return f"{type(exc).__name__}: {exc}"


def both(inputs, argvs, tmp_path, monkeypatch, capsys, setup=None):
    """Run each argv list in turn through both mains, each package in a fresh
    copy of `inputs` at the same path (after `setup(tag)`, if given);
    {tag: (exit codes, stdout, stderr with the package name aside, files)}."""
    outputs = {}
    for tag, main in MAINS:
        work = tmp_path / "run"
        if work.exists():
            shutil.rmtree(work)
        shutil.copytree(inputs, work)
        monkeypatch.chdir(work)
        if setup is not None:
            setup(tag)
        capsys.readouterr()
        rcs = [run(main, argv) for argv in argvs]
        cap = capsys.readouterr()
        err = cap.err.replace("sourmash_tpu_torch", "sourmash_tpu")
        outputs[tag] = (rcs, cap.out, err, snapshot(work))
    return outputs


def assert_same(outputs):
    "Exit codes, stdout, stderr and every file equal, byte for byte."
    for i, what in enumerate(("exit codes", "stdout", "stderr")):
        got, want = outputs["torch"][i], outputs["jax"][i]
        if isinstance(got, str) and got != want:
            import difflib

            diff = difflib.unified_diff(want.splitlines(), got.splitlines(), "jax", "torch",
                                        lineterm="")
            raise AssertionError(f"{what} differs:\n" + "\n".join(list(diff)[:60]))
        assert got == want, what
    files, want = outputs["torch"][3], outputs["jax"][3]
    assert files.keys() == want.keys()
    for name in files:
        assert files[name] == want[name], name
