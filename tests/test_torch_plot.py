"""`sourmash plot` in the port against the JAX package, on the CPU.

Every case runs both packages' `main`s in this process from one directory
with a fresh copy of the inputs: a `compare` matrix of sketches made with
numpy from a seed, with its labels file and label CSV. Exit codes, stdout,
stderr (the package name aside) and every file are compared byte for byte:
the PNGs, and the PDFs with SOURCE_DATE_EPOCH set so that both runs write
the same metadata. matplotlib is imported by the command, not by the port's
import (the card's machine has none).
"""

import numpy as np
import pytest

import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation
from torch_cli_parity import assert_same, both, isolated, setup_run  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

SCALED = 1000


@pytest.fixture(autouse=True)
def _close_figures():
    "The commands leave their figures open in pyplot: close them after each case."
    yield
    import matplotlib.pyplot

    matplotlib.pyplot.close("all")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    "A compare matrix of 9 sketches in 3 clades, its labels, and a scaled-up copy."
    rng = np.random.default_rng(606)
    d = tmp_path_factory.mktemp("plot")
    params = dict(ksize=31, moltype="DNA", num=0, scaled=SCALED, seed=42, track_abundance=False)
    sigs = []
    for clade in range(3):
        core = rng.integers(0, (1 << 64) // SCALED, size=400, dtype=np.uint64)
        for i in range(3):
            fresh = rng.integers(0, (1 << 64) // SCALED, size=int(rng.integers(100, 300)),
                                 dtype=np.uint64)
            mins = np.unique(np.r_[rng.permutation(core)[: int(rng.integers(150, 400))], fresh])
            sigs.append(sourmash_tpu_torch.signature_from_arrays(
                params, mins, name=f"genome {3 * clade + i} clade {clade}"))
    with SaveSignaturesToLocation(str(d / "db.zip")) as save:
        for ss in sigs:
            save.add(ss)
    assert setup_run(jax_main, ["compare", "db.zip", "-o", "cmp", "--labels-to", "labels.csv",
                                "-q"], d) in (None, 0)
    D = np.load(d / "cmp")
    np.save(d / "big.npy", D * 3)
    (d / "big.npy.labels.txt").write_text((d / "cmp.labels.txt").read_text())
    (d / "names.txt").write_text("".join(f"sample {i}\n" for i in range(len(D))))
    (d / "short.txt").write_text("one\ntwo\n")
    return d


CASES = {
    "plot": [["plot", "cmp"]],
    "--labels --csv": [["plot", "cmp", "--labels", "--csv", "out.csv"]],
    "--indices": [["plot", "cmp", "--indices"]],
    "--no-labels": [["plot", "cmp", "--no-labels", "--no-indices"]],
    "--labeltext": [["plot", "cmp", "--labeltext", "names.txt", "--csv", "out.csv"]],
    "--labels-from": [["plot", "cmp", "--labels-from", "labels.csv"]],
    "--subsample": [["plot", "cmp", "--subsample", "5", "--subsample-seed", "3",
                     "--csv", "out.csv"]],
    "--vmin --vmax": [["plot", "cmp", "--vmin", "0.2", "--vmax", "0.8"]],
    "--output-dir": [["plot", "cmp", "--output-dir", "plots", "-q"]],
    "--pdf": [["plot", "cmp", "--pdf", "--labels"]],
    "-f on a matrix past 1": [["plot", "big.npy", "-f", "--csv", "out.csv"]],
    "a matrix past 1: refused": [["plot", "big.npy"]],
    "--labeltext and --labels-from: refused": [["plot", "cmp", "--labeltext", "names.txt",
                                                 "--labels-from", "labels.csv"]],
    "labels not the matrix's size: refused": [["plot", "cmp", "--labeltext", "short.txt"]],
}


@pytest.mark.parametrize("case", list(CASES))
def test_plot_is_identical(world, case, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    outputs = both(world, CASES[case], tmp_path, monkeypatch, capsys)
    assert_same(outputs)
    (rc,), out, err, files = outputs["torch"]
    if "refused" in case:
        assert rc not in (None, 0), err
        return
    assert rc in (None, 0), err
    ext = ".pdf" if "--pdf" in CASES[case][0] else ".png"
    made = [name for name in files if name.endswith(ext)]
    assert len(made) == 3, sorted(files)
    if "--csv" in CASES[case][0]:
        assert files["out.csv"].count(b"\n") >= 5


def test_port_import_leaves_matplotlib_out():
    "Importing the port's plotting module does not import matplotlib."
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, sourmash_tpu_torch.fig, sourmash_tpu_torch.commands\n"
            "print(any(m.split('.')[0] in ('matplotlib', 'pylab') for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=repo, env=dict(os.environ, PYTHONPATH=repo)).stdout
    assert out.strip() == "False"
