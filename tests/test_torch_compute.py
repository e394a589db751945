"""`sourmash compute` (legacy sketching) in the port against the JAX
package, on the CPU (SOURMASH_TORCH_DEVICE=cpu: the kernels run their plain
versions).

Every case runs `python -m sourmash_tpu_torch compute ...` and `python -m
sourmash_tpu compute ...` (both `main`s, in this process) from one directory
with a fresh copy of the inputs, and compares exit codes, stdout, stderr
(the package name aside) and every file, byte for byte. The inputs are made
with numpy from a seed: a DNA FASTA with one record of 2^16 bytes or more
(the device branch: the port's plain K1/K2 against the JAX package's Pallas
kernels in interpret mode, SOURMASH_PALLAS=1) and short ones, which the
moltype rows, `--merge` and `--track-abundance` read; DNA files of short
records for the other cases (interpret mode costs seconds a shape); and a
protein FASTA. Each of the 7 rows of `_MOLTYPE_COMBOS` runs, and
`--merge`, `--singleton`, `--output-dir`, `--track-abundance`,
`--input-is-protein`, `--randomize` (with `random` seeded alike for both
runs), `--name-from-first`, `--check-sequence` and the error exits.
"""

import random

import numpy as np
import pytest

from sourmash_tpu import command_compute as jax_compute
from sourmash_tpu.ops import sketch as jax_sketch
from sourmash_tpu_torch import command_compute as torch_compute
from sourmash_tpu_torch.ops import cuda_sketch
from torch_cli_parity import assert_same, both, isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
LONG_DNA = (1 << 16) + 3_000  # past minhash._DEVICE_MIN_LEN


def _fasta(path, records):
    with open(path, "w") as fp:
        for name, seq in records:
            fp.write(f">{name}\n{seq}\n")


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    rng = np.random.default_rng(2310)
    d = tmp_path_factory.mktemp("compute")

    def dna(n):
        return rng.choice(ACGT, size=n).tobytes().decode()

    long1 = dna(LONG_DNA)
    _fasta(d / "a.fa", [("long1 first record", long1), ("s1", dna(3_000)), ("s2", dna(800))])
    _fasta(d / "b.fa", [("b1 of b", dna(2_500)), ("b2", long1[1_000:4_000] + dna(600))])
    _fasta(d / "c.fa", [("c1", dna(1_200))])
    _fasta(d / "d.fa", [("d1 of d", dna(900)), ("d2", dna(1_700))])
    _fasta(d / "bad.fa", [("bad", dna(500) + "X" + dna(500))])
    _fasta(d / "prot.faa", [(f"p{i}", rng.choice(AA, size=int(n)).tobytes().decode())
                            for i, n in enumerate(rng.integers(200, 900, size=4))])
    (d / "empty.fa").write_text("")
    (d / "outdir").mkdir()
    return d


SHORT = ["-k", "21,30", "--scaled", "100"]

# case -> argv lists run in turn (exit codes compared too)
CASES = {
    # the 7 rows of _MOLTYPE_COMBOS, each on the long record's file
    "dna and protein": [["compute", "a.fa", "--protein", *SHORT]],
    "dna and dayhoff": [["compute", "a.fa", "--dayhoff", *SHORT]],
    "dna and hp": [["compute", "a.fa", "--hp", *SHORT]],
    "dna only, num=500 default": [["compute", "a.fa", "-k", "21,31"]],
    "protein only": [["compute", "a.fa", "--no-dna", "--protein", *SHORT]],
    "dayhoff only": [["compute", "a.fa", "--no-dna", "--dayhoff", *SHORT]],
    "hp only": [["compute", "a.fa", "--no-dna", "--hp", *SHORT]],
    # outputs
    "-o, two files": [["compute", "b.fa", "c.fa", "-k", "21", "--scaled", "1000",
                       "-o", "out.sig"]],
    "-o zip": [["compute", "b.fa", "d.fa", "-k", "31", "--scaled", "1000", "-o", "out.zip"]],
    "--output-dir": [["compute", "b.fa", "c.fa", "-k", "21", "--output-dir", "outdir"]],
    "--output-dir not there": [["compute", "c.fa", "-k", "21", "--output-dir", "nodir"]],
    "already done, then -f": [["compute", "c.fa", "-k", "21"], ["compute", "c.fa", "-k", "31"],
                              ["compute", "c.fa", "-k", "31", "-f"]],
    "--merge": [["compute", "a.fa", "b.fa", "-k", "21", "--scaled", "1000",
                 "--merge", "merged", "-o", "merged.sig"]],
    "--merge with protein": [["compute", "b.fa", "d.fa", "--protein", *SHORT,
                              "--merge", "both", "-o", "merged.sig"]],
    "--singleton": [["compute", "b.fa", "d.fa", "-k", "21", "--scaled", "1000",
                     "--singleton", "-o", "single.sig"]],
    "--singleton into files": [["compute", "b.fa", "--singleton", "-k", "31"]],
    "--track-abundance": [["compute", "a.fa", "-k", "21", "--scaled", "1000",
                           "--track-abundance", "-o", "abund.sig"]],
    "--track-abundance num": [["compute", "b.fa", "-k", "21", "--track-abundance",
                               "-n", "200"]],
    "--name-from-first": [["compute", "b.fa", "d.fa", "-k", "21", "--name-from-first"]],
    "--seed": [["compute", "b.fa", "-k", "21", "--seed", "7", "--scaled", "1000"]],
    "--input-is-protein": [["compute", "prot.faa", "--input-is-protein", "-k", "30",
                            "--scaled", "10", "-o", "prot.sig"]],
    "--input-is-protein --dayhoff --hp": [["compute", "prot.faa", "--input-is-protein",
                                           "--dayhoff", "--hp", "-k", "30,42", "--scaled", "10",
                                           "-o", "prot.zip"]],
    "--check-sequence, bad input": [["compute", "bad.fa", "-k", "21", "--check-sequence"]],
    "bad input without --check-sequence": [["compute", "bad.fa", "-k", "21"]],
    "an empty file": [["compute", "empty.fa", "c.fa", "-k", "21", "-o", "e.sig"]],
    "--randomize": [["compute", "b.fa", "c.fa", "d.fa", "-k", "21", "--randomize",
                     "-o", "r.sig"]],
    "--scaled 1e9 warns": [["compute", "c.fa", "-k", "21", "--scaled", "1e9"]],
    # errors
    "license: refused": [["compute", "a.fa", "--license", "MIT"]],
    "scaled below 1: refused": [["compute", "a.fa", "--scaled", "0.5"]],
    "scaled not an integer: refused": [["compute", "a.fa", "--scaled", "100.5"]],
    "nothing to calculate: refused": [["compute", "a.fa", "--no-dna"]],
    "protein ksize: refused": [["compute", "a.fa", "--protein", "-k", "21,31"]],
    "--merge without -o: refused": [["compute", "a.fa", "--merge", "x"]],
    "-o and --output-dir: refused": [["compute", "a.fa", "-o", "x.sig", "--output-dir", "d"]],
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_is_identical(seqs, case, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SOURMASH_PALLAS", "1")
    # the JAX package's per-record add_sequence takes its device branch on a
    # CPU backend only so
    monkeypatch.setenv("SOURMASH_TPU_HOST_SKETCH", "numpy")
    calls = {}
    for mod, name, tag in ((jax_sketch, "seq_chunks_to_hashes", "jax"),
                           (cuda_sketch, "survivor_slots", "torch"),
                           (cuda_sketch, "window_hashes", "torch")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _tag=tag, **kw):
            calls[_tag] = calls.get(_tag, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    outputs = both(seqs, CASES[case], tmp_path, monkeypatch, capsys,
                   setup=lambda tag: random.seed(5))
    assert_same(outputs)
    rcs, out, err, files = outputs["torch"]
    if "refused" in case:
        assert any(rc not in (None, 0) for rc in rcs), err
    elif "bad input" not in case and "not there" not in case:
        assert all(rc in (None, 0) for rc in rcs), err
        assert any(name.endswith((".sig", ".zip")) for name in files), err
    # the long record's DNA sketches take the device branch in both packages
    dna_long = "a.fa" in CASES[case][0] and "--no-dna" not in CASES[case][0] \
        and "refused" not in case
    if dna_long:
        assert calls.get("torch", 0) >= 1 and calls.get("jax", 0) >= 1, calls


def test_compute_combos_cover_every_row():
    "Each row of _MOLTYPE_COMBOS has a case, and the table is the JAX package's."
    assert torch_compute._MOLTYPE_COMBOS == jax_compute._MOLTYPE_COMBOS
    assert len(torch_compute._MOLTYPE_COMBOS) == 7
    names = {"dna and protein", "dna and dayhoff", "dna and hp", "dna only, num=500 default",
             "protein only", "dayhoff only", "hp only"}
    assert names <= set(CASES)


def test_compute_parameters_from_args():
    "ComputeParameters.from_args copies the matching fields, as the JAX package's."
    from argparse import Namespace

    from sourmash_tpu.command_sketch import ComputeParameters as JaxParams
    from sourmash_tpu_torch.command_sketch import ComputeParameters as TorchParams

    ns = Namespace(ksizes=(21, 30), seed=7, protein=True, dayhoff=False, hp=True, dna=False,
                   num_hashes=0, track_abundance=True, scaled=100.0, other="ignored")
    got, want = TorchParams.from_args(ns), JaxParams.from_args(ns)
    assert vars(got) == vars(want)
    assert got.scaled == 100 and got.ksizes == [21, 30]
