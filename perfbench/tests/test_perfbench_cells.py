"""Every cell's run on the CPU at its rehearsal sizes: the program comes out
correct, the control (the reference's control in the program's place) and
each fault planted under the timed path come out not correct, and the
command refuses to give a result without a card."""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from perfbench.lib import harness

ROOT = harness.ROOT
SKETCH_CELLS = ["sketch-genomes", "sketch-reads"]
GATHER_CELLS = ["gather-metagenomes", "gather-genomes"]
SEED = 2**33 + 17  # more than 32 signed bits hold: seeds may be that large


def rehearse(workload, seconds=0.5, program="port", seed=SEED):
    # this process may hold jax through the repository's root conftest: the
    # look for it is test_nothing_loads_jax_or_the_jax_package's, in a process of its own
    cell = harness.find_cell(ROOT, workload)
    return harness.measure(cell, seed, seconds, False, t0=time.perf_counter(), device="cpu",
                           rehearsal=True, program=program, guard=False,
                           log=lambda *a, **k: None)


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE", "0")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.mark.parametrize("workload", SKETCH_CELLS + GATHER_CELLS)
def test_cell_correct_on_cpu(workload):
    out = rehearse(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"
    assert "setup_s" in out["metrics"]
    if workload in ("sketch-genomes", "gather-metagenomes"):
        # their windows end on whole cycles, of 2 requests at the rehearsal's sizes
        assert out["attempted"] % 2 == 0


@pytest.mark.parametrize("workload", SKETCH_CELLS + GATHER_CELLS)
def test_control_is_not_correct(workload):
    out = rehearse(workload, seconds=0.1, program="control")
    assert not out["correct"], out["checks"]


@contextlib.contextmanager
def patched(obj, name, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _sketch_faults():
    from sourmash_tpu_torch import minhash
    from sourmash_tpu_torch.ops import sketch as ops_sketch

    def unchanged(orig):  # the sketch's insert returns its state unchanged
        return lambda self, hashes, *a, **k: None

    def half(orig):  # half of each batch's hashes left out
        def f(*a, **k):
            h = orig(*a, **k)
            return h[: len(h) // 2]
        return f

    def altered(orig):  # one hash altered where it is produced
        def f(*a, **k):
            h = np.array(orig(*a, **k), copy=True)
            if len(h):
                h[0] ^= np.uint64(1)
            return h
        return f

    return {"unchanged": (minhash.MinHash, "_insert_hashes", unchanged),
            "half": (ops_sketch, "seq_chunks_to_hashes", half),
            "altered": (ops_sketch, "seq_chunks_to_hashes", altered)}


def _gather_faults():
    from sourmash_tpu_torch import minhash, search

    def unchanged(orig):  # a round's removal of the found hashes returns the query unchanged
        return lambda self, *a, **k: None

    def half(orig):  # every other row of a query left out
        def f(self):
            orig(self)
            return orig(self)
        return f

    def altered(orig):  # one number of each row altered where the row is produced
        def f(self, *a, **k):
            orig(self, *a, **k)
            self.unique_intersect_bp += 1
        return f

    return {"unchanged": (minhash.MinHash, "remove_many", unchanged),
            "half": (search.GatherDatabases, "__next__", half),
            "altered": (search.GatherResult, "build_gather_result", altered)}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", SKETCH_CELLS + GATHER_CELLS)
def test_fault_is_not_correct(workload, fault):
    faults = _sketch_faults() if workload in SKETCH_CELLS else _gather_faults()
    obj, name, wrap = faults[fault]
    with patched(obj, name, wrap):
        out = rehearse(workload, seconds=0.1)
    assert not out["correct"], out["checks"]


def _run_py(args, cwd, env=None):
    return subprocess.run([sys.executable, os.path.join(cwd, "perfbench", "run.py"), *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env or dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    p = _run_py(["--workload", "sketch-genomes", "--seed", "1", "--seconds", "1",
                 "--trace", "0"], ROOT)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = _run_py(["--workload", "gather-genomes", "--seed", "1", "--seconds", "1",
                 "--trace", "0"], str(tmp_path))
    assert p.returncode != 0 and not p.stdout.strip()


def test_nothing_loads_jax_or_the_jax_package(tmp_path):
    # a process of its own: the rehearsal of every cell, then the modules it holds
    code = f"""
import sys, time, json
sys.path.insert(0, {ROOT!r})
from perfbench.lib import harness
for w in {SKETCH_CELLS + GATHER_CELLS!r}:
    cell = harness.find_cell({ROOT!r}, w)
    harness.measure(cell, 5, 0.1, False, t0=time.perf_counter(), device="cpu",
                    rehearsal=True, log=lambda *a, **k: None)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    env = dict(os.environ, SOURMASH_TORCH_DEVICE="cpu", TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.splitlines()[-1]))
    assert "sourmash_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_harness_sources_import_no_jax():
    import ast

    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "perfbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    names = [node.module]
                bad += [(f, n) for n in names if n.split(".", 1)[0] in harness.FORBIDDEN]
    assert not bad


def test_a_traced_run_on_the_card(card, tmp_path):
    # on the chip: one short traced run of the quickest cell gives every per-layer metric
    p = _run_py(["--workload", "gather-genomes", "--seed", str(SEED), "--seconds", "3",
                 "--trace", "1"], ROOT, env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert "gather_kernels_roofline_pct" in out["metrics"]
