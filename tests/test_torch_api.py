"""The port's package-level API against the JAX package's
(`sourmash_tpu/__init__.py`): the same names, equal constants, the same
DeprecationWarnings and results from the deprecated aliases and the SBT
helpers; and the profiler hook of `python -m sourmash_tpu_torch`
(SOURMASH_TORCH_PROFILE) on the CPU."""

import glob
import json
import os
import warnings

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu_torch
from sourmash_tpu_torch.__main__ import main as torch_main
from torch_cli_parity import isolated  # noqa: F401

PACKAGES = (sourmash_tpu, sourmash_tpu_torch)
PUBLIC = [name for name in vars(sourmash_tpu) if not name.startswith("_")
          and name not in ("jax", "VERSION", "__version__")]

pytestmark = pytest.mark.usefixtures("isolated")


def _sigs(package, n=3):
    rng = np.random.default_rng(31)
    out = []
    for i in range(n):
        mh = package.MinHash(0, 31, scaled=1000)
        mh.add_many(np.unique(rng.integers(0, (1 << 64) // 1000, size=200, dtype=np.uint64)))
        out.append(package.SourmashSignature(mh, name=f"sig {i}"))
    return out


def test_every_package_level_name_is_there():
    missing = [name for name in PUBLIC if not hasattr(sourmash_tpu_torch, name)]
    assert not missing
    assert set(sourmash_tpu.__all__) <= set(sourmash_tpu_torch.__all__)
    assert sourmash_tpu_torch.DEFAULT_SEED == sourmash_tpu.DEFAULT_SEED == 42
    assert sourmash_tpu_torch.MAX_HASH == sourmash_tpu.MAX_HASH == 2**64 - 1
    assert sourmash_tpu_torch.DEFAULT_LOAD_K == sourmash_tpu.DEFAULT_LOAD_K


def _warned(fn, *args, **kwargs):
    "fn's result and the text of each DeprecationWarning it raised."
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(w.message) for w in caught if w.category is DeprecationWarning]


def test_deprecated_signature_aliases():
    results = {}
    for package in PACKAGES:
        sigs = _sigs(package)
        text = package.save_signatures_to_json(sigs)
        saved, w_save = _warned(package.save_signatures, sigs)
        loaded, w_load = _warned(package.load_signatures, text)
        one, w_one = _warned(package.load_one_signature,
                             package.save_signatures_to_json(sigs[:1]))
        results[package.__name__] = (saved, [ss.md5sum() for ss in loaded], one.md5sum(),
                                     w_save, w_load, w_one)
    got, want = results["sourmash_tpu_torch"], results["sourmash_tpu"]
    assert got == want
    assert got[3] == ["save_signatures is deprecated; use save_signatures_to_json"]
    assert got[4] == ["load_signatures is deprecated; use load_signatures_from_json"]
    assert got[5] == ["load_one_signature is deprecated; use load_one_signature_from_json"]


def test_sbt_helpers(tmp_path):
    results = {}
    for package in PACKAGES:
        from importlib import import_module

        SigLeaf = import_module(f"{package.__name__}.sbtmh").SigLeaf
        sigs = _sigs(package, 4)
        tree, w_create = _warned(package.create_sbt_index, bloom_filter_size=1e4, n_children=2)
        for ss in sigs:
            tree.add_node(SigLeaf(ss.md5sum(), ss))
        path = str(tmp_path / f"{package.__name__}.sbt.zip")
        tree.save(path)
        loaded, w_load = _warned(package.load_sbt_index, path)
        hits, w_search = _warned(lambda: list(package.search_sbt_index(loaded, sigs[2], 0.1)))
        results[package.__name__] = ([(ss.md5sum(), score) for ss, score in hits], w_create,
                                     w_load, w_search, len(list(loaded.leaves())))
    got, want = results["sourmash_tpu_torch"], results["sourmash_tpu"]
    assert got == want
    assert got[0] and got[1] == [] and got[4] == 4
    assert got[2] == ["load_sbt_index is deprecated; use load_file_as_index"]
    assert got[3] == ["search_sbt_index is deprecated; use index.search(...)"]


# -- the profiler hook ---------------------------------------------------------

LONG = (1 << 16) + 2_000  # a DNA record on the device branch: plain torch ops on the CPU


@pytest.fixture
def fasta(tmp_path):
    rng = np.random.default_rng(3)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=LONG).tobytes().decode()
    path = tmp_path / "long.fa"
    path.write_text(f">long\n{seq}\n>short\n{seq[:900]}\n")
    return path


def test_profiler_hook_writes_a_cpu_trace_and_changes_no_output(fasta, tmp_path, monkeypatch,
                                                                capsys):
    monkeypatch.chdir(tmp_path)
    outputs = []
    for tag, profile in (("plain", None), ("profiled", str(tmp_path / "trace"))):
        if profile:
            monkeypatch.setenv("SOURMASH_TORCH_PROFILE", profile)
        capsys.readouterr()
        rc = torch_main(["sketch", "dna", str(fasta), "-p", "k=21,scaled=100", "-o",
                         f"{tag}.sig"])
        cap = capsys.readouterr()
        outputs.append((rc, cap.out, cap.err.replace("profiled.sig", "plain.sig"),
                        (tmp_path / f"{tag}.sig").read_bytes()))
    assert outputs[0] == outputs[1]
    traces = glob.glob(str(tmp_path / "trace" / "sourmash_torch.*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as fp:
        events = json.load(fp)["traceEvents"]
    assert any(ev.get("cat") == "cpu_op" for ev in events)
    assert not any(ev.get("cat") == "kernel" for ev in events)


def test_profiler_hook_writes_its_trace_when_the_command_fails(tmp_path, monkeypatch):
    monkeypatch.setenv("SOURMASH_TORCH_PROFILE", str(tmp_path / "trace"))
    with pytest.raises(SystemExit):
        torch_main(["sketch", "dna", str(tmp_path / "absent.fa"), "-o", "x.sig"])
    assert len(os.listdir(tmp_path / "trace")) == 1


def test_profiler_hook_refuses_cuda_it_cannot_record(tmp_path, monkeypatch):
    """On CUDA the hook records CUDA activity or raises; without a card the
    command's device rule raises first, and no trace is written."""
    import torch
    from torch import profiler

    monkeypatch.setenv("SOURMASH_TORCH_PROFILE", str(tmp_path / "trace"))
    monkeypatch.delenv("SOURMASH_TORCH_DEVICE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_main(["info"])
        assert not (tmp_path / "trace").exists()
        # a card the profiler cannot trace: the hook refuses before the command runs
        from sourmash_tpu_torch import ops

        monkeypatch.setattr(ops, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(profiler, "supported_activities",
                        lambda: {profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot record CUDA activity"):
        torch_main(["info"])
    assert not (tmp_path / "trace").exists()
