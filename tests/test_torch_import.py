"""sourmash_tpu_torch stands alone: importing it (every module) brings in
neither jax nor any sourmash_tpu module nor the root `screed` shim (whose
`open` reaches sourmash_tpu), and asking it for a CUDA device that is not
there raises instead of running on the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import sourmash_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(sourmash_tpu_torch.__file__)


@pytest.fixture(autouse=True)
def _view_cache(monkeypatch, tmp_path_factory):
    "The port's flat-view cache in a directory of the test's own, outside its tmp_path."
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path_factory.mktemp("viewcache")))


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([PKG_DIR], prefix="sourmash_tpu_torch.")
    )


def test_import_every_module_leaves_jax_and_sourmash_tpu_out():
    modules = ["sourmash_tpu_torch"] + _port_modules()
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'sourmash_tpu' or m.startswith('sourmash_tpu.')\n"
        "             or m == 'screed' or m.startswith('screed.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        check=True, capture_output=True, text=True,
    ).stdout
    assert out.strip() == "[]"
    assert "sourmash_tpu_torch.ops.cuda_sketch" in modules
    assert "sourmash_tpu_torch.command_sketch" in modules
    assert "sourmash_tpu_torch.ops.cuda_gather" in modules
    assert "sourmash_tpu_torch.index.flat" in modules
    assert "sourmash_tpu_torch.commands" in modules
    assert "sourmash_tpu_torch.sig.__main__" in modules
    assert "sourmash_tpu_torch.tax.__main__" in modules
    assert "sourmash_tpu_torch.cli.utils" in modules
    for name in ("plugins", "hll", "fig", "command_compute", "cli.scripts", "cli.compute"):
        assert f"sourmash_tpu_torch.{name}" in modules


@pytest.mark.parametrize(
    "path",
    sorted(
        os.path.relpath(os.path.join(d, f), REPO)
        for d, _, files in os.walk(PKG_DIR)
        for f in files
        if f.endswith(".py")
    ) + ["chip_smoke.py"],
)
def test_no_file_imports_jax_or_sourmash_tpu(path):
    "Nor the root `screed` shim: the port reads sequence files with its own sequence_io."
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "sourmash_tpu", "screed"), (path, name)


def test_cuda_device_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from sourmash_tpu_torch.ops import DEVICE_ENV, resolve_device
    from sourmash_tpu_torch.ops.sketch import seq_chunks_to_hashes

    monkeypatch.delenv(DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    big = b"ACGT" * (1 << 15)  # above the host-twin threshold
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seq_chunks_to_hashes(big, 31, (1 << 64) // 1000, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sourmash_tpu_torch.MinHash(0, 31, scaled=1000).add_sequence(big)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sourmash_tpu_torch.SourmashSignature(
            sourmash_tpu_torch.MinHash(0, 31, scaled=1000)).add_sequence(big, device="cuda")
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert resolve_device() == torch.device("cpu")


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """The wrappers take the plain path only for CPU tensors; a tensor on
    any device other than the CPU or CUDA is refused before anything runs."""
    from sourmash_tpu_torch.ops import cuda_sketch

    rows = torch.zeros((1, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sketch.window_hashes(rows, ksize=21)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sketch.survivor_slots(rows, 1 << 50, ksize=21)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sketch.aa_window_hashes(rows, ksize=10)

    from sourmash_tpu_torch.ops import cuda_gather

    q = torch.zeros((8, 128), dtype=torch.int32, device="meta")
    S = torch.zeros((8, 8, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gather.counts_rows(q, q, S, S)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gather.membership_bits(
            q, q, q[0], S, S, torch.zeros((8, 128), dtype=torch.uint8, device="meta"),
            torch.zeros(4, dtype=torch.int64, device="meta"),
            torch.zeros(64, dtype=torch.int32, device="meta"),
            torch.zeros(8 * 128, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gather.round_dec(q, q[0])


def test_cli_without_cuda_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from sourmash_tpu_torch.__main__ import main

    fa = tmp_path / "x.fa"
    fa.write_text(">a\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n")
    monkeypatch.delenv("SOURMASH_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sketch", "dna", str(fa), "-o", str(tmp_path / "x.sig")])
    assert not (tmp_path / "x.sig").exists()


@pytest.mark.parametrize("cmd", ["protein", "translate"])
def test_protein_cli_without_cuda_raises(monkeypatch, tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from sourmash_tpu_torch.__main__ import main

    fa = tmp_path / "x.fa"
    fa.write_text(">a\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n")
    monkeypatch.delenv("SOURMASH_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sketch", cmd, str(fa), "-o", str(tmp_path / "x.zip")])
    assert not (tmp_path / "x.zip").exists()


@pytest.mark.parametrize("flat_view", ["0", "1"])
def test_gather_without_cuda_raises(monkeypatch, tmp_path, flat_view):
    """`gather` asks for CUDA by default, on the host route (batched find)
    and the device route (FlatIndex view) alike."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import numpy as np

    from sourmash_tpu_torch.__main__ import main
    from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

    mh = sourmash_tpu_torch.MinHash(0, 31, scaled=1000)
    mh.add_many(np.arange(1, 300, dtype=np.uint64))
    with SaveSignaturesToLocation(str(tmp_path / "db.zip")) as save:
        for i in range(3):
            save.add(sourmash_tpu_torch.SourmashSignature(mh, name=f"s{i}"))
    with SaveSignaturesToLocation(str(tmp_path / "q.sig")) as save:
        save.add(sourmash_tpu_torch.SourmashSignature(mh, name="q"))
    monkeypatch.delenv("SOURMASH_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("SOURMASH_TORCH_FLAT_VIEW", flat_view)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["gather", str(tmp_path / "q.sig"), str(tmp_path / "db.zip"), "--threshold-bp", "0"])
