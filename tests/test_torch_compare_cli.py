"""`compare` through both packages' `__main__.main` on generated `.sig`
files and zips, on the CPU (the port with SOURMASH_TORCH_DEVICE=cpu, so
`products_block` runs its plain version and the counts the sorted engine):
stdout and the `-o` `.npy`, `.labels.txt`, `--csv` and `--labels-to`
files must be byte-identical.

Collections: 64 sketches of 400-800 hashes (n * total above the host
cutoff of 2,000,000, so the engines run), flat and with abundances, and
12 of 200-400 (below it: host joins, fewer than 30 so the matrix is
printed), the same mixed with scaled=2000 sketches, k=21 and k=31 in one
zip, and num sketches for the error exits.
"""

import os

import numpy as np
import pytest

from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.ops import intersect as jis

import sourmash_tpu_torch
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

BIG, SMALL = 64, 12


def _sketches(rng, n, lo, hi, scaled=1000):
    "n sketches of lo-hi hashes in clades of 1-6 sharing 50-95 % of a core."
    mh = (1 << 64) // scaled
    mins = []
    while len(mins) < n:
        core = np.unique(rng.integers(0, mh, size=hi, dtype=np.uint64))
        for _ in range(int(rng.integers(1, 7))):
            size = int(rng.integers(lo, hi + 1))
            kept = rng.permutation(core)[: int(size * rng.uniform(0.5, 0.95))]
            own = rng.integers(0, mh, size=size - len(kept), dtype=np.uint64)
            mins.append(np.unique(np.concatenate([kept, own])))
    return mins[:n]


def _sig(mins, name, *, abunds=None, ksize=31, scaled=1000, num=0):
    params = dict(ksize=ksize, moltype="DNA", num=num, scaled=scaled, seed=42,
                  track_abundance=abunds is not None)
    return sourmash_tpu_torch.signature_from_arrays(params, mins, abunds, name=name,
                                                    filename=f"{name}.fa.gz")


def _save(path, sigs):
    with SaveSignaturesToLocation(path) as save:
        for ss in sigs:
            save.add(ss)


@pytest.fixture(autouse=True)
def _view_cache(monkeypatch, tmp_path_factory):
    "The port's flat-view cache in a directory of the test's own, outside its tmp_path."
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path_factory.mktemp("viewcache")))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(2028)
    d = tmp_path_factory.mktemp("compare")
    big = _sketches(rng, BIG, 400, 800)
    assert BIG * sum(len(m) for m in big) >= jis._HOST_WORK_CUTOFF
    _save(str(d / "big.zip"), [_sig(m, f"big_{i}") for i, m in enumerate(big)])
    _save(str(d / "big_abund.zip"), [_sig(m, f"ab_{i}", abunds=rng.integers(1, 51, size=len(m)))
                                     for i, m in enumerate(big)])
    small = _sketches(rng, SMALL, 200, 400)
    assert SMALL * sum(len(m) for m in small) < jis._HOST_WORK_CUTOFF
    names = []
    for i, m in enumerate(small):
        ab = rng.integers(1, 20, size=len(m)) if i % 3 else None
        names.append(f"small{i}.sig")
        _save(str(d / names[-1]), [_sig(m, f"small genome {i} with a long name", abunds=ab)])
    (d / "small.txt").write_text("\n".join(names[4:]) + "\n")
    # scaled=2000 sketches of the same genomes: compare downsamples to 2000
    cut = np.uint64((1 << 64) // 2000)
    _save(str(d / "coarse.zip"), [_sig(m[m < cut], f"coarse_{i}", scaled=2000)
                                  for i, m in enumerate(small[:5])])
    _save(str(d / "ks.zip"), [_sig(m, f"k{k}_{i}", ksize=k)
                              for k in (21, 31) for i, m in enumerate(small[:6])])
    _save(str(d / "num.zip"), [_sig(np.sort(m)[:150], f"num_{i}", scaled=0, num=150)
                               for i, m in enumerate(small[:4])])
    return d


SMALL_SIGS = [f"small{i}.sig" for i in range(4)]

COMPARE = {
    "jaccard, engines": (["big.zip"], []),
    "angular, engines": (["big_abund.zip"], []),
    "ignore-abundance, engines": (["big_abund.zip"], ["--ignore-abundance"]),
    "containment, engines": (["big.zip"], ["--containment"]),
    "containment ani, engines": (["big.zip"], ["--containment", "--estimate-ani"]),
    "max-containment, engines": (["big.zip"], ["--max-containment"]),
    "max-containment ani, engines": (["big.zip"], ["--max-containment", "--ani"]),
    "avg-containment, engines": (["big_abund.zip"], ["--avg-containment"]),
    "avg-containment ani, engines": (["big.zip"], ["--avg-containment", "--estimate-ani"]),
    "jaccard ani, engines": (["big.zip"], ["--estimate-ani"]),
    "jaccard, host": (SMALL_SIGS, []),
    "angular and flat, host": (SMALL_SIGS, ["--distance-matrix"]),
    "containment ani, host": (SMALL_SIGS, ["--containment", "--estimate-ani"]),
    "max-containment, host": (SMALL_SIGS, ["--max-containment"]),
    "avg-containment ani, host": (SMALL_SIGS, ["--avg-containment", "--ani"]),
    "mixed scaled": (["coarse.zip", *SMALL_SIGS], ["--containment"]),
    "--scaled": (SMALL_SIGS, ["--scaled", "2000", "--max-containment"]),
    "-k 21": (["ks.zip"], ["-k", "21"]),
    "--from-file": (["small5.sig"], ["--from-file", "small.txt"]),
    "-p 2": (["big_abund.zip"], ["-p", "2"]),
    "distance, engines": (["big.zip"], ["--distance-matrix", "--avg-containment"]),
}


def _run_both(world, tmp_path, capsys, monkeypatch, argv_of, *, exits=None):
    """Run argv_of(out_dir) through both packages; return their (stdout,
    files). With `exits`, both must exit with that SystemExit code."""
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(world)
    outputs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / tag
        out.mkdir()
        if exits is None:
            assert main(argv_of(out)) in (None, 0)
        else:
            with pytest.raises(SystemExit) as exc:
                main(argv_of(out))
            assert exc.value.code == exits
        files = {p: (out / p).read_bytes() for p in sorted(os.listdir(out))}
        outputs[tag] = (capsys.readouterr().out, files)
    (jax_out, jax_files), (torch_out, torch_files) = outputs["jax"], outputs["torch"]
    assert torch_out == jax_out
    assert sorted(torch_files) == sorted(jax_files)
    for name in jax_files:
        assert torch_files[name] == jax_files[name], name
    return torch_out, torch_files


@pytest.mark.parametrize("case", list(COMPARE))
def test_compare_outputs_are_byte_identical(world, case, tmp_path, capsys, monkeypatch):
    inputs, flags = COMPARE[case]
    out, files = _run_both(world, tmp_path, capsys, monkeypatch, lambda d: [
        "compare", *inputs, *flags, "-o", str(d / "cmp"), "--csv", str(d / "cmp.csv"),
        "--labels-to", str(d / "labels.csv")])
    assert sorted(files) == ["cmp", "cmp.csv", "cmp.labels.txt", "labels.csv"]
    n = files["cmp.labels.txt"].count(b"\n") + 1
    assert files["cmp.csv"].count(b"\n") == n + 1
    matrix = np.load(str(tmp_path / "torch" / "cmp"))
    assert matrix.shape == (n, n) and np.isfinite(matrix).all()
    assert "in matrix:" in out


ERRORS = {
    "num and scaled": ["num.zip", "small0.sig"],
    "two containment flags": ["--containment", "--max-containment", *SMALL_SIGS],
    "--containment on num": ["--containment", "num.zip"],
    "--estimate-ani on num": ["--estimate-ani", "num.zip"],
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_compare_error_exits_are_identical(world, case, tmp_path, capsys, monkeypatch):
    _run_both(world, tmp_path, capsys, monkeypatch,
              lambda d: ["compare", *ERRORS[case], "-o", str(d / "cmp")], exits=-1)
