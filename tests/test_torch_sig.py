"""`sourmash sig` in the port against the JAX package, on the CPU (the port
with SOURMASH_TORCH_DEVICE=cpu, so its kernels run their plain versions).

Every case runs `python -m sourmash_tpu_torch sig ...` and `python -m
sourmash_tpu sig ...` (both `main`s, in this process) from one directory
that holds a fresh copy of the inputs, and compares the exit codes, stdout,
stderr (the package name aside) and every file in the directory, byte for
byte. Each of the 23 subcommand names runs at least once, `summarize` and
`import` included, and the `signature` alias once. The inputs are sketches
of a few hundred hashes made with numpy from a seed: k = 21 and 31 DNA,
k = 10 protein, with and without abundances, scaled and num.

The picklist cases cover `sig cat`, `extract` and `check` with the name,
ident, md5short and md5 column types, the `:exclude` form,
`--picklist-require-all` in its passing and its failing case, and one
`gather --picklist` against a zip.

`sig kmers` runs records long enough for the port's device branch (DNA
records of 2^16 bytes or more: K1 and K2; protein and `--translate` frames
of 2^16 windows or more: K3), here their plain versions, against the JAX
package's Pallas kernels in interpret mode (SOURMASH_PALLAS=1), and
invalid bytes in a long and a short record with and without
`--check-sequence` and `--force`.
"""

import json
import os
import shutil

import numpy as np
import pytest

import sourmash_tpu
import sourmash_tpu_torch
from sourmash_tpu import MinHash as JaxMinHash
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.cli import SourmashParser as JaxParser
from sourmash_tpu.ops import sketch as jax_sketch
from sourmash_tpu_torch.__main__ import main as torch_main
from sourmash_tpu_torch.cli import SourmashParser as TorchParser
from sourmash_tpu_torch.ops import cuda_sketch
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

MAINS = (("jax", jax_main), ("torch", torch_main))
SCALED = 1000
N_GENOMES = 8


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "_torch_viewcache"))
    # the citation goes out once a process and package: keep it out of every case
    for parser in (JaxParser, TorchParser):
        monkeypatch.setattr(parser, "_citation_printed", True)


def _sig(params, mins, abunds=None, *, name, filename=""):
    params = dict(dict(moltype="DNA", num=0, scaled=0, seed=42), **params,
                  track_abundance=abunds is not None)
    return sourmash_tpu_torch.signature_from_arrays(params, mins, abunds, name=name,
                                                    filename=filename)


def _save(path, sigs):
    with SaveSignaturesToLocation(str(path)) as save:
        for ss in sigs:
            save.add(ss)


def _hashes(rng, scaled, n):
    return np.unique(rng.integers(0, (1 << 64) // scaled, size=n, dtype=np.uint64))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Genomes in clades (k = 21 and 31), sketches with abundances, protein
    and num sketches, in `.sig` files and a zip; picklists, a pathlist, a
    metagenome query, and a mash CSV and JSON sketch."""
    rng = np.random.default_rng(2024)
    d = tmp_path_factory.mktemp("sig")
    genomes = {21: [], 31: []}
    for k in (21, 31):
        core = _hashes(rng, SCALED, 400)
        for i in range(N_GENOMES):
            kept = rng.permutation(core)[: int(rng.integers(50, 250))] if i % 3 else core[:0]
            mins = np.unique(np.concatenate([kept, _hashes(rng, SCALED, int(rng.integers(150, 400)))]))
            genomes[k].append(_sig(dict(ksize=k, scaled=SCALED), mins,
                                   name=f"GCF_{i:06d}.1 genome {i} clade {i % 3}",
                                   filename=f"genome_{i}.fa.gz"))
    core = _hashes(rng, SCALED, 300)
    abund = []
    for i in range(3):
        mins = np.unique(np.concatenate([core[: 100 + 50 * i], _hashes(rng, SCALED, 200)]))
        abund.append(_sig(dict(ksize=31, scaled=SCALED), mins,
                          rng.integers(1, 20, size=len(mins)), name=f"abund_{i}",
                          filename=f"abund_{i}.fa"))
    prot = [_sig(dict(ksize=10, moltype="protein", scaled=200), _hashes(rng, 200, 300),
                 name=f"proteome_{i}", filename=f"proteome_{i}.faa") for i in range(2)]
    num = [_sig(dict(ksize=31, num=500), _hashes(rng, 1, n), name=f"num_{i}",
                filename=f"num_{i}.fa") for i, n in enumerate((500, 320))]
    _save(d / "coll.zip", genomes[21] + genomes[31] + prot + num)
    _save(d / "multi.sig", genomes[21] + genomes[31])
    for i in range(4):
        _save(d / f"g{i}.sig", [genomes[31][i]])
    _save(d / "abund.sig", abund)
    for i in range(2):
        _save(d / f"a{i}.sig", [abund[i]])
    _save(d / "prot.sig", prot)
    _save(d / "num.sig", num)
    (d / "from_file.txt").write_text("g1.sig\ng2.sig\n")
    (d / "sub").mkdir()

    picked = [genomes[31][i] for i in (1, 3, 5)]
    rows = ["name,ident,md5,md5short"] + [
        f'"{ss.name}",{ss.name.split()[0]},{ss.md5sum()},{ss.md5sum()[:8]}' for ss in picked]
    (d / "pl.csv").write_text("\n".join(rows) + "\n")
    (d / "plx.csv").write_text("\n".join(rows + [
        f'"absent genome",GCF_999999.1,{"0" * 32},{"0" * 8}']) + "\n")

    meta = np.unique(np.concatenate(
        [np.fromiter(genomes[31][i].minhash.hashes, np.uint64) for i in (1, 2, 5)]
        + [_hashes(rng, SCALED, 300)]))
    _save(d / "meta.sig", [_sig(dict(ksize=31, scaled=SCALED), np.asarray(meta, np.uint64),
                                name="metagenome")])

    num_mins = [sorted(int(h) for h in ss.minhash.hashes) for ss in num]
    (d / "mash.csv").write_text("".join(
        f"murmur64,42,31,mash_{i}.fa,{' '.join(map(str, m))}\n" for i, m in enumerate(num_mins)))
    (d / "mash.json").write_text(json.dumps(dict(
        kmer=21, sketchSize=len(num_mins[1]), hashType="MurmurHash3_x64_128", hashBits=64,
        hashSeed=42, sketches=[{"hashes": num_mins[1]}])))
    return d


def _snapshot(root):
    "{relative path: bytes} of every file under root."
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fp:
                out[os.path.relpath(path, root)] = fp.read()
    return out


def _run(main, argv):
    "The exit code, or the type and text of the exception that ended the command."
    try:
        return main(list(argv))
    except SystemExit as exc:
        return exc.code
    except Exception as exc:  # noqa: BLE001 - both packages must raise alike
        return f"{type(exc).__name__}: {exc}"


def _both(inputs, argvs, tmp_path, monkeypatch, capsys):
    """Run each argv list in turn through both mains, each package in a fresh
    copy of `inputs` at the same path; {tag: (exit codes, stdout, stderr,
    files)}."""
    outputs = {}
    for tag, main in MAINS:
        run = tmp_path / "run"
        if run.exists():
            shutil.rmtree(run)
        shutil.copytree(inputs, run)
        monkeypatch.chdir(run)
        capsys.readouterr()
        rcs = [_run(main, argv) for argv in argvs]
        cap = capsys.readouterr()
        err = cap.err.replace("sourmash_tpu_torch", "sourmash_tpu")
        outputs[tag] = (rcs, cap.out, err, _snapshot(run))
    return outputs


CASES = {
    # whole-collection IO
    "cat zip to sig": [["sig", "cat", "coll.zip", "-o", "out.sig"]],
    "cat to zip, -k 31": [["sig", "cat", "multi.sig", "abund.sig", "-k", "31", "-o", "out.zip"]],
    "cat -u --from-file, stdout": [["sig", "cat", "g1.sig", "g0.sig", "--from-file",
                                    "from_file.txt", "-u"]],
    "cat --include-db-pattern": [["sig", "cat", "coll.zip", "--include-db-pattern",
                                  "clade 1", "-o", "out.sig"]],
    "cat --exclude-db-pattern, --protein": [["sig", "cat", "coll.zip", "--protein",
                                             "--exclude-db-pattern", "proteome_0"]],
    "split into cwd": [["sig", "split", "g0.sig", "num.sig", "prot.sig"]],
    "split --output-dir, -k 21": [["sig", "split", "multi.sig", "-k", "21", "--output-dir", "sp"]],
    "split abundances, -E .zip": [["sig", "split", "abund.sig", "-E", ".zip", "--outdir", "sp"]],
    # inspection
    "describe": [["sig", "describe", "coll.zip", "abund.sig"]],
    "describe --csv, -k 21": [["sig", "describe", "multi.sig", "-k", "21", "--csv", "d.csv"]],
    "manifest csv": [["sig", "manifest", "coll.zip", "-o", "mf.csv"]],
    "manifest sql": [["sig", "manifest", "multi.sig", "-o", "mf.sqlmf", "-F", "sql"]],
    "manifest --no-rebuild": [["sig", "manifest", "coll.zip", "--no-rebuild-manifest",
                               "-o", "mf.csv"]],
    "manifest over an existing file: refused, then -f": [["sig", "manifest", "coll.zip", "-o", "mf.csv"],
                                 ["sig", "manifest", "coll.zip", "-o", "mf.csv",
                                  "-F", "sql"],
                                 ["sig", "manifest", "g0.sig", "-o", "mf.sqlmf", "-F", "sql"],
                                 ["sig", "manifest", "g1.sig", "-o", "mf.sqlmf", "-F", "sql",
                                  "-f"]],
    "overlap": [["sig", "overlap", "g0.sig", "g1.sig"]],
    "overlap, abundances": [["sig", "overlap", "a0.sig", "a1.sig", "-k", "31"]],
    "fileinfo": [["sig", "fileinfo", "coll.zip"]],
    "fileinfo --rebuild-manifest": [["sig", "fileinfo", "abund.sig", "--rebuild-manifest"]],
    "summarize --json-out": [["sig", "summarize", "multi.sig", "--json-out"]],
    # sketch set algebra
    "merge --set-name": [["sig", "merge", "multi.sig", "-k", "31", "--set-name", "merged",
                          "-o", "m.sig"]],
    "merge abundances": [["sig", "merge", "abund.sig"]],
    "merge abundances and flat: refused": [["sig", "merge", "a0.sig", "g1.sig"]],
    "merge --flatten": [["sig", "merge", "a0.sig", "g1.sig", "--flatten", "-o", "m.sig"]],
    "merge protein, --from-file": [["sig", "merge", "prot.sig", "--from-file",
                                    "from_file.txt", "-k", "10"]],
    "intersect": [["sig", "intersect", "g0.sig", "g1.sig", "g2.sig", "-o", "i.sig"]],
    "intersect -A": [["sig", "intersect", "a0.sig", "a1.sig", "-A", "a0.sig",
                      "--set-name", "x"]],
    "intersect abundances": [["sig", "intersect", "abund.sig"]],
    "inflate": [["sig", "inflate", "a0.sig", "g0.sig", "g1.sig", "-o", "inf.sig"]],
    "inflate an abundance sketch: refused": [["sig", "inflate", "a0.sig", "a1.sig"]],
    "subtract": [["sig", "subtract", "g0.sig", "g1.sig", "g2.sig", "-o", "s.sig"]],
    "subtract abundances: refused": [["sig", "subtract", "a0.sig", "a1.sig"]],
    "subtract --flatten": [["sig", "subtract", "a0.sig", "a1.sig", "--flatten"]],
    "subtract -A": [["sig", "subtract", "a0.sig", "g1.sig", "--flatten", "-A", "a0.sig",
                     "--set-name", "left"]],
    # per-sketch transforms
    "rename": [["sig", "rename", "g0.sig", "a new name", "-o", "r.sig"]],
    "rename to zip, -k 21": [["sig", "rename", "coll.zip", "same", "-k", "21", "-o", "r.zip"]],
    "extract --name": [["sig", "extract", "multi.sig", "--name", "genome 2"]],
    "extract --md5, -o zip": [["sig", "extract", "coll.zip", "--md5", "{md5:g3.sig}",
                               "-o", "e.zip"]],
    "extract nothing: refused": [["sig", "extract", "coll.zip", "--name", "no such"]],
    "filter -m -M": [["sig", "filter", "abund.sig", "-m", "3", "-M", "12", "-o", "f.sig"]],
    "filter --name, flat input": [["sig", "filter", "abund.sig", "g0.sig", "--name", "abund_1",
                                   "-m", "5"]],
    "flatten": [["sig", "flatten", "abund.sig", "--name", "abund_1"]],
    "flatten --md5, -o zip": [["sig", "flatten", "abund.sig", "g0.sig", "--md5",
                               "{md5:a0.sig}", "-o", "f.zip"]],
    "downsample --scaled": [["sig", "downsample", "multi.sig", "abund.sig", "--scaled",
                             "2000", "-k", "31", "-o", "d.sig"]],
    "downsample num to --num": [["sig", "downsample", "num.sig", "--num", "100"]],
    "downsample scaled to --num": [["sig", "downsample", "g0.sig", "a1.sig", "--num", "50"]],
    "downsample num to --scaled": [["sig", "downsample", "num.sig", "--scaled", "10000"]],
    "downsample to a lower scaled: refused": [["sig", "downsample", "g0.sig", "--scaled",
                                               "100"]],
    "downsample --num and --scaled: refused": [["sig", "downsample", "g0.sig", "--scaled",
                                                "2000", "--num", "50"]],
    # interchange with mash
    "export": [["sig", "export", "g0.sig", "-o", "e.json"]],
    "export num, --md5, stdout": [["sig", "export", "num.sig", "--md5", "{md5:num.sig}"]],
    "import mash json": [["sig", "import", "mash.json", "-o", "i.sig"]],
    "ingest --csv": [["sig", "ingest", "--csv", "mash.csv"]],
    "export then import": [["sig", "export", "num.sig", "-k", "31", "--md5",
                            "{md5:num.sig}", "-o", "e.json"],
                           ["sig", "ingest", "e.json", "-o", "back.zip"]],
    # manifest/collection management
    "collect sql": [["sig", "collect", "coll.zip", "g0.sig", "abund.sig", "-o", "c.sqlmf"]],
    "collect csv --relpath": [["sig", "collect", "coll.zip", "g1.sig", "-F", "csv",
                               "-o", "sub/c.csv", "--relpath"]],
    "collect csv --abspath": [["sig", "collect", "coll.zip", "--from-file", "from_file.txt",
                               "-F", "csv", "-o", "c.csv", "--abspath"]],
    "collect over an existing file: refused, then --merge-previous": [["sig", "collect", "g0.sig", "-F", "csv", "-o", "c.csv"],
                                 ["sig", "collect", "g1.sig", "-F", "csv", "-o", "c.csv"],
                                 ["sig", "collect", "g1.sig", "abund.sig", "-F", "csv",
                                  "-o", "c.csv", "--merge-previous"],
                                 ["sig", "collect", "g2.sig", "-o", "c.sqlmf",
                                  "--merge-previous"],
                                 ["sig", "collect", "g3.sig", "-o", "c.sqlmf",
                                  "--merge-previous"]],
    "grep": [["sig", "grep", "genome 1", "coll.zip"]],
    "grep -v -i, -k 21, -o zip": [["sig", "grep", "-v", "-i", "CLADE 0", "multi.sig", "-k",
                                   "21", "-o", "gr.zip"]],
    "grep -c": [["sig", "grep", "-c", "genome", "coll.zip"]],
    "grep --csv --silent": [["sig", "grep", "clade [12]", "coll.zip", "--csv", "gr.csv",
                             "--silent"]],
    "grep, no match: refused": [["sig", "grep", "absent", "multi.sig"]],
    "check, no picklist: refused": [["sig", "check", "coll.zip"]],
    "signature alias": [["signature", "describe", "g0.sig"], ["signature", "fileinfo",
                                                              "num.sig"]],
    # picklists
    "cat --picklist name": [["sig", "cat", "coll.zip", "--picklist", "pl.csv:name:name",
                             "-o", "out.sig"]],
    "cat --picklist ident:exclude": [["sig", "cat", "coll.zip", "-k", "31", "--picklist",
                                      "pl.csv:ident:ident:exclude"]],
    "cat --picklist md5, zip": [["sig", "cat", "multi.sig", "--picklist", "pl.csv:md5:md5",
                                 "-o", "out.zip"]],
    "extract --picklist ident": [["sig", "extract", "coll.zip", "--picklist",
                                  "pl.csv:ident:ident"]],
    "extract --picklist md5short": [["sig", "extract", "multi.sig", "--picklist",
                                     "pl.csv:md5short:md5short", "-o", "e.sig"]],
    "extract --picklist name:exclude": [["sig", "extract", "multi.sig", "-k", "31",
                                         "--picklist", "pl.csv:name:name:exclude"]],
    "extract --picklist-require-all, all found": [["sig", "extract", "coll.zip",
                                                   "--picklist", "pl.csv:md5:md5",
                                                   "--picklist-require-all"]],
    "extract --picklist-require-all, one missing: refused": [["sig", "extract", "coll.zip",
                                                     "--picklist", "plx.csv:md5:md5",
                                                     "--picklist-require-all"]],
    "cat --picklist-require-all, one missing: refused": [["sig", "cat", "coll.zip", "--picklist",
                                                 "plx.csv:ident:ident",
                                                 "--picklist-require-all"]],
    "check --picklist name": [["sig", "check", "coll.zip", "--picklist", "plx.csv:name:name",
                               "-o", "missing.csv", "-m", "mf.csv"]],
    "check --picklist ident, sql, --abspath": [["sig", "check", "coll.zip", "multi.sig",
                                                "--picklist", "pl.csv:ident:ident", "-m",
                                                "mf.sqlmf", "-F", "sql", "--abspath"]],
    "check --picklist md5short, --relpath": [["sig", "check", "coll.zip", "--picklist",
                                              "plx.csv:md5short:md5short", "-m",
                                              "sub/mf.csv", "--relpath", "-k", "31"]],
    "check --picklist md5, --fail-if-missing, one missing: refused": [["sig", "check", "coll.zip", "--picklist",
                                                 "plx.csv:md5:md5", "--fail-if-missing",
                                                 "-o", "missing.csv"]],
    "check --picklist md5, all found": [["sig", "check", "coll.zip", "--picklist",
                                         "pl.csv:md5:md5", "--fail-if-missing", "-o",
                                         "missing.csv", "-m", "mf.csv"]],
    "check --picklist exclude with -o: refused": [["sig", "check", "coll.zip", "--picklist",
                                                   "pl.csv:md5:md5:exclude", "-o",
                                                   "missing.csv"]],
    "check sigs without a manifest": [["sig", "check", "multi.sig", "--picklist",
                                       "pl.csv:md5:md5", "-m", "mf.csv"],
                                      ["sig", "check", "multi.sig", "--picklist",
                                       "pl.csv:md5:md5", "-m", "mf2.csv",
                                       "--no-require-manifest"]],
    "gather --picklist against a zip": [["gather", "meta.sig", "coll.zip", "--picklist",
                                         "pl.csv:md5:md5", "-o", "g.csv"],
                                        ["gather", "meta.sig", "coll.zip", "--picklist",
                                         "pl.csv:ident:ident:exclude", "-k", "31",
                                         "-o", "gx.csv"]],
}

SUBCOMMANDS = (
    "cat", "split", "describe", "manifest", "overlap", "merge", "intersect", "inflate",
    "subtract", "rename", "extract", "filter", "flatten", "downsample", "fileinfo",
    "summarize", "kmers", "export", "import", "ingest", "check", "collect", "grep",
)


def _expand(world, argv):
    "Fill `{md5:FILE}` with the md5 of FILE's first signature."
    out = []
    for arg in argv:
        if arg.startswith("{md5:"):
            path = arg[len("{md5:"):-1]
            arg = next(iter(sourmash_tpu_torch.load_file_as_signatures(str(world / path)))).md5sum()
        out.append(arg)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_sig_commands_are_identical(world, case, tmp_path, monkeypatch, capsys):
    argvs = [_expand(world, argv) for argv in CASES[case]]
    outputs = _both(world, argvs, tmp_path, monkeypatch, capsys)
    rcs, out, err, files = outputs["torch"]
    assert outputs["torch"][:3] == outputs["jax"][:3]
    assert files.keys() == outputs["jax"][3].keys()
    for name in files:
        assert files[name] == outputs["jax"][3][name], name
    made = set(files) - set(_snapshot(world))
    if "refused" in case:
        assert any(rc not in (None, 0) for rc in rcs), err
    else:
        assert all(rc in (None, 0) for rc in rcs) and (out or made), err


def test_every_subcommand_is_run():
    run = {argv[1] for argvs in CASES.values() for argv in argvs if argv[0] in ("sig", "signature")}
    assert run | {"kmers"} == set(SUBCOMMANDS)
    assert len(SUBCOMMANDS) == 23


# -- sig kmers ----------------------------------------------------------------

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
LONG_DNA = (1 << 16) + 4_000  # past minhash._DEVICE_MIN_LEN
LONG_AA = (1 << 16) + 400  # past 2^16 windows
LONG_TR = 3 * ((1 << 16) + 200)  # each frame past 2^16 windows


def _fasta(path, records):
    with open(path, "w") as fp:
        for name, seq in records:
            fp.write(f">{name}\n{seq}\n")


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """Sequence files and query sketches for `sig kmers`: each query sketches
    a part of a long record (on the host: under the device lengths) and a
    short record."""
    from sourmash_tpu.save_load import SaveSignaturesToLocation as JaxSave

    rng = np.random.default_rng(77)
    d = tmp_path_factory.mktemp("kmers")
    dna = {n: rng.choice(ACGT, size=s).tobytes().decode() for n, s in (
        ("long1", LONG_DNA), ("short1", 2_000), ("short2", 1_500), ("tr", LONG_TR))}
    aa = {n: rng.choice(AA, size=s).tobytes().decode() for n, s in (
        ("plong", LONG_AA), ("pshort", 600))}
    _fasta(d / "dna.fa", [("long1 first", dna["long1"]), ("short1", dna["short1"]),
                          ("short2", dna["short2"])])
    _fasta(d / "short.fa", [("short1", dna["short1"]), ("short2", dna["short2"])])
    _fasta(d / "prot.faa", [("plong", aa["plong"]), ("pshort", aa["pshort"])])
    _fasta(d / "tr.fa", [("tr", dna["tr"])])
    bad = dna["long1"][:30_000] + "X" + dna["long1"][30_001:]
    _fasta(d / "badlong.fa", [("badlong a record with a name longer than forty characters",
                               bad), ("short1", dna["short1"])])
    _fasta(d / "badshort.fa", [("badshort", dna["short1"][:900] + "X" + dna["short1"][901:]),
                               ("long1", dna["long1"])])

    mh = JaxMinHash(0, 31, scaled=SCALED)
    mh.add_sequence(dna["long1"][5_000:60_000])
    mh.add_sequence(dna["short1"][:1_200])
    mh100 = JaxMinHash(0, 31, scaled=100)
    mh100.add_sequence(dna["long1"][20_000:30_000])
    pmh = JaxMinHash(0, 10, is_protein=True, scaled=200)
    pmh.add_protein(aa["plong"][1_000:30_000])
    pmh.add_protein(aa["pshort"])
    tmh = JaxMinHash(0, 10, is_protein=True, scaled=200)
    tmh.add_sequence(dna["tr"][3_000:40_000])
    for name, sk in (("dnaq.sig", mh), ("dnaq100.sig", mh100), ("protq.sig", pmh),
                     ("trq.sig", tmh)):
        with JaxSave(str(d / name)) as save:
            save.add(sourmash_tpu.SourmashSignature(sk, name=name[:-4]))
    return d


K1, K2, K3 = "survivor_slots", "window_hashes", "aa_window_hashes"
# the JAX package's function that calls each kernel's Pallas counterpart
JAX_ENTRY = {K1: "seq_chunks_to_hashes", K2: "seq_chunks_to_hashes",
              K3: "aa_chunks_to_hashes"}

# case -> (arguments, the kernels whose wrappers the port must call, exit code)
KMERS_CASES = {
    "dna, --save-sequences": (["--signatures", "dnaq.sig", "--sequences", "dna.fa",
                               "--save-sequences", "s.fa"], {K1}, None),
    "dna, scaled=100": (["--signatures", "dnaq100.sig", "--sequences", "dna.fa"], {K2}, None),
    "dna, short records, --save-kmers": (["--signatures", "dnaq.sig", "--sequences",
                                          "short.fa", "--save-kmers", "k.csv",
                                          "--save-sequences", "s.fa"], set(), None),
    "protein, --save-sequences": (["--signatures", "protq.sig", "--sequences", "prot.faa",
                                   "--save-sequences", "s.fa"], {K3}, None),
    "translate, --save-sequences": (["--signatures", "trq.sig", "--sequences", "tr.fa",
                                     "--translate", "--save-sequences", "s.fa"], {K3}, None),
    "translate with a DNA query: refused": (["--signatures", "dnaq.sig", "--sequences",
                                             "dna.fa", "--translate"], set(), -1),
    # the long record comes first in badlong.fa, last in badshort.fa
    "invalid byte in a long record": (["--sequences", "badlong.fa"], {K1}, None),
    "invalid byte in a long record --check-sequence": (
        ["--sequences", "badlong.fa", "--check-sequence"], set(), -1),
    "invalid byte in a long record --check-sequence --force": (
        ["--sequences", "badlong.fa", "--check-sequence", "--force"], set(), None),
    "invalid byte in a short record": (["--sequences", "badshort.fa"], {K1}, None),
    "invalid byte in a short record --check-sequence": (
        ["--sequences", "badshort.fa", "--check-sequence"], set(), -1),
    "invalid byte in a short record --check-sequence --force": (
        ["--sequences", "badshort.fa", "--check-sequence", "--force"], {K1}, None),
}


def _spy(monkeypatch, mod, names, calls, tag):
    "Count the calls of each of mod's `names` into calls[(tag, name)]."
    for name in names:
        real = getattr(mod, name)

        def spy(*a, _real=real, _key=(tag, name), **kw):
            calls[_key] = calls.get(_key, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("case", list(KMERS_CASES))
def test_sig_kmers_is_identical(seqs, case, tmp_path, monkeypatch, capsys):
    args, kernels, want_rc = KMERS_CASES[case]
    if "--signatures" not in args:
        args = ["--signatures", "dnaq.sig", *args]
    monkeypatch.setenv("SOURMASH_PALLAS", "1")
    if K3 not in kernels:
        # the JAX package takes its device branch for DNA on a CPU backend only so
        monkeypatch.setenv("SOURMASH_TPU_HOST_SKETCH", "numpy")
    calls = {}
    _spy(monkeypatch, jax_sketch, set(JAX_ENTRY.values()), calls, "jax")
    _spy(monkeypatch, cuda_sketch, (K1, K2, K3), calls, "torch")
    outputs = _both(seqs, [["sig", "kmers", *args]], tmp_path, monkeypatch, capsys)
    assert outputs["torch"] == outputs["jax"]
    (rc,), out, err, files = outputs["torch"]
    assert rc == want_rc, err
    if "invalid" in case:
        assert ("ERROR in sequence" in err) == ("check-sequence" in case)
        assert ("invalid DNA character" in err) == ("check-sequence" in case)
    if rc is None:
        assert "distinct matching hashes" in err
    assert {name for (tag, name) in calls if tag == "torch"} == kernels
    assert {name for (tag, name) in calls if tag == "jax"} == {JAX_ENTRY[k] for k in kernels}
    if "save-sequences" in case:
        assert files["s.fa"].count(b">") >= 1
    if "save-kmers" in case:
        assert files["k.csv"].count(b"\n") > 1
