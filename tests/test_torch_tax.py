"""`sourmash tax` in the port against the JAX package, on the CPU.

Both `main`s run each case in this process from one directory that holds a
fresh copy of the inputs (`test_torch_sig._both`); exit codes, stdout,
stderr (the package name aside) and every file must be the same bytes.

The gather CSVs come from one small gather per query, made by the JAX
package in the module's fixture on a collection of 30 genomes (under the
512-sketch flat-view threshold: the host route). The taxonomies are
generated from the genomes' clades in three forms: NCBI-style ranks, LINs
(with a lingroup file) and ICTV ranks. Every `tax` subcommand runs, the
`taxonomy` alias once, and every `tax metagenome` output format: human,
csv_summary, krona, lineage_summary, kreport, lingroup and bioboxes.
"""

import numpy as np
import pytest

import sourmash_tpu_torch
from sourmash_tpu.__main__ import main as jax_main
from sourmash_tpu.cli import SourmashParser as JaxParser
from sourmash_tpu_torch.cli import SourmashParser as TorchParser
from sourmash_tpu_torch.save_load import SaveSignaturesToLocation
from test_torch_sig import _both, _snapshot

SCALED = 1000
N_GENOMES = 30
RANKS = ("superkingdom", "phylum", "class", "order", "family", "genus", "species", "strain")
ICTV = ("realm", "subrealm", "kingdom", "subkingdom", "phylum", "subphylum", "class",
        "subclass", "order", "suborder", "family", "subfamily", "genus", "subgenus",
        "species", "name")
FORMATS = ("human", "csv_summary", "krona", "lineage_summary", "kreport", "lingroup",
           "bioboxes")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("SOURMASH_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SOURMASH_TORCH_VIEW_CACHE_DIR", str(tmp_path / "_torch_viewcache"))
    for parser in (JaxParser, TorchParser):
        monkeypatch.setattr(parser, "_citation_printed", True)


def _sig(mins, name):
    params = dict(ksize=31, moltype="DNA", num=0, scaled=SCALED, seed=42)
    return sourmash_tpu_torch.signature_from_arrays(params, mins, name=name,
                                                    filename=f"{name.split()[0]}.fa")


def _save(path, sigs):
    with SaveSignaturesToLocation(str(path)) as save:
        for ss in sigs:
            save.add(ss)


def _lineage(clade, i):
    return ["d__Bacteria", f"p__P{clade % 2}", f"c__C{clade % 3}", f"o__O{clade % 4}",
            f"f__F{clade % 5}", f"g__G{clade}", f"s__G{clade} sp{i % 2}", f"strain {i}"]


def _taxpath(clade, i):
    "NCBI-style taxids of each rank, '|'-separated (bioboxes reads them)."
    return "|".join(str(x) for x in (2, 100 + clade % 2, 200 + clade % 3, 300 + clade % 4,
                                     400 + clade % 5, 500 + clade, 600 + 2 * clade + i % 2,
                                     1000 + i))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """30 genomes named 'GCF_N.1 genome N' in a zip; their taxonomy as ranks
    with taxids (one genome left out), LINs with lingroups, and ICTV ranks; gather CSVs
    of two metagenomes and one genome-like query."""
    rng = np.random.default_rng(4242)
    d = tmp_path_factory.mktemp("tax")
    genomes = []
    for i in range(N_GENOMES):
        n = int(rng.integers(300, 700))
        genomes.append(np.unique(rng.integers(0, (1 << 64) // SCALED, size=n, dtype=np.uint64)))
    clades = [i % 7 for i in range(N_GENOMES)]
    names = [f"GCF_{i:06d}.1 genome {i}" for i in range(N_GENOMES)]
    _save(d / "coll.zip", [_sig(m, n) for m, n in zip(genomes, names)])

    ident = [n.split()[0] for n in names]
    rows = [",".join(("ident",) + RANKS + ("taxpath",))]
    rows += [",".join([ident[i]] + _lineage(clades[i], i) + [_taxpath(clades[i], i)])
             for i in range(N_GENOMES) if i != 4]
    (d / "tax.csv").write_text("\n".join(rows) + "\n")
    rows = ["ident,lin"]
    rows += [f"{ident[i]},{clades[i] % 2};{clades[i] % 3};{clades[i]};{i % 4};{i}"
             for i in range(N_GENOMES)]
    (d / "lin.csv").write_text("\n".join(rows) + "\n")
    (d / "lingroups.csv").write_text("name,lin\n" + "".join(
        f"group_{a}_{b},{a};{b}\n" for a in range(2) for b in range(3)) + "lone,0;0;0\n")
    rows = [",".join(("ident",) + ICTV)]
    for i in range(N_GENOMES):
        c = clades[i]
        ranks = [f"Riboviria{c % 2}", "", f"Orthornavirae{c % 3}", "", f"Pisuviricota{c}", "",
                 f"Pisoniviricetes{c}", "", f"Nidovirales{c}", f"Cornidovirineae{c}",
                 f"Coronaviridae{c}", "", f"Betacoronavirus{c}", "", f"virus {c} {i % 2}",
                 f"isolate {i}"]
        rows.append(",".join([ident[i]] + ranks))
    (d / "ictv.csv").write_text("\n".join(rows) + "\n")

    queries = {
        "q1": [1, 2, 4, 9, 15, 22],
        "q2": [3, 9, 10, 17, 28],
    }
    for q, picks in queries.items():
        mins = np.concatenate([g[rng.random(len(g)) < 0.7] for g in (genomes[i] for i in picks)]
                              + [rng.integers(0, (1 << 64) // SCALED, size=400, dtype=np.uint64)])
        _save(d / f"{q}.sig", [_sig(np.unique(mins), f"{q} metagenome")])
    g = genomes[11]
    _save(d / "qg.sig", [_sig(np.unique(np.concatenate([g[rng.random(len(g)) < 0.9],
                                                         genomes[12][:40]])), "qg genome")])
    for q in ("q1", "q2", "qg"):
        assert jax_main(["gather", f"{d}/{q}.sig", f"{d}/coll.zip", "-o", f"{d}/{q}.csv",
                         "-q", "--threshold-bp", "20000"]) in (None, 0)
    (d / "from_file.txt").write_text("q1.csv\nq2.csv\n")
    (d / "out").mkdir()
    return d


MG = ["tax", "metagenome", "-g", "q1.csv", "-t", "tax.csv"]  # q1 holds genome 4, untaxed
MG2 = ["tax", "metagenome", "-g", "q2.csv", "-t", "tax.csv"]
CASES = {
    # tax metagenome: every output format
    "metagenome": [MG],
    "metagenome -F human": [MG + ["-F", "human"]],
    "metagenome -F krona -r species": [MG + ["-F", "krona", "-r", "species"]],
    "metagenome -F lineage_summary, two queries": [
        ["tax", "metagenome", "-g", "q1.csv", "q2.csv", "-t", "tax.csv", "-F",
         "lineage_summary", "-r", "genus"]],
    "metagenome -F kreport": [MG + ["-F", "kreport", "-r", "species"]],
    "metagenome -F bioboxes": [MG2 + ["-F", "bioboxes"]],
    "metagenome -F bioboxes, a match without taxonomy": [MG + ["-F", "bioboxes"]],
    "metagenome, every format to files": [MG2 + [
        "-F", "human", "csv_summary", "krona", "lineage_summary", "kreport", "bioboxes",
        "-r", "family", "-o", "mg", "--output-dir", "out"]],
    "metagenome --from-file, single-query formats dropped": [
        ["tax", "metagenome", "--from-file", "from_file.txt", "-t", "tax.csv", "-F",
         "csv_summary", "kreport", "-o", "both"]],
    "metagenome, only single-query formats for two: refused": [
        ["tax", "metagenome", "-g", "q1.csv", "q2.csv", "-t", "tax.csv", "-F", "kreport",
         "-o", "both"]],
    "metagenome --lins --lingroup": [
        ["tax", "metagenome", "-g", "q1.csv", "-t", "lin.csv", "--lins", "--lingroup",
         "lingroups.csv", "-o", "lin", "-F", "human", "csv_summary"]],
    "metagenome --lins -F lingroup, stdout": [
        ["tax", "metagenome", "-g", "q1.csv", "-t", "lin.csv", "--lins", "--lingroup",
         "lingroups.csv", "-F", "lingroup"]],
    "metagenome --lins -F lineage_summary -r 2": [
        ["tax", "metagenome", "-g", "q1.csv", "q2.csv", "-t", "lin.csv", "--lins", "-F",
         "lineage_summary", "-r", "2"]],
    "metagenome --lins -F kreport: refused": [
        ["tax", "metagenome", "-g", "q1.csv", "-t", "lin.csv", "--lins", "-F", "kreport"]],
    "metagenome --ictv": [
        ["tax", "metagenome", "-g", "q1.csv", "-t", "ictv.csv", "--ictv", "-F", "human",
         "csv_summary", "-o", "ictv"]],
    "metagenome -F krona without --rank: refused": [MG + ["-F", "krona"]],
    "metagenome --fail-on-missing-taxonomy: refused": [MG + ["--fail-on-missing-taxonomy"]],
    "metagenome, taxonomy from tax prepare": [
        ["tax", "prepare", "-t", "tax.csv", "-o", "tax.db"],
        ["tax", "metagenome", "-g", "q1.csv", "-t", "tax.db", "-F", "human"]],
    "taxonomy alias": [["taxonomy", "metagenome", "-g", "q2.csv", "-t", "tax.csv", "-F",
                        "human", "-r", "order"]],
    # tax genome
    "genome": [["tax", "genome", "-g", "qg.csv", "-t", "tax.csv"]],
    "genome --ani-threshold, -r species, files": [
        ["tax", "genome", "-g", "qg.csv", "q1.csv", "-t", "tax.csv", "--ani-threshold",
         "0.95", "-r", "species", "-F", "human", "krona", "lineage_csv", "csv_summary",
         "-o", "g", "--output-dir", "out"]],
    "genome --containment-threshold": [
        ["tax", "genome", "-g", "qg.csv", "q2.csv", "-t", "tax.csv",
         "--containment-threshold", "0.05", "-F", "human"]],
    "genome --lins": [["tax", "genome", "-g", "qg.csv", "-t", "lin.csv", "--lins"]],
    "genome --ictv -r genus": [["tax", "genome", "-g", "qg.csv", "-t", "ictv.csv", "--ictv",
                                "-r", "genus"]],
    # tax annotate
    "annotate": [["tax", "annotate", "-g", "q1.csv", "q2.csv", "-t", "tax.csv", "-o", "out"]],
    "annotate --lins --from-file": [["tax", "annotate", "--from-file", "from_file.txt", "-t",
                                     "lin.csv", "--lins"]],
    "annotate, then metagenome from its output": [
        ["tax", "annotate", "-g", "q1.csv", "-t", "tax.csv"],
        ["tax", "metagenome", "-g", "q1.csv", "-t", "q1.with-lineages.csv", "-F", "human"]],
    # tax prepare
    "prepare -F csv": [["tax", "prepare", "-t", "tax.csv", "-F", "csv", "-o", "p.csv"]],
    "prepare -F sql, two taxonomies": [
        ["tax", "prepare", "-t", "tax.csv", "-t", "tax.csv", "-F", "sql", "-o", "p.db"]],
    "prepare --keep-full-identifiers": [
        ["tax", "prepare", "-t", "tax.csv", "-F", "csv", "-o", "p.csv",
         "--keep-full-identifiers", "--keep-identifier-versions"]],
    "prepare --keep-full-identifiers alone: refused": [
        ["tax", "prepare", "-t", "tax.csv", "-F", "csv", "-o", "p.csv",
         "--keep-full-identifiers"]],
    # tax grep
    "grep": [["tax", "grep", "g__G3", "-t", "tax.csv"]],
    "grep -r genus -i, -o": [["tax", "grep", "G__g[12]", "-r", "genus", "-i", "-t",
                              "tax.csv", "-o", "pick.csv"]],
    "grep -v -c": [["tax", "grep", "p__P0", "-v", "-c", "-t", "tax.csv"]],
    "grep --silent": [["tax", "grep", "s__G5", "--silent", "-t", "tax.csv"]],
    # tax summarize
    "summarize": [["tax", "summarize", "tax.csv"]],
    "summarize -o": [["tax", "summarize", "tax.csv", "-o", "counts.csv"]],
    "summarize --lins": [["tax", "summarize", "lin.csv", "--lins", "-o", "counts.csv"]],
    "summarize --ictv": [["tax", "summarize", "ictv.csv", "--ictv"]],
}


@pytest.mark.parametrize("case", list(CASES))
def test_tax_commands_are_identical(world, case, tmp_path, monkeypatch, capsys):
    outputs = _both(world, CASES[case], tmp_path, monkeypatch, capsys)
    rcs, out, err, files = outputs["torch"]
    assert outputs["torch"][:3] == outputs["jax"][:3]
    assert files.keys() == outputs["jax"][3].keys()
    for name in files:
        assert files[name] == outputs["jax"][3][name], name
    if "refused" in case:
        assert any(rc not in (None, 0) for rc in rcs), err
    else:
        made = set(files) - set(_snapshot(world))
        assert all(rc in (None, 0) for rc in rcs) and (out or made or "found" in err), err


def test_every_subcommand_and_format_is_run():
    argvs = [argv for argvs in CASES.values() for argv in argvs]
    assert {a[1] for a in argvs} == {"metagenome", "genome", "annotate", "prepare", "grep",
                                     "summarize"}
    formats = {f for a in argvs if a[1] == "metagenome" and "-F" in a
               for f in a[a.index("-F") + 1:] if f in FORMATS}
    assert formats == set(FORMATS)
