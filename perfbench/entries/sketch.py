"""Entry adapter of the sketch configurations: `sourmash sketch dna`.

A request is one call of `sourmash_tpu_torch.__main__.main(["sketch", "dna",
"-p", PARAMS, FILES..., "-o", OUT.zip])` in this process, on the files the
traffic gives it, its zip written under the run's temporary directory.
Entry points the benchmark calls (a later change keeps them callable):
`sourmash_tpu_torch.__main__.main` and, wrapped with the trace on to time
parsing, `sourmash_tpu_torch.sequence_io.iter_record_batches`.

`correct` compares the mins and abundances of every k of every signature
the window wrote with the plain numpy sketch of
`perfbench/reference/sketch.py`, computed once for each distinct input.
"""

from __future__ import annotations

import gzip
import json
import math
import os
import zipfile

import numpy as np

from perfbench.lib import traffic
from perfbench.reference import sketch as ref


def _param_ks(params: str) -> tuple:
    "(ksizes, scaled) of a `-p` string such as k=21,k=31,scaled=1000,abund."
    ks, scaled = [], 0
    for part in params.split(","):
        if part.startswith("k="):
            ks.append(int(part[2:]))
        elif part.startswith("scaled="):
            scaled = int(part[7:])
    return tuple(ks), scaled


def read_zip(path: str) -> dict:
    "{(filename, ksize): (mins, abundances)} of every sketch in a signature zip."
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            if not name.endswith((".sig", ".sig.gz")):
                continue
            raw = zf.read(name)
            if name.endswith(".gz"):
                raw = gzip.decompress(raw)
            for sig in json.loads(raw):
                for mh in sig["signatures"]:
                    mins = np.array(mh["mins"], dtype=np.uint64)
                    ab = np.array(mh.get("abundances", []), dtype=np.uint64)
                    out[(sig.get("filename", ""), int(mh["ksize"]))] = (mins, ab)
    return out


def _valid_windows(records, k: int) -> int:
    "Windows of k bases holding only A, C, G or T (either case)."
    n = 0
    for r in records:
        if len(r) < k:
            continue
        bad = np.zeros(len(r) + 1, dtype=np.int32)
        np.cumsum(~ref.ACGT[ref.UPPER[r]], out=bad[1:])
        n += int(np.count_nonzero(bad[k:] == bad[:-k]))
    return n


class Session:
    work_unit = "Mbp"

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.params("config"), ctx.params("traffic")
        self.cfg, self.tr = cfg, tr
        self.params = cfg["params"]
        self.ks, self.scaled = _param_ks(self.params)
        if ctx.device == "cpu":
            os.environ["SOURMASH_TORCH_DEVICE"] = "cpu"
        from sourmash_tpu_torch import sequence_io
        from sourmash_tpu_torch.__main__ import main

        self.main = main
        if ctx.spans.traced:
            sequence_io.iter_record_batches = _timed_batches(sequence_io.iter_record_batches,
                                                             ctx.spans)
        inputs = os.path.join(ctx.workdir, "inputs")
        self.outdir = os.path.join(ctx.workdir, "out")
        os.makedirs(self.outdir)
        shape = tr["shape"]
        with ctx.phase("inputs"):
            if shape == "assemblies":
                pool = traffic.assemblies(tr, ctx.seed, inputs)
                self.files = [p for p, _, _ in pool]
                self.records = [r for _, r, _ in pool]
                self.bases = [b for _, _, b in pool]
            elif shape == "reads":
                os.makedirs(inputs)
                path = os.path.join(inputs, "sample.fq.gz")
                reads, bases = traffic.reads(tr, ctx.seed, path)
                # the reference sees the reads joined by an N, which no valid
                # window spans, in runs of 2^16 reads
                joined = np.empty((reads.shape[0], reads.shape[1] + 1), dtype=np.uint8)
                joined[:, :-1] = reads
                joined[:, -1] = ord("N")
                runs = [joined[lo : lo + (1 << 16)].ravel() for lo in range(0, len(joined), 1 << 16)]
                self.files, self.records, self.bases = [path], [runs], [bases]
            else:
                raise ValueError(f"the sketch entry has no traffic shape {shape!r}")
        self.per_request = int(tr["files_per_request"])
        # a window ends only after whole passes over the pool, so each holds the same files
        self.cycle = math.lcm(len(self.files), self.per_request) // self.per_request
        self.outputs = {}
        self.control = {}

    def describe(self) -> str:
        return (f"{len(self.files)} input files, {sum(self.bases) / 1e6:.1f} Mbp, "
                f"{self.per_request} a request")

    def _files_of(self, i: int) -> list:
        n = len(self.files)
        return [(i * self.per_request + j) % n for j in range(self.per_request)]

    def _run(self, idx: list, out: str):
        argv = ["sketch", "dna", "-q", "-p", self.params, *[self.files[j] for j in idx], "-o", out]
        rc = self.main(argv)
        if rc not in (None, 0):
            raise RuntimeError(f"sketch exited with {rc}")

    def warm(self):
        "One request of the cell's own shapes, outside the window."
        out = os.path.join(self.ctx.workdir, "warm.zip")
        self._run(self._files_of(0), out)
        os.remove(out)

    def request(self, i: int) -> float:
        idx = self._files_of(i)
        out = os.path.join(self.outdir, f"request_{i}.zip")
        self.outputs[i] = (out, idx)
        if self.ctx.program == "control":
            # the control: the reference on the forward strand alone
            jobs = {j: self.records[j] for j in idx}
            got = ref.reference_sketches(jobs, self.ks, self.scaled, self._workers(), canonical=False)
            self.control[i] = {(self.files[j], k): got[(j, k)] for j in idx for k in self.ks}
        else:
            self._run(idx, out)
        return sum(self.bases[j] for j in idx) / 1e6

    def _workers(self) -> int:
        return int(self.cfg.get("reference_workers", 1))

    def counters(self, completed: int) -> dict:
        "The window's work from its inputs: bases, and valid windows of each k."
        uses = {}
        for i in range(completed):
            for j in self._files_of(i):
                uses[j] = uses.get(j, 0) + 1
        out = {"bases": sum(self.bases[j] * n for j, n in uses.items()), "ks": list(self.ks),
               "scaled": self.scaled}
        for k in self.ks:
            out[f"windows_k{k}"] = sum(_valid_windows(self.records[j], k) * n
                                       for j, n in uses.items())
        return out

    def close(self):
        pass

    def check(self, completed: int) -> list:
        """Every k's mins and abundances of every signature the window
        wrote, against the reference of its input (each distinct input
        sketched once)."""
        written = [(i, j) for i in range(completed) for j in self._files_of(i)]
        jobs = {j: self.records[j] for j in sorted({j for _, j in written})}
        want_sk = ref.reference_sketches(jobs, self.ks, self.scaled, self._workers())
        missing = mism_hash = mism_abund = 0
        for i in range(completed):
            got_all = self.control[i] if i in self.control else read_zip(self.outputs[i][0])
            for j in self._files_of(i):
                for k in self.ks:
                    got = got_all.get((self.files[j], k))
                    if got is None:
                        missing += 1
                        continue
                    mins, ab = want_sk[(j, k)]
                    gm, ga = got
                    mism_hash += int(len(np.setxor1d(gm, mins)))
                    common, ia, ib = np.intersect1d(gm, mins, assume_unique=True,
                                                    return_indices=True)
                    if len(ga) != len(gm):
                        mism_abund += len(common)
                    else:
                        mism_abund += int(np.count_nonzero(ga[ia] != ab[ib]))
        return [("sketches_missing", missing, 0), ("hashes_mismatched", mism_hash, 0),
                ("abundances_mismatched", mism_abund, 0)]


def _timed_batches(orig, spans):
    "iter_record_batches with each step of its iteration inside the `parse` span."
    def iter_record_batches(*args, **kwargs):
        it = orig(*args, **kwargs)
        while True:
            with spans.span("parse"):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    return iter_record_batches
