#!/usr/bin/env python3
"""Drive sourmash_tpu_torch on one CUDA card and hold it to its references.

    python3 chip_smoke.py [--quick] [--json PATH] [--profile]

Phases, each raising on failure:

1. Print the card (`nvidia-smi` name, power limit and maximum SM clock)
   and build the CUDA kernels and the native host library from the sources
   in this checkout; print the build time and ptxas' register report.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit, at the main path's row shape [4, 2^21 + k - 1] and at [32, ...],
   for k in {7, 21, 31, 33, 51, 63, 129} and max_hash for scaled 100, 512,
   768, 1000, 2000 and 2^64-1, on ACGT rows with N runs, a zero-padded
   tail and a tandem repeat that overflows K1's slots. Time each kernel
   (CUDA events, median per launch after warm-up) and its plain version,
   and work out the least time the card could take (`bound_ms`).
3. Sketch a generated multi-record FASTA.gz of >= 256 Mbp through
   `python -m sourmash_tpu_torch sketch dna` with sourmash's usual
   parameters, with the launch counters set to 0 just before and read just
   after; every sketch's mins and md5sum must equal the port's native C++
   host loop run on the same records, and a tandem-repeat record must come
   out of the slot-overflow reroute and the full-chunk retry with the host
   loop's exact multiset.
4. Sketch a generated protein FASTA.gz of >= 128 M residues (records of
   50-1,500 aa with X, * and lowercase stretches) through `sketch protein`
   with sourmash's protein, dayhoff and hp defaults and a num sketch into a
   zip collection, launch counters set to 0 just before and read just after;
   K3 must have run, the manifest must list every sketch, and every sketch
   must equal the native host loop (`add_protein` per record).
5. Sketch >= 64 Mbp of phase 3's kind of DNA through `sketch translate`
   (protein and dayhoff) and hold it to the native host loop the same way;
   then one `MinHash.add_protein` on a record above the device threshold.

Phase 2 also holds K3 against its plain version, bit for bit, at
[4, 2^21 + k - 1] and [32, ...] for k in {3, 7, 10, 16, 42, 64, 129}, on
residue rows, rows remapped through DAYHOFF and HP, zero separators and a
zero-padded tail, and times it and its plain version at [4, ...].

The last two lines are a JSON object with every kernel's numbers and then
`{"ok": true, "device": {...}}`. --quick stops after checking each kernel
once at the main path's shape, before the main path, and prints neither
line; --profile runs `sketch dna`, `sketch protein` and `sketch translate`
once more under cProfile and torch.profiler and prints where their time
goes. Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit). The card has no
# published integer rate. Per SM and clock it issues 64 IMADs (on the FMA
# pipe) and 64 other 32-bit integer ops (shifts, LOP3, IADD3 on the INT
# pipe), 128 of the two together; `int_bound_s` applies all three limits at
# the card's maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
SMS = 132
LANES_PER_PIPE = 64

KS = (7, 21, 31, 33, 51, 63, 129)
SCALEDS = (100, 512, 768, 1000, 2000)
TIMED_K = 31  # sourmash's default ksize: the kernels line reports this one
CHUNK = 1 << 21
MBP = 256  # end-to-end input: ~55 genomes the size of E. coli K-12 (4.64 Mbp)
PARAMS = ["k=21,k=31,k=51,scaled=1000", "k=31,scaled=100", "k=31,num=500"]

# K3: amino-acid ksizes (sourmash's defaults: protein 10, dayhoff 16, hp 42)
AA_KS = (3, 7, 10, 16, 42, 64, 129)
TIMED_AA_K = 10
AA_RESIDUES = b"ACDEFGHIKLMNPQRSTVWY"
M_AA = 128  # phase 4: ~95 proteomes the size of E. coli K-12's (4,300 proteins, 1.35 M aa)
PROTEIN_PARAMS = ["k=10,scaled=200", "dayhoff,k=16,scaled=200", "hp,k=42,scaled=200",
                  "k=10,num=500"]
HOST_MERGE_EVERY = 2000  # records per part sketch in the host loop (see host_sketches)
TRANSLATE_MBP = 64
TRANSLATE_PARAMS = ["k=10,scaled=200", "dayhoff,k=16,scaled=200"]


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def sm_clock_hz() -> float:
    "The card's maximum SM clock, as nvidia-smi reports it."
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout
    return float(out.splitlines()[0]) * 1e6


def max_hash_for(scaled: int) -> int:
    from sourmash_tpu_torch.minhash import _get_max_hash_for_scaled

    return _get_max_hash_for_scaled(scaled)


# -- the least time the card could take -------------------------------------


def int_ops_murmur(k: int) -> tuple:
    """(IMAD, other) 32-bit integer operations of murmur over k bytes at
    least: a 64-bit multiply as 3 IMADs, a multiply by 5 as 2; a 64-bit
    add, xor, rotate or shift-xor as 2 other ops."""
    tail = k & 15
    halves = 2 * (k // 16) + (tail > 0) + (tail > 8)
    # per 8-byte half: k *= c, rotl, k *= c, h ^= k (and per full block,
    # per half: rotl h, h += h', h = h * 5 + c)
    imad = 6 * halves + 2 * 2 * (k // 16)
    other = 4 * halves + 6 * 2 * (k // 16)
    # finish: two xors with len and two adds; two fmix64 (two multiplies
    # and three shift-xors each); the final add
    imad += 2 * 2 * 3
    other += 4 * 2 + 2 * 3 * 2 + 2
    return imad, other


def int_ops_per_window(k: int) -> tuple:
    """(IMAD, other) integer operations one canonical DNA window hash needs
    at least: murmur, the canonical bytes assembled four to an op for each
    strand, validity tested four bytes to an op, and the strand choice."""
    imad, other = int_ops_murmur(k)
    return imad, other + 3 * -(-k // 4) + 2


def int_ops_per_aa_window(k: int) -> tuple:
    """(IMAD, other) integer operations one amino-acid window hash (K3)
    needs at least: murmur, the bytes of one strand assembled four to an
    op, and the zero-byte validity test four bytes to an op."""
    imad, other = int_ops_murmur(k)
    return imad, other + 2 * -(-k // 4)


def bound_ms(nbytes: int, imad: int, other: int, clock_hz: float):
    """The least time for the work: bytes over the memory rate, or integer
    ops over the rate of each pipe and of both together."""
    pipe = SMS * LANES_PER_PIPE * clock_hz
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(imad / pipe, other / pipe, (imad + other) / (2 * pipe))
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- inputs ------------------------------------------------------------------


def tandem_unit(k: int, max_hash: int, rng) -> bytes:
    """A primitive repeat unit of period <= 14 one of whose k-mers survives
    max_hash: repeated, it puts >= 9 survivors in every 128 windows, more
    than either slot count, and ~128/period per segment in a long stretch."""
    from sourmash_tpu_torch.ops.encodings import dna_hashes

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    while True:
        p = int(rng.integers(6, 15))
        unit = rng.choice(acgt, size=p)
        seq = np.tile(unit, -(-(k + p) // p) + 1)
        h, valid = dna_hashes(seq, k, 42)
        if (valid & (h <= np.uint64(max_hash))).any():
            return unit.tobytes()


def dna_rows(B: int, k: int, rng, unit: bytes):
    """[B, 2^21 + k - 1] uppercased rows: ACGT with N runs, a 64 KiB tandem
    repeat of `unit` in row 0 and a zero-padded tail in the last row."""
    S = CHUNK + k - 1
    rows = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(B, S))
    for b in range(B):
        for start in rng.integers(0, S - 600, size=8):
            rows[b, start : start + int(rng.integers(1, 500))] = ord("N")
    rep = np.frombuffer(unit * (65536 // len(unit) + 1), dtype=np.uint8)[:65536]
    rows[0, 100_000 : 100_000 + rep.size] = rep
    rows[-1, S - 333_333 :] = 0
    return rows


def aa_rows(B: int, k: int, rng):
    """[B, 2^21 + k - 1] amino-acid rows as `_sketch_aa_file` builds them:
    records of 50-1,500 residues (the 20 amino acids, with X and *) joined
    by k zero bytes; every third row remapped through DAYHOFF, every third
    through HP; a zero-padded tail in the last row."""
    from sourmash_tpu_torch.ops.encodings import DAYHOFF, HP

    S = CHUNK + k - 1
    letters = np.frombuffer(AA_RESIDUES + b"X*", dtype=np.uint8)
    p = np.r_[np.full(20, 0.98 / 20), 0.01, 0.01]
    rows = rng.choice(letters, size=(B, S), p=p)
    for b in range(B):
        if b % 3:
            rows[b] = (DAYHOFF if b % 3 == 1 else HP)[rows[b]]
        ends = np.cumsum(rng.integers(50, 1501, size=S // 50 + 1) + k) - k
        for end in ends[ends < S]:
            rows[b, end : end + k] = 0
    rows[-1, S - 333_333 :] = 0
    return rows


# -- phase 2: kernels against their plain versions ---------------------------


def exact(name: str, got, want) -> float:
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: {bad} of {got.numel()} elements differ")
    return 0.0


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    "Median time per call on the card, by CUDA events around each call."
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(quick: bool, rng, clock_hz: float) -> dict:
    import torch

    from sourmash_tpu_torch.ops import cuda_sketch as cs
    from sourmash_tpu_torch.ops.sketch import _pick_slots

    thresholds = [max_hash_for(s) for s in SCALEDS] + [(1 << 64) - 1]
    results = {"window_hashes": {}, "survivor_slots": {}}
    ks = (TIMED_K,) if quick else KS
    for k in ks:
        unit = tandem_unit(k, max_hash_for(max(SCALEDS)), rng)
        for B in ((4,) if quick else (4, 32)):
            rows = torch.from_numpy(dna_rows(B, k, rng, unit)).cuda()
            h, v = cs.window_hashes(rows, ksize=k)
            hp, vp = cs.window_hashes_plain(rows, ksize=k)
            err = max(exact(f"K2 hashes k={k} B={B}", h, hp), exact(f"K2 valid k={k} B={B}", v, vp))
            for mh in thresholds:
                slots = _pick_slots(mh)
                got = cs.survivor_slots(rows, mh, ksize=k, slots=slots)
                want = cs.slots_from_hashes(hp, vp, mh, slots=slots)
                for name, a, b in zip(("hi", "lo", "counts"), got, want):
                    err = max(err, exact(f"K1 {name} k={k} B={B} max_hash={mh}", a, b))
                if int(got[2][0].max()) <= slots:
                    raise AssertionError(f"K1 k={k} max_hash={mh}: the tandem repeat did not overflow")
            del hp, vp
            log(f"  k={k:3d} B={B:2d}: K2 and K1 ({len(thresholds)} thresholds, each with "
                f"overflowing segments) equal their plain versions")
            if B == 4:
                S = rows.shape[1]
                n, R, n_pad = cs.geometry(S, k)
                mh = max_hash_for(1000)
                slots = _pick_slots(mh)
                reps = 3 if quick else 20
                t2 = time_ms(lambda: cs.window_hashes(rows, ksize=k), reps)
                t1 = time_ms(lambda: cs.survivor_slots(rows, mh, ksize=k, slots=slots), reps)
                p2 = time_ms(lambda: cs.window_hashes_plain(rows, ksize=k), 3, warmup=1)
                p1 = time_ms(lambda: cs.survivor_slots_plain(rows, mh, ksize=k, slots=slots), 3, warmup=1)
                imad, other = (B * n_pad * x for x in int_ops_per_window(k))
                b2 = bound_ms(B * S + B * n_pad * 9, imad, other, clock_hz)
                # K1 adds the threshold, the ballot and the rank per window
                b1 = bound_ms(B * S + B * R * (8 * slots + 4), imad, other + B * n_pad * 4, clock_hz)
                for name, ms, plain, (bms, by) in (
                    ("window_hashes", t2, p2, b2), ("survivor_slots", t1, p1, b1)
                ):
                    results[name][k] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                                            max_abs_err=err, windows=B * n)
                    log(f"    {name}: {ms:.4f} ms/launch, plain {plain:.3f} ms, "
                        f"bound {bms:.4f} ms ({by}), {B * n / ms / 1e6:.2f} Gwindows/s")
            del rows
            torch.cuda.empty_cache()
    results["aa_window_hashes"] = check_aa_kernel(quick, rng, clock_hz)
    return results


def check_aa_kernel(quick: bool, rng, clock_hz: float) -> dict:
    """K3 against its plain version, whole outputs bit for bit; timed at
    [4, ...] for every k (the kernels line reports k=10)."""
    import torch

    from sourmash_tpu_torch.ops import cuda_sketch as cs

    results = {}
    for k in ((TIMED_AA_K,) if quick else AA_KS):
        for B in ((4,) if quick else (4, 32)):
            rows = torch.from_numpy(aa_rows(B, k, rng)).cuda()
            h, v = cs.aa_window_hashes(rows, ksize=k)
            hp, vp = cs.aa_window_hashes_plain(rows, ksize=k)
            err = max(exact(f"K3 hashes k={k} B={B}", h, hp), exact(f"K3 valid k={k} B={B}", v, vp))
            n = cs.geometry(rows.shape[1], k)[0]
            share = float(v[:, :n].float().mean())
            if not 0.5 < share < 1.0 or bool(v[:, n:].any()):
                raise AssertionError(f"K3 k={k} B={B}: valid share {share} or padding valid")
            log(f"  k={k:3d} B={B:2d}: K3 equals its plain version ({100 * share:.2f} % valid)")
            del hp, vp
            if B == 4:
                S = rows.shape[1]
                _, _, n_pad = cs.geometry(S, k)
                t3 = time_ms(lambda: cs.aa_window_hashes(rows, ksize=k), 3 if quick else 20)
                p3 = time_ms(lambda: cs.aa_window_hashes_plain(rows, ksize=k), 3, warmup=1)
                imad, other = (B * n_pad * x for x in int_ops_per_aa_window(k))
                bms, by = bound_ms(B * S + B * n_pad * 9, imad, other, clock_hz)
                results[k] = dict(ms=t3, plain_ms=p3, bound_ms=bms, bound_by=by,
                                  max_abs_err=err, windows=B * n)
                log(f"    aa_window_hashes: {t3:.4f} ms/launch, plain {p3:.3f} ms, "
                    f"bound {bms:.4f} ms ({by}), {B * n / t3 / 1e6:.2f} Gwindows/s")
            del rows
            torch.cuda.empty_cache()
    return results


# -- phase 3: sketch dna end to end -----------------------------------------


def write_fasta(path: str, mbp: int, rng, units) -> tuple:
    """A FASTA.gz of at least `mbp` Mbp in records of 4.4-4.8 Mbp (E. coli
    sized genomes) with N runs and lowercase stretches; the last record
    carries a 1 Mbp tandem repeat of each unit. Returns (records, bases)."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_rec, total = 0, 0
    with gzip.open(path, "wb", compresslevel=1) as f:
        while total < mbp * 1_000_000:
            seq = rng.choice(acgt, size=int(rng.integers(4_400_000, 4_800_000)))
            for start in rng.integers(0, seq.size - 5000, size=20):
                seq[start : start + int(rng.integers(1, 2000))] = ord("N")
            for start in rng.integers(0, seq.size - 50_000, size=10):
                seq[start : start + int(rng.integers(100, 50_000))] |= 32  # lowercase
            if total + seq.size >= mbp * 1_000_000:
                for i, unit in enumerate(units):
                    rep = np.frombuffer(unit * (1_000_000 // len(unit) + 1), np.uint8)
                    at = 500_000 + 1_100_000 * i
                    seq[at : at + 1_000_000] = rep[:1_000_000]
            f.write(b">record_%d synthetic genome\n" % n_rec)
            full = seq.size // 80
            lines = np.empty((full, 81), dtype=np.uint8)
            lines[:, :80] = seq[: full * 80].reshape(full, 80)
            lines[:, 80] = ord("\n")
            f.write(lines.tobytes())
            if seq.size > full * 80:
                f.write(seq[full * 80 :].tobytes() + b"\n")
            n_rec += 1
            total += seq.size
    return n_rec, total


def _upper(seq: bytes) -> np.ndarray:
    from sourmash_tpu_torch.ops.encodings import UPPER

    return UPPER[np.frombuffer(seq, dtype=np.uint8)]


@contextlib.contextmanager
def native_host_loop():
    "Keep every sequence length on the port's native C++ host loop."
    before = os.environ.get("SOURMASH_TORCH_HOST_SKETCH")
    os.environ["SOURMASH_TORCH_HOST_SKETCH"] = "native"
    try:
        yield
    finally:
        if before is None:
            del os.environ["SOURMASH_TORCH_HOST_SKETCH"]
        else:
            os.environ["SOURMASH_TORCH_HOST_SKETCH"] = before


def host_sketches(path: str, mhs: dict, add: str = "add_sequence") -> dict:
    """The port's native C++ host loop over the records of `path`: every
    MinHash of `mhs` gets each record through `add` (add_sequence with
    force, or add_protein). Records go into an empty copy of each sketch
    that is merged into it every HOST_MERGE_EVERY records: an insert
    re-sorts the sketch's mins, so adding 10^5 short records straight into
    one large scaled sketch would take quadratic time. Merging is exact for
    scaled and num sketches."""
    from sourmash_tpu_torch.sequence_io import iter_records_bytes

    parts = {key: mh.copy_and_clear() for key, mh in mhs.items()}

    def merge_parts():
        for key, part in parts.items():
            mhs[key].merge(part)
            parts[key] = part.copy_and_clear()

    with native_host_loop():
        for i, (_name, seq) in enumerate(iter_records_bytes(path), 1):
            for part in parts.values():
                if add == "add_protein":
                    part.add_protein(seq)
                else:
                    part.add_sequence(seq, force=True)
            if i % HOST_MERGE_EVERY == 0:
                merge_parts()
        merge_parts()
    return mhs


def sketch_key(mh) -> tuple:
    return (mh.ksize, mh.moltype, mh.scaled, mh.num)


def dna_host_sketches(path: str) -> dict:
    from sourmash_tpu_torch import MinHash

    mhs = [MinHash(0, k, scaled=1000) for k in (21, 31, 51)]
    mhs += [MinHash(0, 31, scaled=100), MinHash(500, 31)]
    return host_sketches(path, {sketch_key(mh): mh for mh in mhs})


def check_against_host(what: str, got: dict, want: dict):
    "Every sketch equal to the host loop's, in its mins and md5sum."
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: sketches {sorted(got)} vs host {sorted(want)}")
    for key, mh in want.items():
        g = got[key]
        if not np.array_equal(g.mins_array(), mh.mins_array()) or g.md5sum() != mh.md5sum():
            raise AssertionError(f"{what}: sketch {key} differs from the native host loop")
        if len(mh) == 0:
            raise AssertionError(f"{what}: sketch {key} is empty")
        log(f"  {what} {key}: {len(mh)} mins, md5 {mh.md5sum()} == host")


def profiled(fn, what: str) -> dict:
    """Run fn once under cProfile and torch.profiler: the host functions
    that take the most time, the time each kernel ran on the card, and the
    card's busy share of the wall time."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        host.enable()
        fn()
        host.disable()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = {
        e.key: e.self_device_time_total / 1e3
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    }
    busy_ms = sum(kernels.values())
    out = io.StringIO()
    pstats.Stats(host, stream=out).sort_stats("tottime").print_stats(15)
    log(f"  profiled {what}: {wall:.2f} s wall, card busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / 1e3 / wall:.2f} %)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    device {ms:9.2f} ms  {name[:90]}")
    log(out.getvalue().split("\n\n", 1)[-1][:3000])
    return dict(wall_s=wall, device_busy_ms=busy_ms, device_ms_by_kernel=kernels)


def sketch_end_to_end(mbp: int, rng, tmp: str, profile_cli: bool = False) -> dict:
    import torch

    from sourmash_tpu_torch import load_signatures_from_json, native
    from sourmash_tpu_torch.__main__ import main as cli_main
    from sourmash_tpu_torch.ops import cuda_sketch as cs
    from sourmash_tpu_torch.ops.sketch import seq_chunks_to_hashes
    from sourmash_tpu_torch.sequence_io import iter_records_bytes

    units = [tandem_unit(k, max_hash_for(1000), rng) for k in (21, 31, 51)]
    path = os.path.join(tmp, "genomes.fa.gz")
    t0 = time.time()
    n_rec, bases = write_fasta(path, mbp, rng, units)
    log(f"  wrote {n_rec} records, {bases / 1e6:.2f} Mbp, in {time.time() - t0:.1f} s")

    out = os.path.join(tmp, "genomes.sig")
    argv = ["sketch", "dna", path, "-o", out]
    for p in PARAMS:
        argv += ["-p", p]
    wall, launches = run_cli("sketch dna", argv, ("survivor_slots", "window_hashes"))
    log(f"  sketch dna: {wall:.2f} s wall, {bases / 1e6 / wall:.1f} Mbp/s, launches {launches}")

    profile = None
    if profile_cli:
        profile = profiled(lambda: cli_main(argv + ["-q"]), "sketch dna")

    t0 = time.time()
    want = dna_host_sketches(path)
    log(f"  native host loop: {time.time() - t0:.1f} s")
    got = {sketch_key(sig.minhash): sig.minhash for sig in load_signatures_from_json(out)}
    check_against_host("sketch dna", got, want)

    # the tandem-repeat record: slot overflow -> dense reroute -> full-chunk
    # retry, with the host loop's exact multiset
    *_, (name, seq) = iter_records_bytes(path)
    seq = seq[:4_000_000]
    for k in (21, 31, 51):
        mh = max_hash_for(1000)
        cs.reset_launch_counts()
        hs = seq_chunks_to_hashes(seq, k, mh)
        rerouted = cs.LAUNCHES["window_hashes"]
        host, _ = native.sketch_hashes(_upper(seq), k, 42, mh)
        if not np.array_equal(np.sort(hs), np.sort(host)):
            raise AssertionError(f"tandem record k={k}: device multiset differs from host")
        if rerouted < 2:
            raise AssertionError(f"tandem record k={k}: expected reroute and retry, K2 ran {rerouted}x")
        log(f"  tandem record k={k}: {hs.size} survivors == host, K2 reroutes {rerouted}")
    return dict(wall_s=wall, mbp=bases / 1e6, records=n_rec, launches=launches,
                profile=profile)


# -- phase 4: sketch protein end to end -------------------------------------


def write_protein_fasta(path: str, m_aa: int, rng) -> tuple:
    """A FASTA.gz of at least `m_aa` M residues in records of 50-1,500 aa
    (the 20 amino acids, X runs, a terminal * on some records, lowercase
    stretches), one record per line. Returns (records, residues)."""
    letters = np.frombuffer(AA_RESIDUES, dtype=np.uint8)
    total = m_aa * 1_000_000
    lengths = rng.integers(50, 1501, size=total // 700)
    lengths = lengths[: int(np.searchsorted(np.cumsum(lengths), total)) + 1]
    res = rng.choice(letters, size=int(lengths.sum()))
    for start in rng.integers(0, res.size - 20, size=res.size // 2000):
        res[start : start + int(rng.integers(1, 20))] = ord("X")
    for start in rng.integers(0, res.size - 200, size=res.size // 20_000):
        res[start : start + int(rng.integers(10, 200))] |= 32  # lowercase
    ends = np.cumsum(lengths)
    res[ends[::3] - 1] = ord("*")
    starts = ends - lengths
    with gzip.open(path, "wb", compresslevel=1) as f:
        for i in range(0, lengths.size, 4096):
            block = []
            for j in range(i, min(i + 4096, lengths.size)):
                block.append(b">protein_%d synthetic\n" % j)
                block.append(res[starts[j] : ends[j]].tobytes())
                block.append(b"\n")
            f.write(b"".join(block))
    return int(lengths.size), int(res.size)


def protein_host_sketches(path: str) -> dict:
    from sourmash_tpu_torch import MinHash

    mhs = [MinHash(0, 10, is_protein=True, scaled=200), MinHash(0, 16, dayhoff=True, scaled=200),
           MinHash(0, 42, hp=True, scaled=200), MinHash(500, 10, is_protein=True)]
    return host_sketches(path, {sketch_key(mh): mh for mh in mhs}, add="add_protein")


def run_cli(what: str, argv: list, kernels=("aa_window_hashes",)) -> tuple:
    """One CLI run with the launch counters set to 0 just before and read
    just after: (wall, launches). Each of `kernels` must have launched."""
    import torch

    from sourmash_tpu_torch.__main__ import main as cli_main
    from sourmash_tpu_torch.ops import cuda_sketch as cs

    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t0 = time.time()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cs.LAUNCHES)
    if rc not in (None, 0):
        raise AssertionError(f"{what} returned {rc}")
    if min(launches[name] for name in kernels) < 1:
        raise AssertionError(f"{what}: a kernel of the path was not launched: {launches}")
    return wall, launches


def sketch_protein_end_to_end(m_aa: int, rng, tmp: str, profile_cli: bool = False) -> dict:
    import io
    import zipfile

    from sourmash_tpu_torch import load_signatures_from_json
    from sourmash_tpu_torch.__main__ import main as cli_main
    from sourmash_tpu_torch.manifest import CollectionManifest

    path = os.path.join(tmp, "proteomes.faa.gz")
    t0 = time.time()
    n_rec, residues = write_protein_fasta(path, m_aa, rng)
    log(f"  wrote {n_rec} records, {residues / 1e6:.2f} M aa, in {time.time() - t0:.1f} s")

    def argv(out):
        return ["sketch", "protein", path, "-o", out] + [x for p in PROTEIN_PARAMS for x in ("-p", p)]

    out = os.path.join(tmp, "proteomes.zip")
    wall, launches = run_cli("sketch protein", argv(out))
    log(f"  sketch protein: {wall:.2f} s wall, {residues / 1e6 / wall:.2f} M aa/s, "
        f"launches {launches}")

    profile = None
    if profile_cli:
        profile = profiled(lambda: cli_main(argv(os.path.join(tmp, "profiled.zip")) + ["-q"]),
                           "sketch protein")

    t0 = time.time()
    want = protein_host_sketches(path)
    log(f"  native host loop: {time.time() - t0:.1f} s")
    got = {}
    with zipfile.ZipFile(out) as zf:
        manifest = CollectionManifest.load_from_csv(
            io.StringIO(zf.read("SOURMASH-MANIFEST.csv").decode("utf-8")))
        if len(manifest) != len(PROTEIN_PARAMS) or len(zf.namelist()) != len(manifest) + 1:
            raise AssertionError(f"zip holds {zf.namelist()}, manifest {len(manifest)} rows")
        for row in manifest.rows:
            (sig,) = load_signatures_from_json(zf.read(row["internal_location"]))
            if sig.md5sum() != row["md5"] or row["n_hashes"] != len(sig.minhash):
                raise AssertionError(f"manifest row {row} does not describe its sketch")
            got[sketch_key(sig.minhash)] = sig.minhash
    check_against_host("sketch protein", got, want)
    return dict(wall_s=wall, m_aa=residues / 1e6, records=n_rec, launches=launches,
                profile=profile)


# -- phase 5: sketch translate end to end -----------------------------------


def sketch_translate_end_to_end(mbp: int, rng, tmp: str, profile_cli: bool = False) -> dict:
    import torch

    from sourmash_tpu_torch import MinHash, load_signatures_from_json
    from sourmash_tpu_torch.ops import cuda_sketch as cs

    path = os.path.join(tmp, "translate.fa.gz")
    t0 = time.time()
    n_rec, bases = write_fasta(path, mbp, rng, [])
    log(f"  wrote {n_rec} records, {bases / 1e6:.2f} Mbp, in {time.time() - t0:.1f} s")
    out = os.path.join(tmp, "translate.sig")
    argv = ["sketch", "translate", path, "-o", out]
    for p in TRANSLATE_PARAMS:
        argv += ["-p", p]
    wall, launches = run_cli("sketch translate", argv)
    log(f"  sketch translate: {wall:.2f} s wall, {bases / 1e6 / wall:.2f} Mbp/s, "
        f"launches {launches}")
    profile = None
    if profile_cli:
        from sourmash_tpu_torch.__main__ import main as cli_main

        profile = profiled(lambda: cli_main(argv + ["-q"]), "sketch translate")

    t0 = time.time()
    mhs = [MinHash(0, 10, is_protein=True, scaled=200), MinHash(0, 16, dayhoff=True, scaled=200)]
    want = host_sketches(path, {sketch_key(mh): mh for mh in mhs})
    log(f"  native host loop: {time.time() - t0:.1f} s")
    got = {sketch_key(sig.minhash): sig.minhash for sig in load_signatures_from_json(out)}
    check_against_host("sketch translate", got, want)

    # protein_hashes' device branch: one record above 2^16 windows
    seq = rng.choice(np.frombuffer(AA_RESIDUES, dtype=np.uint8), size=300_000).tobytes()
    dev = MinHash(0, 10, is_protein=True, scaled=200)
    cs.reset_launch_counts()
    dev.add_protein(seq)
    torch.cuda.synchronize()
    k3 = cs.LAUNCHES["aa_window_hashes"]
    host = MinHash(0, 10, is_protein=True, scaled=200)
    with native_host_loop():
        host.add_protein(seq)
    if k3 < 1:
        raise AssertionError("add_protein on 300,000 aa did not launch K3")
    check_against_host("add_protein 300,000 aa", {0: dev}, {0: host})
    return dict(wall_s=wall, mbp=bases / 1e6, records=n_rec, launches=launches,
                profile=profile)


KERNELS = {
    "survivor_slots": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch.cu",
        replaces="sourmash_tpu/ops/pallas_sketch.py:379",
    ),
    "window_hashes": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch.cu",
        replaces="sourmash_tpu/ops/pallas_sketch.py:491",
    ),
    "aa_window_hashes": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch.cu",
        replaces="sourmash_tpu/ops/pallas_sketch.py:517",
    ),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check each kernel once, then stop")
    ap.add_argument("--json", help="also write every measurement to this file")
    ap.add_argument("--profile", action="store_true",
                    help="run each sketch command once more under cProfile and "
                         "torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import sourmash_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2
    from sourmash_tpu_torch import native
    from sourmash_tpu_torch.ops import _build

    card = card_line()
    clock_hz = sm_clock_hz()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"max SM clock {clock_hz / 1e6:.0f} MHz")

    t0 = time.time()
    build_log = _build.build()
    native.build()
    log(f"phase 1: built kernels and native host library in {time.time() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  sketch.cu: {line.strip()}")

    rng = np.random.default_rng(20261016)
    t0 = time.time()
    log("phase 2: kernels against their plain versions on the card (exact)")
    timings = check_kernels(args.quick, rng, clock_hz)
    log(f"phase 2 done in {time.time() - t0:.1f} s")
    if args.quick:
        log("--quick: stopped before the main path; no kernels line and no result")
        return 0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        log(f"phase 3: sketch dna end to end on {MBP} Mbp")
        e2e = sketch_end_to_end(MBP, rng, tmp, args.profile)
        log(f"phase 3 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log(f"phase 4: sketch protein end to end on {M_AA} M aa")
        prot = sketch_protein_end_to_end(M_AA, rng, tmp, args.profile)
        log(f"phase 4 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log(f"phase 5: sketch translate end to end on {TRANSLATE_MBP} Mbp")
        trans = sketch_translate_end_to_end(TRANSLATE_MBP, rng, tmp, args.profile)
        log(f"phase 5 done in {time.time() - t0:.1f} s")

    # each kernel's launches come from the phase that runs its path
    launches = dict(survivor_slots=e2e["launches"]["survivor_slots"],
                    window_hashes=e2e["launches"]["window_hashes"],
                    aa_window_hashes=prot["launches"]["aa_window_hashes"])
    timed_k = dict(survivor_slots=TIMED_K, window_hashes=TIMED_K, aa_window_hashes=TIMED_AA_K)
    line = []
    for name, meta in KERNELS.items():
        t = timings[name][timed_k[name]]
        line.append(dict(
            name=name, **meta,
            launches=launches[name],
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        ))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, sm_clock_hz=clock_hz, timings=timings, end_to_end=e2e,
                           protein=prot, translate=trans), f, indent=1)
    log(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
