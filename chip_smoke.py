#!/usr/bin/env python3
"""Drive sourmash_tpu_torch on one CUDA card and hold it to its references.

    python3 chip_smoke.py [--quick] [--compare-only] [--json PATH] [--profile]
                          [--sass-against DIR] [--shard-match-against DIR]

Phases, each raising on failure:

1. Print the card (`nvidia-smi` name, power limit and maximum SM clock)
   and build the CUDA kernels and the native host library from the sources
   in this checkout; print the build time and ptxas' register report.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit, at the main path's row shape [4, 2^21 + k - 1] and at [32, ...],
   for k in {7, 21, 31, 33, 51, 63, 129} and max_hash for scaled 100, 512,
   768, 1000, 2000 and 2^64-1, on ACGT rows with N runs, a zero-padded
   tail and a tandem repeat that overflows K1's slots; K1 at every
   max_hash and K2 on every window (invalid windows' garbage hashes and
   the pad windows past n included) on [4, 2^20] edge rows: uniformly
   random bytes (k = 21, 31, 51), even-k palindromes (k = 20, 32) and N
   runs across the 1,024-window tile and 128-window segment boundaries
   (k = 21, 31, 51, 63). Time each kernel (CUDA events: the median of
   single launches after warm-up, and the time per launch of a run of
   launches back to back) and its plain version, and work out the least
   time the card could take (`bound_ms`: "operations" bounds by the
   integer-pipe probe's model on murmur's least count, and on the count
   before its folds); beside K1's
   bound print T4's murmur_only time per window at K1's windows (its
   murmur_halves, not K1's murmur_words).
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
6. `gather` end to end: a seeded collection of 10,000 k=31, scaled=1000
   sketches of 2,000-6,000 hashes in clades of 1-20 genomes (50-95 % of a
   clade core each), written with the port's zip saver, and a metagenome
   query of ~600 k hashes (about 200 genomes at 40-100 % coverage plus 30 %
   fresh hashes, abundances 1-50). `python -m sourmash_tpu_torch gather
   q.sig db.zip -o dev.csv --save-matches m.zip` with the launch counters
   set to 0 just before and read just after (counts_rows, membership_bits
   and round_dec must have run, on the device-membership route), then the
   same with SOURMASH_TORCH_NO_SCHEDULE=1 (host rounds), whose CSV must be
   byte-identical; every row must equal an independent numpy greedy gather
   (match order, intersect_bp, unique_intersect_bp, f_unique_weighted).
   Then, for queries of ~20 k hashes (k * W * 4 below 24 MB) and ~600 k
   (above it), time the schedule with host bitsets against
   `membership_bits`, and a host-round consume by host sorted joins against
   `round_dec` (same results held).
7. The instruments' own path: each tool under `sourmash_tpu_torch/tools/`
   run through its main() as `python -m` runs it (T2 and T3 `check` and
   `time` at [8, 2^21 + 30], T4 `murmur assembly mul16 probe-mul64-16`,
   T5 `full kernel gatheronly`), the launch counters set to 0 just before
   and read just after; every instrument kernel must have run.
8. `search`, `prefetch` and `multigather` against phase 6's zip, each
   command with the launch counters set to 0 just before and read just
   after. `search` of a genome of a clade of >= 5 (Jaccard, then
   `--containment`): the cutoff form of `counts_rows` must run and the rows
   must be exactly the genomes whose numpy score passes 0.08, with those
   scores. `prefetch` of phase 6's metagenome with `--save-matching-hashes`
   and `--save-unmatched-hashes`: every genome sharing >= 50 kbp and only
   those, with numpy's intersect_bp, and the two hash files an np.isin
   split. `multigather` of 16 samples (`make_gather_query`: 4 of ~600 k
   hashes first, then 12 of 20 k-150 k): `counts_block`,
   `membership_bits_batch` and `round_dec_batch` must run, every sample's
   counts must come from the warm cache, the first block of schedules must
   take the device-membership route and the rest host matrices, and every
   sample's rows must equal the numpy greedy gather; then 1 of the large
   samples under SOURMASH_TORCH_SCHEDULE_CAP=512 (batched recounts) and 4
   small ones with the device budget below the planes (streamed banks)
   must write byte-identical CSVs.
9. `compare` (config 2 of BASELINE.json) on collections of make_collection's
   clades with abundances 1-50 (scaled=1000, B = 4096), written as zips, each
   command with the launch counters set to 0 just before and read just
   after. At n = 2,000, k = 31: Jaccard (`--ignore-abundance`), angular and
   `--containment`, each writing `-o` and `--csv`: the join
   `pairwise_counts` (angular: `pairwise_products`) must run once and no
   other compare kernel, the count (product) matrix the command computed
   must equal a scipy.sparse oracle (X X^T, A A^T) exactly, and the
   written matrix and CSV the oracle's counts through compare.py's closed
   forms. Then the block routes through the library entry points
   (`pairwise_counts_bucketed` at 16 rows a `counts_block` launch,
   `pairwise_weighted_products` at PRODUCTS_BLOCK = 58), each
   matrix equal to the oracle, their launches counted for the kernels
   line. At n = 100: `--max-containment` and
   `--avg-containment`, each with and without `--estimate-ani`, at k = 31,
   and `--avg-containment --estimate-ani` at k = 21 and 51, on the card and
   with SOURMASH_TORCH_DEVICE=cpu (the sorted engine): byte-identical stdout, `.npy`, labels and CSV. Each
   command's wall, all-pairs compares a second, launches and the matrix
   and host-pack walls are printed.
10. The persistent formats, each command with the launch counters set to 0
   just before and read just after. `sketch fromfile` of 8 genomes of phase
   3's kind (a .fa.gz each), 2 of them with a proteome of phase 4's kind,
   with sourmash's DNA ksizes and its protein default into a zip: K1 and K3
   must run and every signature (md5, mins, name, filename) must equal
   `sketch dna|protein --name` of its file; again with --already-done,
   --output-manifest-matching and --output-csv-info: everything matches,
   nothing is built. `index -F revindex` over phase 6's zip, then `gather`
   of phase 6's metagenome against the directory by both routes: the raw
   mins packed on the card, and the mmapped disk planes streamed (the
   device budget below the planes' bytes), the latter with the default
   schedule and again in host rounds; each CSV must be phase 6's against
   the zip byte for byte (the location column aside), counts_rows and
   round_dec must run in each, membership_bits on the resident route and
   in the host rounds. Phase 6's first
   600 genomes saved to a `.sqldb` by the port's saver and to a zip:
   gather against each through the flat view on the card, the same CSV.
   The flat-view cache lives in the run's directory
   (SOURMASH_TORCH_VIEW_CACHE_DIR): phase 6's first load is cold, its later
   loads and phase 8's warm; its hits, misses and bytes are printed after
   phases 6, 8 and 10.
11. SBTs and LCA databases, each command with the launch counters set to 0
   just before and read just after. `index` builds `db.sbt.zip` from phase
   10's zip of 600 genomes, and `lca index` (a taxonomy generated from
   make_collection's clades, `--scaled 1000`) builds `db.lca.json` from it.
   `gather` of phase 6's metagenome against each: the scheduled flat view
   on the card (counts_rows and round_dec launched), and the CSV phase
   10's against the zip byte for byte, the location column aside.
   `search` of a genome of a clade of >= 5 against the tree (the pruned
   walk, on the host): the rows must be exactly the genomes whose numpy
   Jaccard passes 0.08, with those scores. Each build's wall and bytes,
   each command's wall, launches and route, and the phase's total are
   printed.
12. The multi-device layer (`sourmash_tpu_torch/parallel/`) on meshes that
   name the card several times: (a) gather's schedule sharded over 4
   logical shards, (b) multigather's over 2 data devices, each equal
   to the one-device schedules; (c) the fused program on a (2 x 2) mesh
   against 4 of phase 8's samples, round for round against (b), its
   builder first alone under set_sync_debug_mode("error") (no host
   synchronisation in its shard_match launches); (e) shard_match at (c)'s
   chunk, bit for bit, timed with words, counts only and at the
   decrement's shape beside its bound and torch.sparse.mm; (d) the sharded
   sketch; (f) `dryrun_multichip(8)` on 8 logical devices, every
   shard_match call of its counter, gather round and program held bit for
   bit against the plain version.
13. `sig kmers` through `__main__.main`, each command with the launch
   counters set to 0 just before and read just after: a query zip of three
   k=31, scaled=1000 DNA sketches and one k=10, scaled=200 protein sketch
   over 16 DNA records of 0.2-1 Mbp (`--dna -k 31`: K1 or K2 must run),
   proteins of 2^16 aa or more (`--protein -k 10`: K3 must run) and DNA
   records of 0.2-0.3 Mbp with `--translate` (K3 must run), each with
   `--save-sequences`, and two short records with `--save-kmers` (on the
   host). Every form runs again under SOURMASH_TORCH_HOST_SKETCH=native,
   which must launch no sketch kernel: the stderr, the found-hash count and
   every written file must be the same bytes. The phase prints its wall
   beside the card's name and power limit.
14. The last slice through `__main__.main`, each command with the launch
   counters set to 0 just before and read just after. (a) `compute` of a
   generated ~32 Mbp FASTA.gz (records of 0.1-4 Mbp): `-k 21,31 --scaled
   1000 --track-abundance`, `--protein --dayhoff -k 30 --scaled 100` and
   `--merge`; every sketch's mins, abundances and md5sum must equal the
   native host loop's, and K1 and K3 must have run. (b) `categorize` of 4
   genomes of phase 6's collection against its zip (warm in the flat-view
   cache): the cutoff form of `counts_rows` must run, and each CSV row's
   best match and similarity must be numpy's Jaccard argmax without the
   query's own md5. (c) `index` of 4 generated genomes' num=500, k=21
   sketches into an SBT, then `watch --dna --ksize 21` of 100 kbp records
   of genome 0: K1 or K2 must run, the FOUND line must name genome 0 at the
   host's similarity, and `-o`'s sketch must equal the native host loop's.
   (d) SOURMASH_TORCH_PROFILE around `sketch dna` of one 4 Mbp record in a
   subprocess started before (a): its Chrome trace must be valid JSON and
   name K1's survivor_slots_kernel among its kernel events. (e) `info -v`
   must print the card's name as nvidia-smi gives it. The phase prints its
   walls and launches on lines of their own.

Phase 2 also holds K3 against its plain version, bit for bit, for k in
{3, 7, 10, 16, 42, 64, 129} at B = 4, 32 and the batch of `sketch
protein`'s path (one 32 MiB flush: 16 rows): at [B, 2^21 + k - 1] on
residue rows, rows remapped through DAYHOFF and HP, zero separators and a
zero-padded tail, and at [B, 2^20 + 301] on edge rows (zero runs across
the 1,024-window tile boundaries and inside the k-1 halo, random bytes,
odd row bases, a partial last tile); it times K3 and its plain version at
[4, ...] and at the path's batch, per call, back to back and (K3) in a
CUDA graph of 20 launches. It then
holds the gather kernels against their plain versions, bit for bit, at
phase 6's shapes: `counts_rows` on one chunk of [8192, 8, 4096] planes
(PAD slots, the hash 2^64-1, forced spills) against a ~600 k-hash query,
with and without per-row cutoffs (query columns in shared memory), and on
a bank of small sketches (B = 128) against the same query, whose columns
of thousands of slots are searched in global memory, with and without
cutoffs; the cost of the wrapper's query-order check; `membership_bits`
at [2048, W =
ceil(600 k / 32)], and on edge inputs: the identity slot map of
`membership_matrix`, buckets with cnt = 8, emptied and repeated rows, and
a W above the block's shared memory; `round_dec` at [4096, W]. And the
batch kernels at phase 8's shapes: `counts_block`, the join, on the same
chunk against phase 8's block of 16 queries (4 of ~600 k hashes, 12 of
20 k-150 k) and a block of 32 (8 and 24), its tiles planned from the
block's host loads as multigather plans them, each timed beside
`counts_rows` launched for each query of the block (whose raw matches,
less the PAD correction, its first and last rows must equal) and at
tiles of half the entries, and 8 of them against a B = 128 bank, where the join's
tiles exceed shared memory and work in global memory; `membership_bits_batch` with 4
queries (~600 k, 150 k, empty, 20 k hashes) x 2,048 rows at W = ceil(600 k
/ 32), repacked at a depth above the block's own, with padded selections
and rows with cnt = 8 and 2^64-1, its device time split by torch.profiler
into the tables' clearing, build and probe, the lengths of its table walks
counted from this run's data, and with 4 queries of ~600 k hashes, whose
tables together exceed L2, and with one query at `membership_bits`'s shape
(equal to its words); `round_dec_batch` on its words. And
compare's kernels on phase 9's own k=31 collection (2,000 sketches with
abundances, [2048, 8, 4096] planes): the joins `pairwise_counts` on the
bank and `pairwise_products` on `_pack_weighted`'s planes, one launch a
matrix, each bit for bit against its plain version and, on its [:n, :n],
against the scipy.sparse oracle, timed as the wrapper and as the kernel
alone at the path's tiles, at each tile width one block holds and with no
value shared between rows (the walk's pair atomics left out), beside its
bound, its atomics and `torch.sparse.mm` of the whole matrix;
`counts_block` with the bank's own rows as the query block at 16 rows,
and `products_block` on the weighted planes at blocks of 8 and 58, each
bit for bit against its plain version, timed with its byte bound and its
atomics and beside `torch.sparse.mm` of the same block; the joins and the block kernels on
edge rows (spills and 2^64-1 in two rows, a weighted bucket 20 deep; 2,600
sketches padded to 4,096 rows, one empty, all others sharing 8 hashes of
one bucket: the joins' global-memory tiles); `query_intersection_counts`
of one sketch against the collection (the `counts_rows` engine) against
`np.intersect1d`. Beside `counts_rows` and phase 8's block of
`counts_block` it times `torch.sparse.mm` of the same counts (the
query's or the block's incidence rows against the chunk's), held to the
exact counts.

Phase 2 holds `shard_match` on edge planes (`check_shard_match_edges`: a
value alive in two queries, a dead query, a bucket of dq alive slots, a
row value repeated in a bucket, 2^64-1, the in-place write at a row
offset, the gather round's 1 x 1 winner and its decrement) and on planes
past one launch's sizes: lines past one block's staging (two stages of
slots; at B = 2^20, two stages of words), a metagenome-sized query at
B = 128 (its tables built in two ranges of slots, the counts added up),
and 65,537 queries (two launches).

Phase 2 then holds the sketch-kernel instruments (`csrc/sketch_parts.cu`)
against their plain versions on the card, bit for bit: T2's passes
`split_words` / `split_slots` and T3 `survivor_slots_v2` also against K1
for every k above at max_hash for scaled=1000 and 2^64-1 on the rows with
the overflowing tandem repeat, timed at [4, 2^21 + 30], and T2/T3 against
their plain versions on the tools' own batch [8, 2^21 + 30] (`split_words`
and T3 also on K1's edge rows, in `check_k1_edges`); T3's and K1's
registers a thread and theoretical occupancy (`resource_usage`, from
`cuobjdump --dump-resource-usage`); T4's `murmur_only`,
`assembly_only` and `mulchain` (0, 1, 16 and 64 rounds) at the tool's
blocks of random bytes, timed, and `assembly_only` on blocks of random
bytes, of ACGT, and of ACGT with N runs and palindromes at the tool's 512
rows and at 9 (a block ending mid-tile), timed on ACGT: with
`murmur_only` and K1 that gives one line of K1's time per window split
into assembly and murmur. The mul-chain's 16 rounds must
take at least half again the 0-round kernel's time, and 64 rounds >= 3x
the time of 16, both net of 0 rounds (else its work was optimised away);
where `cuobjdump` is at hand its SASS must hold an IMAD.WIDE.U32 for each
of the 4 chains of the 8 unrolled rounds; its opcode counts, its IMAD-pipe
instructions a chain's round and its rounds/SM/clock between 16 and 64
rounds are printed. `murmur_only` runs K1's k = 31 body: its SASS must have
no loop and an IMAD.WIDE.U32 for each of the 12 multiplies of its 4
elements; its instructions an element by pipe are printed beside the
least. The integer-pipe probe (`int_probe`: mul64, mul32, alu and mix
chains) is held bit for bit at 0, 1, 16 and 64 rounds and timed at 16, 64
and 256; from its slopes and its SASS loops the IMAD.WIDE.U32, IMAD and
ALU rates an SM a clock, and whether the mix's round fits the two pipes
side by side or one shared budget, are printed: they set the
"operations" model (IMAD_PER_MUL, the pipes side by side).

The last two lines are a JSON object with every kernel's numbers and then
`{"ok": true, "device": {...}}`. --quick stops after checking each kernel
once at the main path's shape (the gather kernels on a 512-row chunk, the
batch kernels with a block of 4 queries, the instruments at k=31), before
the main path, and prints neither line; --profile runs `sketch dna`,
`sketch protein`, `sketch translate`, `gather`, `multigather` and `compare`
(Jaccard and angular) once more under cProfile and torch.profiler and
prints where their time goes. --compare-only builds, runs phase 2's
checks of compare's kernels and phase 9, and stops, printing neither line
(with --quick: phase 2's compare checks at 256 sketches, no phase 9).
--sass-against DIR (a checkout of another commit) builds DIR's
`csrc/sketch.cu` and this tree's with this tree's flags after phase 1 and
fails unless the SASS of K1 and K2 equals this tree's for every k they are
built for (21, 31, 51 and run-time k); it prints K3's instruction counts
per template k, registers and spill bytes on both sides, and times DIR's K3
beside this tree's at k = 10, B = 4 and the path's batch.
--shard-match-against DIR holds this tree's shard_match on phase 2's
planes after phase 1, then times DIR's and this tree's at the fused
program's chunk shape (made from phase 6's generator), with words, counts
only and at the decrement's shape, beside torch.sparse.mm: each tree in a
process of its own that imports that tree's package (and so its own
wrapper and kernel), in the order DIR, this, this, DIR; then it stops.
Without a CUDA
device, or outside a checkout of the repository, the script exits non-zero
before any result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit). The card's
# integer rate is published per SM and clock only: 64 32-bit integer ops
# on each of two pipes (IMAD on the FMA pipe; shifts, LOP3, IADD3 on the
# INT pipe). The "operations" bounds take that rate at the card's maximum
# SM clock. How many of those slots a 64-bit multiply by a constant takes
# (IMAD_PER_MUL) and whether the two pipes' work overlaps follow from the
# integer-pipe probe (`check_int_probe`; PERF.md keeps its numbers): an
# IMAD issues at the published rate, an IMAD.WIDE.U32 takes about two
# slots, so a multiply (one wide and two plain IMADs) about 4; the ALU
# issues at the published rate beside the IMAD pipe, and work on both
# costs the larger pipe's time, not the sum. Murmur's ops are counted at
# least (`int_ops_murmur`: three-input LOP3s, xors of zero halves left
# out, constant addends folded into the multiply-adds, adds on either
# pipe); the count before those folds gives the bound kept beside each
# (`bound_ms_before`).
HBM_BYTES_PER_S = 3.35e12
SMS = 132
LANES_PER_PIPE = 64
IMAD_PER_MUL = 4

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
HOST_WORKERS = 8  # processes of phases 3's and 4's host loops (an 8-core host)
TRANSLATE_MBP = 64
TRANSLATE_PARAMS = ["k=10,scaled=200", "dayhoff,k=16,scaled=200"]

# phase 6: `sourmash gather metagenome.sig gtdb-rs214-reps.k31.zip` (85,205
# genomes at k=31, scaled=1000), the collection cut to 10,000 genomes for
# the run's time limit; the counts kernel is checked on one full chunk
GATHER_SCALED = 1000
GATHER_GENOMES = 10_000
GATHER_QUERY_HASHES = 600_000
GATHER_THRESHOLD_BP = 50_000  # gather's default --threshold-bp
GATHER_KERNEL_ROWS = 8192  # rows of one bank chunk (ops/index_ops._CHUNK_ROWS)
GATHER_DEVICE = "cuda"  # the gather phases' tensors (a CPU rehearsal sets "cpu")
# phase 6's route comparison: a query of a few genomes, below the 24 MB
# (k * W * 4 bytes) threshold at which the schedule builds membership on the
# device, and one of phase 6's size above it (the 150 k-hash query between
# them and a fourth repetition were cut for the time limit)
GATHER_ROUTE_QUERIES = (20_000, 600_000)
ROUTE_REPS = 3
# phase 8: `multigather` of many samples against one collection (config 5
# of BASELINE.json: 1000 metagenomes against full GTDB), cut to 16 samples
# on one card for the run's time limit: 4 of ~600 k hashes, 12 of 20 k-150 k
MULTI_LARGE, MULTI_SMALL = 4, 12
MULTI_SMALL_HASHES = (20_000, 150_000)
MULTI_CAP = "512"  # the capped rerun of the large samples: converge's recounts
MULTI_CAPPED = 1  # large samples in the capped rerun (of MULTI_LARGE; cut for the time limit)
BLOCK_QUERIES = 32  # phase 2's counts_block block: phase 8's mix, a quarter large
# phase 9: `compare` (config 2 of BASELINE.json: Jaccard, containment and ANI
# matrices at k = 21/31/51) at the size sourmash_tpu's docstring measures
# ("2k x 5000", `sourmash_tpu/ops/bucketed.py:824`): make_collection's
# clades at scaled=1000 (B = 4096) with abundances; n = 2,000 at k = 31, and
# n = 100 at each k for the card-against-CPU byte comparison (cut from 200
# for the run's time limit: the CPU's sorted engine took 10-13 s a command;
# n = 100 stays above the host-join cutoff, so both engines still run)
COMPARE_GENOMES = 2000
COMPARE_SMALL = 100
COMPARE_KS = (21, 31, 51)
COMPARE_SEED = 20261017  # each collection's own, so phases 2 and 9 share it


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


def int_ops_murmur(k: int, mul: int = IMAD_PER_MUL, before: bool = False) -> tuple:
    """(IMAD, other, either) 32-bit integer operations of murmur (seed 42)
    over k bytes at least: IMAD-pipe slots (a 64-bit multiply by a constant
    as `mul`, h * 5 + c as 2 with its addend folded in), ALU-only ops (a
    64-bit rotate as two funnel shifts, a 64-bit xor as two LOP3s, fmix64's
    h ^= h >> 33 as one shift and one LOP3 on the low half) and 64-bit adds
    (2 each), which either pipe can take. before=True gives the count
    before the folds (every add, xor, rotate or shift-xor 2 other ops,
    h * 5 + c's addend 2 more, nothing on either pipe)."""
    blocks, tail = divmod(k, 16)
    halves = 2 * blocks + (tail > 0) + (tail > 8)
    # k *= c twice per 8-byte half, h = h * 5 + c per block and half, two
    # multiplies in each fmix64
    imad = 2 * mul * halves + 2 * 2 * blocks + 2 * 2 * mul
    if before:
        return imad, 4 * halves + 6 * 2 * blocks + 4 * 2 + 2 * 3 * 2 + 2, 0
    # rotl k and h ^= k per half, rotl h per block and half, three
    # shift-xors per fmix64
    other = 4 * halves + 2 * 2 * blocks + 2 * 3 * 2
    # the seed's high half is 0, so the first h ^= k of h1 and of h2 is one
    # LOP3 on the low half; h ^= len (len < 2^32) is a third input of the
    # tail's LOP3 where h has a tail half, else one LOP3 (none where h was
    # never xored: a constant)
    h1_xored, h2_xored = blocks > 0 or tail > 0, blocks > 0 or tail > 8
    other += -h1_xored - h2_xored + (blocks > 0 and tail == 0) + (blocks > 0 and tail <= 8)
    # h1 += h2 and h2 += h1 per block (the first block's h1 + seed folds
    # into h * 5 + c's addend), two at the finish, the final h1 += h2
    either = 2 * (2 * blocks - (blocks > 0)) + 2 * 2 + 2
    return imad, other, either


def int_ops_per_window(k: int, before: bool = False) -> tuple:
    """(IMAD, other, either) integer operations one canonical DNA window
    hash needs at least: murmur, the canonical bytes assembled four to an
    op for each strand, validity tested four bytes to an op, and the strand
    choice."""
    imad, other, either = int_ops_murmur(k, before=before)
    return imad, other + 3 * -(-k // 4) + 2, either


def int_ops_per_aa_window(k: int, before: bool = False) -> tuple:
    """(IMAD, other, either) integer operations one amino-acid window hash
    (K3) needs at least: murmur, the bytes of one strand assembled four to
    an op, and the zero-byte validity test four bytes to an op."""
    imad, other, either = int_ops_murmur(k, before=before)
    return imad, other + 2 * -(-k // 4), either


def bound_ms(nbytes: int, imad: int, other: int, clock_hz: float, either: int = 0):
    """The least time for the work: bytes over the memory rate, or integer
    ops over the published rate (LANES_PER_PIPE an SM a clock) of each pipe,
    the two side by side (as the probe shows): the IMAD pipe's slots, the
    ALU-only ops, or all of them with the ops either pipe can take spread
    over both."""
    pipe = SMS * LANES_PER_PIPE * clock_hz
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(imad, other, (imad + other + either) / 2) / pipe
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mul_bounds(nbytes: int, ops, clock_hz: float) -> tuple:
    """(bound_ms, bound_by, bound_ms_before) of work whose integer
    operations are ops(before), (IMAD, other[, either]): the bound of the
    least count and, beside it, of the count before int_ops_murmur's folds."""
    def at(before):
        imad, other, *either = ops(before)
        return bound_ms(nbytes, imad, other, clock_hz, *either)

    bms, by = at(False)
    return bms, by, at(True)[0]


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


def back_to_back_ms(fn, n: int) -> float:
    """Time per call of n calls issued back to back between two CUDA
    events, after one warm-up call: the kernel's own time where the
    wrapper's host gap between launches is shorter than the kernel."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Time per call of n calls captured in one CUDA graph, the median of
    `reps` replays: the kernel's own time back to back, without the
    wrapper's host gap (which back_to_back_ms still holds where the gap is
    longer than the kernel)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def kernel_times(fn, reps: int) -> tuple:
    "(median per call, per call back to back) of a kernel's wrapper, reps calls each."
    return time_ms(fn, reps), back_to_back_ms(fn, reps)


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
                t2 = kernel_times(lambda: cs.window_hashes(rows, ksize=k), reps)
                t1 = kernel_times(lambda: cs.survivor_slots(rows, mh, ksize=k, slots=slots), reps)
                p2 = time_ms(lambda: cs.window_hashes_plain(rows, ksize=k), 3, warmup=1)
                p1 = time_ms(lambda: cs.survivor_slots_plain(rows, mh, ksize=k, slots=slots), 3, warmup=1)

                def ops(before, extra=0):
                    imad, other, either = int_ops_per_window(k, before)
                    return B * n_pad * imad, B * n_pad * (other + extra), B * n_pad * either

                b2 = mul_bounds(B * S + B * n_pad * 9, ops, clock_hz)
                # K1 adds the threshold, the ballot and the rank per window
                b1 = mul_bounds(B * S + B * R * (8 * slots + 4), lambda b: ops(b, 4), clock_hz)
                for name, (ms, b2b), plain, (bms, by, bo) in (
                    ("window_hashes", t2, p2, b2), ("survivor_slots", t1, p1, b1)
                ):
                    results[name][k] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms,
                                            bound_by=by, bound_ms_before=bo, max_abs_err=err,
                                            windows=B * n)
                    log(f"    {name}: {ms:.4f} ms/launch ({b2b:.4f} back to back), plain "
                        f"{plain:.3f} ms, bound {bms:.4f} ms ({by}; {bo:.4f} by the "
                        f"unfolded count), {B * n / ms / 1e6:.2f} Gwindows/s")
            del rows
            torch.cuda.empty_cache()
    check_k1_edges(rng, thresholds)
    results["aa_window_hashes"] = check_aa_kernel(quick, rng, clock_hz)
    return results


ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
EDGE_S = 1 << 20  # K1 edge rows: 1,024 of K1's 1,024-window tiles a row
K1_TILE = 1024  # csrc/sketch.cu kK1Tile
SEGMENT = 128


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return np.frombuffer(b"TGCA", dtype=np.uint8)[np.searchsorted(ACGT, codes)][::-1]


def k1_edge_rows(kind: str, k: int, rng) -> np.ndarray:
    """[4, EDGE_S] rows of one kind of K1 edge input:
    - "random bytes": rows 0-1 uniformly random bytes (all 256 values),
      rows 2-3 ACGT with 2 % of the bytes uniformly random;
    - "palindromes": rows 0-1 ACGT repeats from A and from C (at even k
      every other window is its own reverse complement), rows 2-3 random
      ACGT holding 4,000 k-long reverse-complement palindromes (even k);
    - "N at boundaries": random ACGT with N runs of 1 to k + 2 bases that
      start, end or sit across the tile (1,024-window) and segment
      (128-window) boundaries of K1's layout, plus one zero-padded tail."""
    if kind == "random bytes":
        rows = rng.choice(ACGT, size=(4, EDGE_S))
        rows[:2] = rng.integers(0, 256, size=(2, EDGE_S), dtype=np.uint8)
        hit = rng.random((2, EDGE_S)) < 0.02
        rows[2:][hit] = rng.integers(0, 256, size=int(hit.sum()), dtype=np.uint8)
        return rows
    if kind == "palindromes":
        rows = np.empty((4, EDGE_S), dtype=np.uint8)
        rep = np.tile(ACGT, EDGE_S // 4 + 2)
        rows[0], rows[1] = rep[:EDGE_S], rep[1 : EDGE_S + 1]
        rows[2:] = rng.choice(ACGT, size=(2, EDGE_S))
        for b in (2, 3):
            for start in rng.integers(0, EDGE_S - k, size=4000):
                half = rng.choice(ACGT, size=k // 2)
                rows[b, start : start + k // 2] = half
                rows[b, start + k // 2 : start + 2 * (k // 2)] = reverse_complement(half)
        return rows
    rows = rng.choice(ACGT, size=(4, EDGE_S))
    for b in range(4):
        bounds = np.r_[np.arange(K1_TILE, EDGE_S, K1_TILE),
                       rng.choice(np.arange(SEGMENT, EDGE_S, SEGMENT), size=2000)]
        for at in bounds:
            length = int(rng.integers(1, k + 3))
            start = int(at) - int(rng.integers(0, length + k))
            rows[b, max(start, 0) : start + length] = ord("N")
    rows[3, EDGE_S - 5000 :] = 0
    return rows


K1_EDGES = (("random bytes", (21, 31, 51)), ("palindromes", (20, 32)),
            ("N at boundaries", (21, 31, 51, 63)))


def check_k1_edges(rng, thresholds):
    """K1 and K2 against their plain versions, bit for bit, on the edge
    inputs of k1_edge_rows: K1 at every threshold, K2 on every window's
    hash and validity, invalid windows' garbage hashes and the pad windows
    past n (rows of 2^20 bytes end in a partial segment) included; T2's
    split_words (K2's tile, the eight-byte strand compare) on every
    window's words and validity; T3 (survivor_slots_v2) as K1; fails
    otherwise."""
    import torch

    from sourmash_tpu_torch.ops import cuda_sketch as cs
    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp
    from sourmash_tpu_torch.ops.sketch import _pick_slots

    for kind, ks in K1_EDGES:
        for k in ks:
            rows = torch.from_numpy(k1_edge_rows(kind, k, rng)).cuda()
            for name, a, b in zip(("words", "valid"), csp.split_words(rows, ksize=k),
                                  csp.split_words_plain(rows, ksize=k)):
                exact(f"split_words {kind} {name} k={k}", a, b)
            hp, vp = cs.window_hashes_plain(rows, ksize=k)
            h, v = cs.window_hashes(rows, ksize=k)
            exact(f"K2 {kind} hashes k={k}", h, hp)
            exact(f"K2 {kind} valid k={k}", v, vp)
            n, _R, n_pad = cs.geometry(rows.shape[1], k)
            if n_pad == n or bool(vp[:, n:].any()):
                raise AssertionError(f"K2 {kind} k={k}: no invalid pad windows past n")
            del h, v
            survivors = 0
            for mh in thresholds:
                slots = _pick_slots(mh)
                want = cs.slots_from_hashes(hp, vp, mh, slots=slots)
                for what, got in (("K1", cs.survivor_slots(rows, mh, ksize=k, slots=slots)),
                                  ("T3", csp.survivor_slots_v2(rows, mh, ksize=k, slots=slots))):
                    for name, a, b in zip(("hi", "lo", "counts"), got, want):
                        exact(f"{what} {kind} {name} k={k} max_hash={mh}", a, b)
                survivors = max(survivors, int(want[2].sum()))
            log(f"  K1, K2, split_words and T3 on {kind} at k={k:3d}: equal their plain versions "
                f"(K1 and T3 at {len(thresholds)} thresholds; {int(vp.sum())} valid windows of "
                f"{vp.numel()}, {n_pad - n} pad windows a row; up to {survivors} survivors)")
            del rows, hp, vp
    torch.cuda.empty_cache()


AA_EDGE_S = (1 << 20) + 301  # K3 edge rows: odd S, a partial last tile
AA_TILE = 1024  # csrc/sketch_common.cuh kAaTile


def path_aa_batch() -> int:
    """Rows of one K3 launch on `sketch protein`'s path: one flush of
    `_AA_FLUSH_BYTES` amino-acid bytes in chunks of CHUNK windows (a flush
    runs a little over, by its separators: phase 4 prints the batches)."""
    from sourmash_tpu_torch.command_sketch import _AA_FLUSH_BYTES

    return _AA_FLUSH_BYTES // CHUNK


def aa_edge_rows(B: int, k: int, rng) -> np.ndarray:
    """[B, AA_EDGE_S] rows of K3's edge inputs, by b % 4:
    0. residues with a zero run of 1 to k + 2 bytes at every 1,024-window
       tile boundary, ending just before it, spanning it or starting at it;
    1. uniformly random bytes (all 256 values, zeros among them);
    2. DAYHOFF-remapped residues with a zero run of 1 to k - 1 bytes
       inside every tile's k-1 halo;
    3. HP-remapped records joined by k zero bytes, ending in a zero tail.
    S is odd, so every odd row starts at an odd byte; the last tile of a
    row is partial (n_pad is not a multiple of 1,024)."""
    from sourmash_tpu_torch.ops.encodings import DAYHOFF, HP

    S = AA_EDGE_S
    letters = np.frombuffer(AA_RESIDUES + b"X*", dtype=np.uint8)
    rows = rng.choice(letters, size=(B, S))
    tiles = np.arange(AA_TILE, S, AA_TILE)
    for b in range(B):
        kind = b % 4
        if kind == 0:
            lengths = rng.integers(1, k + 3, size=tiles.size)
            starts = tiles - rng.integers(0, lengths + 2)
            for start, length in zip(starts, lengths):
                rows[b, start : start + length] = 0
        elif kind == 1:
            rows[b] = rng.integers(0, 256, size=S, dtype=np.uint8)
        elif kind == 2:
            rows[b] = DAYHOFF[rows[b]]
            if k > 1:
                lengths = rng.integers(1, k, size=tiles.size)
                starts = tiles + rng.integers(0, k - lengths)
                for start, length in zip(starts, lengths):
                    rows[b, start : start + length] = 0
        else:
            rows[b] = HP[rows[b]]
            ends = np.cumsum(rng.integers(50, 1501, size=S // 50 + 1) + k) - k
            for end in ends[ends < S]:
                rows[b, end : end + k] = 0
            rows[b, S - 5000 :] = 0
    return rows


def check_aa_kernel(quick: bool, rng, clock_hz: float) -> dict:
    """K3 against its plain version, whole outputs bit for bit (pad windows
    and garbage hashes included), at [B, 2^21 + k - 1] on aa_rows and at
    [B, AA_EDGE_S] on aa_edge_rows, for B = 4, 32 and the path's batch;
    timed per call, back to back and in a CUDA graph at B = 4 and the
    path's batch for every k (the kernels line reports k=10, B=4)."""
    import torch

    from sourmash_tpu_torch.ops import cuda_sketch as cs

    path_b = path_aa_batch()
    results = {}
    for k in ((TIMED_AA_K,) if quick else AA_KS):
        for B in ((4, path_b) if quick else (4, 32, path_b)):
            for kind in ("records", "edges"):
                rows = torch.from_numpy(aa_rows(B, k, rng) if kind == "records"
                                        else aa_edge_rows(B, k, rng)).cuda()
                h, v = cs.aa_window_hashes(rows, ksize=k)
                hp, vp = cs.aa_window_hashes_plain(rows, ksize=k)
                err = max(exact(f"K3 {kind} hashes k={k} B={B}", h, hp),
                          exact(f"K3 {kind} valid k={k} B={B}", v, vp))
                S = rows.shape[1]
                n, _, n_pad = cs.geometry(S, k)
                share = float(v[:, :n].float().mean())
                if not 0.5 < share < 1.0 or bool(v[:, n:].any()):
                    raise AssertionError(f"K3 {kind} k={k} B={B}: valid share {share} or "
                                         f"padding valid")
                log(f"  k={k:3d} B={B:2d} {kind}: K3 equals its plain version "
                    f"({100 * share:.2f} % valid, {n_pad - n} pad windows a row)")
                del h, v, hp, vp
                if kind == "records" and B in (4, path_b):
                    t3, b2b = kernel_times(lambda: cs.aa_window_hashes(rows, ksize=k),
                                           3 if quick else 20)
                    g3 = graph_ms(lambda: cs.aa_window_hashes(rows, ksize=k))
                    p3 = time_ms(lambda: cs.aa_window_hashes_plain(rows, ksize=k), 3, warmup=1)
                    bms, by, bo = mul_bounds(
                        B * S + B * n_pad * 9,
                        lambda b: tuple(B * n_pad * x for x in int_ops_per_aa_window(k, b)),
                        clock_hz)
                    at = dict(ms=t3, b2b_ms=b2b, graph_ms=g3, plain_ms=p3, bound_ms=bms,
                              bound_by=by, bound_ms_before=bo, max_abs_err=err, windows=B * n)
                    if B == 4:
                        results[k] = at
                    else:
                        results[k]["path"] = dict(at, B=B)
                    log(f"    aa_window_hashes B={B}: {t3:.4f} ms/launch ({b2b:.4f} back to "
                        f"back, {g3:.4f} in a CUDA graph), plain {p3:.3f} ms, bound {bms:.4f} "
                        f"ms ({by}; {bo:.4f} by the unfolded count), "
                        f"{B * n / g3 / 1e6:.2f} Gwindows/s in the graph, "
                        f"{100 * bms / g3:.1f} % of the bound")
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


def host_sketches(path: str, mhs: dict, add: str = "add_sequence", workers: int = 1) -> dict:
    """The port's native C++ host loop over the records of `path`: every
    MinHash of `mhs` gets each record through `add` (add_sequence with
    force, or add_protein). Records go into an empty copy of each sketch
    that is merged into it every HOST_MERGE_EVERY records: an insert
    re-sorts the sketch's mins, so adding 10^5 short records straight into
    one large scaled sketch would take quadratic time. Merging is exact for
    scaled and num sketches, so with workers > 1 the records are dealt
    round robin to that many spawned processes, each sketching its share
    into empty copies, and their sketches are merged here."""
    if workers <= 1:
        return _host_share(path, mhs, add, 0, 1)
    import multiprocessing

    from sourmash_tpu_torch import native

    native.build()  # once, before the workers load it
    empty = {key: mh.copy_and_clear() for key, mh in mhs.items()}
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        shares = pool.starmap(_host_share, [(path, empty, add, w, workers)
                                            for w in range(workers)])
    for share in shares:
        for key, mh in share.items():
            mhs[key].merge(mh)
    return mhs


def _host_share(path: str, mhs: dict, add: str, share: int, shares: int) -> dict:
    "host_sketches' loop over the records i of `path` with i % shares == share."
    import itertools

    from sourmash_tpu_torch.sequence_io import iter_records_bytes

    parts = {key: mh.copy_and_clear() for key, mh in mhs.items()}

    def merge_parts():
        for key, part in parts.items():
            mhs[key].merge(part)
            parts[key] = part.copy_and_clear()

    records = itertools.islice(iter_records_bytes(path), share, None, shares)
    with native_host_loop():
        for i, (_name, seq) in enumerate(records, 1):
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


def dna_host_sketches(path: str, workers: int = 1) -> dict:
    from sourmash_tpu_torch import MinHash

    mhs = [MinHash(0, k, scaled=1000) for k in (21, 31, 51)]
    mhs += [MinHash(0, 31, scaled=100), MinHash(500, 31)]
    return host_sketches(path, {sketch_key(mh): mh for mh in mhs}, workers=workers)


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
    wall, launches, batches = run_cli("sketch dna", argv, ("survivor_slots", "window_hashes"))
    log(f"  sketch dna: {wall:.2f} s wall, {bases / 1e6 / wall:.1f} Mbp/s, launches {launches}; "
        f"launches by rows {batches}")

    profile = None
    if profile_cli:
        profile = profiled(lambda: cli_main(argv + ["-q"]), "sketch dna")

    t0 = time.time()
    want = dna_host_sketches(path, HOST_WORKERS)
    log(f"  native host loop ({HOST_WORKERS} processes): {time.time() - t0:.1f} s")
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
                batches=batches, profile=profile)


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
    return host_sketches(path, {sketch_key(mh): mh for mh in mhs}, add="add_protein",
                         workers=HOST_WORKERS)


SKETCH_WRAPPERS = ("survivor_slots", "window_hashes", "aa_window_hashes")


def run_cli(what: str, argv: list, kernels=("aa_window_hashes",)) -> tuple:
    """One CLI run with the launch counters set to 0 just before and read
    just after: (wall, launches, {kernel: {rows of a launch: launches}} for
    the sketch kernels that ran). Each of `kernels` must have launched."""
    import collections

    import torch

    from sourmash_tpu_torch.__main__ import main as cli_main
    from sourmash_tpu_torch.ops import cuda_sketch as cs

    batches = {name: collections.Counter() for name in SKETCH_WRAPPERS}
    wrappers = {name: getattr(cs, name) for name in SKETCH_WRAPPERS}

    def spy(name):  # records each launch's rows; the wrapper counts the launch
        def call(squ, *args, **kw):
            if squ.device.type == "cuda":
                batches[name][int(squ.shape[0])] += 1
            return wrappers[name](squ, *args, **kw)
        return call

    torch.cuda.synchronize()
    cs.reset_launch_counts()
    for name in SKETCH_WRAPPERS:
        setattr(cs, name, spy(name))
    try:
        t0 = time.time()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        for name, fn in wrappers.items():
            setattr(cs, name, fn)
    launches = dict(cs.LAUNCHES)
    if rc not in (None, 0):
        raise AssertionError(f"{what} returned {rc}")
    if min(launches[name] for name in kernels) < 1:
        raise AssertionError(f"{what}: a kernel of the path was not launched: {launches}")
    return wall, launches, {name: dict(sorted(c.items())) for name, c in batches.items() if c}


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
    wall, launches, batches = run_cli("sketch protein", argv(out))
    log(f"  sketch protein: {wall:.2f} s wall, {residues / 1e6 / wall:.2f} M aa/s, "
        f"launches {launches}; launches by rows {batches}")

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
                batches=batches, profile=profile)


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
    wall, launches, batches = run_cli("sketch translate", argv)
    log(f"  sketch translate: {wall:.2f} s wall, {bases / 1e6 / wall:.2f} Mbp/s, "
        f"launches {launches}; launches by rows {batches}")
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
                batches=batches, profile=profile)


# -- phase 2 (gather kernels) and phase 6: gather end to end -----------------


def random_sketch(rng, n: int, max_hash: int) -> np.ndarray:
    "n distinct uniform hashes below max_hash (a FracMinHash sketch's values)."
    out = np.unique(rng.integers(0, max_hash, size=n + n // 100 + 16, dtype=np.uint64))
    return rng.permutation(out)[:n]


def gather_kernel_inputs(rng, rows: int):
    """A bank chunk as phase 6 packs it ([rows, 8, 4096] planes: sketches of
    4,200-6,000 hashes, the 8192 length class) on the card, with the hash
    2^64-1 in row 0 and nine hashes of one bucket (forced spills) in rows
    1-8, and a metagenome query of ~600 k hashes that takes 30-100 % of 150
    rows, the 2^64-1 tail and fresh hashes. Returns (mins_list, bank, q)."""
    import torch

    from sourmash_tpu_torch.ops import bucketed as bk

    mh = max_hash_for(GATHER_SCALED)
    mins_list = [np.sort(random_sketch(rng, int(n), mh)) for n in rng.integers(4200, 6001, size=rows)]
    mins_list[0] = np.unique(np.r_[mins_list[0], np.uint64(2**64 - 1)])
    crowd = (np.arange(9, dtype=np.uint64) << np.uint64(40)) | np.uint64(7)
    for i in range(1, min(9, rows)):
        mins_list[i] = np.unique(np.r_[mins_list[i], crowd])
    parts = [m[rng.random(len(m)) < rng.uniform(0.3, 1.0)] for m in
             (mins_list[i] for i in rng.choice(rows, size=min(150, rows), replace=False))]
    parts += [crowd, np.array([2**64 - 1], dtype=np.uint64)]
    q = np.unique(np.concatenate(parts))
    q = np.unique(np.r_[q, random_sketch(rng, max(600_000 - len(q), 1000), mh)])
    bank = bk.pack_rows_device(mins_list, 4096, device=torch.device(GATHER_DEVICE))
    if bank.n_spilled < 8:
        raise AssertionError(f"expected forced spills, got {bank.n_spilled}")
    return mins_list, bank, q


def u64_planes(vals: np.ndarray):
    "int32 (hi, lo) limb tensors of u64 values, on the card."
    from sourmash_tpu_torch.ops.bucketed import to_torch

    return (to_torch((vals >> np.uint64(32)).astype(np.uint32), GATHER_DEVICE),
            to_torch((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32), GATHER_DEVICE))


def plain_in_chunks(fn, n: int, step: int):
    "torch.cat of fn(slice) over row slices of `step` (bounds the plain transients)."
    import torch

    return torch.cat([fn(slice(a, min(a + step, n))) for a in range(0, n, step)])


def check_gather_kernels(quick: bool, rng, clock_hz: float) -> dict:
    """counts_rows (with and without cutoffs), membership_bits and round_dec
    against their plain versions on the card, bit for bit, at phase 6's
    shapes; each timed with CUDA events (median per launch) beside its plain
    version (run over row slices, summed) and its bound."""
    import torch

    from sourmash_tpu_torch.ops import cuda_gather as cg
    from sourmash_tpu_torch.ops.bucketed import (
        inverse_slot_map, pack_query_bucketed, query_counts_bucketed, query_slot_map)
    from sourmash_tpu_torch.ops.index_ops import _cached_query_pack

    rows = 512 if quick else GATHER_KERNEL_ROWS
    t0 = time.time()
    mins_list, bank, q = gather_kernel_inputs(rng, rows)
    B = bank.B
    log(f"  bank [{rows}, 8, {B}] ({bank.n_spilled} spills), query {len(q)} hashes "
        f"({time.time() - t0:.1f} s to make)")
    qhi, qlo, qcnt, dq, _tail = _cached_query_pack(q, B, torch.device(GATHER_DEVICE))
    Shi, Slo = bank.hi, bank.lo
    reps = 3 if quick else 10
    step = 512
    results = {}

    # cutoffs: none (2^64-1), below and above 2^63, and sourmash's usual max_hash values
    pool = np.array([2**64 - 1, 2**63 - 1, 2**63, 2**63 + 2**40, 2**62,
                     max_hash_for(1000), max_hash_for(10_000), 0], dtype=np.uint64)
    cuts = rng.choice(pool, size=rows)
    chi, clo = u64_planes(cuts)
    for name, cut in (("counts_rows", ()), ("counts_rows cutoff", (chi, clo))):
        got = cg.counts_rows(qhi, qlo, Shi, Slo, *cut)
        want = plain_in_chunks(
            lambda s: cg.counts_rows_plain(qhi, qlo, Shi[s].contiguous(), Slo[s].contiguous(),
                                           *(c[s].contiguous() for c in cut)), rows, step)
        err = exact(name, got, want)
        ms, b2b = kernel_times(lambda: cg.counts_rows(qhi, qlo, Shi, Slo, *cut), reps)
        plain = time_ms(lambda: plain_in_chunks(
            lambda s: cg.counts_rows_plain(qhi, qlo, Shi[s].contiguous(), Slo[s].contiguous(),
                                           *(c[s].contiguous() for c in cut)), rows, step),
            1, warmup=0)
        # the least work of the function, not of the kernel's all-pairs
        # compare: both sides hold each bucket sorted ascending (PAD last),
        # so each valid slot of a row needs a binary search of its bucket's
        # occupied query slots and each PAD slot takes the PAD run
        # (`search_ops`); with cuts, one unsigned <= test (three ops) per
        # slot. Reading the planes once usually outweighs that.
        compares = rows * B * 8 * dq  # what the kernel does, for the rate below
        other = search_ops(qcnt, bank.cnt) + (3 * rows * B * 8 if cut else 0)
        nbytes = 2 * Shi.numel() * 4 + 2 * qhi.numel() * 4 + rows * 4 + (8 * rows if cut else 0)
        bms, by = bound_ms(nbytes, 0, other, clock_hz)
        results[name] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms, bound_by=by,
                             max_abs_err=err, rows=rows, dq=dq, B=B,
                             nonzero=int((got > 0).sum()))
        log(f"  {name}: equals its plain version on all {rows} rows (dq={dq}, shared-memory "
            f"columns); {ms:.4f} ms/launch ({b2b:.4f} back to back), plain {plain:.2f} ms, "
            f"bound {bms:.4f} ms ({by}), {100 * bms / b2b:.1f} % of it back to back, "
            f"{compares / ms / 1e9:.1f} G all-pairs compares/ms equivalent")
    # the wrapper's check of the query columns' order, on its first call
    # with these planes (later calls with the same unmodified planes skip it)
    check_ms = time_ms(lambda: cg._columns_ascending(qhi, qlo), reps)
    results["counts_rows"]["order_check_ms"] = check_ms
    log(f"  counts_rows query order check (first call with new planes): {check_ms:.4f} ms")
    # the library call of the same counts: torch.sparse.mm of the query's
    # incidence row against the chunk's rows, held to the exact counts
    results["counts_rows"]["library_ms"] = lib = sparse_product_ms(
        [q], mins_list, reps, query_counts_bucketed(q, bank)[None])
    log(f"  counts_rows: torch.sparse.mm of the query against the chunk {lib} ms")
    results["counts_rows global columns"] = check_counts_global_branch(
        rng, mins_list, q, reps, clock_hz)

    # membership: phase 6's slot map (pow2 dq) over 2048 selected rows (4096 for round_dec)
    q_core = q[:-1] if q[-1] == np.uint64(2**64 - 1) else q
    W = -(-len(q) // 32)
    mq = pack_query_bucketed(q_core, B, GATHER_DEVICE)
    mdq = mq[3]
    slotmap = torch.from_numpy(query_slot_map(q_core, B, mdq, W * 32)).to(GATHER_DEVICE)
    inv = inverse_slot_map(slotmap, mdq * B)
    nm = min(2048, rows)
    sel = torch.from_numpy(np.sort(rng.choice(rows, size=nm, replace=False)).astype(np.int64)).to(GATHER_DEVICE)
    Scnt = bank.cnt

    def member(sel_, smap, inv_, cnt=Scnt):
        return cg.membership_bits(mq[0], mq[1], mq[2], Shi, Slo, cnt, sel_, smap, inv_)

    def member_plain(sel_, smap, inv_, cnt=Scnt, step_=step):
        return plain_in_chunks(lambda s: cg.membership_bits_plain(
            mq[0], mq[1], mq[2], Shi, Slo, cnt, sel_[s].contiguous(), smap, inv_),
            sel_.shape[0], step_)

    got = member(sel, slotmap, inv)
    err = exact("membership_bits", got, member_plain(sel, slotmap, inv))
    if not bool(got.any()):
        raise AssertionError("membership_bits: no bit set")
    check_membership_edges(rng, member, member_plain, slotmap, inv, q_core, B, mdq, Scnt, rows)
    ms, b2b = kernel_times(lambda: member(sel, slotmap, inv), reps)
    plain = time_ms(lambda: member_plain(sel, slotmap, inv), 1, warmup=0)
    # least work of the function: each selected row's cnt bytes and its
    # valid slots' two limbs read once, each valid slot searched in its
    # bucket's sorted query slots (`search_ops`, PAD slots skipped) with
    # one map read and one bit set per hit, the query planes, occupancy and
    # inverse map read once, every output word written once
    valid = int(Scnt[sel].to(torch.int64).sum())
    other = search_ops(mq[2], Scnt[sel], pad=False) + 2 * valid + nm * W
    nbytes = (nm * (B + 8) + valid * 8 + mq[0].numel() * 8 + B * 4 + inv.numel() * 4
              + nm * W * 4)
    bms, by = bound_ms(nbytes, 0, other, clock_hz)
    results["membership_bits"] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms,
                                      bound_by=by, max_abs_err=err, nm=nm, W=W, dq=mdq,
                                      valid_slots=valid)
    log(f"  membership_bits [{nm}, {W}] (dq={mdq}, {valid} valid slots): equals its plain "
        f"version; {ms:.4f} ms/launch ({b2b:.4f} back to back), plain {plain:.2f} ms, bound "
        f"{bms:.4f} ms ({by}), {100 * bms / ms:.1f} % of it")

    # X4b at one query, on X4's inputs: its words equal X4's
    def member1():
        return cg.membership_bits_batch(mq[0][None], mq[1][None], mq[2][None], Shi, Slo, Scnt,
                                        sel[None], slotmap[None], inv[None])

    exact("membership_bits_batch at one query vs membership_bits", member1()[0], got)
    ms1, b2b1 = kernel_times(member1, reps)
    results["membership_bits"].update(batch_bq1_ms=ms1, batch_bq1_b2b_ms=b2b1,
                                      batch_bq1_parts=membership_parts(
                                          q_core, B, W, Shi, Slo, Scnt, sel, rng))
    log(f"  membership_bits_batch at one query, X4's shape: equals membership_bits; {ms1:.4f} "
        f"ms/launch ({b2b1:.4f} back to back), X4 {b2b:.4f} back to back; its probe kernel "
        f"by input (ms): {results['membership_bits']['batch_bq1_parts']}")

    k = min(4096, rows)
    sel_k = torch.from_numpy(rng.choice(rows, size=k, replace=False).astype(np.int64)).to(GATHER_DEVICE)
    M = member(sel_k, slotmap, inv)
    alive = torch.from_numpy(rng.integers(-2**31, 2**31, size=W, dtype=np.int64).astype(np.int32)).to(GATHER_DEVICE)
    rm = M[0] & alive
    got = cg.round_dec(M, rm)
    err = exact("round_dec", got, cg.round_dec_plain(M, rm))
    ms, b2b = kernel_times(lambda: cg.round_dec(M, rm), reps)
    plain = time_ms(lambda: cg.round_dec_plain(M, rm), 3, warmup=1)
    bms, by = bound_ms(k * W * 4 + W * 4 + k * 4, 0, 3 * k * W, clock_hz)
    results["round_dec"] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms, bound_by=by,
                                max_abs_err=err, k=k, W=W)
    log(f"  round_dec [{k}, {W}]: equals its plain version; {ms:.4f} ms/launch "
        f"({b2b:.4f} back to back), plain {plain:.2f} ms, bound {bms:.4f} ms ({by})")
    del M
    results.update(check_batch_kernels(quick, rng, clock_hz, mins_list, bank, q))
    del bank, Shi, Slo
    torch.cuda.empty_cache()
    return results


def search_ops(Qcnt, Scnt, d: int = 8, pad: bool = True) -> int:
    """The least integer ops of matching a chunk's slots against sorted
    query columns: each valid slot of bucket b is binary-searched in each
    query's own Qcnt[q, b] sorted slots of that bucket (bit_length of that
    occupancy probes, at least one, of three ops: hi compare, lo compare,
    select); with `pad`, each PAD slot costs one op a query (its count is
    the column's PAD run, read from the occupancy). Qcnt [bq, B] or [B],
    Scnt [rows, B]; the count is this run's data, not the most it could be."""
    import torch

    occ = Qcnt.reshape(-1, Qcnt.shape[-1]).to(torch.int64)
    probes = torch.zeros_like(occ)
    while bool((occ > 0).any()):
        probes += (occ > 0).to(torch.int64)
        occ = occ >> 1
    valid = Scnt.to(torch.int64).sum(dim=0)  # [B] valid slots of each bucket
    ops = 3 * int((probes.clamp(min=1) * valid).sum())
    if pad:
        ops += probes.shape[0] * (Scnt.numel() * d - int(valid.sum()))
    return ops


def block_join_bound(Q, S, hits: int, clock_hz: float) -> tuple:
    """(bound ms, by, bytes, query valid slots, row valid slots) of one
    block join (`counts_block` on Q = (Qhi, Qlo, Qcnt) against S = (Shi,
    Slo, Scnt); `products_block` with abundances, four planes a side):
    each side's occupancy read once, its valid slots' limbs (and
    abundance) once, the [bq, rows] output written once; an op an entry
    (its insertion or probe) and an add a matching slot pair (with a 64-bit
    multiply, weighted), `hits` of them, this run's data. The adds are L2
    atomics, whose rate the model does not hold."""
    import torch

    weighted = len(Q) == 4
    q_valid = int(Q[-1].to(torch.int64).clamp(max=Q[0].shape[1]).sum())
    s_valid = int(S[-1].to(torch.int64).clamp(max=S[0].shape[1]).sum())
    nbytes = (Q[-1].numel() * Q[-1].element_size() + S[-1].numel()
              + (12 if weighted else 8) * (q_valid + s_valid)
              + Q[0].shape[0] * S[0].shape[0] * (8 if weighted else 4))
    imad = IMAD_PER_MUL * hits if weighted else 0
    bms, by = bound_ms(nbytes, imad, q_valid + s_valid + (2 if weighted else 1) * hits,
                       clock_hz)
    return bms, by, nbytes, q_valid, s_valid


def check_block_join(name: str, Q, S, plan, reps: int, clock_hz: float, hits=None) -> dict:
    """One block join on `plan`'s tiles, `counts_block` on Q = (Qhi, Qlo,
    Qcnt) against S = (Shi, Slo, Scnt) or `products_block` with abundances
    (four planes a side): bit for bit against its plain version (one call
    on the whole block), timed per wrapper call and back to back, the
    kernel alone back to back at the path's tiles (the widest one block
    holds) and at tiles of half as many entries, each held to the
    wrapper's output; beside its
    byte bound (`block_join_bound`), its atomics (the matching slot pairs:
    the counts' sum, else `hits`) and the time to plan its tiles from host
    loads."""
    import torch

    from sourmash_tpu_torch.ops import cuda_gather as cg

    weighted = len(Q) == 4
    fn, plain_fn = ((cg.products_block, cg.products_block_plain) if weighted else
                    (cg.counts_block, cg.counts_block_plain))
    dev = Q[0].device
    got = fn(*Q, *S, plan)
    torch.cuda.synchronize()
    t0 = time.time()
    want = plain_fn(*Q, *S)
    torch.cuda.synchronize()
    plain = (time.time() - t0) * 1e3
    err = exact(name, got, want)
    del want
    atomics = int(got.sum(dtype=torch.int64)) if hits is None else hits
    ms, b2b = kernel_times(lambda: fn(*Q, *S, plan), reps)
    entries = cg.block_entries(Q[-1], Q[0].shape[1])
    plan_ms = time_ms(lambda: cg.block_join_plan(entries, weighted, dev), reps)
    narrow = cg.block_join_plan(entries, weighted, dev,
                                target=cg.block_join_capacity(weighted, dev) // 2)
    out = torch.zeros_like(got)
    args = (Q[0], Q[1], Q[2] if weighted else None, Q[-1], S[0], S[1],
            S[2] if weighted else None, S[-1], out)
    variants = {}
    for label, p in (("path", plan), (f"tiles of {1 << narrow.tile_log2}", narrow)):
        launch = functools.partial(cg.launch_block_join, p, *args)
        out.zero_()
        launch()
        exact(f"{name} ({label})", out, got)
        variants[label] = dict(tile=1 << p.tile_log2, global_tiles=p.global_tiles,
                               b2b_ms=back_to_back_ms(launch, reps))
    del out
    bq, dq, B = Q[0].shape
    rows, d = S[0].shape[:2]
    bms, by, nbytes, q_valid, s_valid = block_join_bound(Q, S, atomics, clock_hz)
    kernel = variants["path"]["b2b_ms"]
    log(f"  {name} [{bq}, {dq}, {B}] vs [{rows}, {d}, {B}] ({q_valid} + {s_valid} valid slots, "
        f"{atomics} atomics): equals its plain version; {ms:.4f} ms/launch ({b2b:.4f} back to "
        f"back; kernel alone {kernel:.4f}) at tiles of {1 << plan.tile_log2} buckets "
        f"({plan.global_tiles} in global memory); back to back by variant "
        f"{ {k: round(v['b2b_ms'], 4) for k, v in variants.items()} }; plan from host loads "
        f"{plan_ms:.4f} ms; plain {plain:.1f} ms; bound {bms:.4f} ms ({by}, {nbytes} bytes), "
        f"{100 * bms / b2b:.1f} % of it back to back")
    return dict(ms=ms, b2b_ms=b2b, kernel_b2b_ms=kernel, plain_ms=plain, bound_ms=bms,
                bound_by=by, bytes=nbytes, max_abs_err=err, atomics=atomics, q_valid=q_valid,
                s_valid=s_valid, bq=bq, rows=rows, dq=dq, d=d, B=B, tile=1 << plan.tile_log2,
                global_tiles=plan.global_tiles, plan_ms=plan_ms, variants=variants)


def check_counts_block(label: str, qs, Shi, Slo, Scnt, reps: int, clock_hz: float, dev) -> dict:
    """counts_block of a block of queries against one chunk on the tiles
    planned from the block's host loads, as multigather plans them
    (`check_block_join`), each of its first and last queries' rows held to
    counts_rows' raw matches minus the exact PAD correction, and timed
    beside counts_rows launched for each query."""
    from sourmash_tpu_torch.ops import bucketed as bk
    from sourmash_tpu_torch.ops import cuda_gather as cg

    bq, B = len(qs), Shi.shape[2]
    loads = bk.query_block_loads(qs, B)
    Qhi, Qlo, Qcnt, dq, _raw = bk.pack_query_block_device(qs, B, device=dev, loads=loads)
    plan = cg.block_join_plan(loads.sum(axis=0), False, dev)
    res = check_block_join(f"counts_block, {label}", (Qhi, Qlo, Qcnt), (Shi, Slo, Scnt), plan,
                           reps, clock_hz)
    got = cg.counts_block(Qhi, Qlo, Qcnt, Shi, Slo, Scnt, plan)
    for i in (0, bq - 1):
        raw = cg.counts_rows(Qhi[i], Qlo[i], Shi, Slo)
        exact(f"counts_block, {label}, query {i} vs counts_rows", got[i],
              raw - bk._pad_correction(Qcnt[i], Scnt, dq, Shi.shape[1]))
    rows_ms = time_ms(lambda: [cg.counts_rows(Qhi[i], Qlo[i], Shi, Slo) for i in range(bq)],
                      reps)
    log(f"  counts_block ({label}): queries 0 and {bq - 1} equal counts_rows minus the PAD "
        f"correction; counts_rows for each of the {bq} queries {rows_ms:.4f} ms")
    return dict(res, counts_rows_x_bq_ms=rows_ms)


def check_batch_kernels(quick: bool, rng, clock_hz: float, mins_list, bank, q) -> dict:
    """The batch kernels against their plain versions on the card, bit for
    bit, at phase 8's shapes, each timed with its bound: counts_block on
    phase 2's chunk against phase 8's block (MULTI_LARGE queries of ~600 k
    hashes, then MULTI_SMALL of 20 k-150 k) and a block of BLOCK_QUERIES
    of the same mix (a quarter large), each beside counts_rows launched for
    each query of the block, and 8 of them against a B = 128 bank, where
    the join's tiles exceed shared memory; membership_bits_batch with 4 queries x 2,048
    rows at W = ceil(600 k / 32) on edge inputs (padded selections, an
    empty query, the block repacked at a depth above its own, rows with
    cnt = 8 and 2^64-1), and with 4 queries of ~600 k hashes (not
    --quick); round_dec_batch on its words."""
    import torch

    from sourmash_tpu_torch.ops import bucketed as bk
    from sourmash_tpu_torch.ops import cuda_gather as cg

    dev = torch.device(GATHER_DEVICE)
    rows, B = bank.hi.shape[0], bank.B
    Shi, Slo, Scnt = bank.hi, bank.lo, bank.cnt
    reps = 3 if quick else 10
    bq = 4 if quick else BLOCK_QUERIES
    n_large = bq // 4
    t0 = time.time()
    sizes = [GATHER_QUERY_HASHES] * (n_large - 1) + rng.integers(
        MULTI_SMALL_HASHES[0], MULTI_SMALL_HASHES[1] + 1, size=bq - n_large).tolist()
    qs = [q] + [make_gather_query(rng, mins_list, n)[0] for n in sizes]
    log(f"  {bq} queries ({n_large} of ~600 k hashes) made in {time.time() - t0:.1f} s")
    # phase 8's block (MULTI_LARGE large samples first, then MULTI_SMALL
    # small), whose launches the kernels line counts, and a block of
    # BLOCK_QUERIES; --quick: one block of 4
    blocks = ([(f"block of {bq}", qs)] if quick else
              [("phase 8's block", qs[:MULTI_LARGE] + qs[n_large : n_large + MULTI_SMALL]),
               (f"block of {bq}", qs)])
    results = {}
    for label, bqs in blocks:
        res = check_counts_block(label, bqs, Shi, Slo, Scnt, reps, clock_hz, dev)
        if "counts_block" in results:
            results["counts_block"][f"block{len(bqs)}"] = res
        else:
            results["counts_block"] = res
    # the library call of phase 8's block of counts (the kernels line's row)
    path_qs = blocks[0][1]
    want = np.stack([bk.query_counts_bucketed(x, bank) for x in path_qs])
    results["counts_block"]["library_ms"] = lib = sparse_product_ms(path_qs, mins_list, reps, want)
    log(f"  counts_block ({blocks[0][0]}): torch.sparse.mm of the block against the chunk {lib} ms")

    # the global-memory branch: a bank of small genomes (B = 128)
    n_small = min(GLOBAL_ROWS, len(mins_list))
    small = [m[: int(n)] for m, n in zip(mins_list[:n_small], rng.integers(150, 321, size=n_small))]
    gbank = bk.pack_rows_device(small, GLOBAL_B, device=dev)
    gq = qs[:n_large] + [q] * (8 - n_large)  # 8 large queries (--quick: copies of one)
    gloads = bk.query_block_loads(gq, GLOBAL_B)
    Ghi, Glo, Gcnt, gdq, _graw = bk.pack_query_block_device(gq, GLOBAL_B, device=dev,
                                                            loads=gloads)
    gplan = cg.block_join_plan(gloads.sum(axis=0), False, dev)
    if not gplan.global_tiles:
        raise AssertionError(f"dq={gdq} at B = {GLOBAL_B}: no tile of the join in global memory")
    res = check_block_join("counts_block, global-memory tiles", (Ghi, Glo, Gcnt),
                           (gbank.hi, gbank.lo, gbank.cnt), gplan, reps, clock_hz)
    got = cg.counts_block(Ghi, Glo, Gcnt, gbank.hi, gbank.lo, gbank.cnt, gplan)
    for i in (0, len(gq) - 1):
        exact(f"counts_block global tiles, query {i} vs counts_rows", got[i],
              cg.counts_rows(Ghi[i], Glo[i], gbank.hi, gbank.lo)
              - bk._pad_correction(Gcnt[i], gbank.cnt, gdq, gbank.d))
    results["counts_block"]["global"] = res
    del gbank, Ghi, Glo

    # membership_bits_batch: a block of 4 (600 k, 150 k, empty, 20 k hashes),
    # repacked at a depth above the block's own, as a block of a larger wave is
    mq = [q, make_gather_query(rng, mins_list, 150_000)[0], np.zeros(0, dtype=np.uint64),
          make_gather_query(rng, mins_list, 20_000)[0]]
    cores = [m[m != np.uint64(2**64 - 1)] for m in mq]
    _h, _l, _c, own_dq, mraw = bk.pack_query_block_device(cores, B, device=dev)
    dqm = own_dq + 8
    Mhi, Mlo, Mcnt = bk._device_pack(mraw[0], mraw[1], B, dqm, torch.int32)
    W = -(-len(q) // 32)
    smaps = np.full((len(mq), W * 32), dqm * B, dtype=np.int32)
    for j, core in enumerate(cores):
        if len(core):
            smaps[j] = bk.query_slot_map(core, B, dqm, W * 32)
    smaps = torch.from_numpy(smaps).to(dev)
    inv = bk.inverse_slot_map(smaps, dqm * B)
    nm = min(2048, rows)
    sel = np.zeros((len(mq), nm), dtype=np.int64)
    sel[0] = np.r_[np.arange(min(9, rows)), rng.choice(np.arange(9, rows), size=nm - min(9, rows),
                                                       replace=False)]
    sel[1] = rng.choice(rows, size=nm, replace=False)
    sel[3, : nm // 8] = rng.choice(rows, size=nm // 8, replace=False)  # the rest padded with row 0
    sel = torch.from_numpy(sel).to(dev)
    if not bool((Scnt[1 : min(9, rows)] == 8).any()):
        raise AssertionError("membership_bits_batch: no bucket with cnt = 8 among rows 1-8")

    def member():
        return cg.membership_bits_batch(Mhi, Mlo, Mcnt, Shi, Slo, Scnt, sel, smaps, inv)

    res, got = check_membership_batch(
        "membership_bits_batch (an empty query, padded selections, cnt = 8, 2^64-1, a depth "
        "above the block's own)", member, (Mhi, Mlo, Mcnt, Shi, Slo, Scnt, sel, smaps, inv),
        cores, reps, clock_hz)
    if not bool(got[0].any()) or bool(got[2].any()):
        raise AssertionError("membership_bits_batch: the 600 k query has no bit or the empty one has")
    res.update(dq=dqm, own_dq=own_dq, split=device_split(member, 3),
               walks=table_walks(cores[0], Shi, Slo, Scnt, sel[0],
                                 cg.membership_table_groups(dqm, B, W)))
    log(f"  membership_bits_batch: device time a call {res['split']} (ms); table walks of query "
        f"0: {res['walks']}")
    if not quick:
        # 4 queries of ~600 k hashes (phase 8's device-membership samples),
        # whose tables (~18 MB each) together exceed the 50 MB L2
        big = [m[m != np.uint64(2**64 - 1)] for m in qs[:MULTI_LARGE]]
        Bhi, Blo, Bcnt, bdq, _braw = bk.pack_query_block_device(big, B, device=dev)
        bW = -(-max(len(m) for m in big) // 32)
        bmaps = torch.from_numpy(np.stack([bk.query_slot_map(m, B, bdq, bW * 32)
                                           for m in big])).to(dev)
        binv = bk.inverse_slot_map(bmaps, bdq * B)
        bsel = torch.from_numpy(np.stack([rng.choice(rows, size=nm, replace=False)
                                          for _ in big]).astype(np.int64)).to(dev)
        res["large4"], _got = check_membership_batch(
            f"membership_bits_batch, {len(big)} queries of ~600 k",
            lambda: cg.membership_bits_batch(Bhi, Blo, Bcnt, Shi, Slo, Scnt, bsel, bmaps, binv),
            (Bhi, Blo, Bcnt, Shi, Slo, Scnt, bsel, bmaps, binv), big, reps, clock_hz)
        res["large4"]["table_mb"] = len(big) * 48 * cg.membership_table_groups(bdq, B, bW) / 1e6
        del Bhi, Blo, Bcnt, bmaps, binv, _got
    results["membership_bits_batch"] = res

    M = got
    alive = torch.from_numpy(rng.integers(-2**31, 2**31, size=(len(mq), W), dtype=np.int64)
                             .astype(np.int32)).to(dev)
    rm = (M[:, 0] & alive).contiguous()
    got = cg.round_dec_batch(M, rm)
    err = exact("round_dec_batch", got, cg.round_dec_batch_plain(M, rm))
    ms, b2b = kernel_times(lambda: cg.round_dec_batch(M, rm), reps)
    plain = time_ms(lambda: cg.round_dec_batch_plain(M, rm), 3, warmup=1)
    Q, k, _ = M.shape
    bms, by = bound_ms(M.numel() * 4 + rm.numel() * 4 + Q * k * 4, 0, 3 * M.numel(), clock_hz)
    results["round_dec_batch"] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms,
                                      bound_by=by, max_abs_err=err, Q=Q, k=k, W=W)
    log(f"  round_dec_batch [{Q}, {k}, {W}]: equals its plain version; {ms:.4f} ms/launch "
        f"({b2b:.4f} back to back), plain {plain:.2f} ms, bound {bms:.4f} ms ({by})")
    return results


def check_membership_batch(label: str, member, args, cores, reps: int, clock_hz: float):
    """membership_bits_batch (`member()`, on `args` = Qhi, Qlo, Qcnt, Shi,
    Slo, Scnt, sel, slotmaps, inv) against its plain version bit for bit
    (256 selections at a time), timed with its bound: each selected row's
    cnt bytes and its valid slots read once for each query with hashes, the
    query planes, occupancy and inverse maps read once, every word written
    once; an op a valid slot of either side (its one look-up) and a word.
    The bound of the binary search's steps (`search_ops`, the model of
    the kernel this one replaced) stands beside it. Returns (results, the
    words)."""
    import torch

    from sourmash_tpu_torch.ops import cuda_gather as cg

    Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel, smaps, inv = args
    bq, nm, W = sel.shape[0], sel.shape[1], smaps.shape[1] // 32
    B = Qhi.shape[2]
    got = member()
    t0 = time.time()
    torch.cuda.synchronize()
    want = torch.cat([cg.membership_bits_batch_plain(
        Qhi, Qlo, Qcnt, Shi, Slo, Scnt, sel[:, c : c + 256].contiguous(), smaps, inv)
        for c in range(0, nm, 256)], dim=1)
    torch.cuda.synchronize()
    plain = (time.time() - t0) * 1e3
    err = exact(label, got, want)
    del want
    ms, b2b = kernel_times(member, reps)
    valid = [int(Scnt[sel[j]].to(torch.int64).sum()) if len(cores[j]) else 0 for j in range(bq)]
    qvalid = int(Qcnt.to(torch.int64).clamp(max=Qhi.shape[1]).sum())
    nbytes = (sum(nm * (B + 8) + v * 8 for v in valid) + Qhi.numel() * 8 + Qcnt.numel() * 4
              + inv.numel() * 4 + bq * nm * W * 4)
    bms, by = bound_ms(nbytes, 0, sum(valid) + qvalid + bq * nm * W, clock_hz)
    search = sum(search_ops(Qcnt[j], Scnt[sel[j]], pad=False) + 2 * v
                 for j, v in enumerate(valid) if v) + bq * nm * W
    bms_search, by_search = bound_ms(nbytes, 0, search, clock_hz)
    res = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms, bound_by=by,
               bound_ms_search=bms_search, bound_by_search=by_search, max_abs_err=err, bq=bq,
               nm=nm, W=W, valid_slots=sum(valid), query_slots=qvalid)
    log(f"  {label} [{bq}, {nm}, {W}] (dq={Qhi.shape[1]}, {sum(valid)} valid row slots): equals "
        f"its plain version; {ms:.4f} ms/launch ({b2b:.4f} back to back), plain {plain:.0f} ms, "
        f"bound {bms:.4f} ms ({by}; the search's model {bms_search:.4f}, {by_search}), "
        f"{100 * bms / b2b:.1f} % of it back to back")
    return res, got


def membership_parts(core, B: int, W: int, Shi, Slo, Scnt, sel, rng) -> dict:
    """membership_bits_batch's probe kernel (device ms a launch, torch.profiler)
    at one query over the same [len(sel), W] words, by what its inputs let
    it skip: the ~600 k-hash query (the path); an empty query (no row is
    walked: the words cleared and written only); a query of 5 k of its
    hashes (a table that stays in cache); the 600 k query against one row
    selected len(sel) times (the rows in cache)."""
    import torch

    from sourmash_tpu_torch.ops import bucketed as bk
    from sourmash_tpu_torch.ops import cuda_gather as cg

    dev = Scnt.device
    once = torch.zeros_like(sel)
    small = np.sort(rng.choice(core, size=min(5000, len(core)), replace=False))
    out = {}
    for name, c, s in (("path", core, sel), ("empty", core[:0], sel), ("5 k hashes", small, sel),
                       ("rows in cache", core, once)):
        Qhi, Qlo, Qcnt, dq, _raw = bk.pack_query_block_device([c], B, device=dev)
        smap = torch.from_numpy(bk.query_slot_map(c, B, dq, W * 32)[None]).to(dev)
        inv = bk.inverse_slot_map(smap, dq * B)
        split = device_split(lambda: cg.membership_bits_batch(
            Qhi, Qlo, Qcnt, Shi, Slo, Scnt, s[None], smap, inv), 5)
        out[name] = sum(v for k, v in split.items() if "membership" in k and "table" not in k)
    return out


def device_split(fn, n: int) -> dict:
    """{kernel or copy name: device ms a call} of n calls of fn under
    torch.profiler (after one call outside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:64]: round(e.self_device_time_total / 1e3 / n, 4)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def table_walks(core: np.ndarray, Shi, Slo, Scnt, sel, groups: int) -> dict:
    """The groups that membership_bits_batch's probes of one query read, from
    this run's data: the table of the query's hashes (linear probing by
    groups of 4 from `table_home`; which groups fill does not depend on the
    order of the inserts), each valid slot of the selected rows walking
    from its home group to the first group with a free slot (exact for a
    miss; a hit stops there or earlier). Mean groups a look-up, and a warp's
    rounds a slot level (the longest walk of its 32 lanes x 4 buckets,
    kProbeThreads = 512) against the mean, over the slot levels where the
    warp has a look-up."""

    def home(keys):
        with np.errstate(over="ignore"):
            x = (keys * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(32)
        return ((x * np.uint64(groups)) >> np.uint64(32)).astype(np.int64)

    c = np.bincount(home(core), minlength=groups)
    over = np.cumsum(c - 4)
    carry = np.maximum(over - np.minimum(np.minimum.accumulate(over), 0), 0)
    full = np.minimum(np.r_[carry[-1], carry[:-1]] + c, 4) == 4  # one wrap of the carry
    free = np.flatnonzero(~full)
    at = np.searchsorted(free, np.arange(groups))
    walk = np.where(at < len(free), free[np.minimum(at, len(free) - 1)],
                    groups + free[0]) - np.arange(groups) + 1
    cnt = Scnt[sel].cpu().numpy().astype(np.int64)  # [nm, B]
    nm, (d, B) = sel.shape[0], tuple(Shi.shape[1:])
    valid = np.arange(d)[None, :, None] < cnt[:, None, :]
    hi = Shi[sel].cpu().numpy().view(np.uint32)[valid].astype(np.uint64)
    lo = Slo[sel].cpu().numpy().view(np.uint32)[valid].astype(np.uint64)
    lengths = np.zeros((nm, d, B), dtype=np.int64)
    lengths[valid] = walk[home((hi << np.uint64(32)) | lo)]
    out = dict(groups=groups, load=round(len(core) / (4 * groups), 4),
               mean=round(float(lengths[valid].mean()), 4), rows=nm)
    if B % 2048 == 0:  # b = it * 2048 + u * 512 + warp * 32 + lane
        per = lengths.reshape(nm, d, B // 2048, 4, 16, 32)
        live = (per > 0).any(axis=(3, 5))
        out["warp_rounds"] = round(float(per.max(axis=(3, 5))[live].mean()), 4)
        out["warp_mean"] = round(float((per.sum(axis=(3, 5)) / np.maximum(
            (per > 0).sum(axis=(3, 5)), 1))[live].mean()), 4)
    return out


GLOBAL_B = 128  # a bank of small genomes (choose_buckets of <= 320 hashes)
GLOBAL_ROWS = 1024


def check_counts_global_branch(rng, mins_list, q, reps: int, clock_hz: float) -> dict:
    """counts_rows against its plain version, bit for bit, with and without
    cuts, where the query columns exceed the block's shared memory and are
    searched in global memory (L2): a bank of GLOBAL_ROWS sketches of 150-
    320 hashes (B = 128) cut from phase 2's rows against phase 2's ~600 k
    hash query, so dq is in the thousands. Timed, not in the kernels line."""
    import torch

    from sourmash_tpu_torch.ops import bucketed as bk
    from sourmash_tpu_torch.ops import cuda_gather as cg
    from sourmash_tpu_torch.ops.index_ops import _cached_query_pack

    dev = torch.device(GATHER_DEVICE)
    small = [m[: int(n)] for m, n in zip(mins_list[:GLOBAL_ROWS],
                                         rng.integers(150, 321, size=GLOBAL_ROWS))]
    if bk.choose_buckets(max(len(m) for m in small)) != GLOBAL_B:
        raise AssertionError("the small-genome bank does not take B = 128")
    bank = bk.pack_rows_device(small, GLOBAL_B, device=dev)
    qhi, qlo, _qcnt, dq, _tail = _cached_query_pack(q, GLOBAL_B, dev)
    smem = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", 232448)
    if dq * 32 * 8 <= smem:
        raise AssertionError(f"dq={dq} fits the block's shared memory: not the global branch")
    rows = bank.hi.shape[0]
    cuts = rng.choice(np.array([2**64 - 1, 2**63, max_hash_for(1000), 2**62], dtype=np.uint64),
                      size=rows)
    chi, clo = u64_planes(cuts)
    out = {}
    for name, cut in (("plain form", ()), ("cutoff form", (chi, clo))):
        got = cg.counts_rows(qhi, qlo, bank.hi, bank.lo, *cut)
        want = plain_in_chunks(lambda s: cg.counts_rows_plain(
            qhi, qlo, bank.hi[s].contiguous(), bank.lo[s].contiguous(),
            *(c[s].contiguous() for c in cut)), rows, 16)
        exact(f"counts_rows global columns, {name}", got, want)
        if not bool((got > 0).any()):
            raise AssertionError(f"counts_rows global columns, {name}: no row counted a hit")
        ms, b2b = kernel_times(lambda: cg.counts_rows(qhi, qlo, bank.hi, bank.lo, *cut), reps)
        nbytes = 2 * bank.hi.numel() * 4 + 2 * qhi.numel() * 4 + rows * 4
        bms, by = bound_ms(nbytes, 0, 0, clock_hz)
        out[name] = dict(ms=ms, b2b_ms=b2b, bound_ms=bms, bound_by=by)
        log(f"  counts_rows [{rows}, 8, {GLOBAL_B}] vs dq={dq} (global-memory columns, "
            f"{name}): equals its plain version; {ms:.4f} ms/launch ({b2b:.4f} back to back), "
            f"bytes bound {bms:.4f} ms")
    out.update(rows=rows, B=GLOBAL_B, dq=dq)
    return out


def check_membership_edges(rng, member, member_plain, slotmap, inv, q_core, B: int,
                           dq: int, Scnt, rows: int):
    """membership_bits against its plain version, bit for bit, on phase 2's
    chunk and query: the identity slot map of `membership_matrix` (every
    slot position, PAD slots included) on 512 rows; rows whose crowded
    bucket holds cnt = 8, the row with 2^64-1, rows emptied (cnt 0) and a
    `sel` that repeats rows; and one W above the block's shared memory,
    where the kernel builds the words in global memory."""
    import torch

    from sourmash_tpu_torch.ops.bucketed import query_slot_map

    dev = Scnt.device
    identity = torch.arange(dq * B, dtype=torch.int32, device=dev)
    sel = torch.from_numpy(np.r_[np.arange(min(9, rows)),
                                 rng.choice(rows, size=min(503, rows), replace=False)]
                           .astype(np.int64)).to(dev)
    got = member(sel, identity, identity)
    exact("membership_bits identity map", got, member_plain(sel, identity, identity, step_=128))
    if not bool(got.any()):
        raise AssertionError("membership_bits identity map: no bit set")
    if not bool((Scnt[1 : min(9, rows)] == 8).any()):
        raise AssertionError("membership_bits: no bucket with cnt = 8 among rows 1-8")

    emptied = rng.choice(np.arange(9, rows), size=min(8, rows - 9), replace=False)
    cnt = Scnt.clone()
    cnt[torch.from_numpy(emptied).to(dev)] = 0
    picks = np.r_[np.arange(min(9, rows)), emptied, emptied[:3], [1, 1, 0, 5, 5],
                  rng.choice(rows, size=32)]
    edge_sel = torch.from_numpy(rng.permutation(picks).astype(np.int64)).to(dev)
    exact("membership_bits cnt=8, 2^64-1, empty and repeated rows",
          member(edge_sel, slotmap, inv, cnt), member_plain(edge_sel, slotmap, inv, cnt))

    props = torch.cuda.get_device_properties(dev)
    smem_words = getattr(props, "shared_memory_per_block_optin", 232448) // 4
    W_big = smem_words + 1024
    big = torch.from_numpy(query_slot_map(q_core, B, dq, W_big * 32)).to(dev)
    got = member(edge_sel, big, inv, cnt)
    exact(f"membership_bits W={W_big} (global words)", got,
          member_plain(edge_sel, big, inv, cnt, step_=16))
    log(f"  membership_bits edges: identity map [{len(sel)}, {dq * B // 32}], cnt = 8, "
        f"2^64-1, {len(emptied)} emptied and repeated rows [{len(picks)}], and W = {W_big} "
        f"past the {smem_words}-word shared bitmap equal their plain version")


# -- phase 2 (instruments) and phase 7: the sketch-kernel instruments --------

T4_ROWS = 512  # the tools' T4 block rows (sourmash_tpu_torch/tools/_common.py)
# the mul-chain's work is real only if, net of the 0-round kernel, 16 rounds
# take >= half its time and 64 rounds >= 3x the time of 16; its SASS must
# hold an IMAD.WIDE.U32 (the multiply's low product) per chain of each
# unrolled round
MULCHAIN_OWN = 0.5
MULCHAIN_GROWTH = 3.0
MULCHAIN_UNROLL = 8  # `#pragma unroll 8` in mulchain_kernel
MULCHAIN_CHAINS = 4  # kMulChains: independent chains a thread


def cuobjdump(*args: str):
    "cuobjdump's standard output for `args`; None where there is no cuobjdump."
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, *args], check=True, capture_output=True, text=True).stdout


def sass_functions(path: str):
    """{mangled function name: [SASS instruction lines]} of the built
    library or cubin at `path`, by cuobjdump; None where there is none."""
    import re

    sass = cuobjdump("-sass", path)
    if sass is None:
        return None
    functions = {}
    for section in sass.split("Function : ")[1:]:
        header, body = section.split("\n", 1)
        # runs of spaces collapsed: cuobjdump pads its columns to the
        # widest line of the listing, which another kernel may set
        functions[header.strip()] = [" ".join(line.split()) for line in body.splitlines()
                                     if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
    return functions


def sass_of(functions, kernel: str):
    "The SASS lines of the kernel named `kernel` in the source; None if absent."
    for name, lines in (functions or {}).items():
        if f"{len(kernel)}{kernel}" in name:  # the mangled, length-prefixed name
            return lines
    return None


def sass_lines(lib: str, kernel: str, template_k: str | None = None):
    """The SASS lines of `kernel` in the built library `lib` (of its entry
    for `template_k`, "k=31" say, where it is a template), by cuobjdump;
    None where there is no cuobjdump."""
    from sourmash_tpu_torch.ops import _build

    functions = sass_functions(_build._so_path(lib))
    if functions is None:
        return None
    if template_k is None:
        return sass_of(functions, kernel)
    return by_template_k(functions, kernel).get(template_k)


SASS_INSTRUCTION = r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)(.*)"


def sass_instructions(lines) -> list:
    "[(address, opcode, operands)] of SASS lines (predicates dropped)."
    import re

    found = (re.match(SASS_INSTRUCTION, line) for line in lines)
    return [(int(m.group(1), 16), m.group(2), m.group(3)) for m in found if m]


def opcode_counts(instructions) -> dict:
    "{opcode: count} of SASS instructions, the most common first."
    import collections

    return dict(collections.Counter(op for _, op, _ in instructions).most_common())


def sass_opcodes(lib: str, kernel: str):
    """{opcode: count} of `kernel` in the built library `lib`'s SASS, by
    cuobjdump; None where there is no cuobjdump."""
    lines = sass_lines(lib, kernel)
    return None if lines is None else opcode_counts(sass_instructions(lines))


def backward_branches(instructions) -> list:
    """[(target, address)] of the branches to an earlier address: the
    loops (a kernel's closing self-branch after EXIT is not one)."""
    import re

    out = []
    for addr, op, operands in instructions:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", operands)
            if m is None:
                raise AssertionError(f"cannot read the target of {op}{operands}")
            if int(m.group(1), 16) < addr:
                out.append((int(m.group(1), 16), addr))
    return out


def loop_opcodes(instructions) -> dict:
    """{opcode: count} of the longest loop's body (from a backward branch's
    target to the branch): a kernel's unrolled main loop."""
    loops = backward_branches(instructions)
    if not loops:
        return {}
    first, last = max(loops, key=lambda loop: loop[1] - loop[0])
    return opcode_counts(i for i in instructions if first <= i[0] <= last)


# SASS opcodes by pipe: the IMAD pipe (IMAD in all its forms: the wide and
# high products, and the moves, adds and shifts nvcc puts there for
# balance) and the other integer pipe (its base opcodes)
IMAD_PIPE_OPS = ("IMAD", "IMUL")
ALU_OPS = frozenset(("LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "IADD", "VIADD", "LEA", "ISETP",
                     "ICMP", "SEL", "PRMT", "MOV", "IMNMX", "VIMNMX", "SGXT", "BMSK", "PLOP3",
                     "IABS", "BREV", "FLO", "POPC", "P2R", "R2P"))


def chain_round(lines) -> dict | None:
    """A chain's round by pipe (`pipe_counts`) in the unrolled loop of a
    chain kernel's SASS lines (MULCHAIN_UNROLL rounds of MULCHAIN_CHAINS
    chains: the mul-chain, the probe); None without SASS."""
    if lines is None:
        return None
    counts = pipe_counts(loop_opcodes(sass_instructions(lines)))
    return {pipe: n / (MULCHAIN_UNROLL * MULCHAIN_CHAINS) for pipe, n in counts.items()}


def pipe_counts(opcodes: dict) -> dict:
    """{"wide": IMAD.WIDE.U32 and IMAD.WIDE, "imad": the other IMAD-pipe
    instructions, "alu": the other integer instructions} of opcode counts."""
    out = dict(wide=0, imad=0, alu=0)
    for op, n in opcodes.items():
        base = op.split(".")[0]
        if base in IMAD_PIPE_OPS:
            out["wide" if op.startswith("IMAD.WIDE") else "imad"] += n
        elif base in ALU_OPS:
            out["alu"] += n
    return out


SM_WARPS, SM_BLOCKS, SM_REGS, SM_SMEM, BLOCK_SMEM_RESERVED = 64, 32, 65536, 233472, 1024


def dna_smem_bytes(k: int) -> int:
    "csrc/sketch_common.cuh dna_smem_bytes: the DNA tile's dynamic shared memory."
    L = (K1_TILE + k - 1 + 31) // 32 * 32
    return 2 * L + 16 + 5 * 4 * (L // 32 + 1)


def resource_usage(lib: str, kernel: str, threads: int = 256) -> dict | None:
    """{"k=21" ...: registers, stack, static shared and local bytes a
    thread or block, and the theoretical occupancy} of the entries of
    `kernel` in the built library `lib`, from `cuobjdump
    --dump-resource-usage`; None where there is no cuobjdump. Occupancy is
    resident warps over the SM's 64 for blocks of `threads` with the DNA
    tile's dynamic shared memory at the entry's k ("k=any" at k = 129, the
    largest of KS): the least of the SM's block, warp, register (whole
    8-register steps a thread) and shared-memory (1 KB reserved a block)
    limits."""
    import re

    from sourmash_tpu_torch.ops import _build

    dump = cuobjdump("--dump-resource-usage", _build._so_path(lib))
    if dump is None:
        return None
    found = {}
    for name, line in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", dump):
        found[name] = {key.lower(): int(val) for key, val in
                       re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", line)}
    out = {}
    for tk, use in by_template_k(found, kernel).items():
        k = 129 if tk == "k=any" else int(tk[2:])
        warps = threads // 32
        by_regs = SM_REGS // (-(-use["reg"] // 8) * 8 * 32) // warps
        by_smem = SM_SMEM // (use["shared"] + dna_smem_bytes(k) + BLOCK_SMEM_RESERVED)
        blocks = min(SM_BLOCKS, SM_WARPS // warps, by_regs, by_smem)
        out[tk] = dict(registers=use["reg"], stack=use["stack"], shared=use["shared"],
                       local=use["local"], blocks_per_sm=blocks,
                       occupancy=blocks * warps / SM_WARPS)
    return out


def ptxas_usage(build_log: str) -> dict:
    """{mangled entry: (registers, spill store bytes, spill load bytes)}
    from nvcc's `-Xptxas -v` report."""
    import re

    usage = {}
    for section in build_log.split("Compiling entry function '")[1:]:
        name = section.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", section)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", section)
        usage[name] = (int(regs.group(1)) if regs else None,
                       *(int(x) for x in (spills.groups() if spills else (-1, -1))))
    return usage


def by_template_k(functions: dict, kernel: str) -> dict:
    """{"k=21" ...: value} of the entries of `kernel` in `functions`, keyed
    by their template k; 0 reads k at run time and is keyed "k=any"."""
    import re

    out = {}
    for name, value in functions.items():
        if f"{len(kernel)}{kernel}" in name:  # the mangled, length-prefixed name
            m = re.search(r"ILi(\d+)E", name)
            out[f"k={m.group(1) if m and m.group(1) != '0' else 'any'}"] = value
    return out


def sass_against(other_root: str) -> dict:
    """Build this tree's and `other_root`'s csrc/sketch.cu with this tree's
    flags and require the SASS of K1 and K2 to equal the other tree's,
    instruction for instruction, for every k they are built for (21, 31,
    51 and run-time k); print K3's instruction counts per template k, its
    registers and spill bytes on both sides, and time the other tree's K3
    beside this tree's (k = 10 at B = 4 and the path's batch, alternating
    other, this, this, other). Returns those times."""
    from sourmash_tpu_torch.ops import _build

    sides = {"this tree": os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "sourmash_tpu_torch", "csrc", "sketch.cu"),
             other_root: os.path.join(other_root, "sourmash_tpu_torch", "csrc", "sketch.cu")}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (side, src) in enumerate(sides.items()):
            so = os.path.join(tmp, f"sketch{i}.so")
            procs[side] = (so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        sass, usage = {}, {}
        for side, (so, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"--sass-against: building {sides[side]} failed\n{out}")
            sass[side], usage[side] = sass_functions(so), ptxas_usage(out)
        if None in sass.values():
            raise AssertionError("--sass-against needs cuobjdump")
        ours, other = sass["this tree"], sass[other_root]
        differ = []
        for kernel in ("survivor_slots_kernel", "window_hashes_kernel"):
            a, b = by_template_k(ours, kernel), by_template_k(other, kernel)
            if not a or a.keys() != b.keys():
                differ.append(f"{kernel}: template ks {sorted(a)} vs {sorted(b)}")
            for tk in sorted(a.keys() & b.keys()):
                if a[tk] != b[tk]:
                    differ.append(f"{kernel} {tk}: SASS differs from {other_root}'s "
                                  f"({len(a[tk])} vs {len(b[tk])} instructions)")
                    log(f"  {differ[-1]}; first differences:")
                    for x, y in [(x, y) for x, y in zip(a[tk], b[tk]) if x != y][:8]:
                        log(f"    {x}\n    {y}")
                else:
                    log(f"  {kernel} {tk}: SASS identical to {other_root}'s "
                        f"({len(a[tk])} instructions)")
        kernel = "aa_window_hashes_kernel"
        for side in sides:
            counts = {tk: len(lines) for tk, lines in by_template_k(sass[side], kernel).items()}
            regs = {tk: dict(registers=u[0], spill_stores=u[1], spill_loads=u[2])
                    for tk, u in by_template_k(usage[side], kernel).items()}
            log(f"  {kernel} ({side}): {counts} instructions; {regs}")
        times = time_other_k3(procs[other_root][0], other_root)
    if differ:
        raise AssertionError("; ".join(differ))
    return times


def time_other_k3(so: str, other_root: str) -> dict:
    """K3 of the library `so` (another tree's sketch.cu) against this
    tree's at k = TIMED_AA_K on aa_rows at B = 4 and the path's batch:
    outputs bit for bit, then (per call, back to back) of each, timed
    other, this, this, other, with the time per launch in a CUDA graph
    beside them (the other tree's launch has a shorter host path than the
    wrapper, so only the graph times compare the kernels); each side's
    pair of runs is averaged."""
    import ctypes

    import torch

    from sourmash_tpu_torch.ops import _build, u64
    from sourmash_tpu_torch.ops import cuda_sketch as cs

    lib = ctypes.CDLL(so)
    entry = lib.sm_aa_window_hashes
    entry.argtypes = _build._LIBRARIES["sketch"][1]["sm_aa_window_hashes"]
    entry.restype = ctypes.c_int
    k = TIMED_AA_K
    rng = np.random.default_rng(7)
    times = {}
    for B in (4, path_aa_batch()):
        rows = torch.from_numpy(aa_rows(B, k, rng)).cuda()
        S = rows.shape[1]
        _, _, n_pad = cs.geometry(S, k)

        def other():
            h = torch.empty((B, n_pad), dtype=torch.int64, device="cuda")
            v = torch.empty((B, n_pad), dtype=torch.uint8, device="cuda")
            rc = entry(rows.data_ptr(), B, S, n_pad, k, 42 & u64.MASK64, h.data_ptr(),
                       v.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise AssertionError(f"{other_root}'s sm_aa_window_hashes: CUDA error {rc}")
            return h, v

        def this():
            return cs.aa_window_hashes(rows, ksize=k)

        for name, a, b in zip(("hashes", "valid"), this(), other()):
            exact(f"K3 {name} k={k} B={B} against {other_root}'s", a, b)
        runs = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            run = other if side == "other" else this
            runs[side].append((*kernel_times(run, 20), graph_ms(run)))
        times[B] = {side: tuple(sum(x) / 2 for x in zip(*r)) for side, r in runs.items()}
        o, t = times[B]["other"], times[B]["this"]
        log(f"  K3 k={k} B={B}: {other_root}'s {o[0]:.4f} ms/launch ({o[1]:.4f} back to back, "
            f"{o[2]:.4f} in a CUDA graph), this tree's {t[0]:.4f} ({t[1]:.4f}, {t[2]:.4f}); "
            f"{o[2] / t[2]:.2f}x in the graph")
        del rows
    cs.reset_launch_counts()
    return times


def check_instruments(quick: bool, rng, clock_hz: float) -> dict:
    """The instrument kernels of csrc/sketch_parts.cu and the integer-pipe
    probe against their plain versions on the card, bit for bit
    (split_words at every k of KS).
    T2's two passes and T3 are also held to K1 (`survivor_slots`) for every
    k of KS at max_hash for
    scaled=1000 and 2^64-1 on phase 2's rows, whose tandem repeat overflows
    the slots; they are timed at K1's timed shape [4, 2^21 + 30] and held
    to their plain versions there and on the tools' own batch; T4 at the
    tool's blocks [8 * 32 * 520, 128] of random bytes, with the probe
    (`check_int_probe`). The mul-chain must show its rounds' work
    (MULCHAIN_*) and murmur_only's SASS its folded k = 31 body
    (`murmur_sass`), or the phase fails."""
    import torch

    from sourmash_tpu_torch.ops import cuda_sketch as cs
    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp
    from sourmash_tpu_torch.ops.sketch import _pick_slots

    results = {}
    reps = 3 if quick else 20
    thresholds = (max_hash_for(1000), (1 << 64) - 1)
    for k in ((TIMED_K,) if quick else KS):
        rows = torch.from_numpy(dna_rows(4, k, rng, tandem_unit(k, thresholds[0], rng))).cuda()
        words, valid = csp.split_words(rows, ksize=k)
        for name, a, b in zip(("words", "valid"), (words, valid),
                              csp.split_words_plain(rows, ksize=k)):
            exact(f"split_words {name} k={k}", a, b)
        for mh in thresholds:
            slots = _pick_slots(mh)
            want = cs.survivor_slots(rows, mh, ksize=k, slots=slots)
            if int(want[2][0].max()) <= slots:
                raise AssertionError(f"k={k} max_hash={mh}: the tandem repeat did not overflow")
            for what, got in (("split", csp.split_slots(words, valid, mh, ksize=k, slots=slots)),
                              ("v2", csp.survivor_slots_v2(rows, mh, ksize=k, slots=slots))):
                for name, a, b in zip(("hi", "lo", "counts"), got, want):
                    exact(f"{what} {name} k={k} max_hash={mh}", a, b)
        log(f"  k={k:3d}: split_words equals its plain version; split_slots(split_words) and "
            f"survivor_slots_v2 equal K1 at {len(thresholds)} thresholds, with overflowing "
            "segments")
        if k == TIMED_K:
            results.update(time_split_and_v2(rows, words, valid, k, reps, clock_hz))
        del rows, words, valid
        torch.cuda.empty_cache()
    check_tools_batch()
    results.update(check_t4(rng, reps, clock_hz))
    return results


def check_tools_batch():
    """T2's passes and T3 against their plain versions on the batch the
    tools' `check` and `time` run ([8, 2^21 + 30] ACGT rows from seed 0, 4
    slots) at the tools' max_hash and at 2^64-1, where every segment
    overflows."""
    import torch

    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp
    from sourmash_tpu_torch.tools import _common as c

    rows = c.acgt_rows(np.random.default_rng(0), c.BATCH, c.LENGTH, torch.device("cuda"))
    k, slots = c.KSIZE, c.SLOTS
    words, valid = csp.split_words(rows, ksize=k)
    pw, pv = csp.split_words_plain(rows, ksize=k)
    exact("tools' batch: split_words words", words, pw)
    exact("tools' batch: split_words valid", valid, pv)
    for m in (c.MAX_HASH, (1 << 64) - 1):
        for what, got, want in (
                ("split_slots", csp.split_slots(words, valid, m, ksize=k, slots=slots),
                 csp.split_slots_plain(pw, pv, m, ksize=k, slots=slots)),
                ("survivor_slots_v2", csp.survivor_slots_v2(rows, m, ksize=k, slots=slots),
                 csp.survivor_slots_v2_plain(rows, m, ksize=k, slots=slots))):
            for name, a, b in zip(("hi", "lo", "counts"), got, want):
                exact(f"tools' batch: {what} {name} max_hash={m}", a, b)
    log(f"  tools' batch {list(rows.shape)}: split_words, split_slots and survivor_slots_v2 "
        "equal their plain versions at 2 thresholds")
    del rows, words, valid, pw, pv
    torch.cuda.empty_cache()


def time_split_and_v2(rows, words, valid, k: int, reps: int, clock_hz: float) -> dict:
    "T2's passes and T3 against their plain versions at [4, 2^21 + k - 1], timed."
    from sourmash_tpu_torch.ops import cuda_sketch as cs
    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp

    B, S = rows.shape
    n, R, n_pad = cs.geometry(S, k)
    mh = max_hash_for(1000)
    slots = 4
    nw = csp.n_words(k)
    pw, pv = csp.split_words_plain(rows, ksize=k)
    err = max(exact("split_words words", words, pw), exact("split_words valid", valid, pv))
    for m in (mh, (1 << 64) - 1):
        for name, a, b in zip(("hi", "lo", "counts"),
                              csp.split_slots(words, valid, m, ksize=k, slots=slots),
                              csp.split_slots_plain(pw, pv, m, ksize=k, slots=slots)):
            err = max(err, exact(f"split_slots {name} max_hash={m}", a, b))
        for name, a, b in zip(("hi", "lo", "counts"),
                              csp.survivor_slots_v2(rows, m, ksize=k, slots=slots),
                              csp.survivor_slots_v2_plain(rows, m, ksize=k, slots=slots)):
            err = max(err, exact(f"survivor_slots_v2 {name} max_hash={m}", a, b))
    del pw, pv
    gather_ops = B * n_pad * (3 * -(-k // 4) + 2)  # canonical bytes, validity, strand
    word_bytes = B * n_pad * (8 * nw + 1)
    slot_bytes = B * R * (8 * slots + 4)

    def ops(extra):
        def at(before):
            imad, other, either = int_ops_murmur(k, before=before)
            return B * n_pad * imad, B * n_pad * (other + 4) + extra, B * n_pad * either
        return at

    timed = {
        "split_words": (lambda: csp.split_words(rows, ksize=k),
                        lambda: csp.split_words_plain(rows, ksize=k),
                        mul_bounds(B * S + word_bytes, lambda b: (0, gather_ops), clock_hz)),
        "split_slots": (lambda: csp.split_slots(words, valid, mh, ksize=k, slots=slots),
                        lambda: csp.split_slots_plain(words, valid, mh, ksize=k, slots=slots),
                        mul_bounds(word_bytes + slot_bytes, ops(0), clock_hz)),
        "survivor_slots_v2": (
            lambda: csp.survivor_slots_v2(rows, mh, ksize=k, slots=slots),
            lambda: csp.survivor_slots_v2_plain(rows, mh, ksize=k, slots=slots),
            mul_bounds(B * S + slot_bytes, ops(gather_ops), clock_hz)),
    }
    results = {}
    for name, (fn, plain_fn, (bms, by, bo)) in timed.items():
        ms, b2b = kernel_times(fn, reps)
        plain = time_ms(plain_fn, 3, warmup=1)
        results[name] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms, bound_by=by,
                             bound_ms_before=bo, max_abs_err=err, windows=B * n)
        if name == "split_words":
            results[name]["graph_ms"] = graph_ms(fn)
        log(f"    {name}: equals its plain version; {ms:.4f} ms/launch ({b2b:.4f} back to "
            f"back{graph_note(results[name])}), plain {plain:.3f} ms, bound {bms:.4f} ms ({by}; "
            f"{bo:.4f} by the unfolded count), {B * n / ms / 1e6:.2f} Gwindows/s")
    # T3's question, one murmur chain live a thread against K1's four
    # interleaved: each kernel's registers and occupancy
    usage = {"T3": resource_usage("sketch_parts", "survivor_slots_v2_kernel"),
             "K1": resource_usage("sketch", "survivor_slots_kernel")}
    results["survivor_slots_v2"]["resources"] = usage
    for what, per_k in usage.items():
        log(f"    {what} resources: " + ("no cuobjdump" if per_k is None else "; ".join(
            f"{tk} {u['registers']} registers, stack {u['stack']}, local {u['local']}, "
            f"{u['blocks_per_sm']} blocks an SM, occupancy {u['occupancy']:.2f}"
            for tk, u in sorted(per_k.items()))))
    return results


def check_t4(rng, reps: int, clock_hz: float) -> dict:
    """murmur_only, assembly_only, mulchain and the integer-pipe probe against
    their plain versions at the tool's blocks, timed; murmur_only's SASS
    must be its folded k = 31 body, the mul-chain's time must grow with its
    rounds."""
    import torch

    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp

    nblk = 8 * (CHUNK // (T4_ROWS * csp.LANES))
    blocks = torch.from_numpy(rng.integers(0, 256, size=(nblk * (T4_ROWS + csp.EXTRA_ROWS),
                                                         csp.LANES), dtype=np.int32)).cuda()
    n_out = nblk * T4_ROWS * csp.LANES
    k = csp.T4_KSIZE

    def murmur_ops(before):
        # and the fake words' xors (counted before: two a word; at least:
        # the first word's high half is x itself) and the output's hi ^ lo
        imad, other, either = int_ops_murmur(k, before=before)
        return n_out * imad, n_out * (other + 2 * -(-k // 8)), n_out * either

    cases = {
        "murmur_only": (lambda: csp.murmur_only(blocks, rows=T4_ROWS),
                        lambda: csp.murmur_only_plain(blocks, rows=T4_ROWS),
                        mul_bounds(8 * n_out, murmur_ops, clock_hz)),
        "assembly_only": (lambda: csp.assembly_only(blocks, rows=T4_ROWS),
                          lambda: csp.assembly_only_plain(blocks, rows=T4_ROWS),
                          mul_bounds(8 * n_out + 4 * nblk * (k - 1),
                                     lambda b: (0, n_out * (3 * -(-k // 4) + 2 + -(-k // 8))),
                                     clock_hz)),
    }
    for n in (0, 1, 16, 64):
        # a round: v * C1 as IMAD_PER_MUL IMAD slots, rotl64 and the
        # half-swap xor as 4 other ops
        cases[f"mulchain-{n}"] = (
            lambda n=n: csp.mulchain(blocks, n, rows=T4_ROWS),
            lambda n=n: csp.mulchain_plain(blocks, n, rows=T4_ROWS),
            mul_bounds(8 * n_out, lambda b, n=n: (IMAD_PER_MUL * n * n_out, 4 * n * n_out),
                       clock_hz))
    results = {}
    for name, (fn, plain_fn, (bms, by, bo)) in cases.items():
        got = fn()
        err = exact(name, got, plain_fn())
        if name.startswith("mulchain") and not bool((got == (1 if name.endswith("-0") else 0)).all()):
            raise AssertionError(f"{name}: the output is not the JAX function's constant")
        if name == "mulchain-1":
            continue
        ms, b2b = kernel_times(fn, reps)
        plain = time_ms(plain_fn, 3, warmup=1)
        results[name] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms, bound_by=by,
                             bound_ms_before=bo, max_abs_err=err, windows=n_out)
        if name == "assembly_only":
            results[name]["graph_ms"] = graph_ms(fn)
        log(f"    {name}: equals its plain version; {ms:.4f} ms/launch ({b2b:.4f} back to "
            f"back{graph_note(results[name])}), plain {plain:.3f} ms, bound {bms:.4f} ms ({by}; "
            f"{bo:.4f} by the unfolded count), {n_out / ms / 1e6:.2f} Gwindows/s")
    results["murmur_only"]["sass"] = murmur_sass(k)
    results["assembly_only_acgt"] = check_assembly_edges(rng, nblk, reps)
    t0, t16, t64 = (results[f"mulchain-{n}"]["ms"] for n in (0, 16, 64))
    # the rounds' own time grows with their number: net of the same kernel
    # with no rounds (its reads, writes and launch: ~a third of 16 rounds).
    # A folded chain leaves t0, t16 and t64 equal, so the growth alone
    # would divide noise by noise: 16 rounds must first take real time.
    own16 = (t16 - t0) / t0
    growth = (t64 - t0) / (t16 - t0) if t16 > t0 else 0.0
    rounds_per_s = 48 * n_out / ((t64 - t16) / 1e3)  # the slope between 16 and 64
    per_sm_clock = rounds_per_s / (SMS * clock_hz)
    b0, b16, b64 = (results[f"mulchain-{n}"]["b2b_ms"] for n in (0, 16, 64))
    sass = sass_opcodes("sketch_parts", "mulchain_kernel")
    # IMAD-pipe instructions (IMAD and its forms: the multiply's wide low
    # product and high-half terms, moves and adds nvcc puts there) a round
    # of one chain: one IMAD.WIDE.U32 a chain a round
    wide = (sass or {}).get("IMAD.WIDE.U32", 0)
    imad_per_round = (sum(c for op, c in sass.items() if op.startswith("IMAD")) / wide
                      if wide else None)
    # a chain's round in the unrolled loop, by pipe (the probe's models read it)
    per_round = chain_round(sass_lines("sketch_parts", "mulchain_kernel"))
    results["mulchain"] = dict(results["mulchain-16"], growth_64_over_16=growth,
                               own_16_over_0=own16, t64_over_t0=t64 / t0,
                               b2b_own_16_over_0=(b16 - b0) / b0, b2b_t64_over_t0=b64 / b0,
                               rounds_per_s=rounds_per_s, rounds_per_sm_clock=per_sm_clock,
                               imad_pipe_per_round=imad_per_round, per_round=per_round,
                               sass_opcodes=sass)
    log(f"    mulchain: 16 rounds add {own16:.2f}x the 0-round kernel's {t0:.4f} ms "
        f"({(b16 - b0) / b0:.2f}x of {b0:.4f} back to back); 64 rounds take {t64 / t16:.2f}x 16 "
        f"rounds, {growth:.2f}x net of 0 rounds, {t64 / t0:.2f}x 0 rounds ({b64 / b0:.2f}x back "
        f"to back); {rounds_per_s / 1e9:.1f} G rounds/s between 16 and 64, "
        f"{per_sm_clock:.2f} rounds/SM/clock ({IMAD_PER_MUL * per_sm_clock:.1f} IMAD + "
        f"{4 * per_sm_clock:.1f} other/SM/clock at {IMAD_PER_MUL} + 4 a round); "
        f"{imad_per_round if imad_per_round is None else round(imad_per_round, 2)} IMAD-pipe "
        f"instructions a chain's round in its SASS ({per_round} in its unrolled loop); SASS "
        f"opcodes of mulchain_kernel: {sass}")
    if own16 < MULCHAIN_OWN:
        raise AssertionError(f"mulchain: 16 rounds add only {own16:.2f}x the 0-round "
                             "kernel's time; the chain is not being computed")
    if growth < MULCHAIN_GROWTH:
        raise AssertionError(f"mulchain: 64 rounds take only {growth:.2f}x the time of 16 "
                             "net of 0 rounds; the chain is not being computed")
    if sass is not None and wide < MULCHAIN_UNROLL * MULCHAIN_CHAINS:
        raise AssertionError(f"mulchain: {wide} IMAD.WIDE.U32 in its SASS, fewer than its "
                             f"{MULCHAIN_UNROLL} unrolled rounds of {MULCHAIN_CHAINS} chains")
    results["int_probe"] = check_int_probe(blocks, n_out, reps, clock_hz, results["mulchain"])
    del blocks
    torch.cuda.empty_cache()
    return results


# murmur_only's SASS: an IMAD.WIDE.U32 for each 64-bit multiply of each of
# the thread's elements, at least (12 at k = 31); fewer means folded work
MURMUR_WIDE_LEAST = 12


def murmur_sass(k: int) -> dict | None:
    """murmur_only_kernel<k>'s SASS opcodes, and per element by pipe
    beside int_ops_murmur's least (3 IMAD-pipe instructions a 64-bit
    multiply, its ALU-only ops); fails where its body has a loop (the block
    loop of a k read at run time), fewer than MURMUR_WIDE_LEAST
    IMAD.WIDE.U32 an element, or fewer instructions an element on either
    pipe than the least (the count is then not a least). None where there
    is no cuobjdump."""
    lines = sass_lines("sketch_parts", "murmur_only_kernel", f"k={k}")
    if lines is None:
        log("    murmur_only SASS: no cuobjdump")
        return None
    instructions = sass_instructions(lines)
    ops = opcode_counts(instructions)
    per = {pipe: n / MULCHAIN_CHAINS for pipe, n in pipe_counts(ops).items()}
    imad, other, either = int_ops_murmur(k, 3)
    # and the fake words' xors and the output's hi ^ lo, as check_t4 counts them
    least = dict(imad_pipe=imad, other=other + 2 * -(-k // 8), either=either)
    loops = backward_branches(instructions)
    log(f"    murmur_only<{k}> SASS, an element: {per['wide']:.2f} IMAD.WIDE + {per['imad']:.2f} "
        f"other IMAD-pipe, {per['alu']:.2f} other integer ({sum(per.values()):.2f}; "
        f"int_ops_murmur's least {least['imad_pipe']} IMAD-pipe + {least['other']} ALU-only + "
        f"{least['either']} adds on either pipe); {len(instructions)} instructions, "
        f"{len(loops)} loops; opcodes {ops}")
    if loops:
        raise AssertionError(f"murmur_only<{k}>: its SASS has loops {loops}: not the folded body")
    if ops.get("IMAD.WIDE.U32", 0) < MURMUR_WIDE_LEAST * MULCHAIN_CHAINS:
        raise AssertionError(f"murmur_only<{k}>: {ops.get('IMAD.WIDE.U32', 0)} IMAD.WIDE.U32, "
                             f"fewer than {MURMUR_WIDE_LEAST} multiplies x {MULCHAIN_CHAINS} "
                             "elements: work was folded away")
    short = {pipe: (got, want) for pipe, got, want in (
        ("IMAD pipe", per["wide"] + per["imad"], least["imad_pipe"]),
        ("ALU", per["alu"], least["other"])) if got < want}
    if short:
        raise AssertionError(f"murmur_only<{k}>: fewer instructions an element than "
                             f"int_ops_murmur's least {short}: the count is not a least")
    return dict(per_element=per, least=least, opcodes=ops)


# the integer-pipe probe: rounds checked against the plain version, rounds
# timed (the rates from the slope between the last two), and the least
# instructions of each mode's unrolled loop (MULCHAIN_UNROLL rounds of
# MULCHAIN_CHAINS chains) by pipe, below which the compiler folded rounds
PROBE_CHECKED = (0, 1, 16, 64)
PROBE_TIMED = (16, 64, 256)
PROBE_LEAST = {"mul64": dict(wide=1), "mul32": dict(imad=2), "alu": dict(alu=3),
               "mix": dict(wide=1, alu=3)}
PROBE_ENTRY = ("mul64", 16)  # the mode and rounds of the probe's kernels-line entry


def check_int_probe(blocks, n_out: int, reps: int, clock_hz: float, mulchain: dict) -> dict:
    """The integer-pipe probe (`int_probe`) in each mode against its plain
    version at PROBE_CHECKED rounds, bit for bit, then timed back to back at
    PROBE_TIMED rounds. A mode's rounds/SM/clock is the slope between 64
    and 256 rounds (16 rounds of the light modes take less time than the
    kernel's loads and stores, so the slope from 16 to 64, printed beside
    it, reads high or low); its instructions a round are counted by pipe in
    its SASS's unrolled loop. From mul32 the time of an IMAD, from mul64
    (less its IMADs) that of an IMAD.WIDE.U32, from alu that of an ALU
    instruction: each as instructions an SM a clock and as slots of the
    published 64 an SM a clock. The mix (a mul64 round, then an alu round)
    tells whether the two kinds share one budget (its round costs the sum
    of theirs) or run on two pipes side by side (the max); the mul-chain's
    measured round is set beside both models. Fails where a mode's SASS
    lacks PROBE_LEAST's instructions for every round of every chain."""
    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp

    out = dict(modes={})
    for mode in csp.PROBE_MODES:
        for n in PROBE_CHECKED:
            exact(f"int_probe {mode} n={n}", csp.int_probe(blocks, mode, n, rows=T4_ROWS),
                  csp.int_probe_plain(blocks, mode, n, rows=T4_ROWS))
        times = {n: kernel_times(lambda n=n: csp.int_probe(blocks, mode, n, rows=T4_ROWS), reps)
                 for n in PROBE_TIMED}
        b2b = {n: t[1] for n, t in times.items()}
        per_sm_clock = {f"{a}-{b}": n_out * (b - a) / ((b2b[b] - b2b[a]) / 1e3) / (SMS * clock_hz)
                        if b2b[b] > b2b[a] else 0.0
                        for a, b in zip(PROBE_TIMED, PROBE_TIMED[1:])}
        loop = chain_round(probe_sass(mode))
        out["modes"][mode] = dict(ms={n: t[0] for n, t in times.items()}, b2b_ms=b2b,
                                  rounds_per_sm_clock=per_sm_clock, per_round=loop)
        log(f"    int_probe {mode}: equals its plain version at {PROBE_CHECKED} rounds; back to "
            f"back {', '.join(f'{n} rounds {t:.4f} ms' for n, t in b2b.items())}; rounds/SM/clock "
            + ", ".join(f"{k} {v:.2f}" for k, v in per_sm_clock.items())
            + f"; a round in its SASS loop: {loop}")
        if loop is not None:
            short = {p: (loop[p], least) for p, least in PROBE_LEAST[mode].items()
                     if loop[p] < least}
            if short:
                raise AssertionError(f"int_probe {mode}: its SASS loop has fewer instructions a "
                                     f"round than it computes {short}: rounds were folded")
    out.update(probe_model(out["modes"], mulchain))
    mode, n = PROBE_ENTRY
    fn = lambda: csp.int_probe(blocks, mode, n, rows=T4_ROWS)  # noqa: E731
    bms, by, bold = mul_bounds(8 * n_out, lambda b: (IMAD_PER_MUL * n * n_out, 0), clock_hz)
    out.update(ms=out["modes"][mode]["ms"][n], b2b_ms=out["modes"][mode]["b2b_ms"][n],
               plain_ms=time_ms(lambda: csp.int_probe_plain(blocks, mode, n, rows=T4_ROWS), 3,
                                warmup=1),
               bound_ms=bms, bound_by=by, bound_ms_before=bold, max_abs_err=0.0,
               windows=n_out, entry=f"{mode}-{n}")
    return out


def probe_sass(mode: str):
    "The SASS lines of the probe's kernel in `mode`; None where there is no cuobjdump."
    from sourmash_tpu_torch.ops import _build
    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp

    functions = sass_functions(_build._so_path("sketch_parts"))
    if functions is None:
        return None
    wanted = f"ILi{csp.PROBE_MODES.index(mode)}E"  # the mangled template argument
    for name, lines in functions.items():
        if "16int_probe_kernel" in name and wanted in name:
            return lines
    raise AssertionError(f"int_probe {mode}: no int_probe_kernel<{mode}> in the library's SASS")


def probe_model(modes: dict, mulchain: dict) -> dict:
    """What the probe's modes say of the integer pipes. Each pure mode's
    round is read as the time of the pipe its own instructions load: an
    IMAD from mul32, an IMAD.WIDE.U32 from mul64 less its IMADs, an ALU
    instruction from alu (SM clocks a thread's instruction), given as rates
    an SM a clock and as slots of the published LANES_PER_PIPE; a 64-bit
    multiply is mul64's IMAD.WIDE.U32 and two IMADs. The mix's round (and
    the mul-chain's) is then set beside the two models, from its own SASS
    loop (nvcc does not compile it into mul64's and alu's instructions):
    two pipes side by side (the larger pipe's time) and one budget (the
    sum); the nearer names the verdict. Each mode's integer instructions
    an SM a clock are printed too: above LANES_PER_PIPE, one budget of the
    published rate cannot hold them."""
    rate = {m: r["rounds_per_sm_clock"]["64-256"] for m, r in modes.items()}
    if any(r["per_round"] is None for r in modes.values()) or not all(rate.values()):
        log("    int_probe: no SASS counts or no slope; the pipe rates are not read")
        return {}
    t = {m: 1.0 / r for m, r in rate.items()}  # SM clocks a round of one chain
    n = {m: r["per_round"] for m, r in modes.items()}
    c_imad = t["mul32"] / n["mul32"]["imad"]
    c_wide = (t["mul64"] - n["mul64"]["imad"] * c_imad) / n["mul64"]["wide"]
    c_alu = t["alu"] / n["alu"]["alu"]
    cost = dict(wide=c_wide, imad=c_imad, alu=c_alu)

    def models(per_round):  # (two pipes, one budget) SM clocks of a round
        imad_pipe = per_round["wide"] * c_wide + per_round["imad"] * c_imad
        return max(imad_pipe, per_round["alu"] * c_alu), imad_pipe + per_round["alu"] * c_alu

    pipes, budget = models(n["mix"])
    verdict = "two pipes" if abs(t["mix"] - pipes) <= abs(t["mix"] - budget) else "one budget"
    per_sm_clock = {p: 1.0 / c for p, c in cost.items()}
    slots = {p: LANES_PER_PIPE * c for p, c in cost.items()}
    mul_slots = slots["wide"] + 2 * slots["imad"]
    issued = {m: sum(n[m].values()) * rate[m] for m in modes}
    log(f"    int_probe: IMAD.WIDE.U32 {per_sm_clock['wide']:.2f}, IMAD {per_sm_clock['imad']:.2f}, "
        f"ALU {per_sm_clock['alu']:.2f} instructions an SM a clock "
        f"({slots['wide']:.2f}, {slots['imad']:.2f}, {slots['alu']:.2f} slots of "
        f"{LANES_PER_PIPE}); a 64-bit multiply (an IMAD.WIDE.U32 and two IMADs) "
        f"{mul_slots:.2f} slots (IMAD_PER_MUL {IMAD_PER_MUL}); integer instructions an SM a "
        "clock by mode " + ", ".join(f"{m} {v:.1f}" for m, v in issued.items()))
    log(f"    int_probe: the mix's round {t['mix']:.4f} SM clocks ({n['mix']} a round) against "
        f"{pipes:.4f} from two pipes and {budget:.4f} from one budget: {verdict} (mul64's + "
        f"alu's rounds {t['mul64'] + t['alu']:.4f}, their max {max(t['mul64'], t['alu']):.4f}; "
        f"the model: two pipes)")
    if verdict != "two pipes":
        log("    int_probe: the probe disagrees with the model's two pipes side by side")
    out = dict(per_sm_clock=per_sm_clock, slots=slots, mul_slots=mul_slots, verdict=verdict,
               issued_per_sm_clock=issued, mix_round=t["mix"], mix_two_pipes=pipes,
               mix_one_budget=budget, mul64_plus_alu=t["mul64"] + t["alu"])
    mc = mulchain.get("per_round")
    if mc and mulchain.get("rounds_per_sm_clock"):
        mc_pipes, mc_budget = models(mc)
        out.update(mulchain_round=1.0 / mulchain["rounds_per_sm_clock"],
                   mulchain_two_pipes=mc_pipes, mulchain_one_budget=mc_budget)
        log(f"    int_probe: mulchain's round {out['mulchain_round']:.4f} SM clocks ({mc} a "
            f"round) against {mc_pipes:.4f} from two pipes and {mc_budget:.4f} from one budget")
    return out


def graph_note(r: dict) -> str:
    return f"; {r['graph_ms']:.4f} in a CUDA graph" if "graph_ms" in r else ""


T4_KINDS = ("random bytes", "ACGT", "ACGT with N runs and palindromes")


def complement_bytes(c: np.ndarray) -> np.ndarray:
    "The kernels' complement of any bytes: c ^ 4 when bit 1 of c is set, else c ^ 21."
    return c ^ np.where(c & 2, 4, 21).astype(c.dtype)


def t4_blocks(kind: str, rows: int, nblk: int, rng) -> np.ndarray:
    """[nblk * (rows + 8), 128] int32 blocks of T4's layout, of one kind:
    random bytes 0..255 (the tool's input); ACGT; or ACGT with N runs of 1
    to k + 2 bases across every 128- and 1,024-window boundary of each
    block and palindromes under the kernels' complement, 30, 31 (a k-mer
    Q x comp(Q) reversed, equal to its reverse complement but for x) and
    32 long, of ACGT and of random bytes."""
    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp

    V, k = (rows + csp.EXTRA_ROWS) * csp.LANES, csp.T4_KSIZE
    if kind == "random bytes":
        return rng.integers(0, 256, size=(nblk * V // csp.LANES, csp.LANES), dtype=np.int32)
    seq = ACGT[rng.integers(0, 4, size=(nblk, V))].astype(np.int32)
    if kind != "ACGT":
        blk = np.arange(nblk)[:, None, None]
        at = np.arange(SEGMENT, rows * csp.LANES, SEGMENT)  # the 1,024s among them
        length = rng.integers(1, k + 3, size=(nblk, at.size))
        start = at - rng.integers(0, length + k)
        off = np.arange(k + 2)
        pos = start[..., None] + off
        hit = (off < length[..., None]) & (pos >= 0)
        seq[np.broadcast_to(blk, pos.shape)[hit], pos[hit]] = ord("N")
        for plen in (30, 31, 32):
            start = rng.integers(0, V - plen, size=(nblk, V // 400))
            alphabet = np.where(rng.random((nblk, V // 400, 1)) < 0.5, 256, 4)
            draw = rng.integers(0, 256, size=(nblk, V // 400, plen // 2 + plen % 2))
            draw = np.where(alphabet == 4, ACGT[draw % 4], draw).astype(np.int32)
            half, mid = draw[..., : plen // 2], draw[..., plen // 2 :]
            pal = np.concatenate([half, mid, complement_bytes(half)[..., ::-1]], axis=-1)
            seq[blk, start[..., None] + np.arange(plen)] = pal
    return seq.reshape(-1, csp.LANES)


def check_assembly_edges(rng, nblk: int, reps: int) -> dict:
    """assembly_only against its plain version, bit for bit, on T4_KINDS
    blocks at the tool's rows and at rows = 9 (a block ends mid-tile); timed
    on the ACGT blocks at the tool's shape, the assembly K1 runs on its
    path. Returns that timing."""
    import torch

    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp

    timed = None
    for kind in T4_KINDS:
        for rows, nb in ((T4_ROWS, nblk), (9, 64)):
            blocks = torch.from_numpy(t4_blocks(kind, rows, nb, rng)).cuda()
            exact(f"assembly_only {kind} rows={rows}", csp.assembly_only(blocks, rows=rows),
                  csp.assembly_only_plain(blocks, rows=rows))
            if kind == "ACGT" and rows == T4_ROWS:
                fn = lambda blocks=blocks: csp.assembly_only(blocks, rows=T4_ROWS)  # noqa: E731
                ms, b2b = kernel_times(fn, reps)
                timed = dict(ms=ms, b2b_ms=b2b, graph_ms=graph_ms(fn),
                             windows=nblk * T4_ROWS * csp.LANES)
            del blocks
        log(f"    assembly_only on {kind}: equals its plain version at rows {T4_ROWS} and 9")
    log(f"    assembly_only on ACGT: {timed['ms']:.4f} ms/launch ({timed['b2b_ms']:.4f} back to "
        f"back{graph_note(timed)})")
    return timed


def instruments_path() -> dict:
    """The instruments as a user runs them (each tool's main(), the modes of
    its `python -m` line), the launch counters set to 0 just before and read
    just after; every instrument kernel must have been launched."""
    from sourmash_tpu_torch.ops import cuda_sketch_parts as csp
    from sourmash_tpu_torch.tools import (
        exp_split_kernel, exp_v2_kernel, profile_sketch_chain, profile_sketch_parts)

    runs = ((exp_split_kernel, ["check"]), (exp_split_kernel, ["time"]),
            (exp_v2_kernel, ["check"]), (exp_v2_kernel, ["time"]),
            (profile_sketch_parts, ["murmur", "assembly", "mul16",
                                    "probe-{}-{}".format(*PROBE_ENTRY)]),
            (profile_sketch_chain, ["full", "kernel", "gatheronly"]))
    csp.reset_launch_counts()
    for tool, argv in runs:
        log(f"  python -m {tool.__name__} {' '.join(argv)}")
        if tool.main(argv) != 0:
            raise AssertionError(f"{tool.__name__} {argv} failed")
    launches = dict(csp.LAUNCHES)
    missing = [name for name, count in launches.items() if count < 1]
    if missing:
        raise AssertionError(f"instruments: {missing} not launched: {launches}")
    log(f"  launches {launches}")
    return launches


def make_collection(rng, n: int, ksize: int = 31, abundances: bool = False):
    """n sketches at `ksize`, scaled=1000 in clades of 1-20 genomes: each
    member holds 2,000-6,000 hashes, 50-95 % of them from the clade's core;
    with `abundances`, abundances 1-50 (`abunds_array()` of each sketch)."""
    from sourmash_tpu_torch import signature_from_arrays

    mh = max_hash_for(GATHER_SCALED)
    params = dict(ksize=ksize, moltype="DNA", num=0, scaled=GATHER_SCALED, seed=42,
                  track_abundance=abundances)
    sigs, mins_list, clade = [], [], 0
    while len(sigs) < n:
        core = random_sketch(rng, 6000, mh)
        for _ in range(int(rng.integers(1, 21))):
            size = int(rng.integers(2000, 6001))
            kept = core[: int(size * rng.uniform(0.5, 0.95))]
            kept = rng.permutation(kept)
            m = np.unique(np.r_[kept, random_sketch(rng, size - len(kept), mh)])
            ab = rng.integers(1, 51, size=len(m)) if abundances else None
            mins_list.append(m)
            sigs.append(signature_from_arrays(params, m, ab,
                                              name=f"genome_{len(sigs)} clade_{clade}",
                                              filename=f"genome_{len(sigs)}.fa.gz"))
            if len(sigs) == n:
                break
        clade += 1
        core = None
    return sigs, mins_list, clade


def make_gather_query(rng, mins_list, target: int):
    """A metagenome sketch of ~target hashes: 40-100 % of randomly chosen
    collection genomes until they make 70 % of it, then 30 % fresh hashes;
    abundances 1-50. Returns (mins, abunds, genomes used)."""
    mh = max_hash_for(GATHER_SCALED)
    parts, seen = [], set()  # the distinct hashes so far, counted as they come
    used = 0
    for i in rng.permutation(len(mins_list)):
        m = mins_list[i]
        parts.append(m[rng.random(len(m)) < rng.uniform(0.4, 1.0)])
        seen.update(parts[-1].tolist())
        used += 1
        if len(seen) >= 0.7 * target:
            break
    q = np.unique(np.concatenate(parts + [random_sketch(rng, int(0.3 * target), mh)]))
    return q, rng.integers(1, 51, size=len(q)).astype(np.int64), used


def collection_index(mins_list) -> tuple:
    """(every hash of the collection sorted, the sketch holding each): the
    numpy oracles' lookup, built once per collection."""
    lens = np.fromiter((len(m) for m in mins_list), dtype=np.int64)
    allv = np.concatenate(mins_list)
    order = np.argsort(allv, kind="stable")
    return allv[order], np.repeat(np.arange(len(mins_list)), lens)[order]


def holders(q, index) -> tuple:
    """(position in q, sketch) of every pair of a query hash and a sketch
    holding it, by position then sketch, from collection_index's lookup."""
    vals, owners = index
    lo = np.searchsorted(vals, q, "left")
    n = np.searchsorted(vals, q, "right") - lo
    first = np.cumsum(n) - n
    at = np.repeat(lo - first, n) + np.arange(int(n.sum()))
    return np.repeat(np.arange(len(q)), n), owners[at]


def overlap_counts(q: np.ndarray, mins_list, index) -> np.ndarray:
    "|q ∩ m| for every sketch m of the collection."
    return np.bincount(holders(q, index)[1], minlength=len(mins_list))


def oracle_gather(q, abunds, mins_list, threshold_hashes: int, index=None):
    """An independent greedy gather in numpy: a CSR from query hash to the
    sketches holding it (binary searches into the sorted collection,
    `collection_index`, built here unless given) gives the initial counts;
    then per round the argmax (lowest id on ties), the removal of its
    hashes and a bincount decrement. Returns rows of (index, intersect_bp,
    unique_intersect_bp, f_unique_weighted)."""
    pos, cands = holders(q, collection_index(mins_list) if index is None else index)
    counts0 = np.bincount(cands, minlength=len(mins_list))
    cand = np.flatnonzero(counts0 >= max(threshold_hashes, 1))
    keep = counts0[cands] >= max(threshold_hashes, 1)
    pos, cands = pos[keep], cands[keep]
    starts = np.searchsorted(pos, np.arange(len(q) + 1))
    counts = np.zeros(len(mins_list), dtype=np.int64)
    counts[cand] = counts0[cand]
    alive = np.ones(len(q), dtype=bool)
    total = int(abunds.sum())
    rows = []
    while True:
        best = int(np.argmax(counts))
        if counts[best] < max(threshold_hashes, 1):
            break
        m = mins_list[best]
        p = np.searchsorted(q, m)
        inside = p < len(q)
        p = p[inside][q[p[inside]] == m[inside]]
        p = p[alive[p]]
        rows.append((best, int(counts0[best]) * GATHER_SCALED, len(p) * GATHER_SCALED,
                     int(abunds[p].sum()) / total))
        alive[p] = False
        held = np.concatenate([cands[starts[i] : starts[i + 1]] for i in p]) if len(p) else []
        counts -= np.bincount(np.asarray(held, dtype=np.int64), minlength=len(counts))
    return rows


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    "obj.name replaced by wrap(the original) inside the block."
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def call_counted(fn, env: dict) -> tuple:
    """fn() with every launch counter set to 0 just before and read just
    after, under `env` (set for the call only): (its result, wall,
    launches)."""
    import torch

    from sourmash_tpu_torch.ops import cuda_gather as cg
    from sourmash_tpu_torch.ops import cuda_pairwise as cp
    from sourmash_tpu_torch.ops import cuda_sketch as cs

    before = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        torch.cuda.synchronize()
        for module in (cs, cg, cp):
            module.reset_launch_counts()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {**cg.LAUNCHES, **cp.LAUNCHES, **cs.LAUNCHES}
    finally:
        for key, val in before.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    return out, wall, launches


def run_counted(argv: list, env: dict) -> tuple:
    """One port command through `__main__.main`, with every launch counter
    set to 0 just before and read just after, under `env` (set for the run
    only): (wall, launches)."""
    from sourmash_tpu_torch.__main__ import main as cli_main

    rc, wall, launches = call_counted(lambda: cli_main(argv), env)
    if rc not in (None, 0):
        raise AssertionError(f"{argv[0]} returned {rc}")
    return wall, launches


def run_gather_cli(argv: list, env: dict) -> tuple:
    """One `gather` run with every launch counter set to 0 just before and
    read just after, under `env`: (wall, launches, schedule facts)."""
    from sourmash_tpu_torch.index import flat

    seen = {}

    def spy(schedule):  # records what the command scheduled
        def spied(counters):
            coord = schedule(counters)
            seen.update(coord=coord, k=sum(
                int(np.count_nonzero(c.counts)) if hasattr(c, "counts") else len(c.counter)
                for c in counters))
            return coord
        return spied

    with patched(flat, "schedule_device_gather", spy):
        wall, launches = run_counted(argv, env)
    coord = seen.get("coord")
    facts = dict(k=seen.get("k"), scheduled=coord is not None,
                 route=getattr(coord, "route", None) or "host rounds",
                 reschedules=getattr(coord, "reschedules", 0))
    return wall, launches, facts


def compare_membership_routes(rng, db: str, mins_list) -> list:
    """On one loaded collection and each query size of GATHER_ROUTE_QUERIES
    (either side of the device-membership threshold): time the schedule's
    build and scan with host bitsets from the native sorted join
    (SOURMASH_TORCH_DEV_MEMBERSHIP=0) against `membership_bits` on the
    resident planes (=1), alternating, ROUTE_REPS each; both must give the
    same rounds. Split each route's membership build into its parts. Then,
    in host rounds, time one consume by host sorted joins (taken at <= 256
    live candidates) against the membership groups and `round_dec`; both
    must leave the same counts."""
    from sourmash_tpu_torch.save_load import load_file_as_index

    t0 = time.time()
    view = load_file_as_index(db)._as_flat_view()
    log(f"  collection loaded again for the route comparison in {time.time() - t0:.1f} s")
    out = [compare_routes_at(rng, view, mins_list, n) for n in GATHER_ROUTE_QUERIES]
    log(f"  the route comparison took {time.time() - t0:.1f} s")
    return out


def compare_routes_at(rng, view, mins_list, target: int) -> dict:
    "compare_membership_routes for one query of ~target hashes."
    import torch

    from sourmash_tpu_torch import minhash_from_arrays, SourmashSignature
    from sourmash_tpu_torch.index import flat
    from sourmash_tpu_torch.ops.bucketed import to_torch

    q, _ab, used = make_gather_query(rng, mins_list, target)
    params = dict(ksize=31, moltype="DNA", num=0, scaled=GATHER_SCALED, seed=42,
                  track_abundance=False)
    qsig = SourmashSignature(minhash_from_arrays(params, q), name="small")
    th = GATHER_THRESHOLD_BP

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    key = flat.DEV_MEMBERSHIP_ENV
    before = os.environ.pop(key, None)
    try:
        probe = view.counter_gather(qsig, th)
        k = int(np.count_nonzero(probe.counts))
        W = -(-len(probe._q_mins) // 32)
        picks_device = probe._device_membership_worthwhile(th)
        ms = {"0": [], "1": []}
        routes, scheds = {}, {}
        for _ in range(ROUTE_REPS):
            for force in ("0", "1"):
                os.environ[key] = force
                coord = flat.schedule_device_gather([view.counter_gather(qsig, th)])
                t, _ = timed(lambda: coord.compute(th))
                ms[force].append(t)
                routes[force] = coord.route
                if scheds.setdefault(force, coord._sched) != coord._sched:
                    raise AssertionError(f"route {coord.route}: schedules differ between runs")
        os.environ.pop(key)
        # the membership build alone, in parts, each on a fresh counter
        ids = np.nonzero(probe.counts)[0]
        lut_b = view._row_lookup()[0]
        Bs = sorted({view._banks[b].B for b in set(lut_b[ids].tolist())})
        parts = {"host join + upload": [], "device query packs": [], "device patches": [],
                 "device membership_bits": []}
        for _ in range(ROUTE_REPS):
            c = view.counter_gather(qsig, th)
            parts["host join + upload"].append(
                timed(lambda: to_torch(c._bitsets_compute(W, ids), c.device))[0])
            c = view.counter_gather(qsig, th)
            parts["device query packs"].append(timed(lambda: [c._qpack_for_B(B, W) for B in Bs])[0])
            parts["device patches"].append(timed(lambda: c._membership_patches(W))[0])
            parts["device membership_bits"].append(timed(lambda: c._membership_rows_device(ids, W))[0])
        if routes != {"0": "host membership", "1": "device membership"}:
            raise AssertionError(f"membership routes: {routes}")
        if scheds["0"] != scheds["1"] or not scheds["0"]:
            raise AssertionError("host and device membership scheduled different rounds")
        joins, groups, build = [], [], []
        for _ in range(ROUTE_REPS):
            a = view.counter_gather(qsig, th)
            b = view.counter_gather(qsig, th)
            inter = a.peek(qsig.minhash, threshold_bp=th)[1]
            joins.append(timed(lambda: a.consume(inter))[0])
            build.append(timed(b._get_groups)[0])
            groups.append(timed(lambda: b.consume(inter))[0])
            if not np.array_equal(a.counts, b.counts):
                raise AssertionError("host-join and round_dec consumes left different counts")
    finally:
        os.environ.pop(key, None)
        if before is not None:
            os.environ[key] = before
    med = statistics.median
    out = dict(query_hashes=len(q), genomes=used, k=k, W=W, kW_bytes=k * W * 4,
               threshold_picks="device membership" if picks_device else "host membership",
               rounds=len(scheds["0"]),
               schedule_host_ms=med(ms["0"]), schedule_device_ms=med(ms["1"]),
               schedule_ms=ms, build_ms={n: med(v) for n, v in parts.items()},
               consume_branch="host joins" if k <= 256 else "groups",
               consume_first_ms=med(joins), consume_groups_ms=med(groups),
               groups_build_ms=med(build))
    log(f"  query {len(q)} hashes from {used} genomes: k={k}, W={W}, k*W*4 = {k * W * 4} "
        f"bytes (threshold picks {out['threshold_picks']}), {out['rounds']} rounds")
    log(f"    schedule build + scan, median of {ROUTE_REPS}: host membership "
        f"{out['schedule_host_ms']:.2f} ms, device membership {out['schedule_device_ms']:.2f} ms; "
        f"same rounds")
    log("    membership build alone: " + ", ".join(
        f"{n} {v:.2f} ms" for n, v in out["build_ms"].items()))
    log(f"    host-round consume, median of {ROUTE_REPS}: as taken ({out['consume_branch']}) "
        f"{out['consume_first_ms']:.2f} ms, membership groups + round_dec "
        f"{out['consume_groups_ms']:.2f} ms after a {out['groups_build_ms']:.2f} ms group build; "
        f"same counts")
    return out


def read_csv(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def gather_end_to_end(rng, tmp: str, profile_cli: bool = False) -> dict:
    from sourmash_tpu_torch import minhash_from_arrays, SourmashSignature
    from sourmash_tpu_torch.__main__ import main as cli_main
    from sourmash_tpu_torch.index import view_cache
    from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

    t0 = time.time()
    sigs, mins_list, clades = make_collection(rng, GATHER_GENOMES)
    n_hashes = sum(len(m) for m in mins_list)
    log(f"  made {len(sigs)} sketches in {clades} clades, {n_hashes} hashes, "
        f"in {time.time() - t0:.1f} s")
    db = os.path.join(tmp, "gtdb-like.zip")
    t0 = time.time()
    with SaveSignaturesToLocation(db) as save:
        for ss in sigs:
            save.add(ss)
    save_s = time.time() - t0
    log(f"  wrote {db} with the port's zip saver in {save_s:.1f} s "
        f"({os.path.getsize(db) / 2**20:.1f} MiB)")

    q, abunds, used = make_gather_query(rng, mins_list, GATHER_QUERY_HASHES)
    params = dict(ksize=31, moltype="DNA", num=0, scaled=GATHER_SCALED, seed=42,
                  track_abundance=True)
    qsig = SourmashSignature(minhash_from_arrays(params, q, abunds), name="metagenome")
    qpath = os.path.join(tmp, "metagenome.sig")
    with SaveSignaturesToLocation(qpath) as save:
        save.add(qsig)
    log(f"  query: {len(q)} hashes from {used} genomes + 30 % fresh, abundances 1-50")

    t0 = time.time()
    index = collection_index(mins_list)
    want = oracle_gather(q, abunds, mins_list, int(GATHER_THRESHOLD_BP // GATHER_SCALED), index)
    log(f"  numpy oracle: {len(want)} rounds in {time.time() - t0:.1f} s")

    runs = {}
    for tag, env in (("scheduled", {}), ("host rounds", {"SOURMASH_TORCH_NO_SCHEDULE": "1"})):
        out = os.path.join(tmp, f"{tag.replace(' ', '_')}.csv")
        argv = ["gather", qpath, db, "-o", out, "-q",
                "--save-matches", os.path.join(tmp, f"{tag.replace(' ', '_')}.zip")]
        cache_before = dict(view_cache.STATS)
        wall, launches, facts = run_gather_cli(argv, env)
        cache = {n: view_cache.STATS[n] - cache_before[n] for n in ("hits", "misses")}
        runs[tag] = dict(wall_s=wall, launches=launches, csv=out, view_cache=cache, **facts)
        log(f"  gather ({tag}): {wall:.2f} s wall, {len(read_csv(out))} rounds, k={facts['k']}, "
            f"route {facts['route']}, reschedules {facts['reschedules']}, launches "
            f"{ {n: launches[n] for n in ('counts_rows', 'membership_bits', 'round_dec')} }")
    first = runs["scheduled"]
    # the view cache is empty before phase 6: its first load reads the zip
    # (a miss that stores the entry), the second loads the entry
    if first["view_cache"] != dict(hits=0, misses=1) or \
            runs["host rounds"]["view_cache"] != dict(hits=1, misses=0):
        raise AssertionError(f"view cache: {[r['view_cache'] for r in runs.values()]}, want a "
                             f"cold first load and a warm second")
    view_cache_line("phase 6's two gathers (cold, then warm)")
    if first["route"] != "device membership" or not first["scheduled"]:
        raise AssertionError(f"the scheduled run took {first['route']}, not device membership")
    for name in ("counts_rows", "membership_bits", "round_dec"):
        if first["launches"][name] < 1:
            raise AssertionError(f"gather: {name} was not launched: {first['launches']}")
    with open(first["csv"], "rb") as a, open(runs["host rounds"]["csv"], "rb") as b:
        if a.read() != b.read():
            raise AssertionError("scheduled and host-round gathers wrote different CSVs")

    got = read_csv(first["csv"])
    names = [ss.name for ss in sigs]
    check_gather_rows("gather", got, want, names)
    log(f"  all {len(got)} rows equal the numpy oracle (order, intersect_bp, "
        f"unique_intersect_bp, f_unique_weighted) and the host-round run")

    routes = compare_membership_routes(rng, db, mins_list)

    profile = None
    if profile_cli:
        argv = ["gather", qpath, db, "-o", os.path.join(tmp, "profiled.csv"), "-q"]
        profile = profiled(lambda: cli_main(argv), "gather")
    world = dict(db=db, mins_list=mins_list, names=names, qpath=qpath, q=q, index=index,
                 sigs=sigs, csv=first["csv"])
    return dict(genomes=len(sigs), hashes=n_hashes, query_hashes=len(q), zip_save_s=save_s,
                rounds=len(got), runs={t: {k: v for k, v in r.items() if k != "csv"}
                                       for t, r in runs.items()},
                routes=routes, profile=profile), world


def check_gather_rows(what: str, got: list, want: list, names: list):
    "CSV rows of a gather against oracle_gather's: order, bp and weighted fractions."
    if len(got) != len(want):
        raise AssertionError(f"{what} found {len(got)} matches, the oracle {len(want)}")
    for row, (i, ibp, uibp, fuw) in zip(got, want):
        seen = (row["name"], int(float(row["intersect_bp"])), int(float(row["unique_intersect_bp"])),
                float(row["f_unique_weighted"]))
        if seen != (names[i], ibp, uibp, fuw):
            raise AssertionError(f"{what} row {row['gather_result_rank']}: {seen} vs oracle "
                                 f"{(names[i], ibp, uibp, fuw)}")


# -- phase 8: search, prefetch and multigather end to end -------------------


def save_sig(path: str, mins, name: str, abunds=None):
    from sourmash_tpu_torch import signature_from_arrays
    from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

    params = dict(ksize=31, moltype="DNA", num=0, scaled=GATHER_SCALED, seed=42,
                  track_abundance=abunds is not None)
    with SaveSignaturesToLocation(path) as save:
        save.add(signature_from_arrays(params, mins, abunds, name=name,
                                       filename=os.path.basename(path).replace(".sig", ".fa.gz")))


def search_end_to_end(tmp: str, world: dict) -> dict:
    """`search` of one genome of a clade of >= 5 against phase 6's zip, by
    Jaccard and by containment: the cutoff form of counts_rows must run,
    and the rows must be exactly the genomes whose numpy score (from
    np.isin overlaps) passes search's 0.08 threshold, with those scores."""
    from sourmash_tpu_torch.ops import cuda_gather as cg

    mins_list, names = world["mins_list"], world["names"]
    clade = np.array([int(n.rsplit("clade_", 1)[1]) for n in names])
    gi = int(np.flatnonzero(np.bincount(clade)[clade] >= 5)[0])
    g = mins_list[gi]
    qpath = os.path.join(tmp, "genome.sig")
    save_sig(qpath, g, "query genome")
    inter = overlap_counts(g, mins_list, world["index"])
    lens = np.fromiter((len(m) for m in mins_list), dtype=np.int64)
    out = {}
    for tag, flags, denom in (("jaccard", [], lambda i: len(g) + int(lens[i]) - int(inter[i])),
                              ("containment", ["--containment"], lambda i: len(g))):
        csv_path = os.path.join(tmp, f"search_{tag}.csv")
        cut_calls = []

        def spy(counts_rows):
            def spied(*a, **kw):
                cut_calls.append(len(a) > 4 and a[4] is not None)
                return counts_rows(*a, **kw)
            return spied

        with patched(cg, "counts_rows", spy):
            wall, launches = run_counted(["search", qpath, world["db"], "-o", csv_path, "-q",
                                          *flags], {})
        want = {names[i]: int(inter[i]) / denom(i) for i in np.flatnonzero(inter)}
        want = {n: v for n, v in want.items() if v >= 0.08}
        got = {row["name"]: float(row["similarity"]) for row in read_csv(csv_path)}
        if got != want:
            raise AssertionError(f"search ({tag}): {len(got)} rows, numpy {len(want)}; "
                                 f"differ at {sorted(set(got.items()) ^ set(want.items()))[:4]}")
        if not any(cut_calls) or launches["counts_rows"] < 1:
            raise AssertionError(f"search ({tag}): counts_rows with cuts did not run")
        out[tag] = dict(wall_s=wall, rows=len(got), launches=launches["counts_rows"])
        log(f"  search ({tag}) of genome {gi} (clade of {int(np.sum(clade == clade[gi]))}): "
            f"{wall:.2f} s wall, {len(got)} rows equal numpy's scores; counts_rows with cuts "
            f"{launches['counts_rows']} launches")
    return out


def prefetch_end_to_end(tmp: str, world: dict) -> dict:
    """`prefetch` of phase 6's metagenome against its zip with both hash
    outputs: every genome with >= 50 shared hashes (50 kbp) and only those,
    each row's intersect_bp numpy's, and the matched and unmatched hashes
    an np.isin split of the query over those genomes."""
    from sourmash_tpu_torch.sourmash_args import load_one_signature

    mins_list, names, q = world["mins_list"], world["names"], world["q"]
    paths = {n: os.path.join(tmp, f"prefetch.{n}") for n in ("csv", "known.sig", "unknown.sig")}
    wall, launches = run_counted(
        ["prefetch", world["qpath"], world["db"], "-o", paths["csv"], "-q",
         "--save-matching-hashes", paths["known.sig"],
         "--save-unmatched-hashes", paths["unknown.sig"]], {})
    inter = overlap_counts(q, mins_list, world["index"])
    hits = np.flatnonzero(inter * GATHER_SCALED >= GATHER_THRESHOLD_BP)
    want = {names[i]: int(inter[i]) * GATHER_SCALED for i in hits}
    got = {row["match_name"]: int(float(row["intersect_bp"])) for row in read_csv(paths["csv"])}
    if got != want:
        raise AssertionError(f"prefetch: {len(got)} rows, numpy {len(want)}")
    known = np.isin(q, np.concatenate([mins_list[i] for i in hits]))
    for name, part in (("known.sig", q[known]), ("unknown.sig", q[~known])):
        saved = load_one_signature(paths[name]).minhash.mins_array()
        if not np.array_equal(saved, part):
            raise AssertionError(f"prefetch: {name} holds {len(saved)} hashes, numpy {len(part)}")
    log(f"  prefetch: {wall:.2f} s wall, {len(got)} rows equal numpy's overlaps; "
        f"{int(known.sum())} matched and {int((~known).sum())} unmatched hashes equal the "
        f"np.isin split; counts_rows {launches['counts_rows']} launches")
    return dict(wall_s=wall, rows=len(got), known=int(known.sum()), launches=launches)


def run_multigather(tag: str, paths: list, out_dir: str, db: str, env: dict) -> dict:
    """One `multigather --output-dir` run with its launches, wall, warm-cache
    hits, bank residency and the routes and reschedules of its schedules."""
    from sourmash_tpu_torch.index import flat

    views, coords = [], []

    def warm_spy(warm):
        def spied(self, *a, **kw):
            views.append(self)
            return warm(self, *a, **kw)
        return spied

    def converge_spy(converge):
        def spied(cs, *a, **kw):
            coords.extend(c for c in cs if c is not None)
            return converge(cs, *a, **kw)
        return spied

    os.makedirs(out_dir)
    with patched(flat.FlatIndex, "warm_gather_counts", warm_spy), \
            patched(flat, "converge_schedules_batch", converge_spy):
        wall, launches = run_counted(
            ["multigather", "--query", *paths, "--db", db, "--output-dir", out_dir, "-q"], env)
    view = views[0]
    run = dict(wall_s=wall, launches={n: launches[n] for n in MULTI_KERNELS},
               cache_hits=view.counts_cache_hits, resident=all(b.resident for b in view._banks),
               routes=[c.route for c in coords], reschedules=[c.reschedules for c in coords])
    log(f"  multigather ({tag}), {len(paths)} samples: {wall:.2f} s wall, warm-cache hits "
        f"{run['cache_hits']}, banks {'resident' if run['resident'] else 'streamed'}, routes "
        f"{[r[:6] for r in run['routes']]}, reschedules {run['reschedules']}, launches "
        f"{run['launches']}")
    if run["cache_hits"] != len(paths):
        raise AssertionError(f"multigather ({tag}): {run['cache_hits']} warm-cache hits, "
                             f"{len(paths)} samples")
    return run


def multigather_end_to_end(rng, tmp: str, world: dict, profile_cli: bool = False) -> dict:
    """`multigather` of MULTI_LARGE + MULTI_SMALL samples (make_gather_query,
    the large first) against phase 6's zip: counts_block,
    membership_bits_batch and round_dec_batch must run, the first block of
    schedules on the device-membership route and the rest on host matrices,
    and every sample's CSV must equal oracle_gather. Then MULTI_CAPPED large
    samples again under SOURMASH_TORCH_SCHEDULE_CAP=MULTI_CAP (converge's batched
    recounts) and MULTI_LARGE small ones with the device budget below the
    planes (streamed banks): byte-identical CSVs."""
    mins_list, names, db = world["mins_list"], world["names"], world["db"]
    sizes = [GATHER_QUERY_HASHES] * MULTI_LARGE + rng.integers(
        MULTI_SMALL_HASHES[0], MULTI_SMALL_HASHES[1] + 1, size=MULTI_SMALL).tolist()
    t0 = time.time()
    samples = []
    for i, target in enumerate(sizes):
        q, abunds, _used = make_gather_query(rng, mins_list, target)
        path = os.path.join(tmp, f"s{i:02d}.sig")
        save_sig(path, q, f"sample {i}", abunds)
        samples.append((path, q, abunds))
    log(f"  {len(samples)} samples of {[len(s[1]) for s in samples]} hashes "
        f"({time.time() - t0:.1f} s to make)")
    world["samples"] = [q for _p, q, _a in samples]  # phase 12's queries
    t0 = time.time()
    wants = [oracle_gather(q, ab, mins_list, int(GATHER_THRESHOLD_BP // GATHER_SCALED),
                           world["index"]) for _p, q, ab in samples]
    log(f"  numpy oracle: {[len(w) for w in wants]} rounds in {time.time() - t0:.1f} s")

    def csv_of(out_dir, path):
        return os.path.join(out_dir, os.path.basename(path).replace(".sig", ".fa.gz") + ".csv")

    paths = [p for p, _q, _a in samples]
    out = os.path.join(tmp, "multi")
    runs = {"all": run_multigather("all samples", paths, out, db, {})}
    first = runs["all"]
    missing = [n for n, c in first["launches"].items() if c < 1]
    if missing:
        raise AssertionError(f"multigather: {missing} not launched: {first['launches']}")
    if first["routes"] != (["device membership"] * MULTI_LARGE
                           + ["host membership"] * MULTI_SMALL):
        raise AssertionError(f"multigather routes: {first['routes']}")
    for i, ((path, _q, _ab), want) in enumerate(zip(samples, wants)):
        check_gather_rows(f"multigather sample {i}", read_csv(csv_of(out, path)), want, names)
    log(f"  every sample's rows equal the numpy oracle ({sum(len(w) for w in wants)} rows)")

    for tag, part, env in (
        ("capped", paths[:MULTI_CAPPED], {"SOURMASH_TORCH_SCHEDULE_CAP": MULTI_CAP}),
        ("streamed", paths[MULTI_LARGE : 2 * MULTI_LARGE], {BUDGET_ENV: "1"}),
    ):
        rerun = os.path.join(tmp, f"multi_{tag}")
        runs[tag] = run_multigather(tag, part, rerun, db, env)
        for path in part:
            with open(csv_of(out, path), "rb") as a, open(csv_of(rerun, path), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"multigather ({tag}): {path}'s CSV differs")
    if not any(runs["capped"]["reschedules"]):
        raise AssertionError("multigather (capped): no schedule was recounted")
    if runs["streamed"]["resident"]:
        raise AssertionError("multigather (streamed): the banks stayed resident")
    log("  the capped and streamed runs wrote byte-identical CSVs")

    profile = None
    if profile_cli:
        from sourmash_tpu_torch.__main__ import main as cli_main

        out = os.path.join(tmp, "multi_profiled")
        os.makedirs(out)
        argv = ["multigather", "--query", *paths, "--db", db, "-q", "--output-dir", out]
        profile = profiled(lambda: cli_main(argv), "multigather")
    return dict(samples=[len(q) for _p, q, _a in samples], rounds=[len(w) for w in wants],
                runs=runs, profile=profile)


# -- phase 2 (compare's kernels) and phase 9: compare end to end --------------


def incidence(mins_list, values=None):
    """scipy.sparse CSR [n, distinct hashes] of the sketches: 1 where a
    sketch holds a hash, or the hash's value of `values` (its abundance)."""
    import scipy.sparse as sp

    lens = np.fromiter((len(m) for m in mins_list), dtype=np.int64, count=len(mins_list))
    uniq, cols = np.unique(np.concatenate(mins_list), return_inverse=True)
    data = (np.ones(int(lens.sum()), dtype=np.int64) if values is None
            else np.concatenate(values).astype(np.int64))
    rows = np.repeat(np.arange(len(mins_list)), lens)
    return sp.csr_matrix((data, (rows, cols)), shape=(len(mins_list), len(uniq)))


def oracle_pairwise(mins_list, values=None) -> np.ndarray:
    """[n, n] int64 X @ X.T of the sketches' sparse incidence matrix: each
    pair's shared hashes, or with `values` the sum of the products of their
    values over them. Independent of the port's packs and kernels."""
    X = incidence(mins_list, values)
    return np.asarray((X @ X.T).toarray(), dtype=np.int64)


@functools.lru_cache(maxsize=None)
def compare_collection(k: int, n: int) -> tuple:
    """(sigs, mins, clades, abundances) of n sketches at ksize k with
    abundances 1-50 (make_collection), made once from COMPARE_SEED, k and
    n: phase 2 times compare's kernels on the planes that phase 9's path
    gives them."""
    rng = np.random.default_rng([COMPARE_SEED, k, n])
    sigs, mins_list, clades = make_collection(rng, n, ksize=k, abundances=True)
    return sigs, mins_list, clades, [s.minhash.abunds_array() for s in sigs]


@functools.lru_cache(maxsize=None)
def compare_oracle(k: int, n: int) -> tuple:
    "(counts, products) of compare_collection(k, n) by oracle_pairwise."
    _sigs, mins_list, _clades, abunds = compare_collection(k, n)
    return oracle_pairwise(mins_list), oracle_pairwise(mins_list, abunds)


def sparse_product_ms(queries, rows, reps: int, want, qvalues=None, rvalues=None) -> float | None:
    """The time of one torch.sparse.mm on the card of the queries' sparse
    incidence rows against every row's (float64 over the distinct hashes of
    both, built on the card; values: 1, or the hashes' abundances of
    `qvalues` and `rvalues`): the library call that computes the same
    counts (or products) from another layout, the kernels line's
    library_ms. None, with the reason logged, where the call is refused or
    disagrees with `want` [queries, rows]."""
    import torch

    dev = torch.device(GATHER_DEVICE)
    parts = list(queries) + list(rows)
    nq = sum(len(m) for m in queries)
    try:
        vals = torch.from_numpy(np.concatenate(parts).view(np.int64)).to(dev)
        _uniq, cols = torch.unique(vals, return_inverse=True)
        lens = torch.tensor([len(m) for m in parts], device=dev)
        owner = torch.repeat_interleave(torch.arange(len(parts), device=dev), lens)
        data = (torch.ones(len(vals), dtype=torch.float64, device=dev) if qvalues is None else
                torch.from_numpy(np.concatenate(list(qvalues) + list(rvalues))
                                 .astype(np.float64)).to(dev))
        shape = (len(queries), len(_uniq))
        Q = torch.sparse_coo_tensor(torch.stack([owner[:nq], cols[:nq]]), data[:nq],
                                    shape).coalesce()
        XT = torch.sparse_coo_tensor(torch.stack([cols[nq:], owner[nq:] - len(queries)]),
                                     data[nq:], (shape[1], len(rows))).coalesce()
        del vals, cols, owner, data
        got = torch.sparse.mm(Q, XT).to_dense().cpu().numpy()
        if not np.array_equal(got, np.asarray(want).astype(np.float64)):
            log("  torch.sparse.mm disagrees with the oracle; no library time")
            return None
        return time_ms(lambda: torch.sparse.mm(Q, XT), reps)
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  torch.sparse.mm refused ({str(exc)[:200]}); no library time")
        return None


def weighted_edge_rows(rng):
    """16 sketches with abundances at B = 128: 2^64-1 (a valid hash in the
    weighted planes) in two of them, and 20 hashes of one bucket in rows 0
    and 1 (a depth of 20, past the 8 slots a lane holds in registers)."""
    rows = [random_sketch(rng, int(rng.integers(80, 160)), 2**64 - 1) for _ in range(16)]
    rows = [np.sort(m) for m in rows]
    for i in range(1, 16, 2):
        rows[i] = np.unique(np.r_[rows[i], rows[i - 1][::2]])
    top = np.uint64(2**64 - 1)
    rows[2], rows[5] = np.unique(np.r_[rows[2], top]), np.unique(np.r_[rows[5], top])
    deep = (np.arange(20, dtype=np.uint64) << np.uint64(32)) * np.uint64(128) + np.uint64(5)
    rows[0], rows[1] = np.unique(np.r_[rows[0], deep]), np.unique(np.r_[rows[1], deep[3:]])
    return rows, [rng.integers(1, 2**19, size=len(m)).astype(np.int64) for m in rows]


OVERLOAD_N = 2600  # overloaded_rows' sketches: rows padded to 4096


def overloaded_rows(rng):
    """OVERLOAD_N sketches of 40-80 hashes (B = 128; a count that is not a
    multiple of the row padding), row 7 empty, every other row holding the
    same 8 hashes of bucket 5: ~20,800 valid slots in that bucket, more
    than one block holds in shared memory, so its tile takes the join's
    global-memory branch. Abundances 1 to 2^19 - 1."""
    shared = (np.arange(8, dtype=np.uint64) << np.uint64(32)) * np.uint64(128) + np.uint64(5)
    rows = [np.unique(np.r_[random_sketch(rng, int(rng.integers(40, 81)), 2**64 - 1), shared])
            for _ in range(OVERLOAD_N)]
    rows[7] = np.zeros(0, dtype=np.uint64)
    return rows, [rng.integers(1, 2**19, size=len(m)).astype(np.int64) for m in rows]


def check_join(name: str, planes, mins_list, want, reps: int, clock_hz: float, bank=None,
               values=None) -> dict:
    """One all-pairs join on a whole bank, `pairwise_counts` on (hi, lo,
    cnt) or `pairwise_products` on (hi, lo, av, cnt): bit for bit against
    its plain version, its [:n, :n] (with `bank`'s spill correction) equal
    to the oracle `want`; timed as the wrapper (its tile plan reads the
    bucket loads back once, then the launch and the mirror), as the kernel
    alone on the path's tiles (two blocks an SM) and on the widest tiles
    one block holds, beside its bound, its atomics, its plain version and
    torch.sparse.mm of the whole matrix."""
    import torch

    from sourmash_tpu_torch.ops import bucketed as bk
    from sourmash_tpu_torch.ops import cuda_pairwise as cp

    weighted = len(planes) == 4
    fn, plain_fn = ((cp.pairwise_products, cp.pairwise_products_plain) if weighted else
                    (cp.pairwise_counts, cp.pairwise_counts_plain))
    hi, lo, cnt = planes[0], planes[1], planes[-1]
    av = planes[2] if weighted else None
    rows, d, B = hi.shape
    n = len(mins_list)
    got = fn(*planes)
    torch.cuda.synchronize()
    t0 = time.time()
    want_plain = plain_fn(*planes)
    torch.cuda.synchronize()
    plain = (time.time() - t0) * 1e3
    err = exact(name, got, want_plain)
    del want_plain
    M = got[:n, :n].cpu().numpy().astype(np.int64)
    if bank is not None:
        bk._pairwise_spill_correction(M, mins_list, bank)
    if not np.array_equal(M, want):
        raise AssertionError(f"{name}: {int((M != want).sum())} entries differ from the oracle")
    # the pairs the walk adds: sum over runs of g (g + 1) / 2, the upper
    # triangle (diagonal included) of the stored count matrix
    C = got if not weighted else cp.pairwise_counts(hi, lo, cnt)
    pairs = (int(C.sum(dtype=torch.int64)) + int(C.diagonal().sum(dtype=torch.int64))) // 2
    valid = int(cnt.to(torch.int64).clamp(max=d).sum())
    del C
    ms = time_ms(lambda: fn(*planes), reps)
    out = torch.zeros((rows, rows), dtype=torch.int64 if weighted else torch.int32,
                      device=hi.device)
    # the wrapper's parts around the launch: the tile plan (a reduction of
    # the occupancy, read back) and the mirror of the upper triangle
    plan_ms = time_ms(lambda: cp.join_plan(cnt, d, weighted), reps)
    mirror_ms = time_ms(lambda: cp._mirror(out), reps)
    cap, pair_cap = cp.join_capacity(weighted, hi.device), cp.join_capacity(weighted, hi.device, 2)
    per_bucket = cnt.clamp(max=min(d, 255)).sum(dim=0, dtype=torch.int64)
    # the kernel alone at the path's tiles and at each width one block holds
    tiles = {}
    for label, target in [("path", None)] + [
            (f"{1 << lg} buckets", int(per_bucket.view(-1, 1 << lg).sum(dim=1).max()))
            for lg in range(cp._MAX_TILE_LOG2 + 1)]:
        if target is not None and target > cap:
            continue
        plan = cp.join_plan(cnt, d, weighted, target)
        launch = functools.partial(cp.launch_join, plan, hi, lo, av, out)
        tiles[label] = dict(tile=1 << plan.tile_log2, kernel_ms=time_ms(launch, reps),
                            b2b_ms=back_to_back_ms(launch, reps), cap=plan.cap,
                            global_tiles=plan.global_tiles)
    # the same stage and sort with no value shared between rows (each row's
    # hi limbs xor-ed with a row constant; buckets and loads unchanged): the
    # walk adds only the diagonal, so the difference is the pair atomics
    salt = (torch.arange(rows, device=hi.device, dtype=torch.int32) * 0x01000193)[:, None, None]
    plan = cp.join_plan(cnt, d, weighted)
    launch = functools.partial(cp.launch_join, plan, hi ^ salt, lo, av, out)
    tiles["path, no shared values"] = dict(tile=1 << plan.tile_log2, b2b_ms=back_to_back_ms(
        launch, reps))
    del out
    # atomics the kernel issues: a pair of a run, and the diagonal once a
    # row and tile that holds a valid slot
    lg = plan.tile_log2
    rows_tiles = int((cnt.view(rows, B >> lg, 1 << lg).to(torch.int32).sum(dim=2) > 0).sum())
    kernel_atomics = pairs - valid + rows_tiles
    # least bytes: the occupancies, each valid slot's limbs (and abundance)
    # once, the output once; least operations: a compare an entry for the
    # runs, an add a pair (with a 64-bit multiply, the products). The pair
    # increments are atomics in L2, whose rate the model does not hold.
    nbytes = cnt.numel() + (12 if weighted else 8) * valid + rows * rows * (8 if weighted else 4)
    imad = IMAD_PER_MUL * pairs if weighted else 0
    bms, by = bound_ms(nbytes, imad, (2 if weighted else 1) * pairs + valid, clock_hz)
    lib = sparse_product_ms(mins_list, mins_list, reps, want, values, values)
    path = tiles["path"]
    log(f"  {name} [{rows}, {rows}] on [{rows}, {d}, {B}] planes ({valid} valid slots, {pairs} "
        f"pairs, {kernel_atomics} atomics): equals its plain version and the oracle; wrapper "
        f"{ms:.4f} ms (plan {plan_ms:.4f}, mirror {mirror_ms:.4f}), kernel "
        f"{path['kernel_ms']:.4f} ms ({path['b2b_ms']:.4f} back to back) at "
        f"tiles of {path['tile']} buckets; back to back by width "
        f"{ {k: round(v['b2b_ms'], 4) for k, v in tiles.items()} }; plain {plain:.1f} ms; bound "
        f"{bms:.4f} ms ({by}, {nbytes} bytes), {100 * bms / path['b2b_ms']:.1f} % of it back to "
        f"back; torch.sparse.mm of the whole matrix {lib} ms; 1 launch a matrix")
    return dict(ms=ms, b2b_ms=path["b2b_ms"], kernel_ms=path["kernel_ms"], plan_ms=plan_ms,
                mirror_ms=mirror_ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, bytes=nbytes, max_abs_err=err, library_ms=lib,
                atomics=pairs, kernel_atomics=kernel_atomics, valid_slots=valid, rows=rows, d=d,
                B=B, tiles=tiles, cap=cap, cap_pair=pair_cap, launches_per_matrix=1)


def check_compare_kernels(quick: bool, rng, clock_hz: float) -> dict:
    """compare's kernels on phase 9's k=31 collection ([2048, 8, 4096] at
    n = 2,000; 256 sketches with --quick), bit for bit against their plain
    versions, each timed with its bound and beside torch.sparse.mm: the
    joins `pairwise_counts` on the bank and `pairwise_products` on
    `_pack_weighted`'s planes, one launch a matrix, each held to the
    scipy.sparse oracle (`check_join`); the block routes' joins,
    counts_block with the bank's own rows as the query block at
    sourmash_tpu's block of 16, and products_block at blocks of 8 and
    PRODUCTS_BLOCK (`check_block_join`), each beside torch.sparse.mm of the same
    block; the edge rows (spills and 2^64-1 in two rows, a weighted bucket
    20 deep; `overloaded_rows`: a bucket past shared memory, an empty
    sketch, n not a multiple of the row padding) through the joins and the
    block kernels; `query_intersection_counts` of one sketch against the
    collection (`counts_rows` on CUDA) against np.intersect1d."""
    import torch

    from sourmash_tpu_torch.ops import bucketed as bk
    from sourmash_tpu_torch.ops import cuda_gather as cg
    from sourmash_tpu_torch.ops import cuda_pairwise as cp
    from sourmash_tpu_torch.ops import intersect

    dev = torch.device(GATHER_DEVICE)
    n = 256 if quick else COMPARE_GENOMES
    reps = 3 if quick else 10
    t0 = time.time()
    _sigs, mins_list, _clades, abunds = compare_collection(TIMED_K, n)
    C, P = compare_oracle(TIMED_K, n)
    log(f"  {n} sketches with abundances and their scipy.sparse oracle in {time.time() - t0:.1f} s")

    B = bk.choose_buckets(max(len(m) for m in mins_list))
    bank = bk.pack_rows_device(mins_list, B, device=dev)
    Shi, Slo, Scnt = bank.hi, bank.lo, bank.cnt
    rows = Shi.shape[0]
    results = {"pairwise_counts": check_join("pairwise_counts", (Shi, Slo, Scnt), mins_list, C,
                                             reps, clock_hz, bank=bank)}

    # the block route: counts_block with the bank's own rows as the query
    # block, at sourmash_tpu's block of 16, on the tiles `row_block_plans`
    # gives the route (planned from the bank's occupancy, read back once)
    block = COMPARE_BLOCK
    Q = (Shi[:block], Slo[:block], Scnt[:block].to(torch.int32))
    plan = cg.block_join_plan(cg.block_entries(Q[2], 8), False, dev)
    res = check_block_join(f"counts_block (compare), block {block}", Q, (Shi, Slo, Scnt), plan,
                           reps, clock_hz)
    lib = sparse_product_ms(mins_list[:block], mins_list, reps, C[:block])
    launches = -(-rows // block)
    results["counts_block_pairwise"] = dict(res, library_ms=lib, launches_per_matrix=launches,
                                            matrix_kernel_ms=launches * res["b2b_ms"])
    log(f"  counts_block (compare): torch.sparse.mm of the block {lib} ms; {launches} launches "
        f"a matrix ({launches * res['b2b_ms']:.2f} ms back to back)")

    t0 = time.time()
    hi, lo, av, cnt, _B = bk._pack_weighted(mins_list, abunds)
    pack_s = time.time() - t0
    S = tuple(bk.to_torch(x, dev) for x in (hi, lo, av, cnt))
    d = S[0].shape[1]
    results["pairwise_products"] = dict(
        check_join("pairwise_products", S, mins_list, P, reps, clock_hz, values=abunds),
        pack_s=pack_s)
    blocks = {}
    for block in sorted({8, PRODUCTS_BLOCK}):
        Q = tuple(x[:block] for x in S)
        plan = cg.block_join_plan(cg.block_entries(Q[3], d), True, dev)
        # every shared hash a product (abundances 1-50): the count matrix's block
        hits = int(C[: min(block, n)].sum())
        res = check_block_join(f"products_block, block {block}", Q, S, plan, reps, clock_hz,
                               hits=hits)
        got = cg.products_block(*Q, *S, plan)
        if not np.array_equal(got[: min(block, n), :n].cpu().numpy(), P[: min(block, n)]):
            raise AssertionError("products_block: the block differs from the sparse oracle")
        lib = sparse_product_ms(mins_list[:block], mins_list, reps, P[:block],
                                abunds[:block], abunds)
        launches = -(-rows // block)
        blocks[block] = dict(res, library_ms=lib, launches_per_matrix=launches,
                             matrix_kernel_ms=launches * res["b2b_ms"])
        log(f"  products_block, block {block}: equals the oracle; torch.sparse.mm of the block "
            f"{lib} ms; {launches} launches a matrix ({launches * res['b2b_ms']:.2f} ms back to "
            f"back; host pack {pack_s:.2f} s)")
    best = min(blocks, key=lambda b: blocks[b]["matrix_kernel_ms"])
    log(f"  products_block blocks: {best} is the faster a matrix; the block route takes "
        f"{PRODUCTS_BLOCK}")
    results["products_block"] = dict(blocks[PRODUCTS_BLOCK], blocks=blocks, faster=best)
    del bank, Shi, Slo, S, Q

    # edge rows: spills and 2^64-1 in the counts; 2^64-1 and a deep bucket
    # in the products; through the joins and through the block kernels
    erows, eab = weighted_edge_rows(rng)
    want = oracle_pairwise(erows)
    for block in (None, COMPARE_BLOCK):
        if not np.array_equal(bk.pairwise_counts_bucketed(erows, block=block, device=dev), want):
            raise AssertionError(f"pairwise_counts_bucketed (block {block}) on edge rows differs "
                                 f"from the oracle")
    ebank = bk.pack_rows_device(erows, bk.choose_buckets(max(len(m) for m in erows)), device=dev)
    exact("pairwise_counts, edge rows", cp.pairwise_counts(ebank.hi, ebank.lo, ebank.cnt),
          cp.pairwise_counts_plain(ebank.hi, ebank.lo, ebank.cnt))
    wplanes = [bk.to_torch(x, dev) for x in bk._pack_weighted(erows, eab)[:4]]
    want = oracle_pairwise(erows, eab)
    for name, got, plain in (
            ("products_block", cg.products_block(*wplanes, *wplanes),
             cg.products_block_plain(*wplanes, *wplanes)),
            ("pairwise_products", cp.pairwise_products(*wplanes),
             cp.pairwise_products_plain(*wplanes))):
        exact(f"{name}, edge rows", got, plain)
        if not np.array_equal(got[:16, :16].cpu().numpy(), want):
            raise AssertionError(f"{name} on edge rows differs from the oracle")
    # a bucket past shared memory (the join's global-memory branch), an
    # empty sketch, n not a multiple of the row padding
    orows, oab = overloaded_rows(rng)
    OB = bk.choose_buckets(max(len(m) for m in orows))
    obank = bk.pack_rows_device(orows, OB, device=dev)
    oplanes = tuple(bk.to_torch(x, dev) for x in bk._pack_weighted(orows, oab)[:4])
    went_global = {}
    for name, planes, fn, plain_fn, want in (
            ("pairwise_counts", (obank.hi, obank.lo, obank.cnt), cp.pairwise_counts,
             cp.pairwise_counts_plain, oracle_pairwise(orows)),
            ("pairwise_products", oplanes, cp.pairwise_products, cp.pairwise_products_plain,
             oracle_pairwise(orows, oab))):
        plan = cp.join_plan(planes[-1], planes[0].shape[1], len(planes) == 4)
        if not plan.global_tiles:
            raise AssertionError(f"{name}: the overloaded bucket's tile fits shared memory")
        went_global[name] = plan.global_tiles
        got = fn(*planes)
        exact(f"{name}, overloaded bucket", got, plain_fn(*planes))
        M = got[:OVERLOAD_N, :OVERLOAD_N].cpu().numpy().astype(np.int64)
        if len(planes) == 3:
            bk._pairwise_spill_correction(M, orows, obank)
        if not np.array_equal(M, want):
            raise AssertionError(f"{name} on the overloaded bucket differs from the oracle")
    log(f"  edge rows (spills, 2^64-1 in two rows, a weighted bucket {wplanes[0].shape[1]} deep; "
        f"{OVERLOAD_N} sketches padded to {obank.hi.shape[0]} rows, one empty, 8 shared hashes "
        f"in one of {OB} buckets: global-memory tiles {went_global}): the joins and the block "
        f"kernels equal their plain versions and the oracle")
    del obank, oplanes

    # query vs many without cutoffs, past the host cutoff: the counts_rows engine
    q = max(mins_list, key=len)
    if len(q) * n + sum(len(m) for m in mins_list) < intersect._HOST_WORK_CUTOFF:
        raise AssertionError("query_intersection_counts: the collection is under the host cutoff")
    cg.reset_launch_counts()
    got = intersect.query_intersection_counts(q, mins_list, device=dev)
    if cg.LAUNCHES["counts_rows"] < 1:
        raise AssertionError("query_intersection_counts: counts_rows was not launched")
    want = np.array([len(np.intersect1d(q, m)) for m in mins_list], dtype=np.int64)
    if not np.array_equal(got, want):
        raise AssertionError(f"query_intersection_counts: {int((got != want).sum())} counts "
                             f"differ from np.intersect1d")
    log(f"  query_intersection_counts of a {len(q)}-hash sketch vs {n}: "
        f"{cg.LAUNCHES['counts_rows']} counts_rows launches, equal to np.intersect1d")
    torch.cuda.empty_cache()
    return results


def run_compare(argv: list, env: dict) -> dict:
    """One `compare` run (run_counted: launches and wall), its stdout and
    stderr captured, with the count and product matrices the command
    computed and the wall of each, and of the packs inside them."""
    import io

    import torch

    from sourmash_tpu_torch import compare as tcompare
    from sourmash_tpu_torch.ops import bucketed as bk

    seen = {}

    def spy(key, keep):
        def wrap(fn):
            def spied(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.time()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                seen[f"{key}_s"] = seen.get(f"{key}_s", 0.0) + time.time() - t0
                if keep:
                    seen[key] = out
                return out
            return spied
        return wrap

    stdout = io.StringIO()
    with patched(tcompare, "pairwise_intersection_counts", spy("counts", True)), \
            patched(bk, "pairwise_weighted_products", spy("products", True)), \
            patched(bk, "pack_rows_device", spy("pack", False)), \
            patched(bk, "_pack_weighted", spy("pack", False)), \
            contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(io.StringIO()):
        wall, launches = run_counted(["compare", *argv], env)
    return dict(wall_s=wall, launches={n: launches[n] for n in COMPARE_KERNELS},
                stdout=stdout.getvalue(), **seen)


def compare_closed_form(mode: str, C, P, norms, scaled: int) -> np.ndarray:
    """The matrix `compare` writes, from exact counts C (and products P,
    abundance norms) by compare.py's closed forms, term for term: Jaccard
    common / max(1, union); angular 1 - 2 arccos(min(P / (|a_i| |a_j|), 1))
    / pi; containment of j in i common / (len_j * bias(len_j))."""
    n = len(C)
    lens = np.diagonal(C).astype(np.int64)
    if mode == "jaccard":
        out = C / np.maximum(1, lens[:, None] + lens[None, :] - C)
    elif mode == "angular":
        zero = 1.0 - 2.0 * np.arccos(min(0.0 / 1.0, 1.0)) / np.pi
        out = np.full((n, n), zero)
        for i, j in zip(*np.nonzero(np.triu(P, 1))):
            if norms[i] == 0.0 or norms[j] == 0.0:
                v = 0.0
            else:
                cos = min(float(P[i, j]) / (norms[i] * norms[j]), 1.0)
                v = 1.0 - 2.0 * np.arccos(cos) / np.pi
            out[i, j] = out[j, i] = v
    else:
        bias = np.array([1.0 - (1.0 - 1.0 / scaled) ** float(int(m) * scaled) for m in lens])
        out = np.maximum(0.0, np.minimum(1.0, C / (lens * bias)[None, :]))
    np.fill_diagonal(out, 1.0)
    return out


def read_compare_outputs(out: str) -> tuple:
    "(labels, matrix, csv matrix) that `compare -o out --csv out.csv` wrote."
    import csv

    with open(out + ".labels.txt") as f:
        labels = f.read().split("\n")
    with open(out + ".csv", newline="") as f:
        table = list(csv.reader(f))
    if table[0] != labels:
        raise AssertionError(f"{out}.csv: its header is not the labels")
    return labels, np.load(out), np.array([[float(v) for v in row] for row in table[1:]])


def compare_end_to_end(tmp: str, products_block: int, profile_cli: bool = False) -> dict:
    """`compare` (config 2 of BASELINE.json) on compare_collection's
    sketches (abundances 1-50): COMPARE_GENOMES at k=31, phase 2's, and
    COMPARE_SMALL at each of COMPARE_KS, each a zip. At n = 2,000: Jaccard
    with --ignore-abundance, angular and --containment, each writing -o and
    --csv, each launching its join (`pairwise_counts`, angular
    `pairwise_products`) once and no block kernel; the count and product
    matrices the command computed must equal the scipy.sparse oracle
    exactly, and each written matrix (and its CSV) the oracle's counts
    through compare.py's closed forms. Then the block routes through the
    library entry points (`pairwise_counts_bucketed` at COMPARE_BLOCK,
    `pairwise_weighted_products` at `products_block`), launches counted,
    each matrix held to the oracle. At n = 100: COMPARE_SMALL_MODES at k=31
    and the last of them at each other k, on the card and with
    SOURMASH_TORCH_DEVICE=cpu (the sorted engine): byte-identical stdout
    and files."""
    from sourmash_tpu_torch.__main__ import main as cli_main
    from sourmash_tpu_torch.ops import bucketed as bk
    from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

    t0 = time.time()
    colls = {}
    for k in COMPARE_KS:
        n = COMPARE_GENOMES if k == TIMED_K else COMPARE_SMALL
        sigs, mins_list, clades, abunds = compare_collection(k, n)
        paths = {}
        parts = [("all", sigs)] if k == TIMED_K else []
        for tag, part in parts + [("small", sigs[:COMPARE_SMALL])]:
            paths[tag] = os.path.join(tmp, f"compare_k{k}_{tag}.zip")
            with SaveSignaturesToLocation(paths[tag]) as save:
                for ss in part:
                    save.add(ss)
        colls[k] = dict(sigs=sigs, mins=mins_list, abunds=abunds, paths=paths, clades=clades)
    log(f"  made {COMPARE_GENOMES} sketches at k={TIMED_K} and {COMPARE_SMALL} at each other k "
        f"of {COMPARE_KS} (abundances 1-50), written as zips, in {time.time() - t0:.1f} s")

    big = colls[TIMED_K]
    t0 = time.time()
    C, P = compare_oracle(TIMED_K, COMPARE_GENOMES)
    norms = np.array([np.sqrt(float(np.sum(ab.astype(np.float64) ** 2))) for ab in big["abunds"]])
    where = {str(s): i for i, s in enumerate(big["sigs"])}
    log(f"  scipy.sparse oracle (X X^T and A A^T, phase 2's) in {time.time() - t0:.1f} s")

    runs = {}
    n = COMPARE_GENOMES
    for mode, flags, kernel in (("jaccard", ["--ignore-abundance"], "pairwise_counts"),
                                ("angular", [], "pairwise_products"),
                                ("containment", ["--containment"], "pairwise_counts")):
        out = os.path.join(tmp, f"compare_{mode}.npy")
        run = run_compare([big["paths"]["all"], *flags, "-o", out, "--csv", out + ".csv"], {})
        labels, M, M_csv = read_compare_outputs(out)
        idx = np.array([where[label] for label in labels])
        Ci, Pi = C[np.ix_(idx, idx)], P[np.ix_(idx, idx)]
        others = {k: c for k, c in run["launches"].items() if k != kernel and c}
        if run["launches"][kernel] != 1 or others:
            raise AssertionError(f"compare ({mode}): {kernel} must run once a matrix and no "
                                 f"other compare kernel: {run['launches']}")
        computed = run.get("products" if mode == "angular" else "counts")
        if not np.array_equal(computed, Pi if mode == "angular" else Ci):
            raise AssertionError(f"compare ({mode}): the matrix it computed differs from the oracle")
        want = compare_closed_form(mode, Ci, Pi, norms[idx], GATHER_SCALED)
        if not (np.array_equal(M, want) and np.array_equal(M_csv, want)):
            raise AssertionError(f"compare ({mode}): {int((M != want).sum())} written values differ "
                                 f"from the oracle's closed form")
        run = {key: v for key, v in run.items() if key not in ("counts", "products", "stdout")}
        runs[mode] = dict(run, pairs_per_s=n * n / run["wall_s"])
        log(f"  compare ({mode}), n = {n}: {run['wall_s']:.2f} s wall, {n * n / run['wall_s']:.0f} "
            f"all-pairs compares/s; matrix {run.get('products_s', run.get('counts_s', 0)):.3f} s "
            f"(host pack {run.get('pack_s', 0.0):.3f} s); launches {run['launches']}; the "
            f"computed matrix equals the oracle and -o and --csv its closed form")

    # the block routes (the JAX package's design), through the library
    # entry points, each matrix held to the oracle
    block_routes = {}
    for name, kernel, block, fn, want in (
            ("counts_block (compare)", "counts_block", COMPARE_BLOCK,
             lambda: bk.pairwise_counts_bucketed(big["mins"], block=COMPARE_BLOCK, device="cuda"),
             C),
            ("products_block", "products_block", products_block,
             lambda: bk.pairwise_weighted_products(big["mins"], big["abunds"],
                                                   block=products_block, device="cuda"),
             P)):
        M, wall, launches = call_counted(fn, {})
        if not np.array_equal(M, want):
            raise AssertionError(f"{name}: the block route's matrix differs from the oracle")
        block_routes[name] = dict(wall_s=wall, block=block,
                                  launches={k: launches[k] for k in COMPARE_KERNELS})
        log(f"  {name}: the block route at {block} rows a launch, {launches[kernel]} launches, "
            f"{wall:.3f} s a matrix, equal to the oracle")

    cross = {}
    for k in COMPARE_KS:
        for flags in COMPARE_SMALL_MODES if k == TIMED_K else COMPARE_SMALL_MODES[-1:]:
            tag = f"k{k} {' '.join(flags)}"
            outs = {}
            for dev, env in (("cuda", {}), ("cpu", {"SOURMASH_TORCH_DEVICE": "cpu"})):
                d = os.path.join(tmp, f"cross_{k}_{'_'.join(f.strip('-') for f in flags)}_{dev}")
                os.makedirs(d)
                run = run_compare([colls[k]["paths"]["small"], *flags, "-o", os.path.join(d, "m"),
                                   "--csv", os.path.join(d, "m.csv")], env)
                files = {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}
                outs[dev] = (run, files)
            (crun, cfiles), (hrun, hfiles) = outs["cuda"], outs["cpu"]
            if crun["launches"]["pairwise_counts"] != 1 or any(hrun["launches"].values()):
                raise AssertionError(f"compare ({tag}): launches {crun['launches']} on the card, "
                                     f"{hrun['launches']} on the CPU")
            if cfiles != hfiles or crun["stdout"] != hrun["stdout"]:
                raise AssertionError(f"compare ({tag}): the card's outputs differ from the CPU's")
            cross[tag] = dict(cuda_s=crun["wall_s"], cpu_s=hrun["wall_s"],
                              launches=crun["launches"])
    log(f"  n = {COMPARE_SMALL}, k = {COMPARE_KS}: {len(cross)} commands "
        f"({', '.join(cross)}) on the card byte-identical to the CPU's sorted engine; walls card "
        f"{[round(c['cuda_s'], 2) for c in cross.values()]} s, CPU "
        f"{[round(c['cpu_s'], 2) for c in cross.values()]} s")

    profile = {}
    if profile_cli:
        for mode, flags in (("jaccard", ["--ignore-abundance"]), ("angular", [])):
            argv = ["compare", big["paths"]["all"], *flags, "-q",
                    "-o", os.path.join(tmp, f"profiled_{mode}.npy")]
            profile[mode] = profiled(lambda: cli_main(argv), f"compare ({mode})")
    return dict(n=n, small=COMPARE_SMALL, ks=list(COMPARE_KS), runs=runs, cross=cross,
                block_routes=block_routes, clades=big["clades"],
                hashes=int(np.diagonal(C).sum()), profile=profile)


COMPARE_KERNELS = ("pairwise_counts", "pairwise_products", "counts_block", "products_block")
COMPARE_BLOCK = 16  # sourmash_tpu's rows a launch of the all-pairs counts (the block route)
# rows a launch of the all-pairs products' block route, as phase 2 times it
# and phase 9 drives it: the block the first products kernel staged in one
# block's shared memory at depth 10 (PERF.md keeps its times)
PRODUCTS_BLOCK = 58
# phase 9's n = 100 commands, run on the card and on the CPU: all four at
# k = 31, the last (both directions' containment and ANI) at the other k
# (cut from all four for the time limit)
COMPARE_SMALL_MODES = (["--max-containment"], ["--avg-containment"],
                       ["--max-containment", "--estimate-ani"],
                       ["--avg-containment", "--estimate-ani"])
MULTI_KERNELS = ("counts_block", "membership_bits_batch", "round_dec_batch")
BUDGET_ENV = "SOURMASH_TORCH_GPU_BUDGET_BYTES"

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
    "counts_rows": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/gather.cu",
        replaces="tools/exp_pallas_counts.py:71",
    ),
    "membership_bits": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/gather.cu",
        replaces="sourmash_tpu/ops/bucketed.py:965",
    ),
    "round_dec": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/gather.cu",
        replaces="sourmash_tpu/index/flat.py:354",
    ),
    "counts_block": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/block_join.cu",
        replaces="sourmash_tpu/ops/bucketed.py:619",
    ),
    "membership_bits_batch": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/gather.cu",
        replaces="sourmash_tpu/ops/bucketed.py:985",
    ),
    # compare's all-pairs matrices: hash joins of a bank's valid slots, one
    # launch a matrix (the main path of compare)
    "pairwise_counts": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/pairwise.cu",
        replaces="sourmash_tpu/ops/bucketed.py:619",
    ),
    "pairwise_products": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/pairwise.cu",
        replaces="sourmash_tpu/ops/bucketed.py:1025",
    ),
    # the block routes of the all-pairs counts and products (the JAX
    # package's design, kept behind an integer `block`): the joins
    # counts_block with the bank's own rows as the query block (dq = d =
    # 8) and products_block
    "counts_block (compare)": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/block_join.cu",
        replaces="sourmash_tpu/ops/bucketed.py:619",
    ),
    "products_block": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/block_join.cu",
        replaces="sourmash_tpu/ops/bucketed.py:1025",
    ),
    "round_dec_batch": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/gather.cu",
        replaces="sourmash_tpu/index/flat.py:1598",
    ),
    "split_words": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch_parts.cu",
        replaces="tools/exp_split_kernel.py:130",
    ),
    "split_slots": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch_parts.cu",
        replaces="tools/exp_split_kernel.py:146",
    ),
    "survivor_slots_v2": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch_parts.cu",
        replaces="tools/exp_v2_kernel.py:237",
    ),
    "murmur_only": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch_parts.cu",
        replaces="tools/profile_sketch_parts.py:44",
    ),
    "assembly_only": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch_parts.cu",
        replaces="tools/profile_sketch_parts.py:56",
    ),
    "mulchain": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch_parts.cu",
        replaces="tools/profile_sketch_parts.py:77",
    ),
    # the integer-pipe probe replaces no kernel: it answers the JAX tool's
    # question (its docstring's line 2: what is the integer roofline?)
    "int_probe": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/sketch_parts.cu",
        replaces="tools/profile_sketch_parts.py:2",
    ),
    # the sharded gather program's shard-local match (`_local_counts` :146
    # and `build_chunk` :306), timed with its words at the program's chunk:
    # one call, two launches (the alive slots' tables, then the match)
    "shard_match": dict(
        route="cuda", source="sourmash_tpu_torch/csrc/parallel.cu",
        replaces="sourmash_tpu/parallel/__init__.py:146",
    ),
}
INSTRUMENTS = ("split_words", "split_slots", "survivor_slots_v2", "murmur_only",
               "assembly_only", "mulchain", "int_probe")


# -- phase 10: sketch fromfile, disk revindexes, sqlite and the view cache ----

# `sketch fromfile` of a strain list (GTDB-style: genomes, some with
# proteomes), sourmash's three DNA ksizes and its protein default
FROMFILE_GENOMES = 8
FROMFILE_PROTEOMES = 2
FROMFILE_M_AA = 2  # M residues a proteome (E. coli K-12's: 1.35 M aa)
FROMFILE_PARAMS = ["dna,k=21,k=31,k=51,scaled=1000", "protein,k=10,scaled=200"]
# phase 6's first genomes (cut from 1,000 for the run's time limit), above
# the 512-sketch flat-view threshold; phase 11 builds its SBT and LCA
# database from their zip
SQLITE_GENOMES = 600
VIEW_CACHE_ENV = "SOURMASH_TORCH_VIEW_CACHE_DIR"


def view_cache_line(what: str) -> dict:
    "The view cache's hits, misses and bytes so far in this process."
    from sourmash_tpu_torch.index import view_cache

    stats = dict(view_cache.STATS)
    log(f"  view cache after {what}: {stats['hits']} hits, {stats['misses']} misses, "
        f"{stats['bytes_read']} bytes read, {stats['bytes_written']} bytes written")
    return stats


def sig_facts(sig) -> tuple:
    "What fromfile must reproduce of a signature: md5, mins, name, filename."
    return sig.md5sum(), sig.minhash.mins_array().tobytes(), sig.name, sig.filename


def fromfile_end_to_end(rng, tmp: str) -> dict:
    """`sketch fromfile` of FROMFILE_GENOMES genomes of phase 3's kind (one
    record of 4.4-4.8 Mbp each, a .fa.gz each), FROMFILE_PROTEOMES of them
    with a proteome of phase 4's kind, into a zip: K1 and K3 must run and
    every signature (md5, mins, name, filename) must equal `sketch dna` /
    `sketch protein --name` of the same file. Then again with
    --already-done, --output-manifest-matching and --output-csv-info: every
    sketch matches, nothing is built and the command exits 0."""
    from sourmash_tpu_torch import load_signatures_from_json
    from sourmash_tpu_torch.__main__ import main as cli_main
    from sourmash_tpu_torch.manifest import CollectionManifest
    from sourmash_tpu_torch.save_load import load_file_as_index

    d = os.path.join(tmp, "fromfile")
    os.makedirs(d)
    t0 = time.time()
    rows, bases, residues = [], 0, 0
    for i in range(FROMFILE_GENOMES):
        genome = os.path.join(d, f"genome{i}.fa.gz")
        bases += write_fasta(genome, 1, rng, [])[1]
        proteome = ""
        if i < FROMFILE_PROTEOMES:
            proteome = os.path.join(d, f"proteome{i}.faa.gz")
            residues += write_protein_fasta(proteome, FROMFILE_M_AA, rng)[1]
        rows.append((f"strain {i}", genome, proteome))
    csv_path = os.path.join(d, "strains.csv")
    with open(csv_path, "w") as f:
        f.write("name,genome_filename,protein_filename\n")
        f.writelines(f"{n},{g},{p}\n" for n, g, p in rows)
    log(f"  wrote {FROMFILE_GENOMES} genomes ({bases / 1e6:.2f} Mbp) and {FROMFILE_PROTEOMES} "
        f"proteomes ({residues / 1e6:.2f} M aa) in {time.time() - t0:.1f} s")

    params = [x for p in FROMFILE_PARAMS for x in ("-p", p)]
    out = os.path.join(d, "fromfile.zip")
    wall, launches, batches = run_cli(
        "sketch fromfile", ["sketch", "fromfile", csv_path, "--ignore-missing", "-o", out,
                            *params], ("survivor_slots", "aa_window_hashes"))
    got = {}
    for sig in load_file_as_index(out).signatures():
        got[(sig.name, sig.minhash.moltype, sig.minhash.ksize)] = sig_facts(sig)
    log(f"  sketch fromfile: {wall:.2f} s wall, {len(got)} signatures, launches {launches}; "
        f"launches by rows {batches}")

    t0 = time.time()
    want = {}
    for name, genome, proteome in rows:
        for cmd, path, p in (("dna", genome, "k=21,k=31,k=51,scaled=1000"),
                             ("protein", proteome, "k=10,scaled=200")):
            if not path:
                continue
            sig_out = os.path.join(d, f"{os.path.basename(path)}.sig")
            run_cli(f"sketch {cmd}", ["sketch", cmd, path, "-p", p, "--name", name, "-q",
                                      "-o", sig_out],
                    ("survivor_slots",) if cmd == "dna" else ("aa_window_hashes",))
            for sig in load_signatures_from_json(open(sig_out, "rb").read()):
                want[(sig.name, sig.minhash.moltype, sig.minhash.ksize)] = sig_facts(sig)
    if sorted(got) != sorted(want) or len(want) != 3 * FROMFILE_GENOMES + FROMFILE_PROTEOMES:
        raise AssertionError(f"fromfile built {sorted(got)}, sketch dna|protein {sorted(want)}")
    for key, facts in want.items():
        if got[key] != facts:
            raise AssertionError(f"fromfile signature {key} differs from sketch dna|protein's")
    log(f"  every fromfile signature (md5, mins, name, filename) equals sketch dna|protein "
        f"--name of its file ({time.time() - t0:.1f} s for those)")

    matching, info, again = (os.path.join(d, n) for n in ("matching.csv", "info.csv", "again.zip"))
    argv = ["sketch", "fromfile", csv_path, "--ignore-missing", "--already-done", out,
            "--output-manifest-matching", matching, "--output-csv-info", info, "-o", again,
            *params]

    def rerun():
        try:
            return cli_main(argv)
        except SystemExit as exc:
            return exc.code

    rc, rerun_wall, rerun_launches = call_counted(rerun, {})
    with open(matching) as f:
        n_matching = len(CollectionManifest.load_from_csv(f))
    if (rc or 0) != 0 or n_matching != len(want) or os.path.exists(again) \
            or os.path.exists(info) or any(rerun_launches[n] for n in SKETCH_WRAPPERS):
        raise AssertionError(f"fromfile --already-done: rc {rc}, {n_matching} matching rows, "
                             f"launches {rerun_launches}")
    log(f"  fromfile --already-done: {rerun_wall:.2f} s wall, all {n_matching} sketches matched, "
        f"nothing built (no CSV info, no output, no sketch kernel launched), exit 0")
    return dict(wall_s=wall, mbp=bases / 1e6, m_aa=residues / 1e6, signatures=len(got),
                launches=launches, batches=batches, rerun_wall_s=rerun_wall)


def gather_spied(argv: list, env: dict) -> tuple:
    """run_gather_cli against a revindex, also recording the directory's
    load (`load_revindex`: its wall and the signatures' names in order),
    whether FlatIndex took its planes from disk (`load_banks`) and whether
    those stayed on the host."""
    from sourmash_tpu_torch.index import flat, revindex

    loads, opened = [], []

    def banks_spy(load_banks):
        def spied(*a, **kw):
            banks = load_banks(*a, **kw)
            loads.append(all(b.resident for b in banks))
            return banks
        return spied

    def load_spy(load_revindex):
        def spied(*a, **kw):
            t0 = time.time()
            idx = load_revindex(*a, **kw)
            opened.append((time.time() - t0, [s.name for s in idx.signatures()]))
            return idx
        return spied

    with patched(flat, "load_banks", banks_spy), patched(revindex, "load_revindex", load_spy):
        wall, launches, facts = run_gather_cli(argv, env)
    (load_wall, names), = opened
    return wall, launches, dict(facts, load_wall_s=load_wall, names=names,
                                disk_plane_loads=len(loads),
                                disk_planes_resident=all(loads) if loads else None)


def same_csv_at(what: str, got_path: str, want_path: str, want_db: str, got_db: str):
    """The gather CSV at got_path byte for byte the one at want_path, with
    the database's location (the `filename` column) that of got_db."""
    with open(want_path, "rb") as f:
        want = f.read().replace(want_db.encode(), got_db.encode())
    with open(got_path, "rb") as f:
        got = f.read()
    if got != want:
        raise AssertionError(f"{what}: the gather CSV differs from the zip's")


def revindex_end_to_end(tmp: str, world: dict, zip_csv: str) -> dict:
    """`sourmash index -F revindex` over phase 6's zip, then `gather` of
    phase 6's metagenome against the directory by each route: resident
    (the raw mins packed on the card, the default schedule) and disk planes
    (the budget below the planes' bytes: the mmapped planes stream per
    pass), the latter with the default schedule, as a user whose index
    outgrows the card runs it, and again in host rounds
    (SOURMASH_TORCH_NO_SCHEDULE=1, whose consume reads membership from the
    streamed chunks). Each CSV must be phase 6's against the zip byte for
    byte (the location column aside), the directory must hold phase 6's
    genomes in their order, counts_rows and round_dec must run in each
    route and membership_bits in the resident one and in host rounds."""
    from sourmash_tpu_torch.index.revindex import load_revindex

    rev = os.path.join(tmp, "gtdb-like.rev")
    index_wall, _launches = run_counted(["index", "-F", "revindex", rev, world["db"], "-q"], {})
    files = [os.path.join(p, f) for p, _dirs, fs in os.walk(rev) for f in fs]
    dir_bytes = sum(os.path.getsize(f) for f in files)
    plane_bytes = sum(os.path.getsize(f) for f in files if f.endswith(".npy") and "planes" in f)
    # the first load reads sigs.zip (a view-cache miss that stores it), so
    # that every route's gather below loads the directory warm
    t0 = time.time()
    cold = load_revindex(rev)
    load_wall = time.time() - t0
    if [s.name for s in cold.signatures()] != world["names"]:
        raise AssertionError("the revindex does not hold phase 6's genomes in their order")
    del cold
    log(f"  index -F revindex: {index_wall:.2f} s wall")
    log(f"  revindex directory: {dir_bytes} bytes ({plane_bytes} of planes)")
    log(f"  revindex first load (sigs.zip read, a view-cache miss): {load_wall:.2f} s")
    routes = {}
    disk = {BUDGET_ENV: str(plane_bytes // 2)}
    for route, env, scheduled, membership in (
            ("resident", {}, True, True),
            ("disk planes", disk, True, False),
            ("disk planes, host rounds", dict(disk, SOURMASH_TORCH_NO_SCHEDULE="1"), False, True)):
        out = os.path.join(tmp, f"rev_{route.replace(' ', '_').replace(',', '')}.csv")
        wall, launches, facts = gather_spied(["gather", world["qpath"], rev, "-o", out, "-q"],
                                             env)
        same_csv_at(f"gather against the revindex ({route})", out, zip_csv, world["db"], rev)
        if facts.pop("names") != world["names"]:
            raise AssertionError("the revindex does not hold phase 6's genomes in their order")
        wanted = ("counts_rows", "round_dec") + (("membership_bits",) if membership else ())
        missing = [n for n in wanted if launches[n] < 1]
        streamed = facts["disk_plane_loads"] == 1 and facts["disk_planes_resident"] is False
        if missing or streamed != (route != "resident") or facts["scheduled"] != scheduled:
            raise AssertionError(f"revindex gather ({route}): not launched {missing}, "
                                 f"facts {facts}")
        routes[route] = dict(wall_s=wall, launches={n: launches[n] for n in (
            "counts_rows", "membership_bits", "round_dec")}, **facts)
        log(f"  gather against the revindex ({route}): {wall:.2f} s wall (the directory's warm "
            f"load {facts['load_wall_s']:.2f} s), route {facts['route']}, "
            f"planes from disk {facts['disk_plane_loads']}x, launches {routes[route]['launches']}; "
            f"CSV == phase 6's against the zip")
    return dict(index_wall_s=index_wall, dir_bytes=dir_bytes, plane_bytes=plane_bytes,
                first_load_s=load_wall, routes=routes)


def sqlite_end_to_end(tmp: str, world: dict) -> dict:
    """Phase 6's first SQLITE_GENOMES genomes saved to a .sqldb by the
    port's saver and to a zip; `gather` of phase 6's metagenome against
    each, both through the flat view on the card (a device schedule,
    counts_rows and round_dec launched): the same CSV, the location
    column aside."""
    from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

    sigs = world["sigs"][:SQLITE_GENOMES]
    paths = dict(zip=os.path.join(tmp, "first.zip"), sqlite=os.path.join(tmp, "first.sqldb"))
    out = {}
    for tag, path in paths.items():
        t0 = time.time()
        with SaveSignaturesToLocation(path) as save:
            for ss in sigs:
                save.add(ss)
        save_s = time.time() - t0
        csv_path = os.path.join(tmp, f"first_{tag}.csv")
        wall, launches, facts = run_gather_cli(
            ["gather", world["qpath"], path, "-o", csv_path, "-q"], {})
        if not facts["scheduled"] or min(launches["counts_rows"], launches["round_dec"]) < 1:
            raise AssertionError(f"gather against the {tag} of {len(sigs)}: not the flat view "
                                 f"on the card ({facts}, {launches})")
        out[tag] = dict(save_s=save_s, bytes=os.path.getsize(path), wall_s=wall, csv=csv_path,
                        launches={n: launches[n] for n in ("counts_rows", "membership_bits",
                                                           "round_dec")}, route=facts["route"])
        log(f"  {tag} of {len(sigs)} genomes: saved in {save_s:.2f} s ({out[tag]['bytes']} bytes), "
            f"gather {wall:.2f} s wall, route {facts['route']}, launches {out[tag]['launches']}")
    same_csv_at("gather against the .sqldb", out["sqlite"]["csv"], out["zip"]["csv"],
                paths["zip"], paths["sqlite"])
    log("  the .sqldb's gather CSV == the zip's")
    return {tag: {k: v for k, v in r.items() if k != "csv"} for tag, r in out.items()}


def persistent_end_to_end(rng, tmp: str, world: dict, zip_csv: str) -> dict:
    "Phase 10: fromfile, the revindex routes, sqlite and the view cache's totals."
    t0 = time.time()
    out = dict(fromfile=fromfile_end_to_end(rng, tmp))
    log(f"  fromfile part: {time.time() - t0:.1f} s")
    t0 = time.time()
    out["revindex"] = revindex_end_to_end(tmp, world, zip_csv)
    log(f"  revindex part: {time.time() - t0:.1f} s")
    t0 = time.time()
    out["sqlite"] = sqlite_end_to_end(tmp, world)
    log(f"  sqlite part: {time.time() - t0:.1f} s")
    out["view_cache"] = view_cache_line("phase 10")
    return out


# -- phase 11: SBTs and LCA databases ----------------------------------------

LCA_RANKS = ("superkingdom", "phylum", "class", "order", "family", "genus", "species", "strain")


def clade_taxonomy(path: str, names: list):
    """A taxonomy spreadsheet for make_collection's genomes ('genome_N
    clade_C'): each clade a genus of up to 3 species, the higher ranks
    folding clades together; the identifier is the name's first word, as
    `lca index --split-identifiers` reads it."""
    with open(path, "w") as f:
        f.write(",".join(("identifiers",) + LCA_RANKS) + "\n")
        for name in names:
            ident, clade = name.split()
            c, n = int(clade.split("_")[1]), int(ident.split("_")[1])
            f.write(f"{ident},d__Bacteria,p__P{c % 7},c__C{c % 13},o__O{c % 29},f__F{c % 61},"
                    f"g__G{c},s__G{c} sp{n % 3},\n")


def gather_against(what: str, db: str, world: dict, first_zip: str, zip_csv: str) -> dict:
    """`gather` of phase 6's metagenome against db, launch counters set to 0
    just before and read just after: the scheduled flat view on the card
    (counts_rows and round_dec launched), and the CSV phase 10's against
    the zip of the same genomes byte for byte, the location column aside."""
    csv_path = db + ".csv"
    wall, launches, facts = run_gather_cli(["gather", world["qpath"], db, "-o", csv_path, "-q"],
                                           {})
    if not facts["scheduled"] or min(launches["counts_rows"], launches["round_dec"]) < 1:
        raise AssertionError(f"gather against the {what}: not the flat view on the card "
                             f"({facts}, {launches})")
    same_csv_at(f"gather against the {what}", csv_path, zip_csv, first_zip, db)
    kept = {n: launches[n] for n in ("counts_rows", "membership_bits", "round_dec")}
    log(f"  gather against the {what}: {wall:.2f} s wall, route {facts['route']}, "
        f"launches {kept}; CSV == the zip's")
    return dict(wall_s=wall, launches=kept, route=facts["route"], rounds=len(read_csv(csv_path)))


def sbt_search(tmp: str, world: dict, sbt: str) -> dict:
    """`search` of one genome of a clade of >= 5 against the tree: the
    pruned walk on the host. Its rows must be exactly the genomes of the
    tree whose numpy Jaccard (from np.isin overlaps) passes search's 0.08
    threshold, with those scores."""
    mins_list = world["mins_list"][:SQLITE_GENOMES]
    names = world["names"][:SQLITE_GENOMES]
    clade = np.array([int(n.rsplit("clade_", 1)[1]) for n in names])
    gi = int(np.flatnonzero(np.bincount(clade)[clade] >= 5)[0])
    g = mins_list[gi]
    qpath = os.path.join(tmp, "sbt_genome.sig")
    save_sig(qpath, g, "query genome")
    csv_path = os.path.join(tmp, "sbt_search.csv")
    wall, launches = run_counted(["search", qpath, sbt, "-o", csv_path, "-q"], {})
    want = {}
    for name, m in zip(names, mins_list):
        inter = int(np.count_nonzero(np.isin(m, g, assume_unique=True)))
        if inter and inter / (len(g) + len(m) - inter) >= 0.08:
            want[name] = inter / (len(g) + len(m) - inter)
    got = {row["name"]: float(row["similarity"]) for row in read_csv(csv_path)}
    if got != want or len(got) < 2:
        raise AssertionError(f"search against the SBT: {len(got)} rows, numpy {len(want)}; "
                             f"differ at {sorted(set(got.items()) ^ set(want.items()))[:4]}")
    launched = {n: c for n, c in launches.items() if c}
    log(f"  search of genome {gi} (clade of {int(np.sum(clade == clade[gi]))}) against the SBT: "
        f"{wall:.2f} s wall, {len(got)} rows equal numpy's Jaccard; launches {launched}")
    return dict(wall_s=wall, rows=len(got), launches=launched)


def sbt_lca_end_to_end(tmp: str, world: dict) -> dict:
    """Phase 11: `index` builds an SBT (`.sbt.zip`) and `lca index` an LCA
    database (`.lca.json`, a taxonomy from make_collection's clades,
    `--scaled 1000`) from phase 10's zip of SQLITE_GENOMES genomes, each
    command with the launch counters set to 0 just before and read just
    after; gather of phase 6's metagenome against each (gather_against) and
    search of a genome against the tree (sbt_search)."""
    first_zip = os.path.join(tmp, "first.zip")
    zip_csv = os.path.join(tmp, "first_zip.csv")
    out = {}
    t0 = time.time()
    sbt = os.path.join(tmp, "db.sbt.zip")
    wall, _launches = run_counted(["index", sbt, first_zip, "-q"], {})
    out["sbt"] = dict(index_wall_s=wall, bytes=os.path.getsize(sbt))
    log(f"  index (SBT) of {SQLITE_GENOMES} genomes: {wall:.2f} s wall, "
        f"{out['sbt']['bytes']} bytes")
    out["sbt"]["gather"] = gather_against("SBT", sbt, world, first_zip, zip_csv)
    out["sbt"]["search"] = sbt_search(tmp, world, sbt)
    out["sbt"]["part_s"] = time.time() - t0
    log(f"  SBT part: {out['sbt']['part_s']:.1f} s")

    t0 = time.time()
    tax = os.path.join(tmp, "taxonomy.csv")
    clade_taxonomy(tax, world["names"][:SQLITE_GENOMES])
    lca = os.path.join(tmp, "db.lca.json")
    wall, _launches = run_counted(["lca", "index", tax, lca, first_zip, "--scaled",
                                   str(GATHER_SCALED), "--split-identifiers", "-q"], {})
    out["lca"] = dict(index_wall_s=wall, bytes=os.path.getsize(lca))
    log(f"  lca index of {SQLITE_GENOMES} genomes: {wall:.2f} s wall, {out['lca']['bytes']} bytes")
    out["lca"]["gather"] = gather_against("LCA database", lca, world, first_zip, zip_csv)
    out["lca"]["part_s"] = time.time() - t0
    log(f"  LCA part: {out['lca']['part_s']:.1f} s")
    return out


# -- phase 2 (shard_match) and phase 12: the multi-device layer on one card ----

# phase 12 runs the sharded paths on meshes that name the card several
# times: logical shards on one card, run one after another (no multi-GPU
# rate); with more than one card, (a) and (b) run over the distinct cards too
SHARDED_SHARDS = 4  # (a): gather's sharded round scan
DATA_DEVICES = (2,)  # (b): multigather's data-parallel scan (3 devices cut for the time limit)
PROGRAM_MESH = (2, 2)  # (c): the fused program's (data, shards) mesh
SKETCH_ROWS, SKETCH_DATA = 4, 2  # (d): rows of phase 3's kind over data devices
SCAN_ROUNDS = 64  # rounds timed for ms per round
SHARD_MATCH_STEP = 16  # rows of a plain shard_match call on the card


def not_launched(launches: dict, *names) -> list:
    "Which of the kernels `names` did not launch (none, in a CPU rehearsal)."
    return [n for n in names if launches[n] < 1 and GATHER_DEVICE == "cuda"]


def _as_args(qhi, qlo, alive, Shi, Slo, Scnt) -> tuple:
    "Packed numpy planes as shard_match's arguments on GATHER_DEVICE."
    import torch

    from sourmash_tpu_torch.ops.bucketed import pack_bits_u32, to_torch

    dev = torch.device(GATHER_DEVICE)
    return (to_torch(qhi, dev), to_torch(qlo, dev),
            pack_bits_u32(torch.from_numpy(alive).to(dev)), to_torch(Shi, dev),
            to_torch(Slo, dev), torch.from_numpy(Scnt).to(dev))


def _set_alive(qhi, qlo, alive, q: int, values):
    "Mark query q's slots holding any of `values` alive."
    v = (qhi[q].astype(np.uint64) << np.uint64(32)) | qlo[q]
    alive[q] |= np.isin(v, np.asarray(values, dtype=np.uint64))


def shard_match_edge_inputs(rng):
    """Edge planes for shard_match (B = 256): 13 rows of uneven loads, rows
    with empty buckets, one bucket 20 deep, the hash 2^64-1 in a row and a
    query, a value repeated in a row's bucket (no pack gives one: the
    kernel skips the repeat); 4 queries with holes in their alive masks:
    query 0 with a bucket of dq = 40 slots, every one alive (the table's
    sized capacity), query 1 matching nothing, query 2 half of every row,
    query 3 query 2 with every slot dead; values alive in queries 0 and 2
    both."""
    from sourmash_tpu_torch.parallel import pack_query_batch, pack_shard_planes

    B = 256
    sizes = [64, 5, 200, 0, 64, 64, 1, 64, 64, 300, 64, 2, 64]
    mins = [np.unique(rng.integers(1, 1 << 40, size=n, dtype=np.uint64)) for n in sizes]
    crowd = np.arange(1, 21, dtype=np.uint64) * np.uint64(1 << 20)  # one bucket, 20 deep
    full = np.uint64(77) + (np.arange(1, 41, dtype=np.uint64) << np.uint64(33))  # bucket 77
    mins[0] = np.unique(np.r_[mins[0], crowd, np.uint64(2**64 - 1)])
    mins[5] = np.unique(np.r_[mins[5], full[::3]])
    both = mins[0][:8]
    half = np.unique(np.concatenate([m[: len(m) // 2] for m in mins]))
    queries = [np.unique(np.r_[mins[0][:40], crowd[:12], mins[9][:100], full,
                              np.uint64(2**64 - 1)]),
               np.arange(2**41, 2**41 + 32, dtype=np.uint64), half, half]
    Shi, Slo, Scnt, B = pack_shard_planes(mins, 1, B=B)
    # row 4 repeats its first slot of one bucket whose value query 2 holds
    v = mins[4][0]
    b = int(v & np.uint64(B - 1))
    k = int(Scnt[4, b])
    Shi[4, k, b], Slo[4, k, b] = Shi[4, 0, b], Slo[4, 0, b]
    Scnt[4, b] += 1
    qhi, qlo, alive = pack_query_batch(queries, B)
    occupied = alive.copy()
    alive &= rng.random(alive.shape) < 0.85
    alive[3] = False
    alive[0, :, 77] = occupied[0, :, 77]
    if int(occupied[0, :, 77].sum()) != qhi.shape[1]:
        raise AssertionError("the full bucket does not set dq")
    for q in (0, 2):
        _set_alive(qhi, qlo, alive, q, np.r_[both, v])
    alive &= occupied
    return _as_args(qhi, qlo, alive, Shi, Slo, Scnt)


# csrc/parallel.cu's kStageWords: the M words a match block stages at a time
SHARD_MATCH_STAGE_WORDS = 28160


def shard_match_stage_inputs(rng):
    """Planes whose (query, row) lines pass one block's staging: B = 4096
    and a query bucket 300 deep (dq = 300 past the 220 slots a block
    stages), rows matching it in both stages of slots and only in the
    second; 6 rows, 2 queries."""
    from sourmash_tpu_torch.parallel import pack_query_batch, pack_shard_planes

    B = 4096
    deep = np.uint64(1234) + (np.arange(1, 301, dtype=np.uint64) << np.uint64(12))
    mins = [np.unique(rng.integers(1, 1 << 40, size=n, dtype=np.uint64))
            for n in (3000, 500, 0, 4000, 64, 2000)]
    mins[0] = np.unique(np.r_[mins[0], deep[::2]])
    mins[3] = np.unique(np.r_[mins[3], deep[250:]])
    queries = [np.unique(np.r_[deep, mins[0][:1000], mins[3][::2]]),
               np.unique(np.r_[mins[5], deep[:10]])]
    Shi, Slo, Scnt, B = pack_shard_planes(mins, 1, B=B)
    qhi, qlo, alive = pack_query_batch(queries, B)
    alive &= rng.random(alive.shape) < 0.9
    return _as_args(qhi, qlo, alive, Shi, Slo, Scnt)


def shard_match_deep_inputs(rng):
    """A metagenome-sized query against small sketches at B = 128, as
    pack_shard_planes picks B for a collection of viral genomes: 1.4 M
    hashes (dq past the 8,192 query slots of one table, so the tables are
    built in two ranges and the counts added up) and one of 100,000; 6
    rows of 10-300 hashes, a third of each from the large query."""
    from sourmash_tpu_torch.parallel import pack_query_batch, pack_shard_planes

    big = np.unique(rng.integers(1, 2**63, size=1_400_000, dtype=np.uint64))
    mins = [np.unique(np.r_[rng.choice(big, n // 3, replace=False),
                            rng.integers(1, 2**63, size=n - n // 3, dtype=np.uint64)])
            for n in (10, 300, 120, 45, 200, 80)]
    queries = [big, np.unique(np.r_[big[::14], mins[1]])]
    Shi, Slo, Scnt, B = pack_shard_planes(mins, 1, B=128)
    qhi, qlo, alive = pack_query_batch(queries, B)
    alive &= rng.random(alive.shape) < 0.9
    return _as_args(qhi, qlo, alive, Shi, Slo, Scnt)


def shard_match_wide_inputs(rng):
    """B = 2^20, where one slot's line of B/32 words passes one block's
    staging (the words go out in two stages): a query of 300,000 hashes
    against 3 rows of 50,000, half of two of them from the query."""
    from sourmash_tpu_torch.parallel import pack_query_batch, pack_shard_planes

    q = np.unique(rng.integers(1, 2**63, size=300_000, dtype=np.uint64))
    mins = [np.unique(np.r_[q[i::7][:25_000], rng.integers(1, 2**63, size=25_000,
                                                           dtype=np.uint64)])
            for i in range(2)] + [np.unique(rng.integers(1, 2**63, size=50_000,
                                                         dtype=np.uint64))]
    Shi, Slo, Scnt, B = pack_shard_planes(mins, 1, B=1 << 20)
    qhi, qlo, alive = pack_query_batch([q], B)
    alive &= rng.random(alive.shape) < 0.9
    return _as_args(qhi, qlo, alive, Shi, Slo, Scnt)


def shard_match_many_inputs(rng, bq: int = 65_537):
    """bq = 65,537 one-hash queries at B = 32 (past the 65,535 queries of
    one launch's grid), each hash drawn from 3 rows' or from elsewhere."""
    from sourmash_tpu_torch.parallel import pack_shard_planes

    mins = [np.unique(rng.integers(1, 2**63, size=40, dtype=np.uint64)) for _ in range(3)]
    Shi, Slo, Scnt, B = pack_shard_planes(mins, 1, B=32)
    pool = np.r_[np.concatenate(mins), rng.integers(1, 2**63, size=120, dtype=np.uint64)]
    v = rng.choice(pool, bq)
    b = (v & np.uint64(B - 1)).astype(np.int64)
    qhi = np.zeros((bq, 1, B), dtype=np.uint32)
    qlo = np.zeros((bq, 1, B), dtype=np.uint32)
    alive = np.zeros((bq, 1, B), dtype=bool)
    qhi[np.arange(bq), 0, b] = (v >> np.uint64(32)).astype(np.uint32)
    qlo[np.arange(bq), 0, b] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    alive[np.arange(bq), 0, b] = rng.random(bq) < 0.9
    return _as_args(qhi, qlo, alive, Shi, Slo, Scnt)


def shard_match_plain_chunks(args, bits: bool):
    "shard_match_plain over row slices of SHARD_MATCH_STEP: (counts, M or None)."
    import torch

    from sourmash_tpu_torch.ops import cuda_gather as cg

    Qhi, Qlo, A, Shi, Slo, Scnt = args
    counts, words = [], []
    for a in range(0, Shi.shape[0], SHARD_MATCH_STEP):
        s = slice(a, min(a + SHARD_MATCH_STEP, Shi.shape[0]))
        got = cg.shard_match_plain(Qhi, Qlo, A, Shi[s].contiguous(), Slo[s].contiguous(),
                                   Scnt[s].contiguous(), bits=bits)
        counts.append(got[0] if bits else got)
        if bits:
            words.append(got[1])
    return torch.cat(counts, dim=1), torch.cat(words, dim=1) if bits else None


def hold_shard_match(what: str, args):
    "shard_match against its plain version, bit for bit: counts only, and with the words."
    from sourmash_tpu_torch.ops import cuda_gather as cg

    counts, M = cg.shard_match(*args, bits=True)
    want_counts, want_M = shard_match_plain_chunks(args, True)
    exact(f"shard_match counts ({what})", counts, want_counts)
    exact(f"shard_match words ({what})", M, want_M)
    exact(f"shard_match counts only ({what})", cg.shard_match(*args), want_counts)
    return counts, M


def check_shard_match_edges(rng) -> dict:
    """Phase 2's shard_match, bit for bit against the plain version: the
    edge planes of shard_match_edge_inputs (counts only and with words),
    the builder's in-place form (two launches into one buffer at a row
    offset), the gather round's winner (1 query x 1 row, with words) and
    its decrement (counts only, alive = the winners' words), and the sizes
    past one launch's: lines in stages of slots and of words, tables in
    ranges of slots, queries in two launches."""
    import torch

    from sourmash_tpu_torch.ops import cuda_gather as cg

    args = shard_match_edge_inputs(rng)
    counts, M = hold_shard_match("edge rows", args)
    Qhi, Qlo, A, Shi, Slo, Scnt = args
    rows = Shi.shape[0]
    cbuf = torch.full((Qhi.shape[0], rows + 3), 7, dtype=torch.int32, device=Qhi.device)
    Mbuf = torch.full((Qhi.shape[0], rows + 3) + tuple(M.shape[2:]), 7, dtype=torch.int32,
                      device=Qhi.device)
    for a, b in ((0, 6), (6, rows)):
        cg.shard_match(Qhi, Qlo, A, Shi[a:b], Slo[a:b], Scnt[a:b], out=(cbuf, Mbuf), row0=a + 3)
    exact("shard_match in place (counts)", cbuf[:, 3:], counts)
    exact("shard_match in place (words)", Mbuf[:, 3:], M)
    if not bool((cbuf[:, :3] == 7).all()) or not bool((Mbuf[:, :3] == 7).all()):
        raise AssertionError("shard_match wrote outside its rows")
    if int(counts[0].sum()) == 0 or int(counts[2].sum()) == 0 or int(counts[1].sum()) \
            or int(counts[3].sum()):
        raise AssertionError(f"shard_match edge counts {counts.tolist()}")
    # the gather round: each query's winner row, 1 x 1 with words, then the
    # decrement of every row by the winners' words
    best = torch.argmax(counts, dim=1).tolist()
    for q, r in enumerate(best):
        one = (Qhi[q : q + 1], Qlo[q : q + 1], A[q : q + 1], Shi[r : r + 1], Slo[r : r + 1],
               Scnt[r : r + 1])
        c1, m1 = cg.shard_match(*one, bits=True)
        exact(f"shard_match winner of query {q} (counts)", c1, counts[q : q + 1, r : r + 1])
        exact(f"shard_match winner of query {q} (words)", m1, M[q : q + 1, r : r + 1])
    removed = torch.stack([M[q, r] for q, r in enumerate(best)]).contiguous()
    dec = (Qhi, Qlo, removed, Shi, Slo, Scnt)
    exact("shard_match decrement", cg.shard_match(*dec), shard_match_plain_chunks(dec, False)[0])
    table_bytes = cg.shard_match_table_bytes(*Qhi.shape)
    # past one launch's sizes: staged in stages of slots, tables in ranges of
    # slots, words in stages of words, queries in launches
    sizes = {}
    for what, make, past in (
            ("lines in stages of slots", shard_match_stage_inputs,
             lambda dq, B, bq: dq * (B // 32) > SHARD_MATCH_STAGE_WORDS),
            ("tables in ranges of slots", shard_match_deep_inputs,
             lambda dq, B, bq: dq > cg.SHARD_MATCH_RANGE_SLOTS),
            ("lines in stages of words", shard_match_wide_inputs,
             lambda dq, B, bq: B // 32 > SHARD_MATCH_STAGE_WORDS),
            ("queries in two launches", shard_match_many_inputs,
             lambda dq, B, bq: bq > 65535)):
        more = make(rng)
        bq, dq, B = more[0].shape
        if not past(dq, B, bq):
            raise AssertionError(f"the inputs of {what!r}, [{bq}, {dq}, {B}], take one")
        got, _M = hold_shard_match(what, more)
        if int(got.sum()) == 0:
            raise AssertionError(f"shard_match: {what} matched nothing")
        sizes[what] = dict(shape=[bq, dq, B], rows=int(more[3].shape[0]),
                           matched=int(got.sum()))
        del more, got, _M
    log(f"  shard_match: equals its plain version on [{Qhi.shape[0]}, {Qhi.shape[1]}, "
        f"{Qhi.shape[2]}] x {rows} edge rows (d = {Shi.shape[1]}, 2^64-1, empty buckets, a "
        f"repeated row value, holes, a dead query, a bucket of dq alive slots; tables of "
        f"{table_bytes} bytes), counts only and with words, in place at a row offset, as the "
        f"round's winners and decrement, and past one launch's sizes: "
        + "; ".join(f"{w} ({v['shape']} x {v['rows']} rows, {v['matched']} matches)"
                    for w, v in sizes.items()))
    return dict(edge_rows=rows, edge_depth=Shi.shape[1], matched=int(counts.sum()),
                table_bytes=table_bytes, past_one_launch=sizes)


def shard_match_bound(args, bits: bool, clock_hz: float) -> tuple:
    """(bound ms, by, bytes) of one shard_match on the lookup model, this
    run's data: each side's occupancy (the query's alive words, the rows'
    Scnt) read once, its alive or occupied slots' limbs once, the counts
    and, with `bits`, M's words written once; an op an alive slot (its
    insertion) and a query an occupied row slot (its probe)."""
    import torch

    from sourmash_tpu_torch.ops.bucketed import unpack_bits_u32

    Qhi, _Qlo, A, Shi, _Slo, Scnt = args
    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    n_alive = int(unpack_bits_u32(A).sum(dtype=torch.int64))
    n_occ = int(Scnt.to(torch.int64).clamp(max=d).sum())
    nbytes = A.numel() * 4 + Scnt.numel() + 8 * (n_alive + n_occ) + bq * rows * 4
    if bits:
        nbytes += bq * rows * dq * (B // 32) * 4
    bms, by = bound_ms(nbytes, 0, n_alive + bq * n_occ, clock_hz)
    return bms, by, nbytes


def broadcast_bound(args, bits: bool, clock_hz: float) -> tuple:
    """(bound ms, slot pairs) of shard_match on the broadcast compare's
    model (bound_ms_before): each pair of an alive query slot and an
    occupied row slot of the same bucket compared (3 ops), every plane read
    once, the output written once."""
    import torch

    from sourmash_tpu_torch.ops.bucketed import unpack_bits_u32

    Qhi, _Qlo, A, Shi, _Slo, Scnt = args
    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    alive_b = unpack_bits_u32(A).sum(dim=1, dtype=torch.int64).to(torch.float64)  # [bq, B]
    occ_b = Scnt.to(torch.int64).clamp(max=d).sum(dim=0).to(torch.float64)  # [B]
    pairs = int((alive_b @ occ_b).sum())
    nbytes = (2 * Qhi.numel() + A.numel() + 2 * Shi.numel() + bq * rows) * 4 + Scnt.numel()
    if bits:
        nbytes += bq * rows * dq * (B // 32) * 4
    return bound_ms(nbytes, 0, 3 * pairs, clock_hz)[0], pairs


def decrement_args(args, counts, M) -> tuple:
    """The gather round's decrement at args' shape: alive = the removed
    slots, each query's winner row's words (the row of its largest count)."""
    import torch

    best = torch.argmax(counts, dim=1).tolist()
    removed = torch.stack([M[q, r] for q, r in enumerate(best)]).contiguous()
    return (args[0], args[1], removed, *args[3:])


def time_shard_match(args, mins_rows, queries, reps: int, clock_hz: float) -> dict:
    """shard_match at the fused program's chunk shape, bit for bit against
    its plain version, timed with words (the builder) and counts only (the
    counter), and counts only at the decrement's shape (alive = each
    query's winner's words), beside its plain version, its bound (the
    lookup model; the broadcast compare's as bound_ms_before) and the
    library call of the counts (torch.sparse.mm of the incidence rows)."""
    from sourmash_tpu_torch.ops import cuda_gather as cg

    t0 = time.time()
    counts, M = hold_shard_match("the fused program's chunk", args)
    hold_s = time.time() - t0
    dec = decrement_args(args, counts, M)
    del M
    exact("shard_match decrement (chunk)", cg.shard_match(*dec),
          shard_match_plain_chunks(dec, False)[0])
    Qhi, _Qlo, _A, Shi, _Slo, _Scnt = args
    bq, dq, B = Qhi.shape
    rows, d, _B = Shi.shape
    ms, b2b = kernel_times(lambda: cg.shard_match(*args, bits=True), reps)
    ms_c, b2b_c = kernel_times(lambda: cg.shard_match(*args), reps)
    ms_d, b2b_d = kernel_times(lambda: cg.shard_match(*dec), reps)
    plain = time_ms(lambda: shard_match_plain_chunks(args, True), 1, warmup=0)
    bms, by, nbytes = shard_match_bound(args, True, clock_hz)
    bms_c, by_c, nbytes_c = shard_match_bound(args, False, clock_hz)
    bms_d, by_d, _nb = shard_match_bound(dec, False, clock_hz)
    before, pairs = broadcast_bound(args, True, clock_hz)
    before_c, _p = broadcast_bound(args, False, clock_hz)
    lib = sparse_product_ms(queries, mins_rows, reps, counts.cpu().numpy())
    matched = int(counts.sum())
    out = dict(ms=ms, b2b_ms=b2b, plain_ms=plain, bound_ms=bms, bound_by=by, bound_bytes=nbytes,
               bound_ms_before=before, max_abs_err=0.0, library_ms=None,
               counts_only=dict(ms=ms_c, b2b_ms=b2b_c, bound_ms=bms_c, bound_by=by_c,
                                bound_bytes=nbytes_c, bound_ms_before=before_c, library_ms=lib),
               decrement=dict(ms=ms_d, b2b_ms=b2b_d, bound_ms=bms_d, bound_by=by_d,
                              removed=int(counts.max(dim=1).values.sum())),
               bq=bq, dq=dq, B=B, rows=rows, d=d, pairs=pairs, matched=matched, hold_s=hold_s)
    log(f"  shard_match [{bq}, {dq}, {B}] x [{rows}, {d}, {B}] ({pairs} slot pairs, {matched} "
        f"matches): equals its plain version ({hold_s:.1f} s); with words {ms:.4f} ms/launch ({b2b:.4f} back to back), bound "
        f"{bms:.4f} ms ({by}; the broadcast model's {before:.4f}); counts only {ms_c:.4f} "
        f"({b2b_c:.4f}), bound {bms_c:.4f} ms ({by_c}; the broadcast model's {before_c:.4f}), "
        f"torch.sparse.mm of the counts {lib} ms (its work: the matches of every query hash); "
        f"decrement (alive = the winners' {out['decrement']['removed']} slots) "
        f"{ms_d:.4f} ({b2b_d:.4f}), bound {bms_d:.4f} ms ({by_d}); plain {plain:.1f} ms")
    return out


AGAINST_ROWS = 4096  # the fused program's chunk
AGAINST_SEED = 20261018
AGAINST_REPS = 10


def shard_match_timing(reps: int, clock_hz: float) -> dict:
    """time_shard_match at the fused program's chunk shape through the
    sourmash_tpu_torch this process imports: AGAINST_ROWS genomes of phase
    6's generator against 2 queries of GATHER_QUERY_HASHES
    (make_gather_query), packed as phase 12 (c) packs them, from
    AGAINST_SEED. It calls only the package's public shard_match and
    shard_match_plain, so it times any tree's kernel through that tree's
    own wrapper."""
    from sourmash_tpu_torch.parallel import pack_query_batch, pack_shard_planes

    rng = np.random.default_rng(AGAINST_SEED)
    t0 = time.time()
    _sigs, mins_list, _clades = make_collection(rng, AGAINST_ROWS)
    queries = [make_gather_query(rng, mins_list, GATHER_QUERY_HASHES)[0] for _ in range(2)]
    Shi, Slo, Scnt, B = pack_shard_planes(mins_list, 1)
    args = _as_args(*pack_query_batch(queries, B), Shi, Slo, Scnt)
    del Shi, Slo
    log(f"  {AGAINST_ROWS} genomes and 2 queries of {[len(q) for q in queries]} hashes made and "
        f"packed in {time.time() - t0:.1f} s")
    return time_shard_match(args, mins_list, queries, reps, clock_hz)


def shard_match_against(other_root: str) -> dict:
    """shard_match_timing of `other_root`'s checkout and of this one, each in
    a process of its own (this script with --shard-match-timing ROOT, which
    imports ROOT's sourmash_tpu_torch and builds its kernel there), in the
    order other, this, this, other; the back-to-back times of each case
    averaged over a tree's two runs."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate((other_root, here, here, other_root)):
            path = os.path.join(tmp, f"run{i}.json")
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--shard-match-timing", os.path.abspath(root),
                                   "--json", path],
                                  capture_output=True, text=True)
            for line in (proc.stdout + proc.stderr).splitlines():
                log(f"  [{'other' if root == other_root else 'this'}] {line}")
            if proc.returncode != 0:
                raise AssertionError(f"--shard-match-timing {root} failed ({proc.returncode})")
            with open(path) as f:
                runs.append(json.load(f))
    cases = {"with words": lambda r: r["b2b_ms"], "counts only": lambda r: r["counts_only"]["b2b_ms"],
             "decrement": lambda r: r["decrement"]["b2b_ms"],
             "torch.sparse.mm": lambda r: r["counts_only"]["library_ms"]}
    times = {}
    for case, get in cases.items():
        got = [get(r) for r in runs]
        times[case] = dict(runs=got)
        if None not in got:
            times[case].update(other_ms=(got[0] + got[3]) / 2, this_ms=(got[1] + got[2]) / 2)
        log(f"  shard_match {case}, back to back (other, this, this, other): "
            + ", ".join("none" if t is None else f"{t:.4f}" for t in got) + " ms")
    return dict(against=times, runs=runs, other_root=other_root)


def sync_free(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): a host
    synchronisation inside it raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def gather_query_sig(q: np.ndarray, name: str):
    from sourmash_tpu_torch import SourmashSignature, minhash_from_arrays

    params = dict(ksize=31, moltype="DNA", num=0, scaled=GATHER_SCALED, seed=42,
                  track_abundance=False)
    return SourmashSignature(minhash_from_arrays(params, q, None), name=name)


def scan_ms_per_round(built, dev) -> dict:
    """ms per round of the same scan inputs (phase 6's host-built matrix)
    through `_schedule_scan` and the sharded scan at 1 and SHARDED_SHARDS
    logical shards on one card, SCAN_ROUNDS rounds each (the same winners
    required), and the sharded scan's host synchronisations inside its
    rounds (set_sync_debug_mode)."""
    import torch

    from sourmash_tpu_torch.index.flat import _schedule_scan
    from sourmash_tpu_torch.ops.bucketed import to_torch
    from sourmash_tpu_torch.parallel import get_mesh, make_sharded_bitset_scan, shard_rows

    rows, counts, alive_p, thresh, _nk, M_new = built
    k = len(rows)
    alive = to_torch(alive_p, dev)
    out, ref = {}, None
    for n in (None, 1, SHARDED_SHARDS):
        if n is None:
            Mj = to_torch(M_new, dev)
            carry = (alive, torch.from_numpy(counts).to(dev))

            def run():
                return _schedule_scan(Mj, carry, thresh, SCAN_ROUNDS)
        else:
            mesh = get_mesh(1, n, devices=[dev] * n)
            k_pad = -(-k // n) * n
            M = np.zeros((k_pad, M_new.shape[1]), dtype=np.uint32)
            M[:k] = M_new
            c = np.zeros(k_pad, dtype=np.int32)
            c[:k] = counts
            Ms, cs = shard_rows(mesh, to_torch(M)), shard_rows(mesh, torch.from_numpy(c))
            scan = make_sharded_bitset_scan(mesh, SCAN_ROUNDS)

            def run():
                return scan(Ms, alive, cs, thresh)
        run()
        torch.cuda.synchronize()
        t0 = time.time()
        (_a, _c), (bests, _bcs) = run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        tag = "_schedule_scan" if n is None else f"sharded, {n} logical shard{'s' * (n > 1)}"
        out[tag] = dict(ms_per_round=wall * 1e3 / SCAN_ROUNDS)
        got = bests.cpu().numpy()
        if ref is None:
            ref = got
        elif not np.array_equal(got, ref):
            raise AssertionError(f"{tag}: other winners than _schedule_scan's")
        if n == SHARDED_SHARDS:
            sync_free(run)  # no host synchronisation in its rounds, or this raises
            out[tag]["host_syncs"] = 0
    log("  ms per round (logical shards on one card, run one after another; no multi-GPU "
        f"rate), {SCAN_ROUNDS} rounds of phase 6's [{k}, {M_new.shape[1]}] matrix: "
        + ", ".join(f"{t} {v['ms_per_round']:.4f}" for t, v in out.items())
        + f"; no host synchronisation in {SCAN_ROUNDS} sharded rounds (set_sync_debug_mode "
          f"\"error\")")
    return out


def parallel_gather(world: dict, index, dev, meshes: dict) -> dict:
    """(a) `DeviceGatherSchedule.compute` of phase 6's metagenome against
    its collection on each mesh of `meshes`, and over two overlapping
    collections (cross-database ties): every schedule equal to the
    one-device one."""
    from sourmash_tpu_torch.index.flat import FlatIndex, schedule_device_gather

    th = GATHER_THRESHOLD_BP
    qsig = gather_query_sig(world["q"], "metagenome")
    sigs = world["sigs"]
    half, span = len(sigs) // 2, len(sigs) // 10
    # genomes [half - span, half + span) in both collections: each of their
    # rounds is a tie across the two, which the first-listed must win
    overlap = [FlatIndex(sigs[: half + span], device=dev),
               FlatIndex(sigs[half - span :], device=dev)]
    out = {}
    for case, indexes in (("one collection", [index]), ("two collections", overlap)):
        counters = [ix.counter_gather(qsig, th) for ix in indexes]

        def compute(devices):
            coord = schedule_device_gather(counters)
            _r, wall, launches = call_counted(lambda: coord.compute(th, devices=devices), {})
            return coord, dict(wall_s=wall, route=coord.route, rounds=len(coord._sched),
                               truncated=coord.truncated,
                               launches={n: launches[n] for n in ("round_dec", "shard_match",
                                                                  "membership_bits")})

        one, facts = compute([dev])
        runs = {"one device": facts}
        for tag, devices in meshes.items():
            coord, facts = compute(devices)
            if coord._sched != one._sched or coord.truncated != one.truncated:
                raise AssertionError(f"(a) {case}, {tag}: the sharded schedule differs from "
                                     f"the one-device one")
            if coord.route != "sharded host membership" or not_launched(facts["launches"],
                                                                        "round_dec"):
                raise AssertionError(f"(a) {case}, {tag}: {facts}")
            runs[tag] = facts
        if case == "two collections":
            ties = sum(ci == 0 and ds >= half - span for ci, ds, _c in one._sched)
            lost = sum(ci == 1 and ds < 2 * span for ci, ds, _c in one._sched)
            runs["cross-collection ties"] = ties
            if {ci for ci, _ds, _c in one._sched} != {0, 1} or not ties or lost:
                raise AssertionError(f"(a) two collections: rounds {one._sched[:8]}..., "
                                     f"{ties} cross-collection ties")
        out[case] = runs
        log(f"  (a) gather's schedule, {case}, {len(one._sched)} rounds"
            f"{' (truncated by the cap)' if one.truncated else ''}, equal on every mesh: "
            + "; ".join(f"{t} {r['wall_s']:.2f} s ({r['route']}, launches {r['launches']})"
                        for t, r in runs.items() if isinstance(r, dict))
            + (f"; {runs['cross-collection ties']} rounds won by a genome of both collections"
               if case == "two collections" else ""))
        if case == "one collection":
            coord = schedule_device_gather(counters)
            built = coord._build_inputs(th, dev_cached=None, build_mats=True)
            out["ms_per_round"] = scan_ms_per_round(built, dev)
    return out


def parallel_multigather(world: dict, index, dev, meshes: dict) -> tuple:
    """(b) `compute_schedules_batch` of phase 8's samples in blocks of 4
    (multigather's block at their size) on one device and on each data
    mesh of `meshes`: every schedule equal to the one-device one."""
    from sourmash_tpu_torch.index.flat import compute_schedules_batch, schedule_device_gather

    th = GATHER_THRESHOLD_BP
    counters = [index.counter_gather(gather_query_sig(q, f"sample {i}"), th)
                for i, q in enumerate(world["samples"])]
    runs, scheds, truncated = {}, {}, None
    for tag, devices in {"one device": [dev], **meshes}.items():
        coords = [schedule_device_gather([c]) for c in counters]
        _r, wall, launches = call_counted(
            lambda: compute_schedules_batch(coords, th, block=4, devices=devices), {})
        scheds[tag] = [c._sched for c in coords]
        if truncated is None:
            truncated = [c.truncated for c in coords]
        runs[tag] = dict(wall_s=wall, routes=sorted({c.route for c in coords if c.route}),
                         rounds=sum(len(s) for s in scheds[tag]),
                         launches={n: launches[n] for n in ("round_dec_batch", "shard_match",
                                                            "membership_bits_batch")})
        if scheds[tag] != scheds["one device"]:
            raise AssertionError(f"(b) {tag}: the schedules differ from the one-device ones")
        if tag != "one device" and (runs[tag]["routes"] != ["data-parallel host membership"]
                                    or not_launched(launches, "round_dec_batch")):
            raise AssertionError(f"(b) {tag}: {runs[tag]}")
    log(f"  (b) multigather's schedules of {len(counters)} samples "
        f"({runs['one device']['rounds']} rounds), equal on every mesh: "
        + "; ".join(f"{t} {r['wall_s']:.2f} s ({r['routes']}, launches {r['launches']})"
                    for t, r in runs.items()))
    return runs, [dict(sched=s, truncated=t) for s, t in zip(scheds["one device"], truncated)]


def parallel_program(world: dict, dev, want_scheds: list, reps: int, clock_hz: float) -> dict:
    """(c) the fused program (membership build + rounds) on a PROGRAM_MESH
    mesh of the card, phase 6's collection packed by pack_shard_planes,
    against 2 large and 2 small of phase 8's samples: best and best_count
    equal to the one-device schedules round for round. And (e) shard_match
    at the program's chunk shape against its plain version, timed."""
    import torch

    from sourmash_tpu_torch.ops.bucketed import pack_bits_u32, to_torch
    from sourmash_tpu_torch.parallel import (
        get_mesh, make_sharded_gather_program, make_sharded_membership_builder, pack_query_batch,
        pack_shard_planes)
    from sourmash_tpu_torch.search import calc_threshold_from_bp

    nd, ns = PROGRAM_MESH
    picks = (0, 1, MULTI_LARGE, MULTI_LARGE + 1)
    queries = [world["samples"][i] for i in picks]
    mins_list = world["mins_list"]
    t0 = time.time()
    Shi, Slo, Scnt, B = pack_shard_planes(mins_list, ns)
    qhi, qlo, alive = pack_query_batch(queries, B)
    pack_s = time.time() - t0
    thresh = np.array([max(calc_threshold_from_bp(GATHER_THRESHOLD_BP, GATHER_SCALED, len(q))[1],
                           1) for q in queries], dtype=np.int32)
    planes = (to_torch(Shi, dev), to_torch(Slo, dev), torch.from_numpy(Scnt).to(dev))
    plane_bytes = sum(p.numel() * p.element_size() for p in planes)
    del Shi, Slo
    qs = (to_torch(qhi, dev), to_torch(qlo, dev), torch.from_numpy(alive).to(dev))
    per, d = planes[0].shape[0] // ns, planes[0].shape[1]
    log(f"  (c) planes [{planes[0].shape[0]}, {d}, {B}] (pack_shard_planes, {pack_s:.1f} s), "
        f"queries [{len(queries)}, {qhi.shape[1]}, {B}] of {[len(q) for q in queries]} hashes")

    # (e) at the program's chunk: data block 0's queries against shard 0's first rows
    chunk = min(per, 4096)
    bq0 = -(-len(queries) // nd)
    A = pack_bits_u32(qs[2][:bq0])
    args = (qs[0][:bq0].contiguous(), qs[1][:bq0].contiguous(), A,
            *(p[:chunk].contiguous() for p in planes))
    timing = time_shard_match(args, mins_list[:chunk], queries[:bq0], reps, clock_hz)
    del args, A
    torch.cuda.empty_cache()

    max_rounds = max(len(w["sched"]) for w in want_scheds) + 1
    mesh = get_mesh(nd, ns, devices=[dev] * (nd * ns))
    # the builder alone first: its launches make no host synchronisation
    build = make_sharded_membership_builder(mesh, len(mins_list))
    (Mb, cb), _w, build_launches = call_counted(lambda: sync_free(lambda: build(*planes, *qs)),
                                                {})
    del Mb, cb
    torch.cuda.empty_cache()
    prog = make_sharded_gather_program(mesh, len(mins_list), max_rounds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    (best, bc), wall, launches = call_counted(lambda: prog(*planes, *qs, thresh), {})
    peak = torch.cuda.max_memory_allocated(dev)
    best, bc = best.cpu().numpy(), bc.cpu().numpy()
    for j, (i, w) in enumerate(zip(picks, want_scheds)):
        sched = w["sched"]
        got = [(int(b), int(c)) for b, c in zip(best[j], bc[j]) if b >= 0]
        want = [(ds, cnt) for _ci, ds, cnt in sched]
        if got[: len(want)] != want or (best[j, len(want):] >= 0).any() and not w["truncated"]:
            raise AssertionError(f"(c) sample {i}: the program's rounds differ from the "
                                 f"one-device schedule")
    m_bytes = len(queries) * per * ns * qhi.shape[1] * (B // 32) * 4
    if not_launched(launches, "shard_match", "round_dec_batch") \
            or build_launches["shard_match"] != launches["shard_match"]:
        raise AssertionError(f"(c) a kernel was not launched: {launches}; the builder alone "
                             f"launched shard_match {build_launches['shard_match']} times")
    log(f"  (c) fused program on a ({nd} x {ns}) mesh of the card, {max_rounds} rounds: "
        f"{wall:.2f} s, best and best_count equal the one-device schedules round for round "
        f"({[len(w['sched']) for w in want_scheds]} rounds); peak {peak / 2**30:.2f} GiB "
        f"allocated, {(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} allocated before "
        f"the program (the planes' {plane_bytes / 2**30:.2f} and earlier phases' tensors); M "
        f"{m_bytes / 2**30:.2f} GiB, about {m_bytes / len(queries) / 2**30:.2f} GiB a query at "
        f"dq = {qhi.shape[1]}); "
        f"launches {({n: launches[n] for n in ('shard_match', 'round_dec_batch')})}; the "
        f"builder's {build_launches['shard_match']} shard_match launches alone made no host "
        f"synchronisation (set_sync_debug_mode \"error\")")
    return dict(wall_s=wall, max_rounds=max_rounds, peak_bytes=peak, base_bytes=base,
                plane_bytes=plane_bytes, m_bytes=m_bytes, dq=int(qhi.shape[1]), B=B, d=d, pack_s=pack_s,
                launches={n: launches[n] for n in ("shard_match", "round_dec_batch")},
                shard_match=timing)


def parallel_sketch(rng, dev) -> dict:
    """(d) the sharded sketch: SKETCH_ROWS rows of phase 3's kind over
    SKETCH_DATA data devices of the card, equal to the one-device K2 path."""
    import torch

    from sourmash_tpu_torch.ops.sketch import _dense_compact
    from sourmash_tpu_torch.parallel import get_mesh, make_sharded_sketch

    k, mh = TIMED_K, max_hash_for(1000)
    rows = dna_rows(SKETCH_ROWS, k, rng, tandem_unit(k, mh, rng))
    cap = 8192
    seqs = torch.from_numpy(rows).to(dev)
    want, want_n = _dense_compact(seqs, mh, k, 42, cap)
    mesh = get_mesh(SKETCH_DATA, 1, devices=[dev] * SKETCH_DATA)
    (got, n), wall, launches = call_counted(lambda: make_sharded_sketch(mesh, k, cap)(rows, mh),
                                            {})
    exact("(d) sharded sketch survivors", got, want)
    exact("(d) sharded sketch counts", n, want_n.to(torch.int32))
    if launches["window_hashes"] != SKETCH_DATA and GATHER_DEVICE == "cuda":
        raise AssertionError(f"(d) K2 launched {launches['window_hashes']} times")
    log(f"  (d) sharded sketch of [{SKETCH_ROWS}, {rows.shape[1]}] over {SKETCH_DATA} data "
        f"devices: equal to the one-device K2 path ({int(n.sum())} survivors), {wall:.2f} s, "
        f"K2 launches {launches['window_hashes']}")
    return dict(wall_s=wall, survivors=int(n.sum()), launches=launches["window_hashes"])


def parallel_dryrun(dev) -> dict:
    """(f) `parallel.dryrun.dryrun_multichip(8)` on 8 logical devices of the
    card: the sharded counter, the gather round (its winners' words and
    its decrement) and the fused program on the dry run's adversarial
    inputs, each checked there against a host reference, and every
    shard_match call held bit for bit against the plain version on host
    copies of its inputs."""
    from sourmash_tpu_torch import parallel
    from sourmash_tpu_torch.ops import cuda_gather as cg
    from sourmash_tpu_torch.parallel import dryrun

    real = parallel.shard_match
    held = dict(counts=0, words=0, in_place=0)

    def spy(Qhi, Qlo, alive, Shi, Slo, Scnt, bits=False, out=None, row0=0):
        host = [t.cpu() for t in (Qhi, Qlo, alive, Shi, Slo, Scnt)]
        got = real(Qhi, Qlo, alive, Shi, Slo, Scnt, bits=bits, out=out, row0=row0)
        want = cg.shard_match_plain(*host, bits=True)
        rows = slice(row0, row0 + Shi.shape[0])
        if out is not None:
            exact("(f) shard_match in place (counts)", out[0][:, rows].cpu(), want[0])
            if out[1] is not None:
                exact("(f) shard_match in place (words)", out[1][:, rows].cpu(), want[1])
            held["in_place"] += 1
        elif bits:
            exact("(f) shard_match (counts)", got[0].cpu(), want[0])
            exact("(f) shard_match (words)", got[1].cpu(), want[1])
            held["words"] += 1
        else:
            exact("(f) shard_match counts only", got.cpu(), want[0])
            held["counts"] += 1
        return got

    parallel.shard_match = spy
    try:
        facts, wall, launches = call_counted(
            lambda: dryrun.dryrun_multichip(8, devices=[dev] * 8), {})
    finally:
        parallel.shard_match = real
    if min(held.values()) < 1 or (GATHER_DEVICE == "cuda"
                                  and launches["shard_match"] != sum(held.values())):
        raise AssertionError(f"(f) shard_match calls held {held}, launched "
                             f"{launches['shard_match']}")
    log(f"  (f) dryrun_multichip(8) on 8 logical devices of the card: {facts['mesh']} mesh, "
        f"every check held in {wall:.2f} s; {sum(held.values())} shard_match calls "
        f"({held['counts']} counts only: the counter and the decrements; {held['words']} with "
        f"words: the winners; {held['in_place']} in place: the builder) equal the plain "
        f"version; launches {({n: launches[n] for n in ('shard_match', 'round_dec')})}")
    return dict(wall_s=wall, held=held, facts={k: v for k, v in facts.items() if k != "devices"},
                launches={n: launches[n] for n in ("shard_match", "round_dec")})


def parallel_end_to_end(rng, world: dict, clock_hz: float) -> dict:
    "Phase 12: (a)-(f) on meshes that name the card several times."
    import torch

    from sourmash_tpu_torch.index.flat import FlatIndex

    dev = torch.device(GATHER_DEVICE, 0) if GATHER_DEVICE == "cuda" else torch.device("cpu")
    n_cards = torch.cuda.device_count()
    out, walls = {}, {}
    index = FlatIndex(world["sigs"], device=dev)
    index._build()
    t0 = time.time()
    meshes = {f"{SHARDED_SHARDS} logical shards": [dev] * SHARDED_SHARDS}
    if n_cards > 1:
        meshes[f"{n_cards} cards"] = [torch.device("cuda", i) for i in range(n_cards)]
    out["gather"] = parallel_gather(world, index, dev, meshes)
    walls["a"] = time.time() - t0
    t0 = time.time()
    data_meshes = {f"{n} logical data devices": [dev] * n for n in DATA_DEVICES}
    if n_cards > 1:
        data_meshes[f"{n_cards} cards"] = [torch.device("cuda", i) for i in range(n_cards)]
    out["multigather"], scheds = parallel_multigather(world, index, dev, data_meshes)
    walls["b"] = time.time() - t0
    del index
    torch.cuda.empty_cache()
    t0 = time.time()
    picks = (0, 1, MULTI_LARGE, MULTI_LARGE + 1)
    out["program"] = parallel_program(world, dev, [scheds[i] for i in picks], 10, clock_hz)
    walls["c and e"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    out["sketch"] = parallel_sketch(rng, dev)
    walls["d"] = time.time() - t0
    t0 = time.time()
    out["dryrun"] = parallel_dryrun(dev)
    walls["f"] = time.time() - t0
    out["walls_s"] = walls
    log("  phase 12 walls: " + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items()))
    return out


# -- phase 13: sig kmers on the card -----------------------------------------

KMERS_DNA_RECORDS = 16  # records of 0.2-1 Mbp (phase 3's kind): <= 16 Mbp in all
KMERS_AA_RECORDS = 6  # proteins of 2^16-2^17 aa: K3's device branch
KMERS_TR_RECORDS = 4  # DNA records of 0.2-0.3 Mbp: each frame past 2^16 windows
HOST_SKETCH_NATIVE = {"SOURMASH_TORCH_HOST_SKETCH": "native"}


def write_records(path: str, records: list):
    "A plain FASTA of (name, bytes) records, one line each."
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n" + seq + b"\n")


def kmers_inputs(rng, tmp: str) -> dict:
    """Phase 13's sequence files and its query collection: DNA records of
    0.2-1 Mbp with N runs and lowercase stretches, proteins of 2^16 aa or
    more, DNA records for `--translate`, and two short records (one a
    piece of a DNA record) for `--save-kmers`. The query zip holds three
    k=31, scaled=1000 DNA sketches of pieces of three records and one k=10,
    scaled=200 protein sketch of pieces of two proteins and of two
    translated records, each sketched on the native host loop."""
    from sourmash_tpu_torch import MinHash, SourmashSignature
    from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    letters = np.frombuffer(AA_RESIDUES, dtype=np.uint8)
    dna = []
    for _ in range(KMERS_DNA_RECORDS):
        seq = rng.choice(acgt, size=int(rng.integers(200_000, 1_000_001)))
        for start in rng.integers(0, seq.size - 500, size=5):
            seq[start : start + int(rng.integers(1, 300))] = ord("N")
        for start in rng.integers(0, seq.size - 5000, size=3):
            seq[start : start + int(rng.integers(10, 5000))] |= 32  # lowercase
        dna.append(seq.tobytes())
    aa = [rng.choice(letters, size=int(rng.integers((1 << 16) + 100, 1 << 17))).tobytes()
          for _ in range(KMERS_AA_RECORDS)]
    tr = [rng.choice(acgt, size=int(rng.integers(200_000, 300_001))).tobytes()
          for _ in range(KMERS_TR_RECORDS)]
    short = [dna[0][60_000:62_000], rng.choice(acgt, size=2_000).tobytes()]
    paths = {}
    for what, recs in (("dna", dna), ("aa", aa), ("tr", tr), ("short", short)):
        paths[what] = os.path.join(tmp, f"kmers_{what}.fa")
        write_records(paths[what], [(f"{what}_{i} synthetic", r) for i, r in enumerate(recs)])

    sigs = []
    with native_host_loop():
        for i in (0, len(dna) // 3, 2 * len(dna) // 3):
            mh = MinHash(0, 31, scaled=1000)
            mh.add_sequence(dna[i][50_000:200_000], force=True)
            mh.add_many(np.asarray(random_sketch(rng, 50, max_hash_for(1000)), np.uint64))
            sigs.append(SourmashSignature(mh, name=f"dna query {i}"))
        mh = MinHash(0, 10, is_protein=True, scaled=200)
        mh.add_protein(aa[0][:30_000])
        mh.add_protein(aa[-1][5_000:40_000])
        mh.add_sequence(tr[0][3_000:60_000])
        mh.add_sequence(tr[-1][30_000:90_000])
        sigs.append(SourmashSignature(mh, name="protein query"))
    paths["query"] = os.path.join(tmp, "kmers_query.zip")
    with SaveSignaturesToLocation(paths["query"]) as save:
        for ss in sigs:
            save.add(ss)
    paths["mbp"] = sum(map(len, dna)) / 1e6
    return paths


def kmers_forms(paths: dict) -> dict:
    "Phase 13's `sig kmers` commands, each writing into the working directory."
    q = ["sig", "kmers", "--signatures", paths["query"]]
    return {
        "dna": q + ["-k", "31", "--dna", "--sequences", paths["dna"],
                    "--save-sequences", "matched.fa"],
        "protein": q + ["-k", "10", "--protein", "--sequences", paths["aa"],
                        "--save-sequences", "matched.fa"],
        "translate": q + ["-k", "10", "--protein", "--sequences", paths["tr"], "--translate",
                          "--save-sequences", "matched.fa"],
        "save-kmers": q + ["-k", "31", "--dna", "--sequences", paths["short"],
                           "--save-kmers", "kmers.csv", "--save-sequences", "matched.fa"],
    }


# the kernels each form must launch on the card (one of a tuple's, all of a list's)
KMERS_KERNELS = {"dna": [("survivor_slots", "window_hashes")],
                 "protein": [("aa_window_hashes",)], "translate": [("aa_window_hashes",)],
                 "save-kmers": []}


def kmers_run(argv: list, cwd: str, env: dict) -> dict:
    """One `sig kmers` through `__main__.main` in `cwd`, launch counters set
    to 0 just before and read just after: its stderr, output files, found
    hashes, wall and launches."""
    import io
    import re

    from sourmash_tpu_torch.__main__ import main as cli_main

    os.makedirs(cwd)
    here = os.getcwd()
    err = io.StringIO()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stderr(err):
            rc, wall, launches = call_counted(lambda: cli_main(argv), env)
    finally:
        os.chdir(here)
    if rc not in (None, 0):
        raise AssertionError(f"sig kmers returned {rc}: {err.getvalue()[-2000:]}")
    found = re.search(r"found (\d+) distinct matching hashes", err.getvalue())
    files = {}
    for name in sorted(os.listdir(cwd)):
        with open(os.path.join(cwd, name), "rb") as f:
            files[name] = f.read()
    return dict(stderr=err.getvalue(), files=files, found=int(found.group(1)), wall_s=wall,
                launches=launches)


def sig_kmers_end_to_end(rng, tmp: str) -> dict:
    """Phase 13: `sig kmers` of a query zip (three DNA sketches, one protein
    sketch) over DNA records (K1/K2), proteins and translated records (K3)
    and two short records (`--save-kmers`, on the host), each form on the
    card and again under SOURMASH_TORCH_HOST_SKETCH=native: the same
    stderr, found hashes and files, byte for byte."""
    from sourmash_tpu_torch.cli import SourmashParser
    from sourmash_tpu_torch.ops.cuda_sketch import LAUNCHES as SKETCH_LAUNCHES

    # the citation goes out once a process: out now, so that each run's
    # stderr holds the command's own lines
    SourmashParser.print_citation()
    t0 = time.time()
    paths = kmers_inputs(rng, tmp)
    out = dict(inputs_s=time.time() - t0, dna_mbp=paths["mbp"], forms={})
    log(f"  inputs ({paths['mbp']:.2f} Mbp of DNA records) in {out['inputs_s']:.1f} s")
    for form, argv in kmers_forms(paths).items():
        card = kmers_run(argv, os.path.join(tmp, "kmers", form, "card"), {})
        host = kmers_run(argv, os.path.join(tmp, "kmers", form, "native"), HOST_SKETCH_NATIVE)
        for what in ("stderr", "found", "files"):
            if card[what] != host[what]:
                import difflib

                diff = difflib.unified_diff(str(host[what]).splitlines(),
                                            str(card[what]).splitlines(), lineterm="")
                raise AssertionError(f"sig kmers {form}: {what} on the card differs from the "
                                     f"native host loop's:\n" + "\n".join(list(diff)[:40]))
        if not card["found"] or not card["files"].get("matched.fa"):
            raise AssertionError(f"sig kmers {form}: no matching hashes or sequences")
        on_host = [n for n in SKETCH_LAUNCHES if host["launches"].get(n)]
        if on_host:
            raise AssertionError(f"sig kmers {form}: the native host loop launched {on_host}")
        for names in KMERS_KERNELS[form]:
            if len(not_launched(card["launches"], *names)) == len(names):
                raise AssertionError(f"sig kmers {form}: none of {names} launched: "
                                     f"{card['launches']}")
        sizes = {name: len(data) for name, data in card["files"].items()}
        card["launches"] = {name: n for name, n in card["launches"].items() if n}
        log(f"  sig kmers {form}: {card['found']} hashes found == native host loop, files "
            f"{sizes} byte-identical; card {card['wall_s']:.2f} s, launches "
            f"{card['launches']}; native host loop {host['wall_s']:.2f} s")
        out["forms"][form] = dict(found=card["found"], file_bytes=sizes,
                                  card_wall_s=card["wall_s"], launches=card["launches"],
                                  native_wall_s=host["wall_s"])
    return out


# -- phase 14: compute, categorize, watch, the profiler hook and info -------

COMPUTE_MBP = 32  # phase 14 (a): records of 0.1-4 Mbp
COMPUTE_RUNS = {
    "dna": ["-k", "21,31", "--scaled", "1000", "--track-abundance"],
    "protein": ["--protein", "--dayhoff", "-k", "30", "--scaled", "100"],
    "merge": ["-k", "21,31", "--scaled", "1000", "--merge", "merged"],
}
CATEGORIZE_QUERIES = 4
WATCH_GENOMES = 4
WATCH_RECORD = 100_000  # bytes a watch record: past minhash._DEVICE_MIN_LEN (2^16)
PROFILE_MBP = 4


def write_compute_fasta(path: str, mbp: int, rng) -> tuple:
    """A FASTA.gz of about `mbp` Mbp in records of 0.1-4 Mbp with N runs and
    lowercase stretches. Returns (records, bases)."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_rec, total = 0, 0
    with gzip.open(path, "wb", compresslevel=1) as f:
        while total < mbp * 1_000_000:
            seq = rng.choice(acgt, size=int(rng.integers(100_000, 4_000_001)))
            for start in rng.integers(0, seq.size - 3000, size=5):
                seq[start : start + int(rng.integers(1, 2000))] = ord("N")
            for start in rng.integers(0, seq.size - 20_000, size=3):
                seq[start : start + int(rng.integers(100, 20_000))] |= 32  # lowercase
            f.write(b">compute_%d synthetic\n" % n_rec + seq.tobytes() + b"\n")
            n_rec += 1
            total += seq.size
    return n_rec, total


def same_sketch(what: str, got, want):
    "mins, abundances and md5sum equal to the native host loop's."
    if not np.array_equal(got.mins_array(), want.mins_array()) or got.md5sum() != want.md5sum():
        raise AssertionError(f"{what}: differs from the native host loop")
    if want.track_abundance and not np.array_equal(got.abunds_array(), want.abunds_array()):
        raise AssertionError(f"{what}: abundances differ from the native host loop")
    if len(want) == 0:
        raise AssertionError(f"{what}: empty sketch")


def compute_end_to_end(rng, tmp: str) -> dict:
    """Phase 14 (a): `compute` of ~32 Mbp (DNA k=21,31 scaled=1000 with
    abundances; DNA, protein and dayhoff at k=30 scaled=100; `--merge`),
    each through `__main__.main` with the launch counters set to 0 just
    before and read just after. Every sketch equal to the native host loop
    on the same records; K1 and K3 launched."""
    from sourmash_tpu_torch import load_signatures_from_json

    path = os.path.join(tmp, "compute.fa.gz")
    t0 = time.time()
    n_rec, bases = write_compute_fasta(path, COMPUTE_MBP, rng)
    out = dict(records=n_rec, mbp=bases / 1e6, inputs_s=time.time() - t0, runs={})
    oracle = {}
    for tag, flags in COMPUTE_RUNS.items():
        sig_path = os.path.join(tmp, f"compute_{tag}.sig")
        wall, launches = run_counted(["compute", path, "-o", sig_path, "-q", *flags], {})
        sigs = list(load_signatures_from_json(sig_path))
        got = {sketch_key(ss.minhash) + (ss.minhash.track_abundance,): ss for ss in sigs}
        t0 = time.time()
        missing = {k: ss.minhash.copy_and_clear() for k, ss in got.items() if k not in oracle}
        oracle.update(host_sketches(path, missing) if missing else {})
        host_s = time.time() - t0
        for key, ss in got.items():
            same_sketch(f"compute {tag} {key}", ss.minhash, oracle[key])
        if tag == "merge" and {ss.name for ss in sigs} != {"merged"}:
            raise AssertionError(f"compute --merge named its sketches {[ss.name for ss in sigs]}")
        launched = {n: c for n, c in launches.items() if c}
        out["runs"][tag] = dict(wall_s=wall, sketches=len(got), launches=launched,
                                host_loop_s=host_s)
        log(f"  compute {tag} ({' '.join(flags)}): {wall:.2f} s wall, {len(got)} sketches == "
            f"native host loop ({host_s:.1f} s); launches {launched}")
    total = {name: sum(r["launches"].get(name, 0) for r in out["runs"].values())
             for name in ("survivor_slots", "aa_window_hashes")}
    if not_launched(total, *total):
        raise AssertionError(f"compute: {not_launched(total, *total)} not launched")
    return out


def categorize_end_to_end(tmp: str, world: dict) -> dict:
    """Phase 14 (b): `categorize` of 4 genomes of phase 6's collection (each
    from a clade of >= 5, saved as a query `.sig`) against its zip, warm in
    the flat-view cache: the cutoff form of counts_rows must run, and each
    CSV row's best match and similarity must be numpy's Jaccard argmax over
    the collection without the query itself (its own md5)."""
    from sourmash_tpu_torch.ops import cuda_gather as cg

    mins_list, names = world["mins_list"], world["names"]
    clade = np.array([int(n.rsplit("clade_", 1)[1]) for n in names])
    picks = [int(i) for i in np.flatnonzero(np.bincount(clade)[clade] >= 5)[:CATEGORIZE_QUERIES]]
    lens = np.fromiter((len(m) for m in mins_list), dtype=np.int64)
    queries, want = [], {}
    for gi in picks:
        qpath = os.path.join(tmp, f"categorize_{gi}.sig")
        save_sig(qpath, mins_list[gi], names[gi])
        queries.append(qpath)
        inter = overlap_counts(mins_list[gi], mins_list, world["index"])
        jac = inter / (len(mins_list[gi]) + lens - inter)
        jac[gi] = -1.0  # the query's own md5
        best = float(jac.max())
        want[qpath] = (best, {names[i] for i in np.flatnonzero(jac == best)})
    csv_path = os.path.join(tmp, "categorize.csv")
    cut_calls = []

    def spy(counts_rows):
        def spied(*a, **kw):
            cut_calls.append(len(a) > 4 and a[4] is not None or kw.get("cut_hi") is not None)
            return counts_rows(*a, **kw)
        return spied

    with patched(cg, "counts_rows", spy):
        wall, launches = run_counted(["categorize", world["db"], *queries, "--ksize", "31",
                                      "--csv", csv_path, "-q"], {})
    if not any(cut_calls) or not_launched(launches, "counts_rows"):
        raise AssertionError(f"categorize: counts_rows with cuts did not run: {launches}")
    import csv as csvmod

    with open(csv_path, newline="") as f:
        rows = list(csvmod.reader(f))
    if [row[0] for row in rows] != queries:
        raise AssertionError(f"categorize: rows for {[row[0] for row in rows]}, want {queries}")
    for loc, _query, match, sim in rows:
        best, best_names = want[loc]
        if float(sim) != best or match not in best_names:
            raise AssertionError(f"categorize {loc}: {match} at {sim}, numpy {best_names} at "
                                 f"{best}")
    log(f"  categorize of {len(queries)} genomes against {len(names)}: {wall:.2f} s wall, best "
        f"matches and Jaccard == numpy's argmax; counts_rows with cuts "
        f"{launches['counts_rows']} launches")
    return dict(wall_s=wall, queries=len(queries), counts_rows=launches["counts_rows"],
                best=[float(r[3]) for r in rows])


def watch_end_to_end(rng, tmp: str) -> dict:
    """Phase 14 (c): `index` of num=500, k=21 sketches of 4 generated genomes
    into an SBT, then `watch --dna --ksize 21` of records of 100 kbp cut from
    genome 0: K1 or K2 must run, the FOUND line must name genome 0 at the
    host's similarity, and `-o`'s sketch must equal the native host loop's."""
    import io

    from sourmash_tpu_torch import MinHash, SourmashSignature, load_signatures_from_json
    from sourmash_tpu_torch.save_load import SaveSignaturesToLocation

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = [rng.choice(acgt, size=int(rng.integers(1_000_000, 2_000_001))).tobytes()
               for _ in range(WATCH_GENOMES)]
    sketches, sig_paths = [], []
    with native_host_loop():
        for i, g in enumerate(genomes):
            mh = MinHash(500, 21)
            mh.add_sequence(g)
            sketches.append(mh)
            sig_paths.append(os.path.join(tmp, f"watch_genome_{i}.sig"))
            with SaveSignaturesToLocation(sig_paths[-1]) as save:
                save.add(SourmashSignature(mh, name=f"watch genome {i}"))
    tree = os.path.join(tmp, "watch.sbt.zip")
    index_wall, _ = run_counted(["index", tree, *sig_paths, "-q"], {})
    cut = genomes[0][: 8 * WATCH_RECORD]
    records = [(f"piece {j} of watch genome 0", cut[j * WATCH_RECORD:(j + 1) * WATCH_RECORD])
               for j in range(8)]
    fa = os.path.join(tmp, "watch_records.fa")
    write_records(fa, records)
    w_sig = os.path.join(tmp, "watch_w.sig")
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        wall, launches = run_counted(["watch", "--dna", "--ksize", "21", tree, fa, "-o", w_sig],
                                     {})
    want = MinHash(500, 21)
    with native_host_loop():
        for _name, seq in records:
            want.add_sequence(seq)
    got = next(iter(load_signatures_from_json(w_sig))).minhash
    same_sketch("watch -o", got, want)
    found = f"FOUND: watch genome 0, at {want.similarity(sketches[0], ignore_abundance=True):.3f}"
    if stdout.getvalue().strip() != found:
        raise AssertionError(f"watch printed {stdout.getvalue()!r}, the host says {found!r}")
    if len(not_launched(launches, "survivor_slots", "window_hashes")) == 2:
        raise AssertionError(f"watch: neither K1 nor K2 was launched: {launches}")
    launched = {n: c for n, c in launches.items() if c}
    log(f"  index of {WATCH_GENOMES} genomes' num=500 sketches: {index_wall:.2f} s; watch of "
        f"{len(records)} records of {WATCH_RECORD} bp: {wall:.2f} s wall, {found!r} == host, "
        f"-o == native host loop; launches {launched}")
    return dict(index_s=index_wall, wall_s=wall, found=found, launches=launched)


def profile_hook_start(rng, tmp: str) -> dict:
    """Phase 14 (d), started: `sketch dna` of one 4 Mbp record in a
    subprocess under SOURMASH_TORCH_PROFILE, left to run beside (a)-(c)
    (its launches count in its own process); `profile_hook_check` waits."""
    import sourmash_tpu_torch

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    fa = os.path.join(tmp, "profile_record.fa")
    write_records(fa, [("profiled record", rng.choice(acgt, size=PROFILE_MBP * 1_000_000)
                        .tobytes())])
    trace_dir = os.path.join(tmp, "torch_profile")
    root = os.path.dirname(os.path.dirname(os.path.abspath(sourmash_tpu_torch.__file__)))
    env = dict(os.environ, SOURMASH_TORCH_PROFILE=trace_dir,
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    proc = subprocess.Popen([sys.executable, "-m", "sourmash_tpu_torch", "sketch", "dna", fa,
                             "-o", os.path.join(tmp, "profiled.sig"), "-q"],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return dict(proc=proc, trace_dir=trace_dir, t0=time.time())


def profile_hook_check(started: dict) -> dict:
    """Phase 14 (d): the subprocess's Chrome trace must be valid JSON and
    name K1's survivor_slots_kernel among its kernel events."""
    import glob

    proc = started["proc"]
    try:
        _out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    wall = time.time() - started["t0"]
    if proc.returncode != 0:
        raise AssertionError(f"profiled sketch dna returned {proc.returncode}: {err[-2000:]}")
    traces = glob.glob(os.path.join(started["trace_dir"], "sourmash_torch.*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"profiler hook wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [ev["name"] for ev in events if ev.get("cat") == "kernel"]
    k1 = [name for name in kernels if "survivor_slots_kernel" in name]
    if not k1:
        raise AssertionError(f"the trace names no survivor_slots_kernel among {len(kernels)} "
                             f"kernel events: {sorted(set(kernels))[:10]}")
    log(f"  SOURMASH_TORCH_PROFILE sketch dna of {PROFILE_MBP} Mbp in a subprocess (beside "
        f"(a)-(c)): {wall:.2f} s from its start, trace {os.path.getsize(traces[0])} bytes, "
        f"{len(events)} events, {len(kernels)} kernel events, {len(k1)} of K1 ({k1[0][:60]!r})")
    return dict(wall_s=wall, trace_bytes=os.path.getsize(traces[0]), events=len(events),
                kernel_events=len(kernels), k1_events=len(k1))


def info_end_to_end(card: str) -> dict:
    "Phase 14 (e): `info -v` must print the card's name as nvidia-smi gives it."
    import io

    from sourmash_tpu_torch import logging as port_logging
    from sourmash_tpu_torch.__main__ import main as cli_main

    name = card.split(",")[0].strip()
    port_logging.set_quiet(False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(["info", "-v"])
    if rc not in (None, 0) or name not in err.getvalue():
        raise AssertionError(f"info -v returned {rc} and printed no {name!r}: "
                             f"{err.getvalue()[-1500:]}")
    line = next(ln for ln in err.getvalue().splitlines() if ln.startswith("torch devices:"))
    log(f"  info -v: {line!r}")
    return dict(devices_line=line)


def last_slice_end_to_end(rng, tmp: str, world: dict, card: str) -> dict:
    """Phase 14: (a)-(e), each part's wall and launches on lines of their own;
    (d)'s subprocess runs beside (a)-(c), its wall counted from its start."""
    from sourmash_tpu_torch.cli import SourmashParser

    SourmashParser.print_citation()  # once a process: out of each command's output
    walls, out = {}, {}
    started = profile_hook_start(rng, tmp)
    for part, fn in (("a", lambda: compute_end_to_end(rng, tmp)),
                     ("b", lambda: categorize_end_to_end(tmp, world)),
                     ("c", lambda: watch_end_to_end(rng, tmp)),
                     ("d", lambda: profile_hook_check(started)),
                     ("e", lambda: info_end_to_end(card))):
        t0 = time.time()
        out[part] = fn()
        walls[part] = time.time() - t0
    out["walls_s"] = walls
    log("  phase 14 walls: " + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items()))
    launches = {f"compute {tag}": r["launches"] for tag, r in out["a"]["runs"].items()}
    launches.update({"categorize": {"counts_rows": out["b"]["counts_rows"]},
                     "watch": out["c"]["launches"]})
    log("  phase 14 launches: " + json.dumps(launches))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check each kernel once, then stop")
    ap.add_argument("--json", help="also write every measurement to this file")
    ap.add_argument("--sass-against", metavar="DIR",
                    help="fail unless K1's and K2's SASS equals that of the checkout in "
                         "DIR; time DIR's K3 beside this tree's")
    ap.add_argument("--profile", action="store_true",
                    help="run each sketch command once more under cProfile and "
                         "torch.profiler")
    ap.add_argument("--shard-match-against", metavar="DIR",
                    help="check shard_match on phase 2's planes, time the checkout in DIR's "
                         "beside this tree's at the fused program's chunk, then stop")
    ap.add_argument("--shard-match-timing", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--compare-only", action="store_true",
                    help="build, check compare's kernels (phase 2's part) and run phase 9, "
                         "then stop")
    args = ap.parse_args(argv)
    t_start = time.time()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.shard_match_timing:  # that checkout's package, not this one's
        sys.path.insert(0, args.shard_match_timing)
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
    if args.shard_match_timing:
        log(f"shard_match timing through {os.path.dirname(sourmash_tpu_torch.__file__)}")
        timing = shard_match_timing(AGAINST_REPS, clock_hz)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(timing, f, indent=1)
        return 0

    t0 = time.time()
    build_logs = _build.build()
    native.build()
    log(f"phase 1: built kernels and native host library in {time.time() - t0:.1f} s")
    for name, build_log in build_logs.items():
        for line in build_log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "rror")):
                log(f"  {name}.cu: {line.strip()}")
    k3_against = sass_against(args.sass_against) if args.sass_against else None

    rng = np.random.default_rng(20261016)
    if args.shard_match_against:
        t0 = time.time()
        log(f"phase 2 (shard_match only), then against {args.shard_match_against}")
        edges = check_shard_match_edges(rng)
        against = shard_match_against(args.shard_match_against)
        log(f"phase 2 done in {time.time() - t0:.1f} s")
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(card=card, sm_clock_hz=clock_hz, edges=edges, **against), f,
                          indent=1)
        log("--shard-match-against: stopped after shard_match; no kernels line and no result")
        return 0
    if args.compare_only:
        t0 = time.time()
        log("phase 2 (compare's kernels only): against their plain versions on the card (exact)")
        timings = check_compare_kernels(args.quick, rng, clock_hz)
        log(f"phase 2 done in {time.time() - t0:.1f} s")
        if not args.quick:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.time()
                log(f"phase 9: compare end to end on {COMPARE_GENOMES} genomes")
                cmp = compare_end_to_end(tmp, timings["products_block"]["bq"], args.profile)
                log(f"phase 9 done in {time.time() - t0:.1f} s")
            timings["compare"] = cmp
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(card=card, sm_clock_hz=clock_hz, timings=timings), f, indent=1)
        log("--compare-only: stopped after compare; no kernels line and no result")
        return 0
    t0 = time.time()
    log("phase 2: kernels against their plain versions on the card (exact)")
    timings = check_kernels(args.quick, rng, clock_hz)
    timings.update(check_gather_kernels(args.quick, rng, clock_hz))
    timings["shard_match edges"] = check_shard_match_edges(rng)
    timings.update(check_compare_kernels(args.quick, rng, clock_hz))
    t1 = time.time()
    log("phase 2: the sketch-kernel instruments against their plain versions and K1 (exact)")
    timings.update(check_instruments(args.quick, rng, clock_hz))
    log(f"phase 2 done in {time.time() - t0:.1f} s (instruments {time.time() - t1:.1f} s)")
    # murmur_halves' time at K1's windows: T4's murmur alone, per window. It
    # is not a part of K1, whose murmur is murmur_words (sketch_common.cuh)
    k1, t4 = timings["survivor_slots"][TIMED_K], timings["murmur_only"]
    k1["murmur_halves_ms"] = t4["ms"] * k1["windows"] / t4["windows"]
    v2 = timings["survivor_slots_v2"]
    log(f"  K1 at k={TIMED_K}: {k1['ms']:.4f} ms/launch, bound {k1['bound_ms']:.4f} ms "
        f"({k1['bound_by']}; {k1['bound_ms_before']:.4f} by the unfolded count); murmur_halves "
        f"at K1's windows {k1['murmur_halves_ms']:.4f} ms (murmur_only<{TIMED_K}> per window x "
        f"{k1['windows']} windows; not K1's murmur_words); T3 survivor_slots_v2 {v2['ms']:.4f} ms "
        f"({v2['b2b_ms']:.4f} back to back, K1 {k1['b2b_ms']:.4f}): T3 {v2['ms'] / k1['ms']:.2f}x "
        f"K1 a launch, {v2['b2b_ms'] / k1['b2b_ms']:.2f}x back to back")
    # K1 beside the instruments, per window, back to back (murmur_only runs
    # murmur_halves, not K1's murmur_words)
    asm = timings["assembly_only_acgt"]
    split = {name: r["b2b_ms"] * 1e6 / r["windows"]
             for name, r in (("assembly_only on ACGT", asm), ("murmur_only (murmur_halves)", t4),
                             ("K1", k1))}
    k1["ns_per_window"] = split
    log("  ns per window back to back: " + ", ".join(f"{n} {v:.5f}" for n, v in split.items())
        + f"; assembly_only on ACGT + murmur_halves "
        f"{split['assembly_only on ACGT'] + split['murmur_only (murmur_halves)']:.5f}")
    if args.quick:
        log("--quick: stopped before the main path; no kernels line and no result")
        return 0

    with tempfile.TemporaryDirectory() as tmp:
        # the flat-view cache lives in the run's directory: phase 6's first
        # load of its zip is cold, every later load of it warm
        os.environ[VIEW_CACHE_ENV] = os.path.join(tmp, "viewcache")
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
        t0 = time.time()
        log(f"phase 6: gather end to end on {GATHER_GENOMES} genomes")
        gath, world = gather_end_to_end(rng, tmp, args.profile)
        log(f"phase 6 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log("phase 7: the sketch-kernel instruments, as `python -m sourmash_tpu_torch.tools...`")
        instr = instruments_path()
        log(f"phase 7 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log(f"phase 8: search, prefetch and multigather against phase 6's {GATHER_GENOMES} genomes")
        multi = dict(search=search_end_to_end(tmp, world), prefetch=prefetch_end_to_end(tmp, world),
                     multigather=multigather_end_to_end(rng, tmp, world, args.profile))
        multi["view_cache"] = view_cache_line("phase 8 (its loads of phase 6's zip warm)")
        log(f"phase 8 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log(f"phase 9: compare end to end on {COMPARE_GENOMES} genomes")
        cmp = compare_end_to_end(tmp, timings["products_block"]["bq"], args.profile)
        log(f"phase 9 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log("phase 10: sketch fromfile, index -F revindex, sqlite and the view cache")
        pers = persistent_end_to_end(rng, tmp, world, world["csv"])
        log(f"phase 10 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log(f"phase 11: SBT and LCA database of phase 10's {SQLITE_GENOMES} genomes")
        sbt_lca = sbt_lca_end_to_end(tmp, world)
        log(f"phase 11 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log("phase 12: the multi-device layer on meshes that name the card several times")
        par = parallel_end_to_end(rng, world, clock_hz)
        log(f"phase 12 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        log("phase 13: sig kmers on the card against the native host loop")
        kmers = sig_kmers_end_to_end(rng, tmp)
        kmers["wall_s"] = time.time() - t0
        log(f"phase 13 done in {kmers['wall_s']:.1f} s ({card})")
        t0 = time.time()
        log("phase 14: compute, categorize, watch, the profiler hook and info -v")
        last = last_slice_end_to_end(rng, tmp, world, card)
        last["wall_s"] = time.time() - t0
        log(f"phase 14 done in {last['wall_s']:.1f} s ({card})")

    # each kernel's launches come from the phase that runs its path
    gather_launches = gath["runs"]["scheduled"]["launches"]
    launches = dict(survivor_slots=e2e["launches"]["survivor_slots"],
                    window_hashes=e2e["launches"]["window_hashes"],
                    aa_window_hashes=prot["launches"]["aa_window_hashes"],
                    counts_rows=gather_launches["counts_rows"],
                    membership_bits=gather_launches["membership_bits"],
                    round_dec=gather_launches["round_dec"],
                    **multi["multigather"]["runs"]["all"]["launches"],
                    pairwise_counts=cmp["runs"]["jaccard"]["launches"]["pairwise_counts"],
                    pairwise_products=cmp["runs"]["angular"]["launches"]["pairwise_products"],
                    **{name: cmp["block_routes"][name]["launches"][name.split()[0]]
                       for name in ("counts_block (compare)", "products_block")},
                    **{name: instr[name] for name in INSTRUMENTS},
                    shard_match=par["program"]["launches"]["shard_match"])
    timed = dict(survivor_slots=timings["survivor_slots"][TIMED_K],
                 window_hashes=timings["window_hashes"][TIMED_K],
                 aa_window_hashes=timings["aa_window_hashes"][TIMED_AA_K],
                 counts_rows=timings["counts_rows"],
                 membership_bits=timings["membership_bits"],
                 round_dec=timings["round_dec"],
                 **{name: timings[name] for name in MULTI_KERNELS},
                 pairwise_counts=timings["pairwise_counts"],
                 pairwise_products=timings["pairwise_products"],
                 **{"counts_block (compare)": timings["counts_block_pairwise"],
                    "products_block": timings["products_block"]},
                 **{name: timings[name] for name in INSTRUMENTS},
                 shard_match=par["program"]["shard_match"])
    # phase 2 timed compare's kernels on phase 9's planes at each route's block
    for name in ("pairwise_counts", "pairwise_products", "counts_block (compare)",
                 "products_block"):
        if launches[name] != timed[name]["launches_per_matrix"]:
            raise AssertionError(f"{name}: phase 9 launched it {launches[name]} times a matrix, "
                                 f"phase 2 timed {timed[name]['launches_per_matrix']} a matrix")
    line = []
    for name, meta in KERNELS.items():
        t = timed[name]
        line.append(dict(
            name=name, **meta,
            launches=launches[name],
            max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t.get("library_ms"),
        ))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, sm_clock_hz=clock_hz, timings=timings, end_to_end=e2e,
                           protein=prot, translate=trans, gather=gath, multi=multi, compare=cmp,
                           persistent=pers, sbt_lca=sbt_lca, parallel=par, sig_kmers=kmers,
                           last_slice=last,
                           instrument_launches=instr, k3_against=k3_against), f, indent=1)
    log(f"chip_smoke: the whole run took {time.time() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
