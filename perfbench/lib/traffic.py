"""The benchmark's one general generator: every input of every cell is made
here from `--seed` and the parameters of the cell's configuration and
traffic files. A traffic file names its `shape` (a function below) and
holds its numbers; a later cell of the same shape adds a data file only.

Sizes come from a fixed grid that every seed shares (quantiles of the
stated distribution, or a low-discrepancy sequence), so two seeds do the
same amount of work; the seed decides what is in the inputs and their
order. Nothing here loops over single hashes or bases in Python.
"""

from __future__ import annotations

import gzip
import math
import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMPLEMENT[_a] = _b
HASH_BITS = 54  # generated hashes lie below 2^54, under scaled=1000's max_hash
_HASH_MASK = np.uint64((1 << HASH_BITS) - 1)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    "An independent generator for one part of a run's inputs."
    return np.random.default_rng([seed & ((1 << 63) - 1), *stream])


def van_der_corput(n: int, base: int = 2) -> np.ndarray:
    "The first n points of the base-`base` van der Corput sequence, from 1/base."
    out = np.zeros(n)
    i = np.arange(1, n + 1)
    f = 1.0
    while np.any(i):
        f /= base
        out += f * (i % base)
        i //= base
    return out


def grid_values(dist: dict, u: np.ndarray) -> np.ndarray:
    "Values of the distribution `dist` at the quantiles u (in [0, 1))."
    kind = dist["dist"]
    lo, hi = float(dist["min"]), float(dist["max"])
    if kind == "uniform":
        return lo + u * (hi - lo)
    if kind == "log_uniform":
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    if kind == "lognormal":
        # a log-normal of the given median and sigma, truncated to [min, max]
        from statistics import NormalDist

        nd = NormalDist(math.log(float(dist["median"])), float(dist["sigma"]))
        a, b = nd.cdf(math.log(lo)), nd.cdf(math.log(hi))
        return np.exp([nd.inv_cdf(a + x * (b - a)) for x in u])
    raise ValueError(f"unknown distribution {kind!r}")


def quantile_grid(n: int) -> np.ndarray:
    "n evenly spread quantiles, (i + 0.5) / n."
    return (np.arange(n) + 0.5) / n


# -- DNA ----------------------------------------------------------------------


def _mark_runs(seq: np.ndarray, rng, per_mbp: float, length: tuple, apply) -> None:
    "Apply `apply(slice)` to about per_mbp runs a Mbp of lengths in [length)."
    n = int(round(per_mbp * len(seq) / 1e6))
    if n <= 0 or len(seq) < 2:
        return
    lens = rng.integers(length[0], length[1], size=n)
    starts = rng.integers(0, max(1, len(seq) - 1), size=n)
    for s, ln in zip(starts.tolist(), lens.tolist()):
        apply(slice(s, min(len(seq), s + ln)))


def assembly_sequence(bases: int, rng, p: dict) -> np.ndarray:
    """One assembly's bases: uniform ACGT with runs of N (scaffold gaps),
    soft-masked lowercase stretches and short tandem repeats, at the rates
    of the traffic's `features`."""
    seq = ACGT[rng.integers(0, 4, size=bases, dtype=np.uint8)]
    f = p["features"]

    def tandem(sl):
        unit = ACGT[rng.integers(0, 4, size=int(rng.integers(*f["repeat_period"])))]
        n = sl.stop - sl.start
        seq[sl] = np.resize(unit, n)

    def lower(sl):
        seq[sl] |= 32

    def gap(sl):
        seq[sl] = ord("N")

    _mark_runs(seq, rng, f["repeats_per_mbp"], f["repeat_length"], tandem)
    _mark_runs(seq, rng, f["lowercase_per_mbp"], f["lowercase_length"], lower)
    _mark_runs(seq, rng, f["n_runs_per_mbp"], f["n_run_length"], gap)
    return seq


def _fasta_bytes(name: bytes, seq: np.ndarray, width: int) -> bytes:
    full = len(seq) // width
    lines = np.empty((full, width + 1), dtype=np.uint8)
    lines[:, :width] = seq[: full * width].reshape(full, width)
    lines[:, width] = ord("\n")
    tail = seq[full * width :].tobytes()
    return b">" + name + b"\n" + lines.tobytes() + (tail + b"\n" if tail else b"")


def assemblies(p: dict, seed: int, outdir: str) -> list:
    """The pool of assemblies of an `assemblies` traffic: `pool` files of
    plain FASTA, sizes at evenly spread quantiles of `length_bp`, each cut
    into contigs (counts at quantiles of `contigs`), in an order drawn from
    the seed. Returns [(path, records as uint8 arrays, bases)]."""
    n = int(p["pool"])
    rng = rng_for(seed, 1)
    sizes = grid_values(p["length_bp"], quantile_grid(n)).astype(np.int64)
    contigs = np.maximum(1, np.round(grid_values(p["contigs"], quantile_grid(n)))).astype(int)
    sizes = sizes[rng.permutation(n)]
    contigs = contigs[rng.permutation(n)]
    os.makedirs(outdir, exist_ok=True)
    pool = []
    for i in range(n):
        seq = assembly_sequence(int(sizes[i]), rng, p)
        cuts = np.sort(rng.choice(np.arange(1, len(seq)), size=int(contigs[i]) - 1,
                                  replace=False)) if contigs[i] > 1 else np.zeros(0, int)
        records = np.split(seq, cuts)
        path = os.path.join(outdir, f"assembly_{i}.fa")
        with open(path, "wb") as fh:
            for j, rec in enumerate(records):
                fh.write(_fasta_bytes(b"contig_%d_%d" % (i, j), rec, int(p["line_width"])))
        pool.append((path, records, int(len(seq))))
    return pool


def reads(p: dict, seed: int, path: str) -> tuple:
    """A `.fq.gz` of `reads_bp` bases in reads of `read_length` drawn from
    `genomes` random genomes (sizes at quantiles of `genome_bp`) with
    log-normal abundances, half from the reverse strand, with substitution
    errors at `substitution_rate`. Returns (reads as a [n, L] uint8 array,
    bases)."""
    rng = rng_for(seed, 2)
    g = int(p["genomes"])
    sizes = grid_values(p["genome_bp"], quantile_grid(g)).astype(np.int64)[rng.permutation(g)]
    genome = ACGT[rng.integers(0, 4, size=int(sizes.sum()), dtype=np.uint8)]
    starts = np.zeros(g + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    L = int(p["read_length"])
    n = int(p["reads_bp"]) // L
    weight = rng.lognormal(0.0, float(p["abundance_sigma"]), size=g) * sizes
    which = rng.choice(g, size=n, p=weight / weight.sum())
    at = starts[which] + (rng.random(n) * (sizes[which] - L + 1)).astype(np.int64)
    out = np.empty((n, L), dtype=np.uint8)
    step = 1 << 16
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[lo:hi] = genome[at[lo:hi, None] + np.arange(L)]
    rev = rng.random(n) < 0.5
    out[rev] = _COMPLEMENT[out[rev, ::-1]]
    # substitutions: a binomial count of positions, each base changed to another
    flat = out.reshape(-1)
    at_err = rng.integers(0, flat.size, size=int(rng.binomial(flat.size, float(p["substitution_rate"]))))
    code = np.searchsorted(ACGT, flat[at_err])
    flat[at_err] = ACGT[(code + rng.integers(1, 4, size=len(at_err), dtype=np.uint8)) % 4]
    # records of fixed width: "@read_NNNNNNNN\n" seq "\n+\n" quality "\n"; each read
    # takes one of 4,096 quality strings drawn from the binned-quality mix
    head = np.frombuffer(b"".join(b"@read_%08d\n" % i for i in range(n)), np.uint8).reshape(n, -1)
    lines = np.frombuffer(b"F:,#", np.uint8)[rng.choice(4, size=(4096, L), p=p["quality_mix"])]
    qual = lines[rng.integers(0, 4096, size=n)]
    rec = np.concatenate([head, out, np.full((n, 3), [ord("\n"), ord("+"), ord("\n")], np.uint8),
                          qual, np.full((n, 1), ord("\n"), np.uint8)], axis=1)
    with gzip.open(path, "wb", compresslevel=int(p["gzip_level"])) as fh:
        for lo in range(0, n, step):
            fh.write(rec[lo : lo + step].tobytes())
    return out, n * L


# -- sketch collections and gather queries -----------------------------------


def mix_hashes(counters: np.ndarray, key: int) -> np.ndarray:
    """A bijection of [0, 2^54) keyed by the seed (xor-shifts and odd
    multiplies modulo 2^54): distinct counters give distinct hashes, spread
    uniformly below 2^54."""
    x = counters.astype(np.uint64)
    x ^= np.uint64(key)
    x &= _HASH_MASK
    t = np.empty_like(x)
    with np.errstate(over="ignore"):
        for mul, shift in ((0xBF58476D1CE4E5B9, 27), (0x94D049BB133111EB, 31)):
            np.right_shift(x, np.uint64(shift), out=t)
            x ^= t
            x *= np.uint64(mul)
            x &= _HASH_MASK
        np.right_shift(x, np.uint64(29), out=t)
        x ^= t
    return x


class Collection:
    """A sketch collection of `genomes` members in clades (the model of
    `chip_smoke.make_collection`, with the configuration's shares): clade
    sizes drawn from `clade_size`, each member holding `genome_hashes`
    hashes of which a share drawn from `core_share` is a prefix of its
    clade's core of `core_hashes`, the rest its own: two members of a clade
    share the shorter of their prefixes. Every hash is distinct but where
    shared on purpose, by construction: hash = mix(counter), with counters
    [clade * core | fresh].
    Holds flat hashes (each member's ascending), offsets, clade ids and
    names."""

    def __init__(self, p: dict, seed: int):
        rng = rng_for(seed, 3)
        self.key = int(rng.integers(0, 1 << 62))
        n = int(p["genomes"])
        core = int(p["core_hashes"])
        lo, hi = p["clade_size"]
        sizes_c = rng.integers(lo, hi + 1, size=n // lo + 1)
        ends = np.cumsum(sizes_c)
        n_clades = int(np.searchsorted(ends, n) + 1)
        self.clade = np.repeat(np.arange(n_clades), sizes_c[:n_clades])[:n]
        self.core = core
        glo, ghi = p["genome_hashes"]
        size = rng.integers(glo, ghi + 1, size=n)
        slo, shi = p["core_share"]
        kept = (size * rng.uniform(slo, shi, size=n)).astype(np.int64)
        fresh = size - kept
        self.offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(size, out=self.offsets[1:])
        # counters: a member's kept core j is clade * core + j; its own
        # hashes count on from n_clades * core (made a block of members at
        # a time, to bound the temporaries)
        own = n_clades * core + np.cumsum(fresh) - fresh - kept
        self.hashes = np.empty(int(self.offsets[-1]), dtype=np.uint64)
        for b in range(0, n, 256):
            e = min(n, b + 256)
            sz = size[b:e]
            pos = np.arange(int(self.offsets[e] - self.offsets[b]), dtype=np.int64) - np.repeat(
                self.offsets[b:e] - self.offsets[b], sz)
            counters = np.where(pos < np.repeat(kept[b:e], sz),
                                np.repeat(self.clade[b:e] * core, sz) + pos,
                                np.repeat(own[b:e], sz) + pos)
            block = mix_hashes(counters, self.key)
            base = self.offsets[b]
            for g in range(b, e):  # each member's hashes ascending, as a sketch holds them
                lo, hi = self.offsets[g] - base, self.offsets[g + 1] - base
                block[lo:hi].sort()
            self.hashes[self.offsets[b] : self.offsets[e]] = block
        self.next_counter = n_clades * core + int(fresh.sum())
        self.n = n
        self.names = [f"genome_{i} clade_{c}" for i, c in enumerate(self.clade.tolist())]

    def genome(self, i: int) -> np.ndarray:
        return self.hashes[self.offsets[i] : self.offsets[i + 1]]

    def fresh(self, count: int) -> np.ndarray:
        "count hashes held by no member (and by no earlier fresh draw)."
        out = mix_hashes(np.arange(self.next_counter, self.next_counter + count), self.key)
        self.next_counter += count
        return out


def size_points(p: dict, count: int) -> np.ndarray:
    """The quantiles at which the `count` queries' sizes lie, the same for
    every seed: with a `cycle` of n, query j takes the evenly spread
    quantile (j mod n + 0.5) / n, so each whole cycle of n queries holds the
    same sizes; without one, the low-discrepancy points of base 2."""
    n = int(p.get("cycle", 0))
    if n > 0:
        return (np.arange(count) % n + 0.5) / n
    return van_der_corput(count, 2)


def gather_queries(p: dict, coll: Collection, seed: int, count: int) -> list:
    """`count` gather queries: sizes of `size` at `size_points`, each of the
    kind its point picks by the `kinds` weights (low-discrepancy points of
    base 3). Kinds: `genomes` (collection members in seeded order, each
    contributing a share drawn from `keep`, until they make `share` of the
    distinct hashes, the last one in part; the rest fresh), `member` (a
    share drawn from `keep` of one member's hashes, the rest fresh).
    Abundances uniform in `abundance` or none. Returns [(hashes,
    abundances or None, the kind's `name`)]."""
    rng = rng_for(seed, 4)
    sizes = np.round(grid_values(p["size"], size_points(p, count))).astype(np.int64)
    kinds = p["kinds"]
    w = np.cumsum([k["weight"] for k in kinds], dtype=float)
    pick = np.searchsorted(w / w[-1], van_der_corput(count, 3), side="right")
    out = []
    for target, kind in zip(sizes.tolist(), pick.tolist()):
        spec = kinds[min(kind, len(kinds) - 1)]
        q = _query(spec, coll, rng, int(target))
        ab = p.get("abundance")
        abunds = rng.integers(ab[0], ab[1] + 1, size=len(q)).astype(np.int64) if ab else None
        out.append((q, abunds, spec.get("name", spec["from"])))
    return out


def _query(spec: dict, coll: Collection, rng, target: int) -> np.ndarray:
    lo, hi = spec["keep"]
    if spec["from"] == "member":
        g = coll.genome(int(rng.integers(coll.n)))
        part = rng.permutation(g)[: int(target * rng.uniform(lo, hi))]
        return np.unique(np.r_[part, coll.fresh(target - len(part))])
    if spec["from"] != "genomes":
        raise ValueError(f"unknown query kind {spec['from']!r}")
    want = int(spec["share"] * target)
    mean = float(np.mean(np.diff(coll.offsets[: min(coll.n, 1000) + 1])))
    take = min(coll.n, int(2 * want / (mean * (lo + hi) / 2)) + 8)
    order = rng.permutation(coll.n)[:take]
    lens = coll.offsets[order + 1] - coll.offsets[order]
    idx = np.repeat(coll.offsets[order] - np.r_[0, np.cumsum(lens)[:-1]], lens) + np.arange(int(lens.sum()))
    keep = rng.random(len(idx)) < np.repeat(rng.uniform(lo, hi, size=take), lens)
    vals = coll.hashes[idx[keep]]
    member = np.repeat(np.arange(take), lens)[keep]
    # the first `want` distinct hashes in the members' order: the last
    # member contributes part of its share
    _, first = np.unique(vals, return_index=True)
    part = vals[np.sort(first)[:want]]
    return np.unique(np.r_[part, coll.fresh(max(0, target - len(part)))])
