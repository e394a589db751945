"""MinHash / FrozenMinHash: the FracMinHash sketch object model.

API parity with reference `src/sourmash/minhash.py` (MinHash at :162,
FrozenMinHash at :1152) and semantics parity with the Rust core
`src/core/src/sketch/minhash.rs` (KmerMinHash).  Sketches are stored
host-side as sorted numpy uint64 arrays (not opaque Rust handles); per-k-mer
hot loops are replaced by whole-sequence hashing (the native C++ loop or
`ops/encodings.py` on the host, `ops/sketch.py` on the CUDA device for long
DNA sequences and amino-acid streams), and set operations are sorted-array
merges instead of element-wise inserts.

The PyTorch port of `sourmash_tpu/minhash.py`: the object model is the same
code; the device hooks in `add_sequence` and `add_protein` go to the port's
CUDA sketch paths, and `minhash_from_arrays` builds a sketch from plain
arrays.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from .ops import encodings as enc
from .ops.murmur import hash_murmur_scalar

__all__ = ["MinHash", "FrozenMinHash", "hash_murmur", "minhash_from_arrays"]

MINHASH_DEFAULT_SEED = 42
MINHASH_MAX_HASH = 0xFFFFFFFFFFFFFFFF

# length from which DNA sequences are hashed on the device
_DEVICE_MIN_LEN = 1 << 16


def get_minhash_default_seed():
    "Return the default seed value used for the MurmurHash hashing function."
    return MINHASH_DEFAULT_SEED


def get_minhash_max_hash():
    "Return the maximum hash value."
    return MINHASH_MAX_HASH


def _get_max_hash_for_scaled(scaled):
    """Convert a scaled value into a max_hash value.

    Rust-truncation semantics (`minhash.rs:21-27`): sketches created by the
    reference always carry this exact value in `.sig` files.
    """
    if scaled == 0:
        return 0
    elif scaled == 1:
        return MINHASH_MAX_HASH
    return int(np.float64(18446744073709551615) / np.float64(scaled))


def _get_scaled_for_max_hash(max_hash):
    """Convert a max_hash value into a scaled value (Python `round`
    semantics, reference `minhash.py:62-67` — used for the displayed/compared
    `scaled` property)."""
    if max_hash == 0:
        return 0
    return min(int(round(MINHASH_MAX_HASH / max_hash, 0)), MINHASH_MAX_HASH)


def to_bytes(s):
    if isinstance(s, bytes):
        return s
    if not isinstance(s, (str, bytes, int)):
        raise TypeError("Requires a string-like sequence")
    if isinstance(s, str):
        return s.encode("utf-8")
    return bytes([s])


def hash_murmur(kmer, seed=MINHASH_DEFAULT_SEED):
    "Compute a murmur64 hash for a string, matching reference `hash_murmur`."
    return hash_murmur_scalar(to_bytes(kmer), seed)


def translate_codon(codon):
    "Translate a codon into an amino acid (reference `minhash.py:96-103`)."
    return enc.translate_codon(codon)


def flatten_and_downsample_scaled(mh, *scaled_vals):
    "Flatten MinHash object and downsample to max of scaled values."
    assert mh.scaled
    assert all(x > 0 for x in scaled_vals)
    mh = mh.flatten()
    scaled = max(scaled_vals)
    if mh.scaled < scaled:
        return mh.downsample(scaled=scaled)
    return mh


def flatten_and_downsample_num(mh, *num_vals):
    "Flatten MinHash object and downsample to min of num values."
    assert mh.num
    assert all(x > 0 for x in num_vals)
    mh = mh.flatten()
    num = min(num_vals)
    if mh.num > num:
        return mh.downsample(num=num)
    return mh


def flatten_and_intersect_scaled(mh1, mh2):
    "Flatten and downsample two scaled MinHash objs, then return intersection."
    scaled = max(mh1.scaled, mh2.scaled)
    f1 = mh1.flatten().downsample(scaled=scaled)
    f2 = mh2.flatten().downsample(scaled=scaled)
    return f1 & f2


def _unique_sorted(a: np.ndarray) -> np.ndarray:
    """Distinct values of a uint64 array, sorted. Sort-based: numpy 2's
    hash-based np.unique/np.union1d is many times slower on the tens of
    millions of hashes a genome-scale insert brings."""
    a = np.sort(a)
    if a.size > 1:
        a = a[np.concatenate(([True], a[1:] != a[:-1]))]
    return a


def _num_cutoff(hashes: np.ndarray, num: int):
    """The num-th smallest distinct value of `hashes` (its largest when it
    holds fewer): a num sketch keeps no hash above it. Partitions around
    ever larger ranks instead of sorting everything."""
    k = 4 * num
    while k < hashes.size:
        cut = np.partition(hashes, k - 1)[k - 1]
        below = _unique_sorted(hashes[hashes <= cut])
        if below.size >= num:
            return below[num - 1]
        k *= 4
    distinct = _unique_sorted(hashes)
    return distinct[min(num, distinct.size) - 1]


class _HashesDict(Mapping):
    "Read-only mapping view {hash: abundance} over parallel numpy arrays."

    def __init__(self, mins, abunds):
        self._mins = mins
        self._abunds = abunds

    def __getitem__(self, h):
        i = np.searchsorted(self._mins, np.uint64(h))
        if i < len(self._mins) and self._mins[i] == np.uint64(h):
            return int(self._abunds[i]) if self._abunds is not None else 1
        raise KeyError(h)

    def __iter__(self):
        return (int(x) for x in self._mins)

    def __len__(self):
        return len(self._mins)

    def items(self):
        if self._abunds is None:
            return [(int(h), 1) for h in self._mins]
        return [(int(h), int(a)) for h, a in zip(self._mins, self._abunds)]

    def __setitem__(self, k, v):
        raise RuntimeError("cannot modify hashes directly; use add_hash")

    def __delitem__(self, k):
        raise RuntimeError("cannot modify hashes directly; use remove_many")


class MinHash:
    """The core sketch object.

    Constructor signature mirrors reference `minhash.py:162-255`.
    """

    def __init__(
        self,
        n,
        ksize,
        *,
        is_protein=False,
        dayhoff=False,
        hp=False,
        track_abundance=False,
        seed=MINHASH_DEFAULT_SEED,
        max_hash=0,
        mins=None,
        scaled=0,
    ):
        if max_hash and scaled:
            raise ValueError("cannot set both max_hash and scaled")
        elif scaled:
            max_hash = _get_max_hash_for_scaled(scaled)
        if max_hash and n:
            raise ValueError("cannot set both n and max_hash")
        if not n and not (max_hash or scaled):
            raise ValueError("cannot omit both min_hash and scaled")
        if dayhoff or hp:
            is_protein = False

        if dayhoff:
            self._moltype = "dayhoff"
        elif hp:
            self._moltype = "hp"
        elif is_protein:
            self._moltype = "protein"
        else:
            self._moltype = "DNA"

        self._num = int(n)
        # internal _ksize is the serialized value: 3x the aa ksize for
        # protein-family moltypes (reference minhash.py:75-84)
        if self._moltype != "DNA":
            ksize = int(ksize) * 3
        self._ksize = int(ksize)
        self._seed = int(seed)
        self._max_hash = int(max_hash)
        # _max_hash never changes after construction, so the derived
        # scaled can be computed once (warm queries iterate big
        # collections checking .scaled per signature)
        self._scaled_cache = _get_scaled_for_max_hash(self._max_hash)
        self._track_abundance = bool(track_abundance)
        self._mins = np.zeros(0, dtype=np.uint64)
        self._abunds = np.zeros(0, dtype=np.uint64) if track_abundance else None
        self._md5cache = None

        if mins:
            if track_abundance:
                self.set_abundances(dict(mins))
            else:
                self.add_many(mins)

    # -- basics ----------------------------------------------------------

    def __copy__(self):
        a = MinHash(
            self._num,
            self.ksize,
            is_protein=self.is_protein,
            dayhoff=self.dayhoff,
            hp=self.hp,
            track_abundance=self._track_abundance,
            seed=self._seed,
            max_hash=self._max_hash,
        )
        a._mins = self._mins.copy()
        a._abunds = None if self._abunds is None else self._abunds.copy()
        a._md5cache = self._md5cache
        return a

    copy = __copy__

    def __getstate__(self):
        return (
            self._num,
            self.ksize,
            self.is_protein,
            self.dayhoff,
            self.hp,
            self._mins.tolist()
            if self._abunds is None
            else dict(self.hashes.items()),
            None,
            self._track_abundance,
            self._max_hash,
            self._seed,
        )

    def __setstate__(self, tup):
        (n, ksize, is_protein, dayhoff, hp, mins, _, track_abundance, max_hash, seed) = tup
        self.__class__ = MinHash
        self.__init__(
            n,
            ksize,
            is_protein=is_protein,
            dayhoff=dayhoff,
            hp=hp,
            track_abundance=track_abundance,
            seed=seed,
            max_hash=max_hash,
        )
        if track_abundance:
            self.set_abundances(mins)
        else:
            self.add_many(mins)

    def __reduce__(self):
        return (_rebuild_minhash, self.__getstate__())

    def __eq__(self, other):
        if not isinstance(other, MinHash):
            return NotImplemented
        return self.__getstate__() == other.__getstate__()

    def __len__(self):
        return len(self._mins)

    def __iter__(self):
        return (int(x) for x in self._mins)

    def __contains__(self, h):
        i = np.searchsorted(self._mins, np.uint64(h))
        return bool(i < len(self._mins) and self._mins[i] == np.uint64(h))

    def copy_and_clear(self):
        "Create an empty copy of this MinHash (same parameters)."
        return MinHash(
            self._num,
            self.ksize,
            is_protein=self.is_protein,
            dayhoff=self.dayhoff,
            hp=self.hp,
            track_abundance=self._track_abundance,
            seed=self._seed,
            max_hash=self._max_hash,
        )

    # -- properties ------------------------------------------------------

    @property
    def num(self):
        return self._num

    @property
    def ksize(self):
        if self._moltype != "DNA":
            assert self._ksize % 3 == 0
            return self._ksize // 3
        return self._ksize

    @property
    def seed(self):
        return self._seed

    @property
    def scaled(self):
        return self._scaled_cache

    @property
    def is_dna(self):
        return self._moltype == "DNA"

    @property
    def is_protein(self):
        return self._moltype == "protein"

    @property
    def dayhoff(self):
        return self._moltype == "dayhoff"

    @property
    def hp(self):
        return self._moltype == "hp"

    @property
    def moltype(self):
        return self._moltype

    @property
    def track_abundance(self):
        return self._track_abundance

    @track_abundance.setter
    def track_abundance(self, b):
        if self._track_abundance == b:
            return
        if b is False:
            self._abunds = None
            self._track_abundance = False
            return
        if len(self) != 0:
            raise RuntimeError(
                "Can only set track_abundance=True if the MinHash is empty"
            )
        self._abunds = np.zeros(0, dtype=np.uint64)
        self._track_abundance = True

    @property
    def hashes(self):
        return _HashesDict(self._mins, self._abunds)

    def get_mins(self, with_abundance=False):
        """Return hashes, or (hash -> abund) if with_abundance (deprecated
        reference API, `minhash.py:504-511`)."""
        import warnings

        warnings.warn(
            "get_mins is deprecated; use .hashes instead",
            DeprecationWarning,
            stacklevel=2,
        )
        mins = self.hashes
        if not with_abundance:
            return mins.keys()
        return mins

    def get_hashes(self):
        "Return the list of hashes (deprecated reference API)."
        import warnings

        warnings.warn(
            "get_hashes is deprecated; use .hashes instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.hashes.keys()

    def mins_array(self):
        "Internal: sorted uint64 numpy array of mins (no copy)."
        return self._mins

    def abunds_array(self):
        return self._abunds

    # -- mutation --------------------------------------------------------

    def _invalidate(self):
        self._md5cache = None

    def _set_mins_internal(self, mins, abunds=None):
        "Internal fast-path: mins sorted unique uint64; abunds matching."
        self._mins = mins
        if self._track_abundance:
            if abunds is None:
                abunds = np.ones(len(mins), dtype=np.uint64)
            self._abunds = abunds
        self._invalidate()

    def _insert_hashes(self, hashes: np.ndarray, abunds: np.ndarray | None = None):
        """Insert a batch of (hash, abund) pairs; hashes need not be unique
        or sorted. Applies scaled threshold and num-minhash trimming."""
        self._invalidate()
        if hashes.size == 0:
            return
        hashes = hashes.astype(np.uint64, copy=False)
        if self._max_hash:
            if abunds is None:
                keep = hashes <= np.uint64(self._max_hash)
                hashes = hashes[keep]
            else:
                keep = hashes <= np.uint64(self._max_hash)
                hashes = hashes[keep]
                abunds = abunds[keep]
        elif self._num == 0:
            return  # "why did you create this minhash?" (minhash.rs:326)

        if self._num and hashes.size > 4 * self._num:
            # only hashes up to the num-th smallest distinct one can reach
            # the mins: drop the rest before any sort (a whole genome's
            # window hashes shrink to about num)
            keep = hashes <= _num_cutoff(hashes, self._num)
            hashes = hashes[keep]
            if abunds is not None:
                abunds = abunds[keep]

        if hashes.size == 0:
            return

        # bulk-load fast path: inserting already-sorted distinct hashes
        # into an EMPTY sketch (downsample/flatten/copy, loader paths) is
        # a straight assignment — the union1d/argsort merges below cost a
        # full sort per call and dominated gather's per-round stats
        if len(self._mins) == 0 and bool(np.all(hashes[:-1] < hashes[1:])):
            self._mins = hashes.copy()
            if self._track_abundance:
                self._abunds = (
                    abunds.astype(np.uint64, copy=True)
                    if abunds is not None
                    else np.ones(len(hashes), dtype=np.uint64)
                )
            if self._num and len(self._mins) > self._num:
                self._mins = self._mins[: self._num]
                if self._abunds is not None:
                    self._abunds = self._abunds[: self._num]
            return

        if self._track_abundance:
            if abunds is None:
                uniq, counts = np.unique(hashes, return_counts=True)
                counts = counts.astype(np.uint64)
            else:
                order = np.argsort(hashes, kind="stable")
                hs = hashes[order]
                ab = abunds.astype(np.uint64, copy=False)[order]
                uniq, start = np.unique(hs, return_index=True)
                counts = np.add.reduceat(ab, start).astype(np.uint64)
            # merge with existing
            merged = np.concatenate([self._mins, uniq])
            merged_ab = np.concatenate([self._abunds, counts])
            order = np.argsort(merged, kind="stable")
            ms, asum = merged[order], merged_ab[order]
            out_mins, start = np.unique(ms, return_index=True)
            out_ab = np.add.reduceat(asum, start).astype(np.uint64)
            self._mins, self._abunds = out_mins, out_ab
        else:
            self._mins = _unique_sorted(np.concatenate([self._mins, hashes]))

        if self._num and len(self._mins) > self._num:
            self._mins = self._mins[: self._num]
            if self._abunds is not None:
                self._abunds = self._abunds[: self._num]

    def add_hash(self, h):
        self._insert_hashes(np.array([h], dtype=np.uint64))

    def add_hash_with_abundance(self, h, a):
        if not self._track_abundance:
            raise RuntimeError(
                "Use track_abundance=True when constructing "
                "the MinHash to use add_hash_with_abundance."
            )
        self._insert_hashes(
            np.array([h], dtype=np.uint64), np.array([a], dtype=np.uint64)
        )

    def remove_hash(self, h):
        self._invalidate()
        i = np.searchsorted(self._mins, np.uint64(h))
        if i < len(self._mins) and self._mins[i] == np.uint64(h):
            self._mins = np.delete(self._mins, i)
            if self._abunds is not None:
                self._abunds = np.delete(self._abunds, i)

    remove = remove_hash

    def remove_many(self, hashes):
        "Remove many hashes at once; ``hashes`` is an iterable or MinHash."
        if isinstance(hashes, MinHash):
            arr = hashes._mins  # sorted distinct: one searchsorted pass
        else:
            arr = np.sort(np.fromiter((int(h) for h in hashes), dtype=np.uint64))
        self._invalidate()
        if len(arr) and len(self._mins):
            idx = np.searchsorted(arr, self._mins)
            np.minimum(idx, len(arr) - 1, out=idx)
            keep = arr[idx] != self._mins
            self._mins = self._mins[keep]
            if self._abunds is not None:
                self._abunds = self._abunds[keep]

    def add_many(self, hashes):
        "Add many hashes at once; ``hashes`` is an iterable or MinHash."
        if isinstance(hashes, MinHash):
            self._insert_hashes(hashes._mins)
        elif isinstance(hashes, np.ndarray) and hashes.dtype == np.uint64:
            self._insert_hashes(hashes)
        else:
            self._insert_hashes(np.fromiter((int(h) for h in hashes), dtype=np.uint64))

    def clear(self):
        self._invalidate()
        self._mins = np.zeros(0, dtype=np.uint64)
        if self._abunds is not None:
            self._abunds = np.zeros(0, dtype=np.uint64)

    # -- sequence hashing -------------------------------------------------

    def _dna_window_hashes(self, seq_u8, force=False):
        """Canonical in-order window hashes + validity for DNA bytes.

        The numpy twin (`ops/encodings.dna_hashes`).
        Raises on invalid k-mers unless `force`.
        """
        h, valid = enc.dna_hashes(seq_u8, self._ksize, self._seed)
        if not force and not valid.all():
            bad = int(np.argmin(valid))
            kmer = seq_u8[bad : bad + self._ksize].tobytes().decode("ascii", "replace")
            raise ValueError(f"invalid DNA character in input k-mer: {kmer}")
        return h, valid

    def add_sequence(self, sequence, force=False, *, device=None):
        """Add a DNA sequence into the sketch. For protein-family sketches
        this six-frame translates the DNA first (reference
        `signature.rs:38-58` add_sequence dispatch).

        DNA sequences of at least `_DEVICE_MIN_LEN` bytes are hashed on
        `device` (default: `ops.resolve_device()`, CUDA unless
        SOURMASH_TORCH_DEVICE names the CPU); shorter ones on the host.
        SOURMASH_TORCH_HOST_SKETCH=native (or =numpy) keeps every length
        on the native C++ loop (or the numpy twin)."""
        if isinstance(sequence, str):
            sequence = sequence.encode("ascii")
        if not self.is_dna:
            seq = enc.upper(np.frombuffer(sequence, dtype=np.uint8))
            if seq.shape[0] < self.ksize * 3:
                return
            h = enc.translate_hashes(
                seq, self.ksize, self._moltype, self._seed, device=device
            )
            self._insert_hashes(h)
            return
        seq = enc.upper(np.frombuffer(sequence, dtype=np.uint8))
        if seq.shape[0] < self._ksize:
            return
        mode = enc.host_sketch_mode()
        if seq.shape[0] >= _DEVICE_MIN_LEN and mode == "auto":
            all_valid = bool(enc.VALID_DNA[seq].all())
            if not all_valid and not force:
                # find the first window with an invalid byte, for the error
                bad = int(np.argmin(enc.VALID_DNA[seq]))
                start = max(0, bad - self._ksize + 1)
                kmer = seq[start : start + self._ksize].tobytes().decode(
                    "ascii", "replace"
                )
                raise ValueError(f"invalid DNA character in input k-mer: {kmer}")
            # device path: validity-masked survivors (== force semantics)
            from .ops.sketch import seq_chunks_to_hashes

            hs = seq_chunks_to_hashes(
                seq.tobytes(),
                self._ksize,
                self._max_hash if self._max_hash else MINHASH_MAX_HASH,
                self._seed,
                device=device,
            )
            self._insert_hashes(hs)
            return
        if mode != "numpy":
            # native C++ hot loop (threaded rolling canonical murmur;
            # native/sketch.cpp) — ~100x the numpy path per core
            from . import native as _native

            hs, first_bad = _native.sketch_hashes(
                seq,
                self._ksize,
                self._seed,
                self._max_hash if self._max_hash else MINHASH_MAX_HASH,
            )
            if first_bad >= 0 and not force:
                start = max(0, first_bad - self._ksize + 1)
                kmer = seq[start : start + self._ksize].tobytes().decode(
                    "ascii", "replace"
                )
                raise ValueError(f"invalid DNA character in input k-mer: {kmer}")
            self._insert_hashes(hs)
            return
        h, valid = self._dna_window_hashes(seq, force=force)
        self._insert_hashes(h[valid])

    def add_kmer(self, kmer):
        """Add a (DNA) k-mer into the sketch; protein-family sketches
        translate it (reference `minhash.py:462-471`)."""
        if self.is_dna:
            if len(kmer) != self.ksize:
                raise ValueError(f"kmer to add is not {self.ksize} in length")
        else:
            if len(kmer) != self.ksize * 3:
                raise ValueError(
                    f"kmer to add is not {self.ksize * 3} in length"
                )
        self.add_sequence(kmer)

    def add_protein(self, sequence, *, device=None):
        """Add a protein sequence (already amino acids). Records of at least
        2^16 windows are hashed on `device` (see `ops/encodings.protein_hashes`)."""
        if self.is_dna:
            raise ValueError('Invalid hash function: "DNA"')
        if isinstance(sequence, str):
            sequence = sequence.encode("ascii")
        seq = enc.upper(np.frombuffer(sequence, dtype=np.uint8))
        h = enc.protein_hashes(seq, self.ksize, self._moltype, self._seed, device=device)
        self._insert_hashes(h)

    def seq_to_hashes(
        self,
        sequence,
        *,
        force=False,
        bad_kmers_as_zeroes=False,
        is_protein=False,
    ):
        """Convert a sequence into hashes, in window order (reference
        `minhash.py:462-529`). Does not add to the sketch."""
        if isinstance(sequence, str):
            sequence = sequence.encode("ascii")
        seq = enc.upper(np.frombuffer(sequence, dtype=np.uint8))
        if is_protein and self.is_dna:
            raise ValueError('Invalid hash function: "DNA"')

        if self.is_dna:
            h, valid = enc.dna_hashes(seq, self._ksize, self._seed)
            if valid.all():
                return [int(x) for x in h]
            if not force:
                bad = int(np.argmin(valid))
                kmer = seq[bad : bad + self._ksize].tobytes().decode("ascii", "replace")
                raise ValueError(f"invalid DNA character in input k-mer: {kmer}")
            if bad_kmers_as_zeroes:
                return [int(x) if v else 0 for x, v in zip(h, valid)]
            return [int(x) for x, v in zip(h, valid) if v]
        elif is_protein:
            h = enc.protein_hashes(seq, self.ksize, self._moltype, self._seed)
            return [int(x) for x in h]
        else:
            h = enc.translate_hashes(seq, self.ksize, self._moltype, self._seed)
            return [int(x) for x in h]

    def kmers_and_hashes(self, sequence, *, force=False, is_protein=False):
        """Return list of (kmer, hash) for the sequence, hash None for bad
        kmers when force (reference `minhash.py:393-460`)."""
        if isinstance(sequence, str):
            sequence = sequence.encode("ascii")
        sequence = sequence.upper().decode("ascii")
        if self.is_dna:
            ksize = self._ksize
            h = self.seq_to_hashes(
                sequence, force=force, bad_kmers_as_zeroes=force
            )
            kmers = [sequence[i : i + ksize] for i in range(len(sequence) - ksize + 1)]
            return [
                (k, int(x) if x else None) for k, x in zip(kmers, h)
            ]
        if is_protein:
            # aa windows of aa-ksize; hashes may be dayhoff/hp-remapped but
            # the yielded kmer is the raw aa window (reference
            # `minhash.py:454-460`).
            ksize = self.ksize
            h = self.seq_to_hashes(sequence, is_protein=True)
            return [
                (sequence[i : i + ksize], x)
                for i, x in zip(range(len(sequence) - ksize + 1), h)
            ]
        # translate: DNA windows of 3*aa_ksize in frame order
        # fwd,rc per frame 0,1,2 (reference `minhash.py:432-453`), matching
        # ops.encodings.translate_hashes ordering.
        ksize = self.ksize * 3
        h = self.seq_to_hashes(sequence)
        arr = enc.upper(np.frombuffer(sequence.encode("ascii"), dtype=np.uint8))
        seqrc = enc.revcomp(arr).tobytes().decode("ascii")
        out = []
        hash_i = 0
        for frame in (0, 1, 2):
            for s in (sequence, seqrc):
                for start in range(0, len(s) - ksize + 1 - frame, 3):
                    out.append((s[start + frame : start + frame + ksize], h[hash_i]))
                    hash_i += 1
        assert hash_i == len(h)
        return out

    # -- comparison -------------------------------------------------------

    def is_compatible(self, other):
        return (
            isinstance(other, MinHash)
            and self._ksize == other._ksize
            and self._seed == other._seed
            and self._moltype == other._moltype
        )

    def check_compatible(self, other):
        """Raise unless comparable: TypeError for non-MinHash, ValueError
        subclasses for parameter mismatches (reference `minhash.rs:886-913`
        errors mapped through `exceptions.py`)."""
        from .exceptions import (
            MismatchDNAProt,
            MismatchKSizes,
            MismatchScaled,
            MismatchSeed,
        )

        if not isinstance(other, MinHash):
            raise TypeError("Must be a MinHash!")
        if self._ksize != other._ksize:
            raise MismatchKSizes("different ksizes cannot be compared")
        if self._moltype != other._moltype:
            raise MismatchDNAProt(
                "DNA/prot minhashes cannot be compared"
            )
        if self._seed != other._seed:
            raise MismatchSeed("mismatch in seed; comparison fail")
        if self._max_hash != other._max_hash:
            raise MismatchScaled("mismatch in scaled; comparison fail")

    def _intersection_size(self, other):
        """Raw sorted-array intersection count: one searchsorted of the
        SMALLER array into the larger (the count is symmetric), so a
        genome-vs-metagenome overlap costs O(m log n), not O(n log m)."""
        a, b = self._mins, other._mins
        if not len(a) or not len(b):
            return 0
        if len(a) < len(b):
            a, b = b, a
        idx = np.searchsorted(a, b)
        np.minimum(idx, len(a) - 1, out=idx)
        return int(np.count_nonzero(a[idx] == b))

    def count_common(self, other, downsample=False):
        """Return number of hashes in common; optionally downsample scaled
        objects to the larger scaled (`minhash.rs:538-557`)."""
        if not isinstance(other, MinHash):
            raise TypeError("Must be a MinHash!")
        if downsample and self.scaled != other.scaled:
            if self.scaled > other.scaled:
                first, second = self, other
            else:
                first, second = other, self
            return first.count_common(second.downsample(scaled=first.scaled), False)
        self.check_compatible(other)
        return self._intersection_size(other)

    def _union_mins(self, other):
        "Union as a num-trimmed or full sorted array (`minhash.rs` merge)."
        u = np.union1d(self._mins, other._mins)
        if self._num and len(u) > self._num:
            u = u[: self._num]
        return u

    def intersection_and_union_size(self, other):
        "Calculate intersection and union sizes (`minhash.rs:593-621`)."
        if not isinstance(other, MinHash):
            raise TypeError("Must be a MinHash!")
        if not self.is_compatible(other):
            raise TypeError("incompatible MinHash objects")
        self.check_compatible(other)
        if self._num:
            u = self._union_mins(other)
            common = np.intersect1d(self._mins, other._mins)
            common = np.intersect1d(common, u)
            return len(common), len(u)
        common = self._intersection_size(other)
        union = len(self._mins) + len(other._mins) - common
        return common, union

    def jaccard(self, other, downsample=False):
        "Calculate Jaccard similarity of two MinHash objects."
        if self.num != other.num:
            raise TypeError(f"must have same num: {self.num} != {other.num}")
        return self.similarity(other, ignore_abundance=True, downsample=downsample)

    def similarity(self, other, ignore_abundance=False, downsample=False):
        """Similarity: Jaccard (flat) or angular similarity (abund),
        dispatch per `minhash.rs:682-702`."""
        if not isinstance(other, MinHash):
            raise TypeError("Must be a MinHash!")
        if downsample and self.scaled != other.scaled:
            if self.scaled > other.scaled:
                first, second = self, other
            else:
                first, second = other, self
            return first.similarity(
                second.downsample(scaled=first.scaled),
                ignore_abundance=ignore_abundance,
                downsample=False,
            )
        if ignore_abundance or self._abunds is None or other._abunds is None:
            self.check_compatible(other)
            common, union = self.intersection_and_union_size(other)
            return common / max(1, union)
        return self.angular_similarity(other)

    def angular_similarity(self, other):
        "Abundance-weighted angular similarity (`minhash.rs:635-680`)."
        self.check_compatible(other)
        if self._abunds is None or other._abunds is None:
            raise TypeError(
                "Error: Angular (cosine) similarity requires both sketches to track hash abundance."
            )
        a_sq = float(np.sum(self._abunds.astype(np.float64) ** 2))
        b_sq = float(np.sum(other._abunds.astype(np.float64) ** 2))
        # merge-join product over common hashes
        idx = np.searchsorted(other._mins, self._mins)
        idx_c = np.clip(idx, 0, len(other._mins) - 1) if len(other._mins) else idx
        if len(other._mins):
            match = other._mins[idx_c] == self._mins
            prod = float(
                np.sum(
                    self._abunds[match].astype(np.float64)
                    * other._abunds[idx_c[match]].astype(np.float64)
                )
            )
        else:
            prod = 0.0
        norm_a = np.sqrt(a_sq)
        norm_b = np.sqrt(b_sq)
        if norm_a == 0.0 or norm_b == 0.0:
            return 0.0
        prod = min(prod / (norm_a * norm_b), 1.0)
        distance = 2.0 * np.arccos(prod) / np.pi
        return 1.0 - distance

    def contained_by(self, other, downsample=False):
        "How much of self is contained by other (`minhash.py:819-841`)."
        if not (self.scaled and other.scaled):
            raise TypeError(
                "Error: can only calculate containment for scaled MinHashes"
            )
        denom = len(self)
        if not denom:
            return 0.0
        total_denom = float(denom * self.scaled)
        bias_factor = 1.0 - (1.0 - 1.0 / self.scaled) ** total_denom
        containment = self.count_common(other, downsample) / (denom * bias_factor)
        return max(0.0, min(1.0, containment))

    def max_containment(self, other, downsample=False):
        "Maximum containment (`minhash.py:880-903`)."
        if not (self.scaled and other.scaled):
            raise TypeError(
                "Error: can only calculate containment for scaled MinHashes"
            )
        min_denom = min(len(self), len(other))
        if not min_denom:
            return 0.0
        total_denom = float(min_denom * self.scaled)
        bias_factor = 1.0 - (1.0 - 1.0 / self.scaled) ** total_denom
        mc = self.count_common(other, downsample) / (min_denom * bias_factor)
        return max(0.0, min(1.0, mc))

    def avg_containment(self, other, *, downsample=False):
        "Average of the two containments (`minhash.py:945-958`)."
        if not (self.scaled and other.scaled):
            raise TypeError(
                "Error: can only calculate containment for scaled MinHashes"
            )
        c1 = self.contained_by(other, downsample)
        c2 = other.contained_by(self, downsample)
        return (c1 + c2) / 2

    # ANI wrappers live with distance_utils; imported lazily to avoid cycle
    def containment_ani(
        self,
        other,
        *,
        downsample=False,
        containment=None,
        confidence=0.95,
        estimate_ci=False,
        prob_threshold=1e-3,
    ):
        from .distance_utils import containment_to_distance

        if not (self.scaled and other.scaled):
            raise TypeError("Error: can only calculate ANI for scaled MinHashes")
        self_mh, other_mh = self, other
        scaled = self.scaled
        if downsample:
            scaled = max(self_mh.scaled, other_mh.scaled)
            self_mh = self.downsample(scaled=scaled)
            other_mh = other.downsample(scaled=scaled)
        if containment is None:
            containment = self_mh.contained_by(other_mh)
        n_kmers = len(self_mh) * scaled
        res = containment_to_distance(
            containment,
            self_mh.ksize,
            self_mh.scaled,
            n_unique_kmers=n_kmers,
            confidence=confidence,
            estimate_ci=estimate_ci,
            prob_threshold=prob_threshold,
        )
        if not self.size_is_accurate() or not other.size_is_accurate():
            res.size_is_inaccurate = True
        return res

    def jaccard_ani(
        self,
        other,
        *,
        downsample=False,
        jaccard=None,
        prob_threshold=1e-3,
        err_threshold=1e-4,
    ):
        from .distance_utils import jaccard_to_distance

        if not (self.scaled and other.scaled):
            raise TypeError("Error: can only calculate ANI for scaled MinHashes")
        self_mh, other_mh = self, other
        scaled = self.scaled
        if downsample:
            scaled = max(self_mh.scaled, other_mh.scaled)
            self_mh = self.downsample(scaled=scaled)
            other_mh = other.downsample(scaled=scaled)
        if jaccard is None:
            jaccard = self_mh.similarity(other_mh, ignore_abundance=True)
        avg_n_kmers = round((len(self_mh) + len(other_mh)) / 2) * scaled
        res = jaccard_to_distance(
            jaccard,
            self_mh.ksize,
            scaled,
            n_unique_kmers=avg_n_kmers,
            prob_threshold=prob_threshold,
            err_threshold=err_threshold,
        )
        if not self.size_is_accurate() or not other.size_is_accurate():
            res.size_is_inaccurate = True
        return res

    def max_containment_ani(
        self,
        other,
        *,
        downsample=False,
        max_containment=None,
        confidence=0.95,
        estimate_ci=False,
        prob_threshold=1e-3,
    ):
        from .distance_utils import containment_to_distance

        if not (self.scaled and other.scaled):
            raise TypeError("Error: can only calculate ANI for scaled MinHashes")
        self_mh, other_mh = self, other
        scaled = self.scaled
        if downsample:
            scaled = max(self_mh.scaled, other_mh.scaled)
            self_mh = self.downsample(scaled=scaled)
            other_mh = other.downsample(scaled=scaled)
        if max_containment is None:
            max_containment = self_mh.max_containment(other_mh)
        min_n_kmers = min(len(self_mh), len(other_mh))
        n_kmers = min_n_kmers * scaled
        res = containment_to_distance(
            max_containment,
            self_mh.ksize,
            scaled,
            n_unique_kmers=n_kmers,
            confidence=confidence,
            estimate_ci=estimate_ci,
            prob_threshold=prob_threshold,
        )
        if not self.size_is_accurate() or not other.size_is_accurate():
            res.size_is_inaccurate = True
        return res

    def avg_containment_ani(self, other, *, downsample=False, prob_threshold=1e-3):
        "Mean of the two directed containment ANIs; None if either is."
        if not (self.scaled and other.scaled):
            raise TypeError("Error: can only calculate ANI for scaled MinHashes")
        opts = dict(downsample=downsample, prob_threshold=prob_threshold)
        both = (self.containment_ani(other, **opts).ani,
                other.containment_ani(self, **opts).ani)
        if None in both:
            return None
        return sum(both) / 2

    # -- set ops ----------------------------------------------------------

    def downsample(self, *, num=None, scaled=None):
        "Copy and downsample to num or scaled (`minhash.py:663-719`)."
        if (num is None) == (scaled is None):
            raise ValueError(
                "must specify either num or scaled to downsample"
                if num is None
                else "cannot specify both num and scaled"
            )

        if num is not None:
            if self.scaled:
                raise ValueError("cannot downsample a scaled MinHash using num")
            if self.num < num:
                raise ValueError("new sample num is higher than current sample num")
            max_hash = 0
        else:
            if self.num:
                raise ValueError("cannot downsample a num MinHash using scaled")
            if self.scaled > scaled:
                raise ValueError(
                    f"new scaled {scaled} is lower than current sample scaled {self.scaled}"
                )
            num, max_hash = 0, _get_max_hash_for_scaled(scaled)

        a = MinHash(
            num,
            self.ksize,
            max_hash=max_hash,
            seed=self._seed,
            track_abundance=self._track_abundance,
            is_protein=self.is_protein,
            dayhoff=self.dayhoff,
            hp=self.hp,
        )
        if max_hash and len(self._mins):
            # scaled -> coarser scaled on a sorted array is a prefix slice
            cut = int(
                np.searchsorted(self._mins, np.uint64(max_hash), side="right")
            )
            a._set_mins_internal(
                self._mins[:cut].copy(),
                self._abunds[:cut].copy() if self._abunds is not None else None,
            )
        elif self._track_abundance:
            a._insert_hashes(self._mins, self._abunds)
        else:
            a._insert_hashes(self._mins)
        return a

    def flatten(self):
        "Return a non-abundance copy (self if already flat)."
        if self._track_abundance:
            a = MinHash(
                self._num,
                self.ksize,
                is_protein=self.is_protein,
                dayhoff=self.dayhoff,
                hp=self.hp,
                track_abundance=False,
                seed=self._seed,
                max_hash=self._max_hash,
            )
            a._insert_hashes(self._mins)
            return a
        return self

    def __add__(self, other):
        if not isinstance(other, MinHash):
            raise TypeError("can only add MinHash objects to MinHash objects!")
        if self.num and other.num and self.num != other.num:
            raise TypeError(
                f"incompatible num values: self={self.num} other={other.num}"
            )
        merged = self.to_mutable()
        merged += other
        return merged

    __or__ = __add__

    def __iadd__(self, other):
        if not isinstance(other, MinHash):
            raise TypeError("can only add MinHash objects to MinHash objects!")
        self.merge(other)
        return self

    def merge(self, other):
        "Merge other into self (union; abundances summed). `minhash.rs:432`."
        if not isinstance(other, MinHash):
            raise TypeError("can only add MinHash objects to MinHash objects!")
        self.check_compatible(other)
        if self._track_abundance:
            ab = (
                other._abunds
                if other._abunds is not None
                else np.ones(len(other._mins), dtype=np.uint64)
            )
            self._insert_hashes(other._mins, ab)
        else:
            self._insert_hashes(other._mins)

    def intersection(self, other):
        "Intersection of two flat MinHash objects (`minhash.py:1005-1013`)."
        if not isinstance(other, MinHash):
            raise TypeError("can only intersect MinHash objects")
        if self.track_abundance or other.track_abundance:
            raise TypeError("can only intersect flat MinHash objects")
        self.check_compatible(other)
        if self._num:
            u = self._union_mins(other)
            common = np.intersect1d(self._mins, other._mins)
            common = np.intersect1d(common, u)
        else:
            # both sides sorted distinct: search the smaller in the larger
            # (O(m log n), result stays sorted) instead of np.intersect1d's
            # full sort of the concatenation
            sm, lg = self._mins, other._mins
            if len(sm) > len(lg):
                sm, lg = lg, sm
            if len(sm) and len(lg):
                idx = np.searchsorted(lg, sm)
                np.minimum(idx, len(lg) - 1, out=idx)
                common = sm[lg[idx] == sm]
            else:
                common = np.zeros(0, dtype=np.uint64)
        a = self.copy_and_clear()
        a._set_mins_internal(common.astype(np.uint64))
        return a

    __and__ = intersection

    def set_abundances(self, values, clear=True):
        "Set abundances from a {hash: abund} mapping (`minhash.py:1015`)."
        if not self._track_abundance:
            raise RuntimeError(
                "Use track_abundance=True when constructing "
                "the MinHash to use set_abundances."
            )
        self._invalidate()
        hashes = []
        abunds = []
        for h, v in values.items():
            if v < 0:
                raise ValueError("Abundance cannot be set to a negative value.")
            hashes.append(int(h))
            abunds.append(int(v))
        hs = np.array(hashes, dtype=np.uint64)
        ab = np.array(abunds, dtype=np.uint64)
        nz = ab > 0
        if clear:
            self._mins = np.zeros(0, dtype=np.uint64)
            self._abunds = np.zeros(0, dtype=np.uint64)
        else:
            # zero abundance removes existing hashes
            self.remove_many(hs[~nz])
        self._insert_hashes(hs[nz], ab[nz])

    def inflate(self, from_mh):
        "Borrow abundances from from_mh for our hashes (`minhash.py:1069`)."
        if not self.track_abundance and from_mh.track_abundance:
            orig_abunds = from_mh.hashes
            abunds = {h: orig_abunds.get(h, 0) for h in self.hashes}
            abund_mh = from_mh.copy_and_clear()
            # NB: reference discards the downsample() result here
            # (minhash.py:1080-1082) — result keeps from_mh's scaled.
            abund_mh.set_abundances(abunds)
            return abund_mh
        raise ValueError(
            "inflate operates on a flat MinHash and takes a MinHash object with track_abundance=True"
        )

    # -- abundance stats ---------------------------------------------------

    @property
    def sum_abundances(self):
        if self._track_abundance:
            return int(np.sum(self._abunds))
        return None

    @property
    def mean_abundance(self):
        if self._track_abundance:
            if len(self._abunds) == 0:
                return 0.0
            return float(np.mean(self._abunds))
        return None

    @property
    def median_abundance(self):
        if self._track_abundance:
            if len(self._abunds) == 0:
                return 0.0
            return float(np.median(self._abunds))
        return None

    @property
    def std_abundance(self):
        if self._track_abundance:
            if len(self._abunds) == 0:
                return 0.0
            return float(np.std(self._abunds))
        return None

    @property
    def covered_bp(self):
        if not self.scaled:
            raise ValueError("covered_bp requires a scaled signature")
        return len(self) * self.scaled

    @property
    def unique_dataset_hashes(self):
        if not self.scaled:
            raise TypeError(
                "can only approximate unique_dataset_hashes for scaled MinHashes"
            )
        return len(self) * self.scaled

    def size_is_accurate(self, relative_error=0.20, confidence=0.95):
        "Chernoff-bound set size accuracy check (`minhash.py:1129-1151`)."
        from .distance_utils import set_size_exact_prob

        if not self.scaled:
            raise TypeError("Error: can only estimate dataset size for scaled MinHashes")
        if any([not (0 <= relative_error <= 1), not (0 <= confidence <= 1)]):
            raise ValueError(
                "Error: relative error and confidence values must be between 0 and 1."
            )
        probability = set_size_exact_prob(
            self.unique_dataset_hashes, self.scaled, relative_error=relative_error
        )
        return probability >= confidence

    # -- md5 / freezing ----------------------------------------------------

    def md5sum(self):
        "md5 over decimal ksize then each min (`minhash.rs:290-307`)."
        if self._md5cache is None:
            # native decimal-convert + digest (~5x a Python join)
            from . import native

            self._md5cache = native.sketch_md5(self._ksize, self._mins)
        return self._md5cache

    def to_mutable(self):
        "Return a mutable copy."
        return self.__copy__()

    def to_frozen(self):
        new_mh = self.__copy__()
        new_mh.into_frozen()
        return new_mh

    def into_frozen(self):
        self.__class__ = FrozenMinHash

    def __repr__(self):
        return (
            f"MinHash(seed={self._seed}, max_hash={self._max_hash}, num={self._num}, "
            f"ksize={self._ksize}, mins={len(self._mins)}, moltype={self._moltype})"
        )


def _rebuild_minhash(*state):
    mh = MinHash.__new__(MinHash)
    mh.__setstate__(state)
    return mh


class FrozenMinHash(MinHash):
    "Immutable MinHash (reference `minhash.py:1152-1257`)."

    def _frozen_error(self, *args, **kwargs):
        raise TypeError("FrozenMinHash does not support modification")

    add_sequence = _frozen_error
    add_kmer = _frozen_error
    add_protein = _frozen_error
    add_hash = _frozen_error
    add_hash_with_abundance = _frozen_error
    clear = _frozen_error
    remove_many = _frozen_error
    remove_hash = _frozen_error
    remove = _frozen_error
    set_abundances = _frozen_error
    add_many = _frozen_error
    merge = _frozen_error

    def __iadd__(self, other):
        raise TypeError("FrozenMinHash does not support modification")

    @MinHash.track_abundance.setter
    def track_abundance(self, b):
        raise TypeError("FrozenMinHash does not support modification")

    def to_mutable(self):
        mut = MinHash.__new__(MinHash)
        state = self.__getstate__()
        mut.__setstate__(state)
        return mut

    def into_frozen(self):
        pass

    def to_frozen(self):
        return self

    def __copy__(self):
        return self

    copy = __copy__

    def __setstate__(self, tup):
        (n, ksize, is_protein, dayhoff, hp, mins, _, track_abundance, max_hash, seed) = tup
        self.__class__ = FrozenMinHash
        MinHash.__init__(
            self,
            n,
            ksize,
            is_protein=is_protein,
            dayhoff=dayhoff,
            hp=hp,
            track_abundance=track_abundance,
            seed=seed,
            max_hash=max_hash,
        )
        if track_abundance:
            MinHash.set_abundances(self, mins)
        else:
            MinHash.add_many(self, mins)

    def __reduce__(self):
        return (_rebuild_frozen_minhash, self.__getstate__())


def _rebuild_frozen_minhash(*state):
    mh = FrozenMinHash.__new__(FrozenMinHash)
    mh.__setstate__(state)
    return mh


def minhash_from_arrays(params: dict, mins, abunds=None):
    """Build a MinHash from plain values: the state any implementation of
    the sketch (for example `sourmash_tpu.MinHash`) exposes.

    `params` holds `ksize` (the amino-acid ksize for protein-family
    moltypes, as `MinHash.ksize` reports it), `moltype`, `num`, `scaled` or
    `max_hash`, `seed` and `track_abundance`. `mins` are the sketch's
    distinct hashes in any order, `abunds` their abundances (given exactly
    when `track_abundance` is set). Raises ValueError on state that no
    sketch with these parameters can hold."""
    moltype = params.get("moltype", "DNA")
    if moltype not in ("DNA", "protein", "dayhoff", "hp"):
        raise ValueError(f"unknown moltype {moltype!r}")
    max_hash = int(params.get("max_hash") or 0) or _get_max_hash_for_scaled(
        int(params.get("scaled") or 0)
    )
    track = bool(params.get("track_abundance", False))
    mh = MinHash(
        int(params.get("num") or 0),
        int(params["ksize"]),
        is_protein=moltype == "protein",
        dayhoff=moltype == "dayhoff",
        hp=moltype == "hp",
        track_abundance=track,
        seed=int(params.get("seed", MINHASH_DEFAULT_SEED)),
        max_hash=max_hash,
    )
    mins = np.asarray(mins, dtype=np.uint64).reshape(-1)
    if track != (abunds is not None):
        raise ValueError("abunds must be given exactly when track_abundance is set")
    order = np.argsort(mins, kind="stable")
    mins = mins[order]
    if len(mins) > 1 and not bool(np.all(mins[:-1] < mins[1:])):
        raise ValueError("mins must be distinct")
    if max_hash and len(mins) and int(mins[-1]) > max_hash:
        raise ValueError("a hash in mins exceeds the sketch's max_hash")
    if mh.num and len(mins) > mh.num:
        raise ValueError(f"{len(mins)} mins exceed num={mh.num}")
    if abunds is not None:
        abunds = np.asarray(abunds, dtype=np.uint64).reshape(-1)
        if abunds.shape != order.shape:
            raise ValueError("mins and abunds differ in length")
        abunds = abunds[order]
    mh._set_mins_internal(mins, abunds)
    return mh
