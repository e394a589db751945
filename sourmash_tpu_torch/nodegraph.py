"""Nodegraph: a Bloom filter over hash values, khmer/OXLI-compatible.

The port's copy of `sourmash_tpu/nodegraph.py`; a nodegraph either package
saves loads in the other, byte for byte. Behavior parity: reference `src/core/src/sketch/nodegraph.rs` (tables of
prime sizes :70-109, count/get :111-143, OXLI binary format :179-290) and
the Python wrapper `src/sourmash/nodegraph.py`.

Host code: tables are numpy packed-bit arrays and all updates / membership
checks are vectorized over whole hash arrays at once (the reference sets
one bit at a time through FFI). String k-mers hash through the port's
`minhash.hash_murmur` (`ops/murmur.hash_murmur_scalar`).
"""

from __future__ import annotations

import gzip
import struct
import sys
from io import BytesIO

import numpy as np

from .minhash import MinHash
from .exceptions import SourmashError


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def _tablesizes(tablesize: int, n_tables: int):
    "Primes descending from tablesize-1 (reference `with_tables` :86-103)."
    sizes = []
    i = max(int(tablesize) - 1, 2)
    if i % 2 == 0:
        i -= 1
    while len(sizes) != n_tables:
        if _is_prime(i):
            sizes.append(i)
        if i == 1:
            break
        i -= 2
    return sizes


class Nodegraph:
    "Bloom filter over uint64 hashes with khmer-compatible binary IO."

    def __init__(self, ksize, starting_size, n_tables, _tables=None):
        if _tables is not None:
            self._sizes = [s for s, _ in _tables]
            self._bits = [t for _, t in _tables]
        else:
            self._sizes = _tablesizes(int(starting_size), int(n_tables))
            self._bits = [
                np.zeros(s // 8 + 1, dtype=np.uint8) for s in self._sizes
            ]
        self._ksize = int(ksize)
        self.occupied_bins = 0
        self.unique_kmers = 0

    # -- core ops ---------------------------------------------------------

    def count(self, h):
        "Insert a hash (or k-mer string); return True if new."
        if isinstance(h, str):
            from .minhash import hash_murmur

            h = hash_murmur(h)
        is_new = False
        for i, (size, bits) in enumerate(zip(self._sizes, self._bits)):
            bin_ = int(h) % size
            byte, bit = bin_ >> 3, bin_ & 7
            mask = np.uint8(1 << bit)
            if not (bits[byte] & mask):
                bits[byte] |= mask
                if i == 0:
                    self.occupied_bins += 1
                is_new = True
        if is_new:
            self.unique_kmers += 1
        return is_new

    def get(self, h):
        "Return 1 if the hash (or k-mer) might be present, 0 otherwise."
        if isinstance(h, str):
            from .minhash import hash_murmur

            h = hash_murmur(h)
        for size, bits in zip(self._sizes, self._bits):
            bin_ = int(h) % size
            if not (bits[bin_ >> 3] & np.uint8(1 << (bin_ & 7))):
                return 0
        return 1

    def count_many(self, hashes: np.ndarray):
        "Vectorized insert of many hashes."
        hashes = np.asarray(hashes, dtype=np.uint64)
        newly = np.ones(len(hashes), dtype=bool)
        for i, (size, bits) in enumerate(zip(self._sizes, self._bits)):
            bins = (hashes % np.uint64(size)).astype(np.int64)
            bytes_ = bins >> 3
            masks = np.uint8(1) << (bins & 7).astype(np.uint8)
            present = (bits[bytes_] & masks) != 0
            newly &= ~present
            if i == 0:
                # occupied_bins counts distinct bits newly set in table 0
                newbits = ~present
                if newbits.any():
                    uniq = np.unique(bins[newbits])
                    self.occupied_bins += len(uniq)
            np.bitwise_or.at(bits, bytes_, masks)
        self.unique_kmers += int(newly.sum())

    def get_many(self, hashes: np.ndarray) -> np.ndarray:
        "Vectorized membership: bool array."
        hashes = np.asarray(hashes, dtype=np.uint64)
        out = np.ones(len(hashes), dtype=bool)
        for size, bits in zip(self._sizes, self._bits):
            bins = (hashes % np.uint64(size)).astype(np.int64)
            present = (bits[bins >> 3] & (np.uint8(1) << (bins & 7).astype(np.uint8))) != 0
            out &= present
        return out

    def update(self, other):
        "Union with another Nodegraph, or insert all mins of a MinHash."
        if isinstance(other, Nodegraph):
            if self._sizes != other._sizes:
                raise SourmashError("cannot merge nodegraphs with different sizes")
            total = 0
            for i, (mine, theirs) in enumerate(zip(self._bits, other._bits)):
                if i == 0:
                    before = int(np.unpackbits(mine, bitorder="little").sum())
                np.bitwise_or(mine, theirs, out=mine)
                if i == 0:
                    after = int(np.unpackbits(mine, bitorder="little").sum())
                    total = after - before
            self.occupied_bins += total
        elif isinstance(other, MinHash):
            self.count_many(other.mins_array())
        else:
            raise TypeError("Must be a Nodegraph or MinHash")

    def matches(self, mh) -> int:
        "Number of mh's mins present in this nodegraph."
        if not isinstance(mh, MinHash):
            raise ValueError("mh must be a MinHash")
        return int(self.get_many(mh.mins_array()).sum())

    def similarity(self, other):
        "Bitwise Jaccard across tables (reference :296-313)."
        union = 0
        inter = 0
        for mine, theirs in zip(self._bits, other._bits):
            inter += int(np.unpackbits(mine & theirs, bitorder="little").sum())
            union += int(np.unpackbits(mine | theirs, bitorder="little").sum())
        return inter / union if union else 0.0

    def containment(self, other):
        mine_total = 0
        inter = 0
        for mine, theirs in zip(self._bits, other._bits):
            inter += int(np.unpackbits(mine & theirs, bitorder="little").sum())
            mine_total += int(np.unpackbits(mine, bitorder="little").sum())
        return inter / mine_total if mine_total else 0.0

    def n_occupied(self):
        return self.occupied_bins

    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return list(self._sizes)

    @property
    def expected_collisions(self):
        """False-positive rate estimate (reference `nodegraph.rs:145-152`):
        (occupied_bins / min_table_size) ** n_tables."""
        min_size = min(self._sizes)
        n_ht = len(self._sizes)
        return (self.occupied_bins / min_size) ** n_ht

    # -- khmer OXLI binary IO ---------------------------------------------

    def to_bytes(self, compression=1) -> bytes:
        out = BytesIO()
        out.write(b"OXLI")
        out.write(struct.pack("B", 4))  # version
        out.write(struct.pack("B", 2))  # ht_type
        out.write(struct.pack("<I", self._ksize))
        out.write(struct.pack("B", len(self._sizes)))
        out.write(struct.pack("<Q", self.occupied_bins))
        for size, bits in zip(self._sizes, self._bits):
            out.write(struct.pack("<Q", size))
            byte_size = size // 8 + 1
            buf = bits[:byte_size].tobytes()
            if len(buf) < byte_size:
                buf = buf + b"\x00" * (byte_size - len(buf))
            out.write(buf)
        data = out.getvalue()
        if compression:
            data = gzip.compress(data, compresslevel=compression, mtime=0)
        return data

    def save(self, filename):
        with open(filename, "wb") as f:
            f.write(self.to_bytes(compression=0))

    @classmethod
    def from_buffer(cls, buf):
        if buf[:2] == b"\x1f\x8b":
            buf = gzip.decompress(bytes(buf))
        f = BytesIO(bytes(buf))
        magic = f.read(4)
        if magic != b"OXLI":
            raise SourmashError(f"invalid nodegraph signature {magic!r}")
        version = struct.unpack("B", f.read(1))[0]
        assert version == 4, version
        ht_type = struct.unpack("B", f.read(1))[0]
        assert ht_type == 2, ht_type
        ksize = struct.unpack("<I", f.read(4))[0]
        n_tables = struct.unpack("B", f.read(1))[0]
        occupied = struct.unpack("<Q", f.read(8))[0]
        tables = []
        for _ in range(n_tables):
            size = struct.unpack("<Q", f.read(8))[0]
            byte_size = size // 8 + 1
            # stored as u32 blocks: ceil to 4-byte multiple... the writer
            # writes exactly byte_size bytes (trailing partial u32 truncated)
            bits = np.frombuffer(f.read(byte_size), dtype=np.uint8).copy()
            tables.append((size, bits))
        ng = cls(ksize, 0, 0, _tables=tables)
        ng.occupied_bins = occupied
        return ng

    @classmethod
    def load(cls, filename):
        with open(filename, "rb") as f:
            return cls.from_buffer(f.read())


def extract_nodegraph_info(filename):
    "Peek header info of a nodegraph file."
    with open(filename, "rb") as f:
        data = f.read(27)
    if data[:2] == b"\x1f\x8b":
        with open(filename, "rb") as f:
            data = gzip.open(f).read(27)
    signature = data[:4]
    if signature != b"OXLI":
        raise ValueError(
            f"Node graph '{filename}' is missing file type signature" + str(signature)
        )
    version, ht_type = data[4], data[5]
    ksize = struct.unpack("<I", data[6:10])[0]
    n_tables = data[10]
    occupied = struct.unpack("<Q", data[11:19])[0]
    table_size = struct.unpack("<Q", data[19:27])[0]
    return ksize, round(table_size, -2), n_tables, version, ht_type, occupied


def calc_expected_collisions(graph, force=False, max_false_pos=0.2):
    """Check a nodegraph's estimated false-positive rate; print the
    khmer-style warning banner and abort (unless force) when too high."""
    fp_all = graph.expected_collisions
    if fp_all > max_false_pos:
        banner = (
            "**\n"
            "** ERROR: the graph structure is too small for \n"
            "** this data set.  Increase data structure size.\n"
            "** Do not use these results!!\n"
            "**\n"
            f"** (estimated false positive rate of {fp_all:.3f}; "
            f"max recommended {max_false_pos:.3f})\n"
            "**"
        )
        print(banner, file=sys.stderr)
        if not force:
            raise SystemExit(1)
    return fp_all
