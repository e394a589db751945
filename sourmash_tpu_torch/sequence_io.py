"""FASTA/FASTQ reading (replaces the reference's use of the `screed` library,
`command_sketch.py:318`).

Minimal, fast, dependency-free: format + compression sniffing, buffered
parsing, records yielded as (name, sequence-bytes).  The batch interface
`iter_record_batches` feeds the device sketching pipeline with large
concatenated buffers (records joined by k-1 'N' separator bytes, which the
kernel drops as invalid windows) instead of per-record Python loops.

The port's copy of `sourmash_tpu/sequence_io.py`.
"""

from __future__ import annotations

import bz2
import gzip
import io
from dataclasses import dataclass


@dataclass
class Record:
    name: str
    sequence: str

    def __getitem__(self, key):  # screed-style access
        return getattr(self, key)


def _open_maybe_compressed(path):
    if path == "-":
        import sys

        path = sys.stdin.buffer
    if hasattr(path, "read"):
        f = path
        if hasattr(f, "seekable") and f.seekable():
            f.seek(0)  # rewind before sniffing: object may have been read
            head = f.read(2)
            f.seek(0)
        else:
            head = f.read(2)
            # non-seekable stream (stdin, pipes): chain the sniffed bytes back
            f = io.BufferedReader(_Chain(head, f))
    else:
        f = open(path, "rb")
        head = f.read(2)
        f.seek(0)
    if head == b"\x1f\x8b":
        return gzip.open(f, "rb")
    if head == b"BZ":
        return bz2.open(f, "rb")
    return f


def open_reader(path):
    "Open a (possibly gzip/bzip2 compressed) FASTA/FASTQ file."
    return _open_maybe_compressed(path)


def iter_records(path):
    """Yield Record(name, sequence) from a FASTA/FASTQ file.

    Matches screed semantics: name is the full header line minus '>'/'@'.
    """
    for name, seq in iter_records_bytes(path):
        yield Record(name=name, sequence=seq.decode("ascii"))


def _native_ok(path):
    "Native parser handles plain/gzip file paths (not bz2, not streams)."
    if hasattr(path, "read") or path == "-":
        return False
    try:
        with open(path, "rb") as f:
            head = f.read(2)
    except OSError:
        return False
    return head != b"BZ"


def iter_records_bytes(path):
    "Yield (name:str, seq:bytes) tuples."
    if _native_ok(path):
        from . import native

        yield from native.iter_records_bytes(path)
        return
    we_opened = not hasattr(path, "read")
    f = _open_maybe_compressed(path)
    try:
        first = f.read(1)
        if not first:
            return
        rest = io.BufferedReader(_Chain(first, f)) if not hasattr(f, "peek") else None
        # simpler: re-open logic — read whole stream line-wise
        stream = io.BufferedReader(_Chain(first, f))
        c = first[:1]
        if c == b">":
            yield from _iter_fasta(stream)
        elif c == b"@":
            yield from _iter_fastq(stream)
        else:
            raise ValueError(
                f"invalid sequence file: does not start with '>' or '@'"
            )
    finally:
        if we_opened:
            f.close()


class _Chain(io.RawIOBase):
    "Raw stream chaining an initial bytes chunk with a file object."

    def __init__(self, head: bytes, f):
        self._head = head
        self._f = f

    def readable(self):
        return True

    def readinto(self, b):
        if self._head:
            n = min(len(b), len(self._head))
            b[:n] = self._head[:n]
            self._head = self._head[n:]
            return n
        data = self._f.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)


def _iter_fasta(stream):
    name = None
    chunks = []
    for line in stream:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if name is not None:
                yield name, b"".join(chunks)
            name = line[1:].decode("utf-8", "replace")
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield name, b"".join(chunks)


def _iter_fastq(stream):
    while True:
        header = stream.readline()
        if not header:
            return
        header = header.rstrip(b"\r\n")
        if not header:
            continue
        if not header.startswith(b"@"):
            raise ValueError("malformed FASTQ record header")
        seq = stream.readline().rstrip(b"\r\n")
        plus = stream.readline()
        if not plus.startswith(b"+"):
            raise ValueError("malformed FASTQ record separator")
        qual = stream.readline()
        yield header[1:].decode("utf-8", "replace"), seq


def iter_record_batches(path, ksize: int, target_bytes: int = 8 << 20):
    """Yield (names, joined_seq_bytes) batches for device sketching.

    Records are joined with (ksize-1) b'N' bytes so no k-mer window spans a
    record boundary. `names` is the list of record names in the batch.
    """
    sep = b"N" * (ksize - 1)
    if _native_ok(path):
        from . import native

        for bnames, blob, off in native.iter_batches(path, target_bytes=target_bytes):
            mv = memoryview(blob)
            joined = sep.join(
                mv[off[i] : off[i + 1]] for i in range(len(bnames))
            )
            yield bnames, joined
        return
    names: list[str] = []
    parts: list[bytes] = []
    size = 0
    for name, seq in iter_records_bytes(path):
        names.append(name)
        if parts:
            parts.append(sep)
            size += len(sep)
        parts.append(seq)
        size += len(seq)
        if size >= target_bytes:
            yield names, b"".join(parts)
            names, parts, size = [], [], 0
    if parts or names:
        yield names, b"".join(parts)
