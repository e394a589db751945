"""ctypes binding for the native C++ host code: the FASTA/FASTQ batch
parser (fastx.cpp), the threaded canonical-k-mer sketch loop (sketch.cpp),
the sketch md5 digester (sigmd5.cpp), the .sig array scanner
(sigjson.cpp), the bucketed-plane packer (pack.cpp) and the membership
bitset builder (membership.cpp). The sources are copies of
`sourmash_tpu/native/`.

The shared library is compiled with g++ on first use into the port's own
build directory (`buildpaths.build_dir("native")`), keyed by a hash of the
sources, so checkouts stay source-only. A failed build raises: the port has
no second parser or sketch loop behind this one.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..buildpaths import build_dir, sources_tag

_HERE = os.path.dirname(__file__)
_SOURCES = [
    os.path.join(_HERE, name)
    for name in (
        "fastx.cpp", "sketch.cpp", "sigmd5.cpp", "sigjson.cpp", "pack.cpp",
        "membership.cpp",
    )
]
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
_lib = None


def _compile(sopath):
    tmp = f"{sopath}.tmp{os.getpid()}"
    cmd = ["g++", *_FLAGS, *_SOURCES, "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError("building the native host library needs g++") from exc
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(
            f"native host library build failed: {' '.join(cmd)}\n{exc.stderr}"
        ) from exc
    os.replace(tmp, sopath)


def build():
    "Compile (if needed) and load the shared library."
    global _lib
    if _lib is not None:
        return _lib
    tag = sources_tag(_SOURCES, *_FLAGS)
    sopath = os.path.join(build_dir("native"), f"libsourmash_host_{tag}.so")
    if not os.path.exists(sopath):
        _compile(sopath)
    lib = ctypes.CDLL(sopath)
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.fastx_read_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.fastx_read_batch.restype = ctypes.c_int64
    lib.sketch_hashes.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int32,
    ]
    lib.sketch_hashes.restype = ctypes.c_int64
    lib.hash_windows.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_uint32,
        ctypes.c_void_p,
        ctypes.c_int32,
    ]
    lib.hash_windows.restype = ctypes.c_int64
    lib.sketch_md5_hex.argtypes = [
        ctypes.c_int64,   # ksize
        ctypes.c_void_p,  # mins u64*
        ctypes.c_int64,   # n
        ctypes.c_char_p,  # out hex[32]
    ]
    lib.sketch_md5_hex.restype = ctypes.c_int64
    lib.sig_scan_arrays.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sig_scan_arrays.restype = ctypes.c_int64
    lib.sig_extract_arrays.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p,  # values u64*
        ctypes.c_void_p,  # arr_off i64*
        ctypes.c_void_p,  # spans i64*
        ctypes.c_void_p,  # kind u8*
    ]
    lib.sig_extract_arrays.restype = ctypes.c_int64
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    # vals, offs, n, rows, B, d, hi, lo, cnt, spill_rows, spill_vals,
    # spill_cap, n_threads
    lib.pack_rows_native.argtypes = [P, P, I64, I64, I64, I32, P, P, P, P, P, I64, I32]
    lib.pack_rows_native.restype = ctypes.c_int64
    # vals, offs, n, rows, L, hi, lo, n_threads
    lib.split_limbs_native.argtypes = [P, P, I64, I64, I64, P, P, I32]
    lib.split_limbs_native.restype = None
    # q, nq, vals, offs, k, M, W, n_threads
    lib.membership_bits_native.argtypes = [P, I64, P, P, I64, P, I64, I32]
    lib.membership_bits_native.restype = ctypes.c_int64
    _lib = lib
    return lib


def iter_batches(path, target_bytes=8 << 20, max_records=65536):
    """Yield (names:list[str], seq_blob:bytes, seq_offsets:np.int64[n+1])
    batches from a plain or gzip FASTA/FASTQ file.

    Raises ValueError on malformed input; OSError if the file can't be
    opened.
    """
    lib = build()
    handle = lib.fastx_open(os.fsencode(path))
    if not handle:
        raise OSError(f"cannot open '{path}'")

    seq_cap = int(target_bytes)
    name_cap = 1 << 20
    try:
        while True:
            seq_buf = np.empty(seq_cap, dtype=np.uint8)
            name_buf = np.empty(name_cap, dtype=np.uint8)
            seq_off = np.empty(max_records + 1, dtype=np.int64)
            name_off = np.empty(max_records + 1, dtype=np.int64)
            n = lib.fastx_read_batch(
                handle,
                seq_buf.ctypes.data_as(ctypes.c_void_p),
                seq_cap,
                seq_off.ctypes.data_as(ctypes.c_void_p),
                name_buf.ctypes.data_as(ctypes.c_void_p),
                name_cap,
                name_off.ctypes.data_as(ctypes.c_void_p),
                max_records,
            )
            if n == 0:
                return
            if n == -1:
                raise ValueError(
                    "invalid sequence file: does not start with '>' or '@'"
                )
            if n == -2:  # a single record larger than the buffers: grow, retry
                seq_cap *= 4
                name_cap *= 4
                continue
            n = int(n)
            blob = seq_buf[: seq_off[n]].tobytes()
            nb = name_buf[: name_off[n]].tobytes()
            names = [
                nb[name_off[i] : name_off[i + 1]].decode("utf-8", "replace")
                for i in range(n)
            ]
            yield names, blob, seq_off[: n + 1].copy()
    finally:
        lib.fastx_close(handle)


def iter_records_bytes(path):
    "Yield (name, seq_bytes) via the native parser."
    for names, blob, off in iter_batches(path):
        for i, name in enumerate(names):
            yield name, blob[off[i] : off[i + 1]]


def sketch_md5(ksize, mins):
    """Hex md5 over decimal ksize + each decimal min (the reference's
    sketch identity)."""
    lib = build()
    mins = np.ascontiguousarray(mins, dtype=np.uint64)
    out = ctypes.create_string_buffer(32)
    lib.sketch_md5_hex(
        ctypes.c_int64(int(ksize)),
        mins.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(mins)),
        out,
    )
    return out.raw.decode("ascii")


def extract_sig_arrays(buf: bytes):
    """Scan .sig JSON bytes for the "mins"/"abundances" integer arrays
    (see sigjson.cpp). Returns (values u64[], arr_off i64[n+1],
    spans i64[n,2] byte ranges incl. brackets, kinds u8[n] 0=mins
    1=abundances), or None when the buffer needs the general JSON path
    (floats, nulls, malformed)."""
    lib = build()
    n = len(buf)
    na = ctypes.c_int64(0)
    nv = ctypes.c_int64(0)
    if lib.sig_scan_arrays(buf, n, ctypes.byref(na), ctypes.byref(nv)) != 0:
        return None
    na, nv = int(na.value), int(nv.value)
    values = np.empty(nv, dtype=np.uint64)
    arr_off = np.empty(na + 1, dtype=np.int64)
    spans = np.empty((na, 2), dtype=np.int64)
    kinds = np.empty(na, dtype=np.uint8)
    rc = lib.sig_extract_arrays(
        buf, n,
        values.ctypes.data_as(ctypes.c_void_p),
        arr_off.ctypes.data_as(ctypes.c_void_p),
        spans.ctypes.data_as(ctypes.c_void_p),
        kinds.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return values, arr_off, spans, kinds


def sketch_hashes(seq: "np.ndarray", ksize: int, seed: int, max_hash: int, n_threads: int = 0):
    """Native canonical-kmer murmur + threshold hot loop.

    seq: uppercased uint8 array. Returns (survivors uint64 array in window
    order with multiplicity, first_bad byte index or -1). Thread-chunked
    above 2^18 windows.
    """
    lib = build()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.shape[0]
    nwin = n - ksize + 1
    if nwin <= 0:
        return np.zeros(0, dtype=np.uint64), -1
    # expected survivors ~ nwin * scaled-fraction; headroom then retry
    frac = (int(max_hash) + 1) / float(1 << 64)
    cap = int(nwin * frac * 2) + 1024
    first_bad = ctypes.c_int64(-1)
    while True:
        out = np.empty(cap, dtype=np.uint64)
        got = lib.sketch_hashes(
            seq.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(n),
            ctypes.c_int32(ksize),
            ctypes.c_uint32(seed),
            ctypes.c_uint64(int(max_hash)),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(cap),
            ctypes.byref(first_bad),
            ctypes.c_int32(n_threads),
        )
        if got >= 0:
            return out[:got], int(first_bad.value)
        cap = int(-got) + 16


def hash_windows(seq: "np.ndarray", ksize: int, seed: int, n_threads: int = 0):
    """murmur64 of every k-byte window (no canonicalization/validity) —
    the protein-family hot loop. Returns uint64[n-k+1] in window order."""
    lib = build()
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.shape[0]
    nwin = n - ksize + 1
    if nwin <= 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.empty(nwin, dtype=np.uint64)
    got = lib.hash_windows(
        seq.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        ctypes.c_int32(ksize),
        ctypes.c_uint32(seed),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int32(n_threads),
    )
    return out[: int(got)]


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _pack(vals, offs, n, rows, B, d, planes, n_threads):
    """pack_rows_native into `planes` (hi, lo or (None, None)) and a fresh
    cnt; returns (cnt, spill_rows, spill_vals), growing the spill buffers
    until they hold every spill."""
    lib = build()
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    cnt = np.empty((rows, B), dtype=np.uint8)
    cap = 4096
    while True:
        spill_rows = np.empty(cap, dtype=np.int64)
        spill_vals = np.empty(cap, dtype=np.uint64)
        ret = int(lib.pack_rows_native(
            _ptr(vals), _ptr(offs), n, rows, B, d, _ptr(planes[0]),
            _ptr(planes[1]), _ptr(cnt), _ptr(spill_rows), _ptr(spill_vals),
            cap, n_threads,
        ))
        if ret >= 0:
            return cnt, spill_rows[:ret], spill_vals[:ret]
        cap = -ret


def pack_rows(vals, offs, n, rows, B, d, n_threads=0):
    """Thread-parallel bucketed-plane pack (see pack.cpp).

    vals: concatenated per-row-sorted u64 hashes; offs: int64[n+1] row
    boundaries. Returns (hi [rows,d,B] u32, lo, cnt [rows,B] u8,
    spill_rows i64[k], spill_vals u64[k]), value-identical to the numpy
    pack in ops/bucketed.pack_rows_bucketed."""
    hi = np.empty((rows, d, B), dtype=np.uint32)
    lo = np.empty((rows, d, B), dtype=np.uint32)
    cnt, spill_rows, spill_vals = _pack(vals, offs, n, rows, B, d, (hi, lo), n_threads)
    return hi, lo, cnt, spill_rows, spill_vals


def pack_spills(vals, offs, n, rows, B, d, n_threads=0):
    """cnt and the spill lists only, for callers that pack the hi/lo
    planes on the device (ops/bucketed.pack_rows_device). Returns
    (cnt, spill_rows, spill_vals)."""
    return _pack(vals, offs, n, rows, B, d, (None, None), n_threads)


def split_limbs(vals, offs, n, rows, L, n_threads=0):
    """Concatenated u64 rows -> PAD-padded [rows, L] (hi, lo) u32 limb
    planes (thread-chunked, PAD fill fused with the copy)."""
    lib = build()
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    hi = np.empty((rows, L), dtype=np.uint32)
    lo = np.empty((rows, L), dtype=np.uint32)
    lib.split_limbs_native(_ptr(vals), _ptr(offs), n, rows, L, _ptr(hi), _ptr(lo), n_threads)
    return hi, lo


def membership_bits(q, vals, offs, k, W, n_threads=0):
    """Thread-parallel membership bitsets (see membership.cpp): bit p of
    M[r] set iff q[p] (sorted distinct u64 query) is present in dataset r
    (vals/offs concatenated sorted rows). Returns M [k, W] u32."""
    lib = build()
    q = np.ascontiguousarray(q, dtype=np.uint64)
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    M = np.empty((k, W), dtype=np.uint32)
    lib.membership_bits_native(_ptr(q), len(q), _ptr(vals), _ptr(offs), k, _ptr(M), W, n_threads)
    return M
