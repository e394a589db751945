"""Build, load and launch the port's hand-written CUDA kernels.

Each source in `csrc/` (`sketch.cu`: K1, K2, K3; `gather.cu`: counts_rows,
membership_bits, round_dec, and the batch forms membership_bits_batch and
round_dec_batch; `block_join.cu`: the join of a query block against a
chunk's rows, counts_block and products_block; `pairwise.cu`: compare's
all-pairs joins pairwise_counts and pairwise_products; `sketch_parts.cu`:
the sketch-kernel instruments T2, T3, T4 and the integer-pipe probe;
`parallel.cu`: shard_match, the sharded gather program's compare) has a
plain C interface with an error-string entry, and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own `build/kernels/<name>_<hash>.so` at
first use, then loaded with ctypes.
The hash covers the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source builds anew and the other sources keep their
builds; an edited header builds every library anew. `build()` starts one
`nvcc` per missing library, all at once. `nvcc` is taken from CUDA_HOME, then PATH,
then /usr/local/cuda. A missing `nvcc` or a failed build raises: there is
no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

from ..buildpaths import build_dir, sources_tag

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = {
    name: os.path.join(_CSRC, f"{name}.cu")
    for name in ("sketch", "gather", "block_join", "pairwise", "sketch_parts", "parallel")
}
HEADERS = sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh"))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
# library -> (error-string entry, {C entry -> argtypes}); pointers and the
# stream as void*, sizes as int
_LIBRARIES = {
    "sketch": ("sm_error_string", {
        # seq, B, S, n_pad, ksize, seed, hashes, valid, stream
        "sm_window_hashes": [_P, _I, _I, _I, _I, _U64, _P, _P, _P],
        # seq, B, S, n_pad, ksize, seed, hashes, valid, stream
        "sm_aa_window_hashes": [_P, _I, _I, _I, _I, _U64, _P, _P, _P],
        # seq, B, S, n, R, ksize, seed, max_hash, slots, hi, lo, counts, stream
        "sm_survivor_slots": [_P, _I, _I, _I, _I, _I, _U64, _U64, _I, _P, _P, _P, _P],
    }),
    "gather": ("gm_error_string", {
        # qhi, qlo, dq, B, shi, slo, rows, cut_hi, cut_lo, out, stream
        "gm_counts_rows": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P],
        # qhi, qlo, qcnt, B, shi, slo, scnt, sel, nm, inv, W, out, stream
        "gm_membership_bits": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P],
        # M, rm, k, W, out, stream
        "gm_round_dec": [_P, _P, _I, _I, _P, _P],
        # qhi, qlo, qcnt, bq, dq, B, shi, slo, scnt, sel, cap, inv, W, table, groups,
        # out, stream
        "gm_membership_bits_batch": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P,
                                     _I, _P, _P],
        # M, rm, Q, k, W, out, stream
        "gm_round_dec_batch": [_P, _P, _I, _I, _I, _P, _P],
    }),
    "block_join": ("bj_error_string", {
        # weighted, cap (out); called directly, no stream
        "bj_join_capacity": [_I, _P],
        # qhi, qlo, qav, qcnt, bq, dq, shi, slo, sav, scnt, rows, d, B, tile_log2, meta,
        # g_key, g_head, g_next, g_row, g_ab, cap, out, stream
        "bj_join": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                    _I, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    }),
    "pairwise": ("pw_error_string", {
        # weighted, blocks, cap (out); called directly, no stream
        "pw_join_capacity": [_I, _I, _P],
        # hi, lo, av, cnt, rows, d, B, tile_log2, meta, g_key, g_head, g_next, g_row, g_ab,
        # cap, out, stream
        "pw_join": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P],
    }),
    "sketch_parts": ("sp_error_string", {
        # seq, B, S, n_pad, ksize, nw, words, valid, stream
        "sp_split_words": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
        # words, valid, B, n_pad, R, ksize, nw, seed, max_hash, slots, hi, lo, counts, stream
        "sp_split_slots": [_P, _P, _I, _I, _I, _I, _I, _U64, _U64, _I, _P, _P, _P, _P],
        # seq, B, S, n, R, ksize, seed, max_hash, slots, hi, lo, counts, stream
        "sp_survivor_slots_v2": [_P, _I, _I, _I, _I, _I, _U64, _U64, _I, _P, _P, _P, _P],
        # blocks, nblk, rows, out, stream
        "sp_murmur_only": [_P, _I, _I, _P, _P],
        "sp_assembly_only": [_P, _I, _I, _P, _P],
        # blocks, nblk, rows, n_rounds, out, stream
        "sp_mulchain": [_P, _I, _I, _I, _P, _P],
        # blocks, nblk, rows, mode, n_rounds, out, stream
        "sp_int_probe": [_P, _I, _I, _I, _I, _P, _P],
    }),
    "parallel": ("pm_error_string", {
        # qhi, qlo, alive, bq, dq, B, shi, slo, scnt, rows, d, out_rows, row0, table,
        # table_bytes, counts, M, stream
        "pm_shard_match": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _U64, _P, _P,
                           _P],
    }),
}
_libs: dict = {}


def nvcc_path() -> str:
    "The nvcc executable; raises RuntimeError when there is none."
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "the CUDA kernels need nvcc (CUDA_HOME, PATH or /usr/local/cuda/bin)"
    )


def _so_path(name: str) -> str:
    tag = sources_tag([SOURCES[name], *HEADERS], *NVCC_FLAGS)
    return os.path.join(build_dir("kernels"), f"{name}_{tag}.so")


def build(names=None) -> dict:
    """Compile every library of `names` (default: all) that is not built
    yet, one nvcc each, all started together. Returns {name: nvcc's log}
    (ptxas' register and spill report) for the libraries it built."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(_so_path(n))]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = f"{_so_path(name)}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (cmd, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"CUDA kernel build failed: {' '.join(cmd)}\n{out}")
            continue
        os.replace(tmp, _so_path(name))
        logs[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str):
    "The loaded kernel library `name`, built first if needed."
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(_so_path(name))
    err_fn, signatures = _LIBRARIES[name]
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, err_fn).argtypes = [ctypes.c_int]
    getattr(lib, err_fn).restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def launch(name: str, fn_name: str, device, *args) -> None:
    """Call the C entry `fn_name` of library `name` with `args` and the
    current stream of `device`; raise if the launch was refused."""
    lib = load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = getattr(lib, _LIBRARIES[name][0])(rc).decode()
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc} ({msg})")
