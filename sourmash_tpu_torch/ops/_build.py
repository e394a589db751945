"""Build and load the port's hand-written CUDA kernels.

`csrc/sketch.cu` has a plain C interface (with an `sm_error_string(code)`
entry for messages) and is compiled by `nvcc` for Hopper (`sm_90a`) into
`build/kernels/sketch_<hash>.so` at first use, then loaded with ctypes. The
hash covers the source and the flags, so an edited source builds anew.
`nvcc` is taken from CUDA_HOME, then PATH, then /usr/local/cuda. A missing
`nvcc` or a failed build raises: there is no fallback to another
implementation.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from ..buildpaths import build_dir, sources_tag

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "sketch.cu"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
# C entry -> argtypes (pointers and the stream as void*, sizes as int)
_SIGNATURES = {
    # seq, B, S, n_pad, ksize, seed, hashes, valid, stream
    "sm_window_hashes": [_P, _I, _I, _I, _I, _U64, _P, _P, _P],
    # seq, B, S, n_pad, ksize, seed, hashes, valid, stream
    "sm_aa_window_hashes": [_P, _I, _I, _I, _I, _U64, _P, _P, _P],
    # seq, B, S, n, R, ksize, seed, max_hash, slots, hi, lo, counts, stream
    "sm_survivor_slots": [_P, _I, _I, _I, _I, _I, _U64, _U64, _I, _P, _P, _P, _P],
}
_lib = None


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


def _so_path() -> str:
    tag = sources_tag([SOURCE], *NVCC_FLAGS)
    return os.path.join(build_dir("kernels"), f"sketch_{tag}.so")


def build() -> str:
    """Compile csrc/sketch.cu unless it is built already. Returns nvcc's log
    (ptxas' register and spill report), or "" when nothing was built."""
    so = _so_path()
    if os.path.exists(so):
        return ""
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    try:
        done = subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(
            f"CUDA kernel build failed: {' '.join(cmd)}\n{exc.stdout}{exc.stderr}"
        ) from exc
    os.replace(tmp, so)
    return done.stdout + done.stderr


def load():
    "The loaded kernel library, built first if needed."
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(_so_path())
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.sm_error_string.argtypes = [ctypes.c_int]
    lib.sm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
