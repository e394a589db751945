"""Where the port builds what it compiles at first use (the native host
library and the CUDA kernels): `build/` beside the package in a checkout,
or SOURMASH_TORCH_BUILD_DIR. Each artifact's file name carries a hash of
its sources, so a changed source builds anew and stale builds are never
loaded."""

from __future__ import annotations

import hashlib
import os

BUILD_DIR_ENV = "SOURMASH_TORCH_BUILD_DIR"


def build_dir(kind: str) -> str:
    "The directory for artifacts of one kind ('native', 'kernels'), created."
    root = os.environ.get(BUILD_DIR_ENV) or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build"
    )
    path = os.path.join(root, kind)
    os.makedirs(path, exist_ok=True)
    return path


def sources_tag(paths, *extra: str) -> str:
    "A short hash of the sources' bytes and any extra strings (flags)."
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(f.read())
    for e in extra:
        h.update(e.encode())
    return h.hexdigest()[:16]
