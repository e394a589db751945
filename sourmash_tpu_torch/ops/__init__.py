"""Device compute ops: the sketch paths (`ops/sketch.py`, K1-K3) and the
bucketed counts, membership and gather-round engine (`ops/bucketed.py`,
`ops/index_ops.py`, `ops/intersect.py`: counts_rows, membership_bits,
round_dec and their batch forms, and the sharded program's shard_match;
compare's all-pairs joins in `ops/cuda_pairwise.py`) on a CUDA device, with hand-written kernels in `csrc/` and
PyTorch around them, plus the numpy host twins.

Device rule: every entry point runs on CUDA unless the caller asks for the
CPU, through a `device=` argument or, for the CLI, SOURMASH_TORCH_DEVICE.
Asking for CUDA where there is none raises; nothing drops to the CPU on its
own. (Counterpart of `sourmash_tpu/ops/__init__.py:default_backend`.)
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "SOURMASH_TORCH_DEVICE"


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on: `device` if given, else
    SOURMASH_TORCH_DEVICE, else "cuda". Raises RuntimeError for CUDA on a
    machine without one, and ValueError for a device type that is neither
    CUDA nor the CPU."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"sourmash_tpu_torch runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch sees no CUDA device; "
            f"pass device='cpu' or set {DEVICE_ENV}=cpu to run on the CPU"
        )
    return dev
