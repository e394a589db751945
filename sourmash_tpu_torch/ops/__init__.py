"""Device compute ops: the DNA sketch path on a CUDA device (hand-written
kernels in `csrc/`, PyTorch around them) and the numpy host twins.

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
