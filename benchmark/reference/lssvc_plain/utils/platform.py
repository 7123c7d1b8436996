"""Device selection for the port's entry points.

Every entry point takes an explicit device and runs on the GPU unless the
caller asks for the CPU.  A missing GPU is an error, never a quiet fall
back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if it is a CUDA device and CUDA
    is not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
