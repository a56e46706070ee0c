"""Device selection for the port's entry points.

The port targets an NVIDIA GPU: ``None`` means ``cuda``.  A CUDA request
on a machine without one raises instead of silently running on the CPU;
the CPU is used only when the caller asks for it (as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
