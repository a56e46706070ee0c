"""CUDA wrapper for the fused softmax-max -> Platt -> gate kernel.

Replaces the Pallas TPU kernel ``repro/kernels/fused_calib_gate/kernel.py``
(``calib_gate``).  The kernel (``csrc/calib_gate.cu``) is memory-bound: its
least time is B·V·4 bytes / 3.35 TB/s, and at the serving shape
(B=16, V=1000) it is launch-bound.  It is built by ``nvcc`` for ``sm_90a``
on first use (``kernels/build.py``).

``calib_gate`` takes only contiguous float32 CUDA tensors and raises on
anything else: a CUDA tensor never takes the plain version, and a CPU
tensor never reaches here (``ops.calibrated_gate`` dispatches).
``calib_gate.launches`` counts launches, and only launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

_P = ctypes.c_void_p
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "calib_gate.cu",
    {"calib_gate_launch": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, _P]},
)


def _threads(V: int) -> int:
    """About 8 elements a thread, in whole warps, 32..1024 threads a row."""
    per_row = -(-V // 8)
    return min(1024, max(32, (per_row + 31) // 32 * 32))


def calib_gate(logits: torch.Tensor, a: float, b: float, theta: float):
    """logits (B, V) f32 on CUDA -> (calibrated conf (B,) f32, gate (B,) bool)."""
    if not logits.is_cuda:
        raise ValueError(f"calib_gate launches a CUDA kernel; got a tensor on {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"calib_gate takes float32 logits, got {logits.dtype}")
    if logits.ndim != 2 or logits.shape[1] < 1:
        raise ValueError(f"calib_gate takes (B, V>=1) logits, got shape {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("calib_gate takes contiguous logits")
    B, V = logits.shape
    calib = torch.empty(B, dtype=torch.float32, device=logits.device)
    gate = torch.empty(B, dtype=torch.bool, device=logits.device)
    if B == 0:
        return calib, gate
    lib = LIBRARY.load()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.calib_gate_launch(logits.data_ptr(), calib.data_ptr(), gate.data_ptr(),
                                    B, V, float(a), float(b), float(theta), _threads(V), stream)
    if err != 0:
        raise RuntimeError(f"calib_gate launch failed with cudaError {err}")
    calib_gate.launches += 1
    return calib, gate


calib_gate.launches = 0
