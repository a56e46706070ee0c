"""CUDA wrapper for the flash-attention kernel.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``flash_attention``).  The kernel (``csrc/flash_attention.cu``) is bound by
operations at the serving shape: 4·B·H·S²·D FLOPs in f32 against
4·B·S·H·D elements moved.  It is built by ``nvcc`` for ``sm_90a`` on first
use (``kernels/build.py``).

``flash_attention`` takes float32 or bfloat16 CUDA tensors of head dim 64
or 128 (the reference's) or 16 (``deit-smoke``'s) whose inner stride is 1,
in any (B, S, H) strides, and raises on anything else: a CUDA tensor
never takes the plain version, and a CPU tensor never reaches here
(``ops.attention`` dispatches).
``flash_attention.launches`` counts launches, and only launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "flash_attention.cu",
    {"flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _P]},
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)
BLOCK_Q = 64  # query rows per block, as in the kernel


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention launches a CUDA kernel; got {name} on {t.device}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention takes (B, S, H, D) tensors; {name} has shape {tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must have inner stride 1, got {t.stride(3)}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
                         " do not agree in B, H or D")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got {D}")
    if k.shape[1] < 1:
        raise ValueError("flash_attention needs at least one key")
    if B * H > 2**31 - 1 or -(-Sq // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: grid too large for shape {tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, H, D) on CUDA -> (B, Sq, H, D) in q's dtype."""
    _check(q, k, v)
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                         DTYPES[q.dtype], B, H, Sq, k.shape[1], D, strides,
                                         1.0 / math.sqrt(D), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
