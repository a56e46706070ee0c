"""CUDA wrapper for the flash-attention kernel.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``flash_attention``).  The source (``csrc/flash_attention.cu``) holds two
kernels, both on the tensor cores with K/V tiles double-buffered by
``cp.async``.  float32 runs ``mma.sync`` m16n8k8 in three TF32 products per
product ("3xTF32": each operand split into a TF32 big part and a TF32
remainder), which keeps each product within ~2^-20 of f32's; at DeiT-B's
(16, 198, 12, 64) it needs 11.69 µs of operations at 494.7 TFLOP/s of TF32
against 11.62 µs of bytes at 3.35 TB/s.  bfloat16 runs ``mma.sync``
m16n8k16, bf16 products with f32 sums; at the f(batch) sweep's (32, 256, 4,
64) causal shape it is bound by bytes, 2.504 µs for 8.39 MB at 3.35 TB/s
against 1.09 µs of operations at 989 TFLOP/s.  It rounds the
probabilities to bf16 before P·V, as SDPA's flash backend does; the
reference multiplies them in f32.  The library is built by ``nvcc`` for
``sm_90a`` on first use (``kernels/build.py``).

``flash_attention`` takes float32 or bfloat16 CUDA tensors of head dim 64
or 128 (the reference's) or 16 (``deit-smoke``'s) whose inner stride is 1,
in any (B, S, H) strides; each tensor's data pointer and (B, S, H) strides
must also be multiples of 16 bytes (4 float32 or 8 bfloat16 elements),
which the ``cp.async`` copies need.  Views into a fused qkv projection
meet that at these head dims.  It raises on anything else: a CUDA tensor
never takes the plain version or the other kernel, and a CPU tensor never
reaches here (``ops.attention`` dispatches).
Under autograd (grad enabled and a float input that requires grad) it
raises: the kernel has no backward (``kernels.forbid_autograd``).
``flash_attention.launches`` counts launches, and only launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import forbid_autograd
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
ALIGN = {torch.float32: 4, torch.bfloat16: 8}  # elements in the 16 bytes that a cp.async copies


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
    align = ALIGN[q.dtype]
    for name, t in (("q", q), ("k", k), ("v", v)):
        strides = [t.stride(i) for i in range(3) if t.shape[i] > 1]
        if t.data_ptr() % 16 or any(st % align for st in strides):
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned, with (B, S, H) strides that"
                             f" are multiples of {align} {str(q.dtype).removeprefix('torch.')} elements;"
                             f" got strides {t.stride()[:3]} at data pointer offset {t.data_ptr() % 16}"
                             " (mod 16 bytes)")
    if B * H > 2**31 - 1 or -(-Sq // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: grid too large for shape {tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, H, D) on CUDA -> (B, Sq, H, D) in q's dtype."""
    forbid_autograd("flash_attention", q, k, v)
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
