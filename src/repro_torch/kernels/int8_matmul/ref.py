"""Plain PyTorch W8A8 int8 matmul, the oracle of the CUDA kernel
(port of ``repro.kernels.int8_matmul.ref``; per-row / per-column scales).

``quantize_rows`` and ``quantize_cols`` are bit-equal to the reference's:
the absolute maximum in float32, ``scale = max(amax, 1e-8) / 127``, a
float32 division, ``torch.round`` (half to even, as ``jnp.round``) and a
clip to ±127.

PyTorch has no integer matrix product on CUDA (``torch.matmul`` of int32
CUDA tensors raises), so ``int8_acc_ref`` takes the product in float64 and
casts it to int32.  That is exact: every partial sum is an integer of
magnitude at most 127²·K, below 2^53 for any K this repository uses.  The
same route runs on both devices, so the CPU tests run the code that the
card is compared with.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _quantize(x: torch.Tensor, dim: int):
    xf = x.to(F32)
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8: returns (q (M,K) int8, scale (M,1) f32)."""
    return _quantize(x, -1)


def quantize_cols(w: torch.Tensor):
    """Per-column symmetric int8: returns (q (K,N) int8, scale (1,N) f32)."""
    return _quantize(w, 0)


def int8_acc_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 × (K,N) int8 -> the exact (M,N) int32 sum over K."""
    return (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)


def int8_matmul_ref(x_q, x_scale, w_q, w_scale, out_dtype=F32) -> torch.Tensor:
    """(M,K)i8 × (K,N)i8 -> (M,N) with int32 accumulation, then dequant:
    ``acc · x_scale · w_scale`` left to right in float32, one cast."""
    acc = int8_acc_ref(x_q, w_q)
    return (acc.to(F32) * x_scale.to(F32) * w_scale.to(F32)).to(out_dtype)


def matmul_ref(x, w, out_dtype=F32) -> torch.Tensor:
    """End-to-end QDQ oracle: quantize fp inputs, int8 matmul, dequant."""
    xq, xs = quantize_rows(x)
    wq, ws = quantize_cols(w)
    return int8_matmul_ref(xq, xs, wq, ws, out_dtype)
