"""Plain PyTorch version of the 3xTF32 dense product: the arithmetic of
``csrc/linear_3xtf32.cu`` written with bit masks.

Each f32 operand v splits into two TF32 values (sign, exponent and 10
mantissa bits): big = v rounded to TF32 to nearest, ties away from zero
(``cvt.rna.tf32.f32``: half a TF32 step added to the bits, the 13 low bits
cleared), small = v - big (exact in f32) rounded likewise; big + small lies
within 2^-22 of v.  Then

    y = (x_small·W_bigᵀ + x_big·W_smallᵀ) + x_big·W_bigᵀ + b

with every product of two TF32 values exact in f32 and the sums in f32.
x_small·W_smallᵀ, at most 2^-22 of the product, is left out.  The kernel
sums the same terms in the tensor cores' order, so the two agree to the
f32 rounding of the sums, not bit for bit.  ``linear_tf32_ref`` is the
single TF32 product (x_big·W_bigᵀ + b), the precision below, which the
tests use as the control.  Values within half a TF32 step of f32's largest
round to infinity, as in the kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
TF32_MASK = -8192  # 0xffffe000 as int32: sign, exponent, 10 mantissa bits
TF32_HALF = 0x1000  # half a TF32 step in the bits


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """v (f32) rounded to TF32, to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32``; the int32 sum wraps as the kernel's uint32 does."""
    return ((v.contiguous().view(torch.int32) + TF32_HALF) & TF32_MASK).view(F32)


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v (f32) -> (big, small), both TF32, big + small within 2^-22 of v."""
    big = tf32_round(v)
    return big, tf32_round(v - big)


def linear_3xtf32_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K), w (N, K), b (N,) or None, all f32 -> (..., N) f32."""
    xb, xs = split_tf32(x)
    wb, ws = split_tf32(w)
    y = (F.linear(xs, wb) + F.linear(xb, ws)) + F.linear(xb, wb)
    return y if b is None else y + b


def linear_tf32_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """One TF32 product, each operand rounded to TF32: the control."""
    y = F.linear(tf32_round(x), tf32_round(w))
    return y if b is None else y + b
