"""Dispatch for attention, by the device of the inputs.

A CUDA tensor goes to the hand-written kernel (``kernel.flash_attention``),
which launches or raises; a CPU tensor goes to the plain version
(``ref.attention_ref``).  There is no other fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q, k, v (B, S, H, D) -> (B, Sq, H, D) in q's dtype."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on cuda or cpu, got {q.device}")
    return attention_ref(q, k, v, causal=causal)
