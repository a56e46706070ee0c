"""Dispatch for int8-KV decode attention, by the device of the inputs.

A CUDA tensor goes to the hand-written kernel (``kernel.int8_kv_decode``),
which launches or raises; a CPU tensor goes to the plain version
(``ref.decode_attention_ref``).  There is no other fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.int8_kv_decode.kernel import int8_kv_decode
from repro_torch.kernels.int8_kv_decode.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor, v_q: torch.Tensor,
                     v_s: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); k_q, v_q (B, S, KH, D) int8; k_s, v_s (B, S) f32 -> (B, H, D) in q's dtype."""
    if q.is_cuda:
        return int8_kv_decode(q, k_q, k_s, v_q, v_s)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention runs on cuda or cpu, got {q.device}")
    return decode_attention_ref(q, k_q, k_s, v_q, v_s)
