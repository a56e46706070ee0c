"""Dispatch for int8-KV decode attention, by the device of the inputs.

A CUDA tensor goes to the hand-written kernel (``kernel.int8_kv_decode``),
which launches or raises; a CPU tensor goes to the plain version
(``ref.decode_attention_ref``); a meta tensor gets an empty output of
the kernel's shape and dtype, for counting a step without running it.
There is no other fallback.  On ``cuda`` and ``meta`` the call reports
``cost.decode_cost`` to the open cost counters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cost import counted, decode_cost
from repro_torch.kernels.int8_kv_decode.kernel import int8_kv_decode
from repro_torch.kernels.int8_kv_decode.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor, v_q: torch.Tensor,
                     v_s: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); k_q, v_q (B, S, KH, D) int8; k_s, v_s (B, S) f32 -> (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_q, k_s, v_q, v_s)
    if not (q.is_cuda or q.is_meta):
        raise ValueError(f"decode_attention runs on cuda, cpu or meta, got {q.device}")
    B, H, D = q.shape
    S, KH = k_q.shape[1], k_q.shape[2]
    with counted("int8_kv_decode", decode_cost, B, S, KH, H // KH, D, q.element_size()):
        if q.is_meta:
            return q.new_empty(q.shape)
        return int8_kv_decode(q, k_q, k_s, v_q, v_s)
