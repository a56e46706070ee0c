"""Dispatch for attention, by the device of the inputs.

A CUDA tensor goes to the hand-written kernel (``kernel.flash_attention``),
which launches or raises; a CPU tensor goes to the plain version
(``ref.attention_ref``); a meta tensor gets an empty output of the
kernel's shape and dtype, for counting a step without running it, and
the call reports ``cost.attention_cost`` to the open cost counters, as a
CUDA call does.  Where autograd would record the call (grad enabled and
an input that requires grad), the kernel cannot go: it has no backward,
and the CUDA wrapper raises.  A meta call then takes the plain version,
as a CPU call does, so that a train step's count holds the attention's
backward (counted op by op, like the reference's plain attention).
There is no other fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cost import attention_cost, counted
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q, k, v (B, S, H, D) -> (B, Sq, H, D) in q's dtype."""
    if q.device.type == "cpu" or (q.is_meta and torch.is_grad_enabled()
                                  and any(t.requires_grad for t in (q, k, v))):
        return attention_ref(q, k, v, causal=causal)
    if not (q.is_cuda or q.is_meta):
        raise ValueError(f"attention runs on cuda, cpu or meta, got {q.device}")
    B, Sq, H, D = q.shape
    with counted("flash_attention", attention_cost, B, Sq, k.shape[1], H, D, causal, q.element_size()):
        if q.is_meta:
            return q.new_empty(q.shape)
        return flash_attention(q, k, v, causal=causal)
