"""Dispatch for the 3xTF32 dense product on the card.

``linear_3xtf32(x, w, b)`` takes x (..., K) and hands its rows to the
kernel as one (M, K) matrix: in place where TMA can address them (x
contiguous, or (M, K) with a row stride it can take; no view of them is
made, as a product's host time counts in a host-bound tier), a
contiguous copy where it cannot.
It reports ``cost.linear_cost`` to the open cost counters.  Which products
come here is ``models/layers.py::linear``'s rule; this function launches
or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cost import counted, linear_cost
from repro_torch.kernels.linear_3xtf32 import kernel as lk


def linear_3xtf32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., K), w (N, K), b (N,) or None, f32 on CUDA -> (..., N) f32."""
    K, N = x.shape[-1], w.shape[0]
    with counted("linear_3xtf32", linear_cost, x.numel() // max(K, 1), N, K, b is not None):
        if lk.takes(x, w, b):
            return lk.launch(x, w, b)
        # rows that TMA cannot read in place are copied; anything else, the wrapper refuses
        y = lk.linear_3xtf32(x.reshape(-1, K).contiguous(), w, b)
    return y.view(*x.shape[:-1], N)
