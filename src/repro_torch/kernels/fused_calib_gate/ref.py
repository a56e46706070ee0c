"""Plain PyTorch version of the fused confidence + Platt + gate op.

conf  = max softmax(logits) = 1 / sum_j exp(x_j - max_j x_j)
calib = sigmoid(-(A*conf + B))         (Platt)
gate  = calib < theta                  (offload decision)

Written as the CUDA kernel computes it (``kernel.py``): the row max
starts at ``NEG`` and the exp-sum is floored at ``1e-30``, so rows of
``-inf`` give a finite ``calib`` instead of NaN.
"""
from __future__ import annotations

import torch

NEG = -1e30


def calib_gate_ref(logits: torch.Tensor, a: float, b: float, theta: float):
    """logits (B, V) -> (calibrated conf (B,) f32, gate (B,) bool)."""
    x = logits.to(torch.float32)
    m = x.amax(dim=-1, keepdim=True).clamp(min=NEG)
    conf = 1.0 / torch.exp(x - m).sum(dim=-1).clamp(min=1e-30)
    calib = torch.sigmoid(-(a * conf + b))
    return calib, calib < theta
