"""Confidence scores from classifier outputs (port of ``repro.core.confidence``).

The paper's score is max-softmax; margin and entropy are ablations.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def max_softmax(logits) -> torch.Tensor:
    """The paper's confidence score: max_i sigma(x_i). logits: (..., N)."""
    return torch.softmax(logits.to(F32), dim=-1).amax(dim=-1)


def margin(logits) -> torch.Tensor:
    """Top-1 minus top-2 softmax probability."""
    top2 = torch.softmax(logits.to(F32), dim=-1).topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def neg_entropy(logits) -> torch.Tensor:
    """Normalized negative entropy in [0, 1] (1 = fully confident)."""
    p = torch.softmax(logits.to(F32), dim=-1)
    h = -(p * torch.log(p.clamp(1e-12, 1.0))).sum(-1)
    return 1.0 - h / math.log(p.shape[-1])


def sequence_confidence(token_logits, mask=None) -> torch.Tensor:
    """LM adaptation: mean per-token max-softmax over a sequence.

    token_logits: (B, S, V); mask: (B, S) optional validity mask.
    """
    c = max_softmax(token_logits)  # (B, S)
    if mask is None:
        return c.mean(-1)
    m = mask.to(F32)
    return (c * m).sum(-1) / m.sum(-1).clamp(min=1.0)


SCORES = {"max_softmax": max_softmax, "margin": margin, "neg_entropy": neg_entropy}
