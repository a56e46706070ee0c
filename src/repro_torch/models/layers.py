"""Shared layers (port of part of ``repro.models.layers``).

Only what the ResNet and ViT call: the dense layer, LayerNorm and the
GELU MLP.  RMSNorm, SwiGLU, RoPE and the blockwise attention come with
the language models, and with them the reference's ``kind``/``act``
arguments.  The attention core is ``kernels.flash_attention.ops.attention``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

F32 = torch.float32
EPS = 1e-5


class Dense(nn.Module):
    """``F.linear`` with ``w`` in its ``(out, in)`` layout and bias ``b``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_out, d_in))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return F.linear(x, self.w, self.b)


def apply_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics over the last axis (``layers.py:34-42``)."""
    xf = x.to(F32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + EPS)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The GELU MLP: ``wi`` (d_ff, d) and ``wo`` (d, d_ff) in ``F.linear``'s layout.

    The reference's ``jax.nn.gelu(approximate=True)`` is the tanh form."""
    h = F.gelu(F.linear(x, p["wi"]).to(F32), approximate="tanh").to(x.dtype)
    return F.linear(h, p["wo"])
