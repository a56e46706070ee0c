"""Plain PyTorch attention, the oracle of the flash-attention kernel.

q, k, v (B, S, H, D) -> (B, Sq, H, D), as ``repro.kernels.flash_attention.ref``
computes it: scores and softmax in float32 over the whole (Sq, Sk) matrix,
scale 1/sqrt(D), the causal mask ``qpos >= kpos`` aligned top-left when
Sq != Sk, masked scores at -1e30, the output in q's dtype.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), k.to(F32)) * (1.0 / math.sqrt(D))
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(F32)).to(q.dtype)
