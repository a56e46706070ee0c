"""Plain PyTorch forward of DINOv3 ViT-H+/16 (Siméoni et al.,
arXiv:2508.10104), as ``transformers`` 4.57 writes its equations in
``models/dinov3_vit/modular_dinov3_vit.py``: patch embedding; ``[cls,
registers, patches]`` with no absolute position embedding; pre-norm
blocks ``x + ls1 * o(attn(rope(q), rope(k), v))`` and ``x + ls2 *
down(silu(gate(h)) * up(h))``, with q and v biases and no k bias; the
axial 2D RoPE (base ``rope_theta``, patch centres normalised to [-1, 1],
angles for y then x tiled twice, ``rotate_half``) on the patch tokens
only; LayerNorm eps 1e-5; the final norm.

It departs from the hub model's code in two places:

* the patch stem is a product on ``(d, p·p·3)`` weights over patches
  flattened in (row, col, channel) order, the program's layout, where the
  hub model has a ``(d, 3, p, p)`` convolution of stride p: the same
  linear map on the same pixels, its weight permuted;
* the logits are a linear head on the class token after the final norm
  (the hub model's ``pooler_output``), since no ImageNet head is
  published for ViT-H+.

Nothing here is a kernel: products and softmax are torch operations, the
attention is written out, and q, k and v are three products.  It runs on
the ``meta`` device too, where the benchmark counts a frame's operations.
The caller picks the precision (``models.precision``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.models import _patches, _softmax_attention, layer_norm


def rope_table(n_h: int, n_w: int, d_head: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (n_h·n_w, d_head), as the hub model's
    ``DINOv3ViTRopePositionEmbedding`` makes them."""
    inv_freq = 1 / theta ** torch.arange(0, 1, 4 / d_head, dtype=torch.float32, device=device)
    ch = torch.arange(0.5, n_h, dtype=torch.float32, device=device) / n_h
    cw = torch.arange(0.5, n_w, dtype=torch.float32, device=device) / n_w
    coords = 2.0 * torch.stack(torch.meshgrid(ch, cw, indexing="ij"), dim=-1).flatten(0, 1) - 1.0
    angles = (2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]).flatten(1, 2).tile(2)
    return torch.cos(angles), torch.sin(angles)


def rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def rope(x, cos, sin, n_prefix: int):
    """x (B, S, H, D): the patch tokens rotated, the prefix tokens kept."""
    prefix, patches = x[:, :n_prefix], x[:, n_prefix:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat((prefix, patches * c + rotate_half(patches) * s), dim=1)


def dinov3(state: dict, images: torch.Tensor, *, patch: int, n_layers: int, n_heads: int, n_registers: int,
           rope_theta: float) -> torch.Tensor:
    """images (B, R, R, 3) -> logits (B, classes)."""
    B, R = images.shape[0], images.shape[1]
    x = _patches(images, patch) @ state["patch_embed.w"].T + state["patch_embed.b"]
    d = x.shape[-1]
    x = torch.cat([state["cls_token"].expand(B, 1, d), state["reg_tokens"].expand(B, n_registers, d), x], dim=1)
    S, dh, n_prefix = x.shape[1], d // n_heads, 1 + n_registers
    cos, sin = rope_table(R // patch, R // patch, dh, rope_theta, images.device)
    for i in range(n_layers):
        p = f"layers.{i}"
        h = layer_norm(state, f"{p}.ln1", x)
        wq, wk, wv = state[f"{p}.attn.wqkv"].chunk(3, dim=0)
        q = (h @ wq.T + state[f"{p}.attn.bq"]).view(B, S, n_heads, dh)
        k = (h @ wk.T).view(B, S, n_heads, dh)
        v = (h @ wv.T + state[f"{p}.attn.bv"]).view(B, S, n_heads, dh)
        a = _softmax_attention(rope(q, cos, sin, n_prefix), rope(k, cos, sin, n_prefix), v).reshape(B, S, d)
        x = x + (a @ state[f"{p}.attn.wo"].T + state[f"{p}.attn.bo"]) * state[f"{p}.ls1"]
        h = layer_norm(state, f"{p}.ln2", x)
        gate = F.silu(h @ state[f"{p}.mlp.wg"].T + state[f"{p}.mlp.bg"])
        up = h @ state[f"{p}.mlp.wu"].T + state[f"{p}.mlp.bu"]
        x = x + ((gate * up) @ state[f"{p}.mlp.wd"].T + state[f"{p}.mlp.bd"]) * state[f"{p}.ls2"]
    x = layer_norm(state, "final_norm", x)
    return (x[:, 0] @ state["head.w"].T + state["head.b"]).float()
