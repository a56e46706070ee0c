"""Plain PyTorch DINOv3 ViT forward, the oracle of ``models/dinov3.py``.

The equations of ``transformers``' ``DINOv3ViTModel`` (arXiv:2508.10104),
float32, written out: patch embedding, ``[cls, registers, patches]``,
pre-norm blocks with q and v biases and no k bias, the axial 2D RoPE on
the patch tokens' q and k only (``rotate_half`` on the whole head),
softmax attention over the whole matrix, LayerScale on both branches, a
SwiGLU FFN with biases, LayerNorm eps 1e-5.  Two departures from the hub
model's code, both the program's: the patch stem is a product on
``(d, p·p·3)`` weights over (row, col, channel)-ordered patches, the hub's
stride-p convolution with its weight permuted; and the logits are a
linear head on the class token after the final norm (``pooler_output``).
No kernel of the port and no JAX; the state dict is in the port's names.
"""
import math

import torch
import torch.nn.functional as F

EPS = 1e-5


def rope_table(n_h, n_w, d_head, theta):
    inv_freq = 1 / theta ** torch.arange(0, 1, 4 / d_head, dtype=torch.float32)
    ch = torch.arange(0.5, n_h, dtype=torch.float32) / n_h
    cw = torch.arange(0.5, n_w, dtype=torch.float32) / n_w
    coords = 2.0 * torch.stack(torch.meshgrid(ch, cw, indexing="ij"), dim=-1).flatten(0, 1) - 1.0
    angles = (2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]).flatten(1, 2).tile(2)
    return torch.cos(angles), torch.sin(angles)


def _norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + EPS) * scale + bias


def _rope(x, cos, sin, n_prefix):
    half = x.shape[-1] // 2
    pat = x[:, n_prefix:]
    rot = torch.cat((-pat[..., half:], pat[..., :half]), dim=-1)
    return torch.cat((x[:, :n_prefix], pat * cos[:, None] + rot * sin[:, None]), dim=1)


def forward(state, images, *, patch, n_layers, n_heads, n_registers, rope_theta):
    """images (B, R, R, 3) NHWC -> logits (B, classes)."""
    B, R, _, C = images.shape
    g = R // patch
    x = images.reshape(B, g, patch, g, patch, C).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, patch * patch * C)
    x = x @ state["patch_embed.w"].T + state["patch_embed.b"]
    d = x.shape[-1]
    x = torch.cat([state["cls_token"].expand(B, 1, d), state["reg_tokens"].expand(B, n_registers, d), x], dim=1)
    S, dh, n_prefix = x.shape[1], d // n_heads, 1 + n_registers
    cos, sin = rope_table(g, g, dh, rope_theta)
    for i in range(n_layers):
        p = f"layers.{i}."
        h = _norm(x, state[p + "ln1.scale"], state[p + "ln1.bias"])
        wq, wk, wv = state[p + "attn.wqkv"].chunk(3, dim=0)
        q = _rope((h @ wq.T + state[p + "attn.bq"]).view(B, S, n_heads, dh), cos, sin, n_prefix)
        k = _rope((h @ wk.T).view(B, S, n_heads, dh), cos, sin, n_prefix)
        v = (h @ wv.T + state[p + "attn.bv"]).view(B, S, n_heads, dh)
        probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh), dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, d)
        x = x + (a @ state[p + "attn.wo"].T + state[p + "attn.bo"]) * state[p + "ls1"]
        h = _norm(x, state[p + "ln2.scale"], state[p + "ln2.bias"])
        ff = F.silu(h @ state[p + "mlp.wg"].T + state[p + "mlp.bg"]) * (h @ state[p + "mlp.wu"].T + state[p + "mlp.bu"])
        x = x + (ff @ state[p + "mlp.wd"].T + state[p + "mlp.bd"]) * state[p + "ls2"]
    x = _norm(x, state["final_norm.scale"], state["final_norm.bias"])
    return x[:, 0] @ state["head.w"].T + state["head.b"]
