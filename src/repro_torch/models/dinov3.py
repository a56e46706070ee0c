"""DINOv3 ViT (Siméoni et al., arXiv:2508.10104): the encoder that
``transformers``' ``DINOv3ViTModel`` computes, with a linear head on the
class token.

Images (B, R, R, 3) NHWC go through ``models/vit.py``'s ``patchify`` and a
linear patch stem, then ``[cls, registers, patches]`` through pre-norm
blocks, each ``x += ls1 ⊙ o(attn(rope(q), rope(k), v))`` and then
``x += ls2 ⊙ down(silu(gate(h)) ⊙ up(h))``; the final LayerNorm, and the
head on the class token (the hub model's ``pooler_output``).  There is no
absolute position embedding: the patch tokens' q and k are rotated by an
axial 2D RoPE (``layers.rope_2d_table``, made once a grid size and
device), the class and register tokens are not.

Parameter names, weights in ``F.linear``'s ``(out, in)`` layout:
``patch_embed.w`` ``(d, p·p·3)`` (features in patchify's (row, col,
channel) order), ``patch_embed.b``, ``cls_token`` ``(1, 1, d)``,
``reg_tokens`` ``(1, R, d)``; in ``layers.<i>``: ``ln1.{scale,bias}``,
``attn.wqkv`` ``(3·d, d)`` whose output splits as (3, H, Dh), ``attn.bq``
and ``attn.bv`` (no k bias), ``attn.wo`` ``(d, d)``, ``attn.bo``, ``ls1``
``(d,)``, ``ln2.*``, ``mlp.{wg,bg,wu,bu,wd,bd}``, ``ls2``; then
``final_norm.*`` and ``head.{w,b}``.

The attention is ``kernels.flash_attention.ops.attention``, one call a
layer: on the rotated q and k, each contiguous, and v, a strided view of
the projection.  While the serving loop is profiled each rotation sits
in a ``vit.rope`` range and each attention call in ``vit.attn``
(``obs.profile.model_range``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import DINOv3Config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import Dense, apply_mlp, apply_rope_2d, linear, rope_2d_table
from repro_torch.models.vit import LayerNorm, patchify
from repro_torch.obs.profile import model_range

F32 = torch.float32


class Attention(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads, self.d_head = n_heads, d // n_heads
        self.wqkv = nn.Parameter(torch.zeros(3 * d, d))
        self.bq = nn.Parameter(torch.zeros(d))
        self.bv = nn.Parameter(torch.zeros(d))
        self.wo = nn.Parameter(torch.zeros(d, d))
        self.bo = nn.Parameter(torch.zeros(d))
        self.register_buffer("no_bk", torch.zeros(d), persistent=False)

    def forward(self, x, cos, sin, n_prefix: int):
        B, S, d = x.shape
        qkv = linear(x, self.wqkv, torch.cat((self.bq, self.no_bk, self.bv)))
        qkv = qkv.view(B, S, 3, self.n_heads, self.d_head)
        with model_range("vit.rope"):
            qk = apply_rope_2d(qkv[:, :, :2].permute(2, 0, 1, 3, 4), cos, sin, n_prefix)  # (2, B, S, H, Dh)
        with model_range("vit.attn"):
            out = attention(qk[0], qk[1], qkv[:, :, 2], causal=False)
        return linear(out.reshape(B, S, d), self.wo, self.bo)


class GatedMLP(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        for name, shape in (("wg", (d_ff, d)), ("bg", (d_ff,)), ("wu", (d_ff, d)), ("bu", (d_ff,)),
                            ("wd", (d, d_ff)), ("bd", (d,))):
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def forward(self, x):
        return apply_mlp(self._parameters, x, "swiglu")


class Block(nn.Module):
    def __init__(self, d: int, n_heads: int, d_ff: int):
        super().__init__()
        self.ln1 = LayerNorm(d)
        self.attn = Attention(d, n_heads)
        self.ls1 = nn.Parameter(torch.zeros(d))
        self.ln2 = LayerNorm(d)
        self.mlp = GatedMLP(d, d_ff)
        self.ls2 = nn.Parameter(torch.zeros(d))

    def forward(self, x, cos, sin, n_prefix: int):
        x = torch.addcmul(x, self.ls1, self.attn(self.ln1(x), cos, sin, n_prefix))
        return torch.addcmul(x, self.ls2, self.mlp(self.ln2(x)))


class DINOv3(nn.Module):
    """Weights are zeros, to be overwritten by ``load_state_dict``."""

    def __init__(self, cfg: DINOv3Config, *, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.n_prefix = 1 + cfg.n_registers
        self.patch_embed = Dense(cfg.patch * cfg.patch * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.reg_tokens = nn.Parameter(torch.zeros(1, cfg.n_registers, d))
        self.layers = nn.ModuleList(Block(d, cfg.n_heads, cfg.d_ff) for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(d)
        self.head = Dense(d, cfg.n_classes)
        self._rope: dict = {}
        self.to(resolve_device(device))

    def rope(self, n_h: int, n_w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) of an n_h x n_w patch grid on ``device``, made once."""
        key = (n_h, n_w, device)
        if key not in self._rope:
            self._rope[key] = rope_2d_table(n_h, n_w, self.cfg.d_model // self.cfg.n_heads, self.cfg.rope_theta,
                                            device)
        return self._rope[key]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, R, R, 3) NHWC -> logits (B, n_classes) f32."""
        B, H, W, _ = images.shape
        p = self.cfg.patch
        x = self.patch_embed(patchify(images, p).to(self.patch_embed.w.dtype))
        x = torch.cat([self.cls_token.expand(B, 1, -1), self.reg_tokens.expand(B, -1, -1), x], dim=1)
        cos, sin = self.rope(H // p, W // p, x.device)
        for layer in self.layers:
            x = layer(x, cos, sin, self.n_prefix)
        return self.head(self.final_norm(x[:, 0])).to(F32)
