"""ViT / DeiT encoders (port of ``repro.models.vit``). [arXiv:2010.11929, arXiv:2012.12877]

DeiT adds a distillation token and a second classifier head; at inference
the two head outputs are averaged (the paper's protocol).

Parameter names follow the JAX pytree's leaves with the stacked layers
unstacked (``layers.3.attn.wqkv``), as ``models/convert.py`` names them;
weights are stored in ``F.linear``'s ``(out, in)`` layout: ``wqkv``
``(3·H·Dh, d)`` whose output splits as (3, H, Dh), ``bqkv`` ``(3·H·Dh,)``,
attention ``wo`` ``(d, H·Dh)``, ``mlp.wi`` ``(d_ff, d)``, ``mlp.wo``
``(d, d_ff)``, ``patch_embed.w`` ``(d, p·p·3)``, ``head.w`` ``(classes, d)``.
Images arrive NHWC, as the JAX package takes them.  Each attention call
sits in a ``vit.attn`` range while the serving loop is profiled
(``obs.profile.model_range``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ViTConfig
from repro_torch.core.cascade import _resize
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import (HEADS_OUT, LINEAR, QKV, Dense, Leaf, apply_mlp, apply_norm, flat, leaf,
                                      linear, mlp_shapes, norm_shapes)
from repro_torch.obs.profile import model_range

F32 = torch.float32
WEIGHTS = (".w", ".wqkv", ".wo", ".wi")  # drawn fan-in-scaled; every other leaf is constant


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return apply_norm({"scale": self.scale, "bias": self.bias}, x)


class Attention(nn.Module):
    def __init__(self, d: int, n_heads: int, d_head: int):
        super().__init__()
        self.n_heads, self.d_head = n_heads, d_head
        self.wqkv = nn.Parameter(torch.zeros(3 * n_heads * d_head, d))
        self.bqkv = nn.Parameter(torch.zeros(3 * n_heads * d_head))
        self.wo = nn.Parameter(torch.zeros(d, n_heads * d_head))
        self.bo = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        B, S, _ = x.shape
        qkv = linear(x, self.wqkv, self.bqkv).view(B, S, 3, self.n_heads, self.d_head)
        # q, k, v are strided views (B, S, H, Dh) of one projection; the
        # kernel reads them in place.  This is the function the reference's
        # ``attention_core(causal=False)`` computes (``layers.py:80-130``).
        with model_range("vit.attn"):
            out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False)
        return linear(out.reshape(B, S, self.n_heads * self.d_head), self.wo, self.bo)


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(d_ff, d))
        self.wo = nn.Parameter(torch.zeros(d, d_ff))

    def forward(self, x):
        return apply_mlp({"wi": self.wi, "wo": self.wo}, x)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, n_heads: int, d_ff: int):
        super().__init__()
        self.ln1 = LayerNorm(d)
        self.attn = Attention(d, n_heads, d // n_heads)
        self.ln2 = LayerNorm(d)
        self.mlp = MLP(d, d_ff)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H/p · W/p, p·p·3), features in (row, col, channel) order."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // patch, patch, W // patch, patch, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // patch) * (W // patch), patch * patch * C)


def _interp_pos(pos: torch.Tensor, n_special: int, n_tok_new: int) -> torch.Tensor:
    """Bilinear-resize the grid part of a position embedding to a new token count."""
    special, grid = pos[:, :n_special], pos[:, n_special:]
    g_old = math.isqrt(grid.shape[1])
    g_new = math.isqrt(n_tok_new - n_special)
    d = grid.shape[-1]
    grid2 = _resize(grid.reshape(1, g_old, g_old, d).to(F32), g_new).to(grid.dtype)
    return torch.cat([special, grid2.reshape(1, g_new * g_new, d)], dim=1)


def vit_shapes(cfg: ViTConfig) -> dict[str, Leaf]:
    """``vit_param_spec`` in the port's layout (the names of
    ``ViT.named_parameters()``), with the reference layout's dims,
    logical axes and fan-ins: the norms are float32, the rest takes the
    model's dtype."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    n_tok = (cfg.img_res // cfg.patch) ** 2 + 1 + int(cfg.distill_token)
    token = leaf((1, None), (1, None), (d, "embed"), const=True)
    out = {"patch_embed.w": leaf((cfg.patch * cfg.patch * 3, "conv_in"), (d, "embed"), order=LINEAR),
           "patch_embed.b": leaf((d, "embed"), const=True), "cls_token": token,
           "pos_embed": leaf((1, None), (n_tok, None), (d, "embed"), fan_in=1, scale=0.02)}
    layer = {**{f"ln1.{k}": v for k, v in norm_shapes(d, "layernorm").items()},
             "attn.wqkv": leaf((3, "stack"), (d, "embed"), (H, "q_heads"), (dh, "head_dim"), order=QKV),
             "attn.bqkv": leaf((3, "stack"), (H, "q_heads"), (dh, "head_dim"), order=flat(3), const=True),
             "attn.wo": leaf((H, "q_heads"), (dh, "head_dim"), (d, "embed"), order=HEADS_OUT),
             "attn.bo": leaf((d, "embed"), const=True),
             **{f"ln2.{k}": v for k, v in norm_shapes(d, "layernorm").items()},
             **{f"mlp.{k}": v for k, v in mlp_shapes(d, cfg.d_ff, "gelu").items()}}
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    out.update({f"final_norm.{k}": v for k, v in norm_shapes(d, "layernorm").items()})
    heads = ("head", "head_dist") if cfg.distill_token else ("head",)
    for h in heads:
        out.update({f"{h}.w": leaf((d, "embed"), (cfg.n_classes, "classes"), order=LINEAR),
                    f"{h}.b": leaf((cfg.n_classes, "classes"), const=True)})
    if cfg.distill_token:
        out["dist_token"] = token
    return out


class ViT(nn.Module):
    """``ViT(cfg, generator=g)`` draws weights as ``models/ptree.py`` does
    (normal, std 1/sqrt(fan_in), with the reference layout's fan-in: the
    product of all dims but the last, so 3·d·H for ``wqkv``; ``pos_embed``
    at std 0.02; tokens and biases 0, norm scales 1) from ``g``; without a
    generator the weights are zeros, to be overwritten by ``load_state_dict``."""

    def __init__(self, cfg: ViTConfig, *, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.n_special = 1 + int(cfg.distill_token)
        n_tok = (cfg.img_res // cfg.patch) ** 2 + self.n_special
        self.patch_embed = Dense(cfg.patch * cfg.patch * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        if cfg.distill_token:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, d))
            self.head_dist = Dense(d, cfg.n_classes)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, d))
        self.layers = nn.ModuleList(EncoderLayer(d, cfg.n_heads, cfg.d_ff) for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(d)
        self.head = Dense(d, cfg.n_classes)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Draw on the generator's device, then copy into place."""
        gdev = generator.device
        for name, p in self.named_parameters():
            if name == "pos_embed":
                std = 0.02
            elif name.endswith(WEIGHTS):
                fan_in = 3 * self.cfg.d_model * self.cfg.n_heads if name.endswith(".wqkv") else p.shape[1]
                std = 1.0 / math.sqrt(fan_in)
            else:
                p.fill_(1.0 if name.endswith(".scale") else 0.0)
                continue
            p.copy_(torch.randn(p.shape, generator=generator, device=gdev) * std)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, R, R, 3) NHWC -> logits (B, n_classes) f32."""
        B = images.shape[0]
        x = self.patch_embed(patchify(images, self.cfg.patch).to(self.patch_embed.w.dtype))
        toks = [self.cls_token.expand(B, 1, -1)]
        if self.cfg.distill_token:
            toks.append(self.dist_token.expand(B, 1, -1))
        x = torch.cat(toks + [x], dim=1)
        pos = self.pos_embed
        if pos.shape[1] != x.shape[1]:
            pos = _interp_pos(pos, self.n_special, x.shape[1])
        x = x + pos
        for layer in self.layers:
            x = layer(x)
        x = self.final_norm(x)
        logits = self.head(x[:, 0])
        if self.cfg.distill_token:
            logits = (logits + self.head_dist(x[:, 1])) / 2
        return logits.to(F32)
