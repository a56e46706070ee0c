"""DiT (Diffusion Transformer) with adaLN-Zero conditioning (port of
``repro.models.dit``). [arXiv:2212.09748]

Works on VAE latents (img_res / 8) patchified at ``cfg.patch``; predicts
epsilon, and sigma with ``learn_sigma``.  The position embedding is a
fixed 2-D sincos grid, so any latent resolution works.

Parameter names are the reference tree's leaves with the stacked layers
unstacked (``layers.3.adaln.w``), in ``F.linear``'s ``(out, in)`` layout
(``models/convert.py``).  The adaLN-Zero leaves (``adaln``, ``final``) are
zero-initialised, as in the reference, so that a block starts as the
identity; ``reset_parameters(g, zero_std=...)`` draws them.  Each layer's
attention is ``kernels.flash_attention.ops.attention(causal=False)`` on
views of the one ``wqkv`` projection: the reference's
``attention_core(..., mode="sp")``, whose ``mode`` changes only the
sharding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import DiTConfig
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import (F32, HEADS_OUT, LINEAR, QKV, Leaf, ParamTree, apply_mlp, leaf, mlp_shapes,
                                      sinusoidal_embedding)
from repro_torch.models.vit import patchify

T_DIM = 256  # the timestep embedding's width


def dit_shapes(cfg: DiTConfig) -> dict[str, Leaf]:
    """``dit_param_spec`` in the port's layout, with the reference
    layout's dims, logical axes and fan-ins."""
    d, H = cfg.d_model, cfg.n_heads
    pin = cfg.patch**2 * cfg.in_channels
    pout = cfg.patch**2 * cfg.in_channels * (2 if cfg.learn_sigma else 1)
    out = {"x_embed.w": leaf((pin, "conv_in"), (d, "embed"), order=LINEAR), "x_embed.b": leaf((d, "embed"), const=True),
           "t_embed.w1": leaf((T_DIM, "conv_in"), (d, "embed"), order=LINEAR),
           "t_embed.b1": leaf((d, "embed"), const=True),
           "t_embed.w2": leaf((d, "embed"), (d, "mlp"), order=LINEAR), "t_embed.b2": leaf((d, "mlp"), const=True),
           "y_embed": leaf((cfg.n_classes + 1, "vocab"), (d, "embed"), fan_in=1, scale=0.02)}
    layer = {"attn.wqkv": leaf((3, "stack"), (d, "embed"), (H, "q_heads"), (d // H, "head_dim"), order=QKV),
             "attn.wo": leaf((H, "q_heads"), (d // H, "head_dim"), (d, "embed"), order=HEADS_OUT),
             **{f"mlp.{k}": v for k, v in mlp_shapes(d, cfg.d_ff, "gelu").items()},
             "adaln.w": leaf((d, "embed"), (6 * d, "mlp"), order=LINEAR, const=True),
             "adaln.b": leaf((6 * d, "mlp"), const=True)}
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    out.update({"final.adaln.w": leaf((d, "embed"), (2 * d, "mlp"), order=LINEAR, const=True),
                "final.adaln.b": leaf((2 * d, "mlp"), const=True),
                "final.w": leaf((d, "embed"), (pout, "conv_out"), order=LINEAR, const=True),
                "final.b": leaf((pout, "conv_out"), const=True)})
    return out


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def _ln(x, eps: float = 1e-6):
    """LayerNorm with float32 statistics and no affine (adaLN gives it)."""
    xf = x.to(F32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _silu(x):
    return F.silu(x.to(F32)).to(x.dtype)


def _sincos_pos_2d(h: int, w: int, d: int) -> np.ndarray:
    """(h·w, d) float32: the grid's rows, then its columns, each
    [sin, cos]; computed in float64 (``dit.py:62``)."""
    def axis_emb(n):
        omega = np.arange(d // 4, dtype=np.float64) / (d / 4)
        omega = 1.0 / 10000**omega
        pos = np.arange(n, dtype=np.float64)[:, None] * omega[None]
        return np.concatenate([np.sin(pos), np.cos(pos)], axis=1)

    eh, ew = axis_emb(h), axis_emb(w)
    return np.concatenate([np.repeat(eh, w, axis=0), np.tile(ew, (h, 1))], axis=1).astype(np.float32)


def dit_layer(p, x, c, n_heads: int):
    """x (B, T, D), c (B, D): one adaLN-Zero block (``dit.py:76-86``)."""
    B, T, _ = x.shape
    mod = F.linear(_silu(c), p["adaln"]["w"], p["adaln"]["b"])
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _modulate(_ln(x), sh1, sc1)
    qkv = F.linear(h, p["attn"]["wqkv"]).view(B, T, 3, n_heads, -1)
    att = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False)
    x = x + g1[:, None] * F.linear(att.reshape(B, T, -1), p["attn"]["wo"])
    h = _modulate(_ln(x), sh2, sc2)
    return x + g2[:, None] * apply_mlp(p["mlp"], h, "gelu")


def dit_forward(m: "DiT", latents: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                cfg: DiTConfig) -> torch.Tensor:
    """latents (B, h, w, C) on the VAE grid, t (B,) timesteps, y (B,) class
    ids -> the epsilon (+ sigma) prediction (B, h, w, C or 2C)."""
    B, h, w, C = latents.shape
    ps, d = cfg.patch, cfg.d_model
    xe = m["x_embed"]
    x = F.linear(patchify(latents, ps).to(xe["w"].dtype), xe["w"], xe["b"])
    pos = m.const(("pos", h // ps, w // ps), lambda: _sincos_pos_2d(h // ps, w // ps, d))
    x = x + pos.to(x.dtype)

    te = m["t_embed"]
    temb = F.linear(sinusoidal_embedding(t, T_DIM).to(x.dtype), te["w1"], te["b1"])
    temb = F.linear(_silu(temb), te["w2"], te["b2"])
    c = temb + m["y_embed"][y]

    for layer in m["layers"]:  # the reference's lax.scan over layers.all, unrolled
        x = dit_layer(layer, x, c, cfg.n_heads)

    f = m["final"]
    sh, sc = F.linear(_silu(c), f["adaln"]["w"], f["adaln"]["b"]).chunk(2, dim=-1)
    x = F.linear(_modulate(_ln(x), sh, sc), f["w"], f["b"])
    out_ch = cfg.in_channels * (2 if cfg.learn_sigma else 1)
    gh, gw = h // ps, w // ps
    return x.reshape(B, gh, gw, ps, ps, out_ch).permute(0, 1, 3, 2, 4, 5).reshape(B, h, w, out_ch)


class DiT(ParamTree):
    """DiT's weights (``ParamTree``'s init); ``model(latents, t, y)`` is
    ``dit_forward``."""

    def __init__(self, cfg: DiTConfig, *, generator: torch.Generator | None = None, device=None,
                 dtype=torch.bfloat16):
        super().__init__(dit_shapes(cfg), generator=generator, device=device, dtype=dtype)
        self.cfg = cfg

    def forward(self, latents, t, y):
        return dit_forward(self, latents, t, y, self.cfg)
