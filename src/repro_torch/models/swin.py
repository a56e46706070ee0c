"""Swin Transformer: windowed and shifted-window attention, patch merging
(port of ``repro.models.swin``). [arXiv:2103.14030]

Relative-position bias per head; a cyclic shift of half a window on every
odd layer of a stage, as in the reference, even where the feature map is
one window (Swin-B's last stage at 224 px), where the official Swin turns
the shift off.  Patch merging concatenates the 2 x 2 neighbours in the
reference's ``(dh, dw, C)`` order: x00, x01, x10, x11.

Parameter names are the reference tree's leaves (``stage2.l5.attn.wqkv``,
``stage0.merge.w``); weights are in ``F.linear``'s ``(out, in)`` layout
(``models/convert.py``): ``wqkv`` ``(3·H·Dh, C)``, ``bqkv`` ``(3·H·Dh,)``,
``wo`` ``(C, H·Dh)``, ``rel_bias`` ``((2w-1)², H)`` as in the reference.
Window attention is plain torch (the reference's einsums and softmax, no
Pallas kernel there): its scores carry a bias and a mask, which the flash
kernel does not take.  Images arrive NHWC.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import SwinConfig
from repro_torch.models.layers import (
    F32,
    HEADS_OUT,
    LINEAR,
    NEG,
    QKV,
    Leaf,
    ParamTree,
    apply_mlp,
    apply_norm,
    flat,
    leaf,
    linear,
    mlp_shapes,
    norm_shapes,
)
from repro_torch.models.vit import patchify


def _rel_index(window: int) -> np.ndarray:
    """(W², W²) index into ``rel_bias``'s rows (``swin.py:23``)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + window - 1
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


def _shift_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """(nWin, W², W²) True where two tokens of a shifted window came from
    the same region (``swin.py:75-85``): the regions are labelled before
    the roll and the window split."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = np.roll(img, (-shift, -shift), axis=(0, 1))
    nh, nw = H // window, W // window
    wins = img.reshape(nh, window, nw, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    return wins[:, :, None] == wins[:, None, :]


def swin_window_for(cfg: SwinConfig, img_res: int) -> int:
    if img_res == cfg.img_res:
        return cfg.window
    return max(cfg.window * img_res // cfg.img_res, 1)


def swin_shapes(cfg: SwinConfig) -> dict[str, Leaf]:
    """``swin_param_spec`` in the port's layout, with the reference
    layout's dims, logical axes and fan-ins."""
    window = swin_window_for(cfg, cfg.img_res)
    d0, pin = cfg.dims[0], cfg.patch**2 * 3
    out = {"patch_embed.w": leaf((pin, "conv_in"), (d0, "embed"), order=LINEAR),
           "patch_embed.b": leaf((d0, "embed"), const=True)}
    out.update({f"pos_norm.{k}": v for k, v in norm_shapes(d0, "layernorm").items()})
    for i, (dep, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        H = cfg.heads[i]
        dh = dim // H
        layer = {"attn.wqkv": leaf((3, "stack"), (dim, "embed"), (H, "q_heads"), (dh, "head_dim"), order=QKV),
                 "attn.bqkv": leaf((3, "stack"), (H, "q_heads"), (dh, "head_dim"), order=flat(3), const=True),
                 "attn.wo": leaf((H, "q_heads"), (dh, "head_dim"), (dim, "embed"), order=HEADS_OUT),
                 "attn.rel_bias": leaf(((2 * window - 1) ** 2, None), (H, "q_heads"), fan_in=1, scale=0.02)}
        for g in ("ln1", "ln2"):
            layer.update({f"{g}.{k}": v for k, v in norm_shapes(dim, "layernorm").items()})
        layer.update({f"mlp.{k}": v for k, v in mlp_shapes(dim, 4 * dim, "gelu").items()})
        for j in range(dep):
            out.update({f"stage{i}.l{j}.{k}": v for k, v in layer.items()})
        if i < len(cfg.dims) - 1:
            out.update({f"stage{i}.merge.norm.{k}": v for k, v in norm_shapes(4 * dim, "layernorm").items()})
            out[f"stage{i}.merge.w"] = leaf((4 * dim, "conv_in"), (cfg.dims[i + 1], "embed"), order=LINEAR)
    out.update({f"final_norm.{k}": v for k, v in norm_shapes(cfg.dims[-1], "layernorm").items()})
    out.update({"head.w": leaf((cfg.dims[-1], "embed"), (cfg.n_classes, "classes"), order=LINEAR),
                "head.b": leaf((cfg.n_classes, "classes"), const=True)})
    return out


def _window_attention(p, x, window: int, shift: int, rel_index, mask):
    """x (B, H, W, C) -> (B, H, W, C) (``swin.py:44-72``): scores in x's
    dtype, then float32 with the bias and, shifted, masked at -1e30;
    the probabilities cast to x's dtype before P·V."""
    B, H, W, C = x.shape
    n_heads = p["rel_bias"].shape[1]
    d_head = p["wqkv"].shape[0] // (3 * n_heads)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    nh, nw = H // window, W // window
    xw = x.reshape(B, nh, window, nw, window, C).permute(0, 1, 3, 2, 4, 5).reshape(B * nh * nw, window**2, C)
    qkv = linear(xw, p["wqkv"], p["bqkv"]).view(B * nh * nw, window**2, 3, n_heads, d_head)
    q, k, v = qkv.unbind(2)
    scores = torch.einsum("nqhk,nshk->nhqs", q, k).to(F32) / math.sqrt(d_head)
    bias = p["rel_bias"][rel_index]  # (W², W², H)
    scores = scores + bias.permute(2, 0, 1)[None].to(F32)
    if shift:
        scores = scores.view(B, nh * nw, n_heads, window**2, window**2)
        scores = torch.where(mask[None, :, None], scores, NEG)
        scores = scores.view(B * nh * nw, n_heads, window**2, window**2)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("nhqs,nshk->nqhk", probs, v)
    out = linear(out.reshape(B * nh * nw, window**2, n_heads * d_head), p["wo"])
    out = out.reshape(B, nh, nw, window, window, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out


def swin_forward(m: "Swin", images: torch.Tensor, cfg: SwinConfig) -> torch.Tensor:
    """images (B, R, R, 3) NHWC -> logits (B, n_classes) float32."""
    B, R = images.shape[0], images.shape[1]
    window = swin_window_for(cfg, R)
    pe = m["patch_embed"]
    x = linear(patchify(images, cfg.patch).to(pe["w"].dtype), pe["w"], pe["b"])
    x = apply_norm(m["pos_norm"], x)
    H = W = R // cfg.patch
    x = x.reshape(B, H, W, -1)
    rel_index = m.const(("rel_index", window), lambda: _rel_index(window).astype(np.int64))
    for i, dep in enumerate(cfg.depths):
        stage = m[f"stage{i}"]
        shift_w = window // 2
        mask = m.const(("shift_mask", H, W, window, shift_w), lambda: _shift_mask(H, W, window, shift_w))
        for j in range(dep):
            p = stage[f"l{j}"]
            shift = shift_w if j % 2 == 1 else 0
            x = x + _window_attention(p["attn"], apply_norm(p["ln1"], x), window, shift, rel_index, mask)
            x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x), "gelu")
        if i < len(cfg.depths) - 1:
            merge = stage["merge"]
            C = x.shape[-1]
            x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
            x = linear(apply_norm(merge["norm"], x), merge["w"])
            H, W = H // 2, W // 2
    x = apply_norm(m["final_norm"], x)
    x = x.reshape(B, H * W, -1).to(F32).mean(dim=1)
    head = m["head"]
    return linear(x, head["w"].to(F32)) + head["b"].to(F32)


class Swin(ParamTree):
    """Swin's weights (``ParamTree``'s init); ``model(images)`` is
    ``swin_forward``."""

    def __init__(self, cfg: SwinConfig, *, generator: torch.Generator | None = None, device=None,
                 dtype=torch.bfloat16):
        super().__init__(swin_shapes(cfg), generator=generator, device=device, dtype=dtype)
        self.cfg = cfg

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return swin_forward(self, images, self.cfg)
