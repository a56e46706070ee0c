"""SDXL-class UNet: ResBlocks and spatial transformers with self- and
cross-attention (port of ``repro.models.unet``). [arXiv:2307.01952]

Activations stay NHWC, as in the reference: a convolution reads them as an
NCHW view in channels-last memory, so no copy goes either way.  Three
details change every output if they are missed:

- a stride-2 ``"SAME"`` convolution pads (0, 1) on an even size, not
  (1, 1) (``layers._same_pad``);
- GroupNorm takes ``min(32, C)`` groups of contiguous channels, float32
  statistics with eps 1e-5, and the float32 scale and bias before the
  cast back;
- the 2x upsampling is nearest, each pixel repeated 2 x 2, as
  ``jax.image.resize(..., "nearest")`` does at exactly 2x.

Parameter names are the reference tree's leaves (``up.stage2.b1.tf.blocks.b7.cross_k``),
in ``F.linear``'s ``(out, in)`` and ``F.conv2d``'s OIHW layouts
(``models/convert.py``): ``self_q``/``cross_k``... ``(H·Dh, in)``,
``self_o``/``cross_o`` ``(C, H·Dh)``.  The GroupNorm and LayerNorm scales
and biases are float32, the rest in the model's dtype.  ``proj_out`` is
zero-initialised, as in the reference; ``reset_parameters(g, zero_std=...)``
draws it.  Self- and cross-attention (the 77 text tokens' keys) are
``kernels.flash_attention.ops.attention(causal=False)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import UNetConfig
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import (HEADS_IN, HEADS_OUT, HWIO, LINEAR, F32, Leaf, ParamTree, _same_pad, apply_norm, leaf,
                                      norm_shapes, sinusoidal_embedding)

GN_GROUPS = 32


# ------------------------------ primitives --------------------------------- #


def _gn_shapes(c: int) -> dict[str, Leaf]:
    return norm_shapes(c, "layernorm", axis="conv_out")


def apply_gn(p, x, groups: int = GN_GROUPS, eps: float = 1e-5):
    """GroupNorm over NHWC (``unet.py:33-40``), explicitly in float32."""
    B, H, W, C = x.shape
    g = min(groups, C)
    xf = x.to(F32).reshape(B, H, W, g, C // g)
    mu = xf.mean((1, 2, 4), keepdim=True)
    var = (xf - mu).square().mean((1, 2, 4), keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf.reshape(B, H, W, C) * p["scale"] + p["bias"]).to(x.dtype)


def _conv_shapes(cin: int, cout: int, k: int = 3) -> dict[str, Leaf]:
    return {"w": leaf((k, None), (k, None), (cin, "conv_in"), (cout, "conv_out"), order=HWIO),
            "b": leaf((cout, "conv_out"), const=True)}


def _conv(p, x, stride: int = 1):
    """A ``"SAME"`` convolution of NHWC ``x`` (``unet.py:47-51``); the bias
    is added after, in x's dtype, as the reference adds it."""
    w = p["w"].to(x.dtype)
    k = w.shape[-1]
    (top, bottom), (left, right) = _same_pad(x.shape[1], k, stride), _same_pad(x.shape[2], k, stride)
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    if (top, left) == (bottom, right):
        y = F.conv2d(xc, w, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), w, stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def _lin_shapes(cin: int, cout: int, axes=("embed", "mlp"), zero: bool = False) -> dict[str, Leaf]:
    return {"w": leaf((cin, axes[0]), (cout, axes[1]), order=LINEAR, const=zero), "b": leaf((cout, axes[1]), const=True)}


def _lin(p, x):
    return F.linear(x, p["w"], p["b"])


def _silu(x):
    return F.silu(x.to(F32)).to(x.dtype)


def upsample_nearest_2x(x):
    """(B, H, W, C) -> (B, 2H, 2W, C), each pixel repeated 2 x 2."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


def _group(prefix: str, leaves: dict[str, Leaf]) -> dict[str, Leaf]:
    return {f"{prefix}.{k}": v for k, v in leaves.items()}


# ------------------------------ res block ---------------------------------- #


def _res_shapes(cin: int, cout: int, t_dim: int) -> dict[str, Leaf]:
    out = {**_group("gn1", _gn_shapes(cin)), **_group("c1", _conv_shapes(cin, cout)),
           **_group("temb", _lin_shapes(t_dim, cout, axes=("embed", "conv_out"))), **_group("gn2", _gn_shapes(cout)),
           **_group("c2", _conv_shapes(cout, cout))}
    if cin != cout:
        out.update(_group("skip", _conv_shapes(cin, cout, k=1)))
    return out


def _res_block(p, x, temb):
    h = _conv(p["c1"], _silu(apply_gn(p["gn1"], x)))
    h = h + _lin(p["temb"], _silu(temb))[:, None, None, :]
    h = _conv(p["c2"], _silu(apply_gn(p["gn2"], h)))
    skip = _conv(p["skip"], x) if "skip" in p else x
    return skip + h


# -------------------------- spatial transformer ----------------------------- #


def _tf_block_shapes(ch: int, ctx_dim: int, head_dim: int) -> dict[str, Leaf]:
    H = max(ch // head_dim, 1)
    q = leaf((ch, "embed"), (H, "q_heads"), (head_dim, "head_dim"), order=HEADS_IN)
    kv = leaf((ctx_dim, "ctx"), (H, "q_heads"), (head_dim, "head_dim"), order=HEADS_IN)
    o = leaf((H, "q_heads"), (head_dim, "head_dim"), (ch, "embed"), order=HEADS_OUT)
    out = {"self_q": q, "self_k": q, "self_v": q, "self_o": o, "cross_q": q, "cross_k": kv, "cross_v": kv,
           "cross_o": o}
    for g in ("ln1", "ln2", "ln3"):
        out.update(_group(g, norm_shapes(ch, "layernorm")))
    out.update({**_group("ff_g", _lin_shapes(ch, 4 * ch)), **_group("ff_u", _lin_shapes(ch, 4 * ch)),
                **_group("ff_o", _lin_shapes(4 * ch, ch, axes=("mlp", "embed")))})
    return out


def _heads(x, w, head_dim: int):
    """A projection (B, T, H·Dh) viewed as (B, T, H, Dh)."""
    y = F.linear(x, w)
    return y.view(*y.shape[:2], -1, head_dim)


def _tf_block(p, x, ctx, head_dim: int):
    """x (B, T, C), ctx (B, Tc, ctx_dim) (``unet.py:124-145``)."""
    B, T, _ = x.shape
    h = apply_norm(p["ln1"], x)
    a = attention(_heads(h, p["self_q"], head_dim), _heads(h, p["self_k"], head_dim),
                  _heads(h, p["self_v"], head_dim), causal=False)
    x = x + F.linear(a.reshape(B, T, -1), p["self_o"])
    h = apply_norm(p["ln2"], x)
    a = attention(_heads(h, p["cross_q"], head_dim), _heads(ctx, p["cross_k"], head_dim),
                  _heads(ctx, p["cross_v"], head_dim), causal=False)
    x = x + F.linear(a.reshape(B, T, -1), p["cross_o"])
    h = apply_norm(p["ln3"], x)
    h = _silu(_lin(p["ff_g"], h)) * _lin(p["ff_u"], h)
    return x + _lin(p["ff_o"], h)


def _spatial_tf_shapes(ch: int, depth: int, ctx_dim: int, head_dim: int) -> dict[str, Leaf]:
    out = {**_group("gn", _gn_shapes(ch)), **_group("proj_in", _lin_shapes(ch, ch, axes=("conv_in", "embed")))}
    for i in range(depth):
        out.update(_group(f"blocks.b{i}", _tf_block_shapes(ch, ctx_dim, head_dim)))
    out.update(_group("proj_out", _lin_shapes(ch, ch, axes=("embed", "conv_out"), zero=True)))
    return out


def _spatial_tf(p, x, ctx, head_dim: int):
    B, H, W, C = x.shape
    h = _lin(p["proj_in"], apply_gn(p["gn"], x).reshape(B, H * W, C))
    for blk in p["blocks"]:  # made b0, b1, ..., b9: numeric order, not b0, b1, b10
        h = _tf_block(blk, h, ctx, head_dim)
    return x + _lin(p["proj_out"], h).reshape(B, H, W, C)


# ------------------------------ full UNet ---------------------------------- #


def unet_shapes(cfg: UNetConfig) -> dict[str, Leaf]:
    """``unet_param_spec`` in the port's layout, with the reference
    layout's fan-ins."""
    t_dim = 4 * cfg.ch
    chans = [cfg.ch * m for m in cfg.ch_mult]
    out = {**_group("temb.l1", _lin_shapes(cfg.ch, t_dim)), **_group("temb.l2", _lin_shapes(t_dim, t_dim)),
           **_group("conv_in", _conv_shapes(cfg.in_channels, cfg.ch))}

    def tf(prefix, ch, depth):
        out.update(_group(prefix, _spatial_tf_shapes(ch, depth, cfg.ctx_dim, cfg.head_dim)))

    prev = cfg.ch
    skips = [cfg.ch]
    for i, ch in enumerate(chans):
        for b in range(cfg.n_res_blocks):
            out.update(_group(f"down.stage{i}.b{b}.res", _res_shapes(prev, ch, t_dim)))
            if cfg.transformer_depth[i]:
                tf(f"down.stage{i}.b{b}.tf", ch, cfg.transformer_depth[i])
            prev = ch
            skips.append(ch)
        if i < len(chans) - 1:
            out.update(_group(f"down.stage{i}.down", _conv_shapes(ch, ch)))
            skips.append(ch)
    out.update(_group("mid.res1", _res_shapes(prev, prev, t_dim)))
    tf("mid.tf", prev, cfg.transformer_depth[-1])
    out.update(_group("mid.res2", _res_shapes(prev, prev, t_dim)))
    for i, ch in reversed(list(enumerate(chans))):
        for b in range(cfg.n_res_blocks + 1):
            out.update(_group(f"up.stage{i}.b{b}.res", _res_shapes(prev + skips.pop(), ch, t_dim)))
            if cfg.transformer_depth[i]:
                tf(f"up.stage{i}.b{b}.tf", ch, cfg.transformer_depth[i])
            prev = ch
        if i > 0:
            out.update(_group(f"up.stage{i}.up", _conv_shapes(ch, ch)))
    out.update({**_group("out.gn", _gn_shapes(cfg.ch)), **_group("out.conv", _conv_shapes(cfg.ch, cfg.in_channels))})
    return out


def unet_forward(m: "UNet", latents: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
                 cfg: UNetConfig) -> torch.Tensor:
    """latents (B, h, w, 4), t (B,), ctx (B, 77, ctx_dim) text conditioning
    -> epsilon (B, h, w, 4)."""
    hd = cfg.head_dim
    temb = sinusoidal_embedding(t, cfg.ch).to(latents.dtype)
    temb = _lin(m["temb"]["l2"], _silu(_lin(m["temb"]["l1"], temb)))

    x = _conv(m["conv_in"], latents)
    skips = [x]
    for i in range(len(cfg.ch_mult)):
        stage = m["down"][f"stage{i}"]
        for b in range(cfg.n_res_blocks):
            blk = stage[f"b{b}"]
            x = _res_block(blk["res"], x, temb)
            if "tf" in blk:
                x = _spatial_tf(blk["tf"], x, ctx, hd)
            skips.append(x)
        if "down" in stage:
            x = _conv(stage["down"], x, stride=2)
            skips.append(x)

    mid = m["mid"]
    x = _res_block(mid["res1"], x, temb)
    x = _spatial_tf(mid["tf"], x, ctx, hd)
    x = _res_block(mid["res2"], x, temb)

    for i in reversed(range(len(cfg.ch_mult))):
        stage = m["up"][f"stage{i}"]
        for b in range(cfg.n_res_blocks + 1):
            blk = stage[f"b{b}"]
            x = _res_block(blk["res"], torch.cat([x, skips.pop()], dim=-1), temb)
            if "tf" in blk:
                x = _spatial_tf(blk["tf"], x, ctx, hd)
        if "up" in stage:
            x = _conv(stage["up"], upsample_nearest_2x(x))

    return _conv(m["out"]["conv"], _silu(apply_gn(m["out"]["gn"], x)))


class UNet(ParamTree):
    """The UNet's weights (``ParamTree``'s init); ``model(latents, t, ctx)``
    is ``unet_forward``."""

    def __init__(self, cfg: UNetConfig, *, generator: torch.Generator | None = None, device=None,
                 dtype=torch.bfloat16):
        super().__init__(unet_shapes(cfg), generator=generator, device=device, dtype=dtype)
        self.cfg = cfg

    def forward(self, latents, t, ctx):
        return unet_forward(self, latents, t, ctx, self.cfg)
