"""Shared layers (port of ``repro.models.layers``).

Plain functions on tensors: the dense product (``linear``: f32 on the card
through the 3xTF32 kernel) and layer, LayerNorm and RMSNorm, partial
rotary embeddings and DINOv3's axial 2D ones, the GQA head expansion, the
reference's plain causal attention (whole and blockwise), and the GELU and
SwiGLU MLPs; and the parameter shapes of the norms and MLPs
(``norm_spec``/``mlp_spec``'s counterparts).  Weights are in ``F.linear``'s ``(out, in)`` layout.  The
ViT's attention core is ``kernels.flash_attention.ops.attention``; the language models' prefill
attention is ``attention_core`` here, as in the reference, where it is
plain einsums and no Pallas kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.linear_3xtf32.ops import linear_3xtf32

F32 = torch.float32
EPS = 1e-5
NEG = -1e30


def kernel_takes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> bool:
    """Whether the 3xTF32 kernel takes this product, on what the inputs
    show whatever their device: float32 throughout, nothing for autograd
    to record (grad off, or no input that requires grad), K and N
    multiples of 4 (TMA's 16-byte strides), and rows to multiply."""
    records = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b))
    return (x.dtype == F32 and w.dtype == F32 and (b is None or b.dtype == F32) and not records
            and x.shape[-1] % 4 == 0 and w.shape[0] % 4 == 0 and x.numel() > 0)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``F.linear(x, w, b)``, w in its ``(out, in)`` layout.

    A product on the card that ``kernel_takes`` runs the hand-written
    3xTF32 kernel (``kernels/linear_3xtf32``): on the tensor cores at
    f32-level error, where PyTorch with TF32 off takes cuBLAS's f32 product
    on the CUDA cores.  Every other product (the CPU, meta, bf16 and f16,
    training, other widths) is ``F.linear``."""
    if x.is_cuda and kernel_takes(x, w, b):
        return linear_3xtf32(x, w, b)
    return F.linear(x, w, b)


class Dense(nn.Module):
    """``linear`` with ``w`` in ``F.linear``'s ``(out, in)`` layout and bias ``b``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_out, d_in))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return linear(x, self.w, self.b)


def apply_norm(p, x: torch.Tensor, kind: str = "layernorm", eps: float = EPS) -> torch.Tensor:
    """LayerNorm or RMSNorm with f32 statistics over the last axis
    (``layers.py:34-42``); the result in x's dtype."""
    xf = x.to(F32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (y * p["scale"]).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, rotate_dim: int) -> torch.Tensor:
    """x (..., S, H, Dh): rotate the first ``rotate_dim`` dims of Dh, NeoX
    half split (``layers.py:50-64``).  Angles are float32 products, as in
    the reference, so large positions round as they do there."""
    if rotate_dim <= 0:
        return x
    half = rotate_dim // 2
    xr, xp = x[..., :rotate_dim], x[..., rotate_dim:]
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., :, None] * freqs[None, :]  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = xr[..., :half].to(F32), xr[..., half:].to(F32)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


def rope_2d_table(n_h: int, n_w: int, d_head: int, theta: float, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """DINOv3's axial 2D RoPE (arXiv:2508.10104): (cos, sin), each
    (n_h·n_w, d_head) float32, for the patches in row-major order.  A
    patch centre's coordinates ``c`` (y, x) are normalised to [-1, 1];
    its angles are ``2π·c·theta^(-j/(d_head/4))``, j = 0 … d_head/4 - 1,
    for y then for x, and that half-width table tiled twice, so that
    ``rotate_half`` pairs dim i with dim i + d_head/2 at one angle."""
    inv_freq = 1.0 / theta ** torch.arange(0, 1, 4 / d_head, dtype=F32, device=device)  # (d_head/4,)
    ys = torch.arange(0.5, n_h, dtype=F32, device=device) / n_h
    xs = torch.arange(0.5, n_w, dtype=F32, device=device) / n_w
    coords = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).flatten(0, 1) * 2.0 - 1.0  # (P, 2)
    ang = (2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]).flatten(1, 2).tile(2)  # (P, d_head)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, n_prefix: int) -> torch.Tensor:
    """x (..., S, H, Dh), any strides -> a new contiguous tensor with the
    last S - ``n_prefix`` tokens rotated by ``rope_2d_table``'s (cos, sin)
    as ``x·cos + rotate_half(x)·sin`` and the first ``n_prefix`` (class and
    register tokens) copied as they are.  The table is tiled twice, so its
    first half serves both halves of Dh; each half is written in place:
    one copy and four elementwise passes, whatever the leading dims."""
    half = x.shape[-1] // 2
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out[..., :n_prefix, :, :] = x[..., :n_prefix, :, :]
    c, s = cos[:, None, :half].to(x.dtype), sin[:, None, :half].to(x.dtype)  # (P, 1, Dh/2): over heads
    xp, op = x[..., n_prefix:, :, :], out[..., n_prefix:, :, :]
    x1, x2, o1, o2 = xp[..., :half], xp[..., half:], op[..., :half], op[..., half:]
    torch.mul(x1, c, out=o1)
    o1.addcmul_(x2, s, value=-1.0)
    torch.mul(x2, c, out=o2)
    o2.addcmul_(x1, s)
    return out


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, S, H, D): query head h reads KV head h // (H/KH)."""
    kh = k.shape[2]
    if kh == n_heads:
        return k
    return k.repeat_interleave(n_heads // kh, dim=2)


def attention_core(q, k, v, *, causal: bool) -> torch.Tensor:
    """Dense attention, q (B, Sq, H, Dh), k and v (B, Sk, H, Dh_v) -> (B, Sq, H, Dh_v)
    (``layers.py:80-130``): scores in q's dtype scaled by 1/sqrt(Dh), then
    softmax in f32 with masked scores at -1e30, and the probabilities cast
    to q's dtype before P·V, as the reference does.  The causal mask lets
    query i see keys 0..i."""
    Sq, Dh = q.shape[1], q.shape[3]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(F32) * (1.0 / math.sqrt(Dh))
    if causal:
        qpos, kpos = torch.arange(Sq, device=q.device), torch.arange(k.shape[1], device=q.device)
        scores = torch.where((qpos[:, None] >= kpos[None, :])[None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_blockwise(q, k, v, *, causal: bool, chunk: int = 1024) -> torch.Tensor:
    """Blockwise attention over KV chunks with an online softmax
    (``layers.py:133-190``): Sk splits into ``max(Sk // chunk, 1)`` equal
    chunks (Sk must divide, as the reference's reshape requires); m starts
    at -inf; the output is acc / max(l, 1e-30) in q's dtype."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    n_chunks = max(Sk // chunk, 1)
    chunk = Sk // n_chunks
    if n_chunks * chunk != Sk:
        raise ValueError(f"attention_blockwise: {Sk} keys do not split into {n_chunks} chunks")
    scale = 1.0 / math.sqrt(Dh)
    qpos = torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), -torch.inf, dtype=F32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, H, Sq, v.shape[-1]), dtype=F32, device=q.device)
    for i in range(n_chunks):
        start = i * chunk
        kb, vb = k[:, start:start + chunk], v[:, start:start + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).to(F32) * scale
        if causal:
            kpos = start + torch.arange(chunk, device=q.device)
            s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.to(F32))
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


Dim = tuple  # (size, logical axis or None): one dim of the reference's layout of a leaf

# How the reference's dims make the port's: one tuple per port dim, the
# reference dims it merges, outermost first (``models/convert.py`` moves
# the values so).
LINEAR = ((1,), (0,))  # (in, out) -> F.linear's (out, in)
HEADS_IN = ((1, 2), (0,))  # (in, H, Dh) -> (H·Dh, in)
HEADS_OUT = ((2,), (0, 1))  # (H, Dh, out) -> (out, H·Dh)
QKV = ((0, 2, 3), (1,))  # (3, d, H, Dh) -> (3·H·Dh, d)
HWIO = ((3,), (2,), (0,), (1,))  # a conv's HWIO -> OIHW


def flat(n: int) -> tuple:
    """n reference dims merged into the port's one: (H, Dh) -> (H·Dh,)."""
    return (tuple(range(n)),)


class Leaf(NamedTuple):
    """One parameter: its shape in the port's layout, the fan-in of the
    reference layout's init (None for a constant: norm scales 1, biases 0),
    whether it is float32 whatever the model's dtype (norms, the MoE
    router), the init's scale (``ts(..., scale=)``: the draw's std is
    ``scale / sqrt(fan_in)``), the reference's dims with their logical
    axes (``ref``; a stacked layer's without its leading ``layers`` dim)
    and which of them each port dim merges (``order``)."""

    shape: tuple[int, ...]
    fan_in: int | None
    f32: bool = False
    scale: float = 1.0
    ref: tuple[Dim, ...] = ()
    order: tuple[tuple[int, ...], ...] = ()


def leaf(*ref: Dim, order: tuple | None = None, const: bool = False, fan_in: int = 0, f32: bool = False,
         scale: float = 1.0) -> Leaf:
    """A leaf given as the reference's ``ts(*ref)``: its (size, logical
    axis) dims in the reference's layout, and ``order`` (default: the
    same dims) to the port's layout.  The fan-in is the reference's
    default, the product of all dims but the last, unless ``fan_in`` is
    given; ``const`` marks a leaf the reference sets to 0 or 1."""
    sizes = [n for n, _ in ref]
    order = order or tuple((i,) for i in range(len(ref)))
    shape = tuple(math.prod(sizes[i] for i in g) for g in order)
    fan = None if const else (fan_in or (math.prod(sizes[:-1]) if len(sizes) > 1 else sizes[0]))
    return Leaf(shape, fan, f32, scale, tuple(ref), order)


def norm_shapes(d: int, kind: str, axis: str = "embed") -> dict[str, Leaf]:
    """``layers.py::norm_spec``: a float32 scale, and a bias for LayerNorm
    (``axis`` is ``conv_out`` for the conv nets' affine, as there)."""
    names = ("scale",) if kind == "rmsnorm" else ("scale", "bias")
    return {k: leaf((d, axis), const=True, f32=True) for k in names}


def mlp_shapes(d: int, d_ff: int, act: str) -> dict[str, Leaf]:
    """``layers.py::mlp_spec`` in ``F.linear``'s layout."""
    up, down = leaf((d, "embed"), (d_ff, "mlp"), order=LINEAR), leaf((d_ff, "mlp"), (d, "embed"), order=LINEAR)
    if act == "swiglu":
        return {"wg": up, "wu": up, "wd": down}
    return {"wi": up, "wo": down}


def apply_mlp(p, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    """The MLP (``layers.py:206-215``), weights in ``F.linear``'s layout.

    ``swiglu``: ``wg``/``wu`` (d_ff, d), ``wd`` (d, d_ff), and their biases
    ``bg``/``bu``/``bd`` where ``p`` holds them (DINOv3's FFN; the language
    models' have none); silu in f32, cast back to x's dtype before the
    product with the up projection.
    ``gelu``: ``wi`` (d_ff, d), ``wo`` (d, d_ff); the reference's
    ``jax.nn.gelu(approximate=True)`` is the tanh form.  Every product is
    ``linear``."""
    if act == "swiglu":
        bg, bu, bd = (p[k] if k in p else None for k in ("bg", "bu", "bd"))
        g = linear(x, p["wg"], bg)
        u = linear(x, p["wu"], bu)
        return linear(F.silu(g.to(F32)).to(x.dtype) * u, p["wd"], bd)
    h = F.gelu(linear(x, p["wi"]).to(F32), approximate="tanh").to(x.dtype)
    return linear(h, p["wo"])



class ParamGroup(nn.Module):
    """A node of the parameter tree: parameters and sub-groups by name, read
    as ``p["wq"]`` and ``"bq" in p``, like the reference's nested dicts;
    iterating it yields its sub-groups in the order they were made
    (``layers.0``, ``layers.1``, ...)."""

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def __iter__(self):
        return iter(self._modules.values())


class ParamTree(ParamGroup):
    """The weights of a model given as ``{dotted name: Leaf}``, placed in
    nested ``ParamGroup``s under the reference's leaf names.

    With a generator they are drawn as ``models/ptree.py::tree_init``
    draws them: normal with std ``scale / sqrt(fan_in)``, norm scales 1 and
    the rest 0; each leaf on the generator's device in its dtype, copied
    into place.  Without one they are zeros, to be overwritten by
    ``load_state_dict``.  Float32 leaves stay float32; the rest is in
    ``dtype``.  No parameter requires grad: serving builds no autograd
    graph.  ``train/trainer.py`` turns grad on for the leaves it trains."""

    def __init__(self, leaves: dict[str, Leaf], *, generator: torch.Generator | None = None,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        from repro_torch.device import resolve_device

        dev = resolve_device(device)
        self.leaves = leaves
        self._consts: dict = {}
        for name, leaf in leaves.items():
            *path, key = name.split(".")
            node = self
            for k in path:
                if k not in node._modules:
                    node.add_module(k, ParamGroup())
                node = node._modules[k]
            node.register_parameter(key, nn.Parameter(
                torch.zeros(leaf.shape, dtype=F32 if leaf.f32 else dtype, device=dev), requires_grad=False))
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, zero_std: float = 0.0):
        """Draw every leaf again.  ``zero_std`` > 0 draws the leaves that the
        reference sets to 0 (biases, adaLN-Zero's modulation, a zero
        ``proj_out``) from a normal of that std instead: on the reference's
        init those leaves make a block's output exactly 0, so a forward on
        such weights would never show its attention."""
        gdev = generator.device
        for name, p in self.named_parameters():
            leaf = self.leaves[name]
            if leaf.fan_in is not None:
                std = leaf.scale / math.sqrt(max(leaf.fan_in, 1))
            elif zero_std > 0 and not name.endswith(".scale"):
                std = zero_std
            else:
                p.fill_(1.0 if name.endswith(".scale") else 0.0)
                continue
            p.copy_(torch.randn(p.shape, generator=generator, device=gdev, dtype=p.dtype).mul_(std))

    def const(self, key: tuple, make) -> torch.Tensor:
        """``make()`` (a host array) as a tensor on the model's device, made
        once per ``key``, so that a forward copies no table from the host."""
        dev = next(self.parameters()).device
        if (key, dev) not in self._consts:
            self._consts[key, dev] = torch.as_tensor(make(), device=dev)
        return self._consts[key, dev]


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """The diffusion timestep embedding (``layers.py:224``): t (B,) ->
    (B, dim) float32, the cos half first, then the sin half."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=F32, device=t.device) / half)
    ang = t.to(F32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def pad_heads(n_heads: int, model_axis: int) -> int:
    """The head count rounded up to a multiple of the model axis
    (``layers.py::pad_heads``)."""
    if model_axis <= 1 or n_heads % model_axis == 0:
        return n_heads
    return -(-n_heads // model_axis) * model_axis


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME split (lo, hi) for one spatial dim of size ``n``: for
    stride 2 on an even size the extra row or column goes at the end."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    """Pad an NCHW tensor as XLA's SAME does before a ``k`` x ``k`` window."""
    (top, bottom), (left, right) = (_same_pad(x.shape[2], k, stride),
                                    _same_pad(x.shape[3], k, stride))
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)
