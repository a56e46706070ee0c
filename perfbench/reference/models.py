"""Plain PyTorch forwards of the benchmark's three models.

Each takes a state dict (the benchmark's own weights, named as the
benchmark's tier tables name them) and NHWC float images, and returns
float32 logits.  They follow the published architectures as the program
under test states them:

* ResNet-50 v1.5 (He et al., arXiv:1512.03385): bottleneck blocks, the
  stride on the 3 x 3 conv, batch norm folded to a per-channel affine,
  XLA's SAME padding (for stride 2 on an even size the extra row and
  column go at the end), a 3 x 3 max-pool, global mean pool, one head.
* DeiT-B with the distillation token (Touvron et al., arXiv:2012.12877):
  16 x 16 patches, class and distillation tokens, pre-norm encoder layers,
  the tanh GELU, MLPs without biases, and the mean of the two heads.
* Swin-B (Liu et al., arXiv:2103.14030): 4 x 4 patches, 7 x 7 windows, a
  shift of half a window on every odd layer of a stage (also where the map
  is one window), the relative-position bias, masks of -1e30, patch
  merging in (dh, dw, C) order, no bias on the attention's output
  projection or the merge.

Nothing here is a kernel: convolutions, products and softmax are torch
operations, the attention is written out.  The caller picks the
precision (``precision`` below).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

EPS = 1e-5
NEG = -1e30


@contextlib.contextmanager
def precision(mode: str):
    """``"f32"``: float32 with TF32 off in cuBLAS and cuDNN.  ``"tf32"``:
    float32 tensors with TF32 on in both.  ``"bf16"``: autocast to
    bfloat16 on the tensors' device type (``device_type`` is read from the
    default CUDA availability: the caller passes CUDA tensors on the card
    and CPU tensors in tests)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        torch.backends.cudnn.allow_tf32 = mode == "tf32"
        if mode == "bf16":
            dev = "cuda" if torch.cuda.is_available() else "cpu"
            with torch.autocast(dev, dtype=torch.bfloat16):
                yield
        elif mode in ("f32", "tf32"):
            yield
        else:
            raise ValueError(f"unknown precision {mode!r}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _same(n: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    top, bottom = _same(x.shape[2], k, stride)
    left, right = _same(x.shape[3], k, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(state, name: str, x, k: int, stride: int, relu: bool):
    y = F.conv2d(_pad_same(x, k, stride), state[f"{name}.w"], stride=stride)
    y = y.float() * state[f"{name}.scale"][:, None, None] + state[f"{name}.bias"][:, None, None]
    return F.relu(y) if relu else y


def resnet(state: dict, images: torch.Tensor, *, depths, width: int) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, classes)."""
    x = images.permute(0, 3, 1, 2)
    x = _conv(state, "stem", x, 7, 2, True)
    x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)
    for i, dep in enumerate(depths):
        for b in range(dep):
            stride = 2 if (b == 0 and i > 0) else 1
            p = f"stage{i}.b{b}"
            y = _conv(state, f"{p}.c1", x, 1, 1, True)
            y = _conv(state, f"{p}.c2", y, 3, stride, True)
            y = _conv(state, f"{p}.c3", y, 1, 1, False)
            idn = _conv(state, f"{p}.proj", x, 1, stride, False) if b == 0 else x
            x = F.relu(y + idn)
    feats = x.float().mean(dim=(2, 3))
    return (feats @ state["head.w"].T + state["head.b"]).float()


def layer_norm(state, name: str, x):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + EPS) * state[f"{name}.scale"] + state[f"{name}.bias"]


def _patches(images, patch: int):
    B, H, W, C = images.shape
    x = images.reshape(B, H // patch, patch, W // patch, patch, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // patch) * (W // patch), patch * patch * C)


def _mlp(state, name: str, x):
    h = F.gelu(x @ state[f"{name}.wi"].T, approximate="tanh")
    return h @ state[f"{name}.wo"].T


def _softmax_attention(q, k, v, bias=None):
    """q, k, v (N, S, H, D) -> (N, S, H, D); scores scaled by 1/sqrt(D),
    the softmax in float32."""
    scores = torch.einsum("nqhd,nkhd->nhqk", q, k).float() / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", probs.to(v.dtype), v)


def deit(state: dict, images: torch.Tensor, *, patch: int, n_layers: int, n_heads: int) -> torch.Tensor:
    """images (B, R, R, 3) -> logits (B, classes): the mean of the class
    and distillation heads."""
    B = images.shape[0]
    x = _patches(images, patch) @ state["patch_embed.w"].T + state["patch_embed.b"]
    d = x.shape[-1]
    x = torch.cat([state["cls_token"].expand(B, 1, d), state["dist_token"].expand(B, 1, d), x], dim=1)
    x = x + state["pos_embed"]
    S, dh = x.shape[1], d // n_heads
    for i in range(n_layers):
        p = f"layers.{i}"
        h = layer_norm(state, f"{p}.ln1", x)
        qkv = (h @ state[f"{p}.attn.wqkv"].T + state[f"{p}.attn.bqkv"]).view(B, S, 3, n_heads, dh)
        a = _softmax_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(B, S, d)
        x = x + a @ state[f"{p}.attn.wo"].T + state[f"{p}.attn.bo"]
        x = x + _mlp(state, f"{p}.mlp", layer_norm(state, f"{p}.ln2", x))
    x = layer_norm(state, "final_norm", x)
    cls = x[:, 0] @ state["head.w"].T + state["head.b"]
    dist = x[:, 1] @ state["head_dist.w"].T + state["head_dist.b"]
    return ((cls + dist) / 2).float()


def _rel_index(window: int, device) -> torch.Tensor:
    """(W², W²): the row of the (2W-1)² bias table for each pair of tokens."""
    ys, xs = torch.meshgrid(torch.arange(window, device=device), torch.arange(window, device=device),
                            indexing="ij")
    flat = torch.stack([ys.reshape(-1), xs.reshape(-1)])  # (2, W²)
    rel = flat[:, :, None] - flat[:, None, :] + window - 1
    return rel[0] * (2 * window - 1) + rel[1]


def _region_mask(H: int, W: int, window: int, shift: int, device) -> torch.Tensor:
    """(nWin, W², W²) True where two tokens of a shifted window lie in the
    same region of the unshifted map."""
    label = torch.zeros(H, W, dtype=torch.long, device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    n = 0
    for hs in cuts:
        for ws in cuts:
            label[hs, ws] = n
            n += 1
    label = torch.roll(label, (-shift, -shift), dims=(0, 1))
    wins = label.reshape(H // window, window, W // window, window).permute(0, 2, 1, 3)
    wins = wins.reshape(-1, window * window)
    return wins[:, :, None] == wins[:, None, :]


def _window_attention(state, p: str, x, window: int, shift: int, n_heads: int):
    B, H, W, C = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    nh, nw = H // window, W // window
    xw = x.reshape(B, nh, window, nw, window, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)
    dh = C // n_heads
    qkv = (xw @ state[f"{p}.wqkv"].T + state[f"{p}.bqkv"]).view(xw.shape[0], window * window, 3, n_heads, dh)
    bias = state[f"{p}.rel_bias"][_rel_index(window, x.device)].permute(2, 0, 1).float()  # (H, W², W²)
    bias = bias[None].expand(B * nh * nw, -1, -1, -1)
    if shift:
        same = _region_mask(H, W, window, shift, x.device)  # (nWin, W², W²)
        keep = same[None, :, None].expand(B, -1, n_heads, -1, -1).reshape(B * nh * nw, n_heads,
                                                                         window * window, window * window)
        bias = torch.where(keep, bias, torch.full_like(bias, NEG))
    out = _softmax_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], bias)
    out = out.reshape(-1, window * window, C) @ state[f"{p}.wo"].T
    out = out.reshape(B, nh, nw, window, window, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out


def swin(state: dict, images: torch.Tensor, *, patch: int, window: int, depths, dims) -> torch.Tensor:
    """images (B, R, R, 3) -> logits (B, classes); 32 channels a head."""
    B, R = images.shape[0], images.shape[1]
    x = _patches(images, patch) @ state["patch_embed.w"].T + state["patch_embed.b"]
    x = layer_norm(state, "pos_norm", x)
    H = W = R // patch
    x = x.reshape(B, H, W, -1)
    for i, (dep, dim) in enumerate(zip(depths, dims)):
        for j in range(dep):
            p = f"stage{i}.l{j}"
            shift = window // 2 if j % 2 == 1 else 0
            x = x + _window_attention(state, f"{p}.attn", layer_norm(state, f"{p}.ln1", x), window, shift,
                                      dim // 32)
            x = x + _mlp(state, f"{p}.mlp", layer_norm(state, f"{p}.ln2", x))
        if i < len(depths) - 1:
            C = x.shape[-1]
            x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
            x = layer_norm(state, f"stage{i}.merge.norm", x) @ state[f"stage{i}.merge.w"].T
            H, W = H // 2, W // 2
    x = layer_norm(state, "final_norm", x).reshape(B, H * W, -1).float().mean(dim=1)
    return (x @ state["head.w"].T + state["head.b"]).float()
