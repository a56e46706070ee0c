"""ResNet-v1.5 with bottleneck blocks (port of ``repro.models.resnet``).

BatchNorm is folded to inference-style ``scale``/``bias`` ("frozen BN").
Images arrive NHWC, as the JAX package takes them, and are permuted once
to NCHW at entry.  Parameter names follow the JAX pytree's leaves
(``stem.w``, ``stage0.b0.c1.scale``, ``head.w``, ...), so
``quant.quantize``'s name rules apply unchanged; weights are stored in
PyTorch's layouts (conv OIHW, head ``(classes, features)``).

``"SAME"`` padding in XLA is asymmetric for stride 2 (the extra row and
column go at the end), which a symmetric ``padding=`` would shift: every
conv and the max-pool pad explicitly with the split ``layers._same_pad``
computes from the input size.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ResNetConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import F32, HWIO, LINEAR, Dense, Leaf, _pad_same, leaf, norm_shapes


def _conv_shapes(cin: int, cout: int, k: int) -> dict[str, Leaf]:
    return {"w": leaf((k, None), (k, None), (cin, "conv_in"), (cout, "conv_out"), order=HWIO),
            **norm_shapes(cout, "layernorm", axis="conv_out")}


def resnet_shapes(cfg: ResNetConfig) -> dict[str, Leaf]:
    """``resnet_param_spec`` in the port's layout (the names of
    ``ResNet.named_parameters()``), with the reference layout's dims,
    logical axes and fan-ins: the frozen-BN ``scale`` and ``bias`` are
    float32, the rest takes the model's dtype."""
    out = {f"stem.{k}": v for k, v in _conv_shapes(3, cfg.width, 7).items()}
    cin = cfg.width
    for i, dep in enumerate(cfg.depths):
        mid = cfg.width * 2**i
        cout = mid * 4
        for b in range(dep):
            convs = {"c1": (cin, mid, 1), "c2": (mid, mid, 3), "c3": (mid, cout, 1)}
            if b == 0:
                convs["proj"] = (cin, cout, 1)
            for c, args in convs.items():
                out.update({f"stage{i}.b{b}.{c}.{k}": v for k, v in _conv_shapes(*args).items()})
            cin = cout
    out.update({"head.w": leaf((cin, "embed"), (cfg.n_classes, "classes"), order=LINEAR),
                "head.b": leaf((cfg.n_classes, "classes"), const=True)})
    return out


class Conv(nn.Module):
    """SAME conv + frozen-BN affine (+ ReLU)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, act: bool = True):
        super().__init__()
        self.k, self.stride, self.act = k, stride, act
        self.w = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        """The conv in x's dtype, the affine (+ ReLU) in float32, the result
        in x's dtype (``resnet.py::_conv``)."""
        y = F.conv2d(_pad_same(x, self.k, self.stride), self.w.to(x.dtype), stride=self.stride)
        y = y.to(F32) * self.scale[:, None, None] + self.bias[:, None, None]
        return (F.relu(y) if self.act else y).to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int, downsample: bool):
        super().__init__()
        self.c1 = Conv(cin, mid, 1)
        self.c2 = Conv(mid, mid, 3, stride=stride)
        self.c3 = Conv(mid, cout, 1, act=False)
        self.proj = Conv(cin, cout, 1, stride=stride, act=False) if downsample else None

    def forward(self, x):
        y = self.c3(self.c2(self.c1(x)))
        idn = x if self.proj is None else self.proj(x)
        return F.relu(y + idn)


class ResNet(nn.Module):
    """``ResNet(cfg, generator=g)`` draws weights as ``models/ptree.py``
    does (normal, std 1/sqrt(fan_in); conv fan-in k·k·cin, head fan-in
    cin; scale 1, bias 0) from ``g``; without a generator the weights are
    zeros, to be overwritten by ``load_state_dict``."""

    def __init__(self, cfg: ResNetConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = Conv(3, cfg.width, 7, stride=2)
        cin = cfg.width
        for i, dep in enumerate(cfg.depths):
            mid = cfg.width * 2**i
            cout = mid * 4
            blocks = nn.ModuleDict()
            for b in range(dep):
                stride = 2 if (b == 0 and i > 0) else 1
                blocks[f"b{b}"] = Bottleneck(cin, mid, cout, stride, downsample=(b == 0))
                cin = cout
            setattr(self, f"stage{i}", blocks)
        self.head = Dense(cin, cfg.n_classes)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Fan-in-scaled normal weights drawn on the generator's device."""
        gdev = generator.device
        for name, p in self.named_parameters():
            if name.endswith(".w"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3] if p.ndim == 4 else p.shape[1]
                draw = torch.randn(p.shape, generator=generator, device=gdev)
                p.copy_(draw / math.sqrt(fan_in))
            elif name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.zero_()

    def forward(self, images):
        """images (B, H, W, 3) NHWC -> logits (B, n_classes) f32: the pooled
        features and the head in float32, as in the reference."""
        x = images.permute(0, 3, 1, 2).contiguous()
        x = self.stem(x)
        x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)
        for i, dep in enumerate(self.cfg.depths):
            stage = getattr(self, f"stage{i}")
            for b in range(dep):
                x = stage[f"b{b}"](x)
        return F.linear(x.to(F32).mean(dim=(2, 3)), self.head.w.to(F32), self.head.b.to(F32))
