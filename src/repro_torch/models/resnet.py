"""ResNet-v1.5 with bottleneck blocks (port of ``repro.models.resnet``).

BatchNorm is folded to inference-style ``scale``/``bias`` ("frozen BN").
Images arrive NHWC, as the JAX package takes them, and are permuted once
to NCHW at entry.  Parameter names follow the JAX pytree's leaves
(``stem.w``, ``stage0.b0.c1.scale``, ``head.w``, ...), so
``quant.quantize``'s name rules apply unchanged; weights are stored in
PyTorch's layouts (conv OIHW, head ``(classes, features)``).

``"SAME"`` padding in XLA is asymmetric for stride 2 (the extra row and
column go at the end), which a symmetric ``padding=`` would shift: every
conv and the max-pool take an input padded explicitly with the split
``layers._same_pad`` computes from the input size.  Each conv's output
goes through one epilogue (``kernels/conv_epilogue``: the frozen-BN
affine, the block's residual, the ReLU, and the pad its consumer needs,
so the 3 x 3 conv and the max-pool read their inputs already padded); on
the card that is one hand-written kernel a conv (under autograd too, with
a closed-form backward), on the CPU the eager sequence.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ResNetConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.conv_epilogue.ops import conv_epilogue
from repro_torch.models.layers import F32, HWIO, LINEAR, Dense, Leaf, _pad_same, _same_pad, leaf, norm_shapes


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
    """Conv + frozen-BN affine (+ residual) (+ ReLU) (+ the consumer's SAME
    pad); ``act`` is the ReLU last, after the residual where one is given."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, act: bool = True):
        super().__init__()
        self.k, self.stride, self.act = k, stride, act
        self.w = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, residual=None, pad_for: tuple[int, int] | None = None, fill: float = 0.0):
        """x already SAME-padded for this conv -> the conv in x's dtype, the
        affine in float32 (``resnet.py::_conv``), ``residual`` added in x's
        dtype, the ReLU, and the result in x's dtype padded as SAME pads it
        before a (k, stride) = ``pad_for`` window, with ``fill``."""
        y = F.conv2d(x, self.w.to(x.dtype), stride=self.stride)
        pad = (0, 0, 0, 0)
        if pad_for is not None:
            pad = (*_same_pad(y.shape[2], *pad_for), *_same_pad(y.shape[3], *pad_for))
        return conv_epilogue(y, self.scale, self.bias, residual, act=self.act, pad=pad, fill=fill)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int, downsample: bool):
        super().__init__()
        self.c1 = Conv(cin, mid, 1)
        self.c2 = Conv(mid, mid, 3, stride=stride)
        self.c3 = Conv(mid, cout, 1)  # its ReLU follows the residual
        self.proj = Conv(cin, cout, 1, stride=stride, act=False) if downsample else None

    def forward(self, x):
        """relu(c3(c2(c1(x))) + idn): c1 writes its output padded for c2,
        c3 adds the identity (or ``proj(x)``) and applies the ReLU."""
        y = self.c2(self.c1(x, pad_for=(self.c2.k, self.c2.stride)))
        idn = x if self.proj is None else self.proj(x)
        return self.c3(y, residual=idn)


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
        x = self.stem(_pad_same(x, self.stem.k, self.stem.stride), pad_for=(3, 2), fill=-math.inf)
        x = F.max_pool2d(x, 3, 2)
        for i, dep in enumerate(self.cfg.depths):
            stage = getattr(self, f"stage{i}")
            for b in range(dep):
                x = stage[f"b{b}"](x)
        return F.linear(x.to(F32).mean(dim=(2, 3)), self.head.w.to(F32), self.head.b.to(F32))
