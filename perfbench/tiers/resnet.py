"""ResNet-50 v1.5 (He et al., arXiv:1512.03385) as the fast tier."""
from __future__ import annotations

import math

from perfbench.reference import models


def leaves(cfg: dict) -> dict:
    out = {}

    def conv(name, cin, cout, k):
        out[f"{name}.w"] = ((cout, cin, k, k), 1.0 / math.sqrt(cin * k * k))
        out[f"{name}.scale"] = ((cout,), "one")
        out[f"{name}.bias"] = ((cout,), "zero")

    width = cfg["width"]
    conv("stem", 3, width, 7)
    cin = width
    for i, dep in enumerate(cfg["depths"]):
        mid = width * 2**i
        cout = mid * 4
        for b in range(dep):
            conv(f"stage{i}.b{b}.c1", cin, mid, 1)
            conv(f"stage{i}.b{b}.c2", mid, mid, 3)
            conv(f"stage{i}.b{b}.c3", mid, cout, 1)
            if b == 0:
                conv(f"stage{i}.b{b}.proj", cin, cout, 1)
            cin = cout
    out["head.w"] = ((cfg["n_classes"], cin), 1.0 / math.sqrt(cin))
    out["head.b"] = ((cfg["n_classes"],), "zero")
    return out


def port(cfg: dict, device):
    import torch

    from repro_torch.configs.base import ResNetConfig
    from repro_torch.models.resnet import ResNet

    with torch.device(device):
        return ResNet(ResNetConfig(name=cfg["name"], img_res=cfg["img_res"], depths=tuple(cfg["depths"]),
                                   width=cfg["width"], n_classes=cfg["n_classes"]), device=device).eval()


def reference(cfg: dict):
    return lambda state, images: models.resnet(state, images, depths=cfg["depths"], width=cfg["width"])


def kernels(cfg: dict) -> dict:
    return {}


def attention_calls(cfg: dict, n: int) -> list:
    return []
