"""Swin-B (Liu et al., arXiv:2103.14030): 32 channels a head."""
from __future__ import annotations

import math

from perfbench.reference import models


def leaves(cfg: dict) -> dict:
    dims, w, p = cfg["dims"], cfg["window"], cfg["patch"]
    out = {"patch_embed.w": ((dims[0], p * p * 3), 1.0 / math.sqrt(p * p * 3)), "patch_embed.b": ((dims[0],), 0.02),
           "pos_norm.scale": ((dims[0],), "one"), "pos_norm.bias": ((dims[0],), "zero")}
    for i, (dep, dim) in enumerate(zip(cfg["depths"], dims)):
        for j in range(dep):
            q = f"stage{i}.l{j}"
            out.update({f"{q}.attn.wqkv": ((3 * dim, dim), 1.0 / math.sqrt(dim)), f"{q}.attn.bqkv": ((3 * dim,), 0.02),
                        f"{q}.attn.wo": ((dim, dim), 1.0 / math.sqrt(dim)),
                        f"{q}.attn.rel_bias": (((2 * w - 1) ** 2, dim // 32), 0.02),
                        f"{q}.ln1.scale": ((dim,), "one"), f"{q}.ln1.bias": ((dim,), "zero"),
                        f"{q}.ln2.scale": ((dim,), "one"), f"{q}.ln2.bias": ((dim,), "zero"),
                        f"{q}.mlp.wi": ((4 * dim, dim), 1.0 / math.sqrt(dim)),
                        f"{q}.mlp.wo": ((dim, 4 * dim), 1.0 / math.sqrt(4 * dim))})
        if i < len(dims) - 1:
            out.update({f"stage{i}.merge.norm.scale": ((4 * dim,), "one"), f"stage{i}.merge.norm.bias": ((4 * dim,), "zero"),
                        f"stage{i}.merge.w": ((dims[i + 1], 4 * dim), 1.0 / math.sqrt(4 * dim))})
    out.update({"final_norm.scale": ((dims[-1],), "one"), "final_norm.bias": ((dims[-1],), "zero"),
                "head.w": ((cfg["n_classes"], dims[-1]), 1.0 / math.sqrt(dims[-1])), "head.b": ((cfg["n_classes"],), 0.02)})
    return out


def port(cfg: dict, device):
    import torch

    from repro_torch.configs.base import SwinConfig
    from repro_torch.models.swin import Swin

    return Swin(SwinConfig(name=cfg["name"], img_res=cfg["img_res"], patch=cfg["patch"], window=cfg["window"],
                           depths=tuple(cfg["depths"]), dims=tuple(cfg["dims"]), n_classes=cfg["n_classes"]),
                device=device, dtype=torch.float32).eval()


def reference(cfg: dict):
    return lambda state, images: models.swin(state, images, patch=cfg["patch"], window=cfg["window"],
                                             depths=cfg["depths"], dims=cfg["dims"])


def kernels(cfg: dict) -> dict:
    return {}


def attention_calls(cfg: dict, n: int) -> list:
    return []
