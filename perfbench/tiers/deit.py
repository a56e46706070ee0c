"""DeiT-B with the distillation token (Touvron et al., arXiv:2012.12877)."""
from __future__ import annotations

import math

from perfbench.reference import models


def leaves(cfg: dict) -> dict:
    d, ff, p, V = cfg["d_model"], cfg["d_ff"], cfg["patch"], cfg["n_classes"]
    n_tok = (cfg["img_res"] // p) ** 2 + 2
    out = {"patch_embed.w": ((d, p * p * 3), 1.0 / math.sqrt(p * p * 3)), "patch_embed.b": ((d,), 0.02),
           "cls_token": ((1, 1, d), 0.02), "dist_token": ((1, 1, d), 0.02), "pos_embed": ((1, n_tok, d), 0.02)}
    for i in range(cfg["n_layers"]):
        q = f"layers.{i}"
        out.update({f"{q}.ln1.scale": ((d,), "one"), f"{q}.ln1.bias": ((d,), "zero"),
                    f"{q}.attn.wqkv": ((3 * d, d), 1.0 / math.sqrt(d)), f"{q}.attn.bqkv": ((3 * d,), 0.02),
                    f"{q}.attn.wo": ((d, d), 1.0 / math.sqrt(d)), f"{q}.attn.bo": ((d,), 0.02),
                    f"{q}.ln2.scale": ((d,), "one"), f"{q}.ln2.bias": ((d,), "zero"),
                    f"{q}.mlp.wi": ((ff, d), 1.0 / math.sqrt(d)), f"{q}.mlp.wo": ((d, ff), 1.0 / math.sqrt(ff))})
    out.update({"final_norm.scale": ((d,), "one"), "final_norm.bias": ((d,), "zero")})
    for h in ("head", "head_dist"):
        out.update({f"{h}.w": ((V, d), 1.0 / math.sqrt(d)), f"{h}.b": ((V,), 0.02)})
    return out


def port(cfg: dict, device):
    import torch

    from repro_torch.configs.base import ViTConfig
    from repro_torch.models.vit import ViT

    with torch.device(device):
        return ViT(ViTConfig(name=cfg["name"], img_res=cfg["img_res"], patch=cfg["patch"],
                             n_layers=cfg["n_layers"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
                             d_ff=cfg["d_ff"], n_classes=cfg["n_classes"], distill_token=True),
                   device=device).eval()


def reference(cfg: dict):
    return lambda state, images: models.deit(state, images, patch=cfg["patch"], n_layers=cfg["n_layers"],
                                             n_heads=cfg["n_heads"])


def kernels(cfg: dict) -> dict:
    return {"flash_attention": cfg["n_layers"]}


def attention_calls(cfg: dict, n: int) -> list:
    S = (cfg["img_res"] // cfg["patch"]) ** 2 + 2
    return [(n, S, S, cfg["n_heads"], cfg["d_model"] // cfg["n_heads"])] * cfg["n_layers"]
