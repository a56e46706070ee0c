"""DINOv3 ViT-H+/16 (Siméoni et al., arXiv:2508.10104): 2D RoPE on the
patch tokens, register tokens, a SwiGLU FFN and LayerScale; a linear head
on the class token.  LayerScale vectors are drawn as normals of std 1, so
that a forward that drops them fails the check."""
from __future__ import annotations

import math

from perfbench.reference import dinov3


def _tokens(cfg: dict) -> int:
    return (cfg["img_res"] // cfg["patch"]) ** 2 + 1 + cfg["n_registers"]


def leaves(cfg: dict) -> dict:
    d, ff, p, V = cfg["d_model"], cfg["d_ff"], cfg["patch"], cfg["n_classes"]
    out = {"patch_embed.w": ((d, p * p * 3), 1.0 / math.sqrt(p * p * 3)), "patch_embed.b": ((d,), 0.02),
           "cls_token": ((1, 1, d), 0.02), "reg_tokens": ((1, cfg["n_registers"], d), 0.02)}
    for i in range(cfg["n_layers"]):
        q = f"layers.{i}"
        out.update({f"{q}.ln1.scale": ((d,), "one"), f"{q}.ln1.bias": ((d,), "zero"),
                    f"{q}.attn.wqkv": ((3 * d, d), 1.0 / math.sqrt(d)), f"{q}.attn.bq": ((d,), 0.02),
                    f"{q}.attn.bv": ((d,), 0.02), f"{q}.attn.wo": ((d, d), 1.0 / math.sqrt(d)),
                    f"{q}.attn.bo": ((d,), 0.02), f"{q}.ls1": ((d,), 1.0),
                    f"{q}.ln2.scale": ((d,), "one"), f"{q}.ln2.bias": ((d,), "zero"),
                    f"{q}.mlp.wg": ((ff, d), 1.0 / math.sqrt(d)), f"{q}.mlp.bg": ((ff,), 0.02),
                    f"{q}.mlp.wu": ((ff, d), 1.0 / math.sqrt(d)), f"{q}.mlp.bu": ((ff,), 0.02),
                    f"{q}.mlp.wd": ((d, ff), 1.0 / math.sqrt(ff)), f"{q}.mlp.bd": ((d,), 0.02),
                    f"{q}.ls2": ((d,), 1.0)})
    out.update({"final_norm.scale": ((d,), "one"), "final_norm.bias": ((d,), "zero"),
                "head.w": ((V, d), 1.0 / math.sqrt(d)), "head.b": ((V,), 0.02)})
    return out


def port(cfg: dict, device):
    import torch

    from repro_torch.configs.base import DINOv3Config
    from repro_torch.models.dinov3 import DINOv3

    with torch.device(device):
        return DINOv3(DINOv3Config(name=cfg["name"], img_res=cfg["img_res"], patch=cfg["patch"],
                                   n_layers=cfg["n_layers"], d_model=cfg["d_model"], n_heads=cfg["n_heads"],
                                   d_ff=cfg["d_ff"], n_registers=cfg["n_registers"], rope_theta=cfg["rope_theta"],
                                   n_classes=cfg["n_classes"]), device=device).eval()


def reference(cfg: dict):
    return lambda state, images: dinov3.dinov3(state, images, patch=cfg["patch"], n_layers=cfg["n_layers"],
                                               n_heads=cfg["n_heads"], n_registers=cfg["n_registers"],
                                               rope_theta=cfg["rope_theta"])


def kernels(cfg: dict) -> dict:
    return {"flash_attention": cfg["n_layers"]}


def attention_calls(cfg: dict, n: int) -> list:
    S = _tokens(cfg)
    return [(n, S, S, cfg["n_heads"], cfg["d_model"] // cfg["n_heads"])] * cfg["n_layers"]
