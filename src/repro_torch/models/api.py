"""Unified model API (port of ``repro.models.api``): ``build(cfg, plan)``.

The handle carries the config, the plan, the family, ``n_params()`` and
``forward`` for every config type the reference builds: the language
models (``LMConfig``: dense GQA, MLA and MoE), ViT/DeiT, Swin and ResNet
(``forward(m, images)``), and the diffusion models DiT and the UNet
(``forward(m, latents, t, cond)``: class ids for DiT, ``CTX_TOKENS`` text
embeddings for the UNet).  ``init`` makes the model's module, which
stands for the reference's parameter pytree: ``forward(model, x)`` takes
it as the reference's ``forward(params, x)`` takes the tree.
``loss`` (training) and ``pspecs`` (sharding) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import DiTConfig, LMConfig, ResNetConfig, SwinConfig, UNetConfig, ViTConfig
from repro_torch.models import transformer as tr
from repro_torch.models.dit import DiT
from repro_torch.models.resnet import ResNet
from repro_torch.models.swin import Swin
from repro_torch.models.transformer import ParallelPlan, TransformerLM
from repro_torch.models.unet import UNet
from repro_torch.models.vit import ViT

CTX_TOKENS = 77  # the UNet's text-conditioning length (the reference stubs the text encoder)


@dataclass
class ModelHandle:
    cfg: Any
    plan: ParallelPlan
    family: str
    make: Callable  # (generator, device, dtype) -> module
    forward: Callable

    def init(self, generator: torch.Generator | None = None, device=None, dtype=None) -> torch.nn.Module:
        """The model's module with weights drawn from ``generator`` (zeros
        without one), on ``device`` (cuda unless ``device="cpu"``)."""
        return self.make(generator, device, dtype)

    def n_params(self) -> int:
        """The number of parameters the reference's tree holds, counted on
        a module made on the meta device (nothing is allocated)."""
        with torch.device("meta"):
            model = self.make(None, "meta", None)
        return sum(p.numel() for p in model.parameters())


def build(cfg, plan: ParallelPlan | None = None) -> ModelHandle:
    plan = plan or ParallelPlan()
    if isinstance(cfg, LMConfig):
        tr.check_supported(cfg, plan)

        def make(g, device, dtype):
            return TransformerLM(cfg, plan, generator=g, device=device, dtype=dtype or torch.bfloat16)

        return ModelHandle(cfg, plan, "lm", make, lambda m, tokens: tr.lm_forward(m, tokens, cfg, plan)[0])
    if isinstance(cfg, (ViTConfig, ResNetConfig)):
        cls = ViT if isinstance(cfg, ViTConfig) else ResNet

        def make(g, device, dtype):
            model = cls(cfg, generator=g, device=device)
            return model if dtype is None else model.to(dtype)

        return ModelHandle(cfg, plan, "vision", make, lambda m, images: m(images))
    trees = {SwinConfig: (Swin, "vision"), DiTConfig: (DiT, "diffusion"), UNetConfig: (UNet, "diffusion")}
    if type(cfg) in trees:
        cls, family = trees[type(cfg)]

        def make(g, device, dtype):
            return cls(cfg, generator=g, device=device, dtype=dtype or torch.bfloat16)

        return ModelHandle(cfg, plan, family, make, lambda m, *inputs: m(*inputs))
    raise TypeError(f"unknown config type {type(cfg)}")


def config_for_shape(cfg, img_res: int):
    """The config whose parameter tree serves ``img_res`` (a shape's
    ``img_res``; 0 keeps ``cfg``): Swin's window scales with the
    resolution, as the Swin-384 protocol does (7 -> 12 at 384 px), and
    ViT's position embedding takes the new token count."""
    if isinstance(cfg, SwinConfig) and img_res and img_res != cfg.img_res:
        return dataclasses.replace(cfg, img_res=img_res, window=max(cfg.window * img_res // cfg.img_res, 1))
    if isinstance(cfg, ViTConfig) and img_res and img_res != cfg.img_res:
        return dataclasses.replace(cfg, img_res=img_res)
    return cfg
