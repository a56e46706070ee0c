"""Unified model API (port of ``repro.models.api``): ``build(cfg, plan)``.

The handle carries the config, the plan, the family, ``n_params()`` and
``forward`` for the families ported so far: the language models
(``LMConfig``: dense GQA, MLA and MoE), ViT/DeiT and ResNet.  ``init``
makes the model's module, which stands for the reference's parameter
pytree: ``forward(model, x)`` takes it as the reference's
``forward(params, x)`` takes the tree.
``loss`` (training) and ``pspecs`` (sharding) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import LMConfig, ResNetConfig, ViTConfig
from repro_torch.models import transformer as tr
from repro_torch.models.resnet import ResNet
from repro_torch.models.transformer import ParallelPlan, TransformerLM
from repro_torch.models.vit import ViT


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
    raise TypeError(f"config type {type(cfg).__name__} is not ported yet (ROADMAP A.12: Swin, DiT, the UNet)")
