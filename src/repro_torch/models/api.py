"""Unified model API (port of ``repro.models.api``): ``build(cfg, plan)``.

The handle carries the config, the plan, the family, ``n_params()``,
``forward`` and ``loss`` for every config type the reference builds: the language
models (``LMConfig``: dense GQA, MLA and MoE), ViT/DeiT, Swin and ResNet
(``forward(m, images)``), and the diffusion models DiT and the UNet
(``forward(m, latents, t, cond)``: class ids for DiT, ``CTX_TOKENS`` text
embeddings for the UNet).  ``init`` makes the model's module, which
stands for the reference's parameter pytree: ``forward(model, x)`` takes
it as the reference's ``forward(params, x)`` takes the tree.
``loss(m, batch)`` is the reference's training objective: the LM's
chunked cross-entropy (``transformer.lm_loss``), the classifiers' mean
cross-entropy over ``{"images", "labels"}``, and the diffusion models'
epsilon-prediction MSE over ``{"latents", "t", "noise", "cond"}`` at the
cosine schedule.  ``pspecs`` (sharding) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
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

F32 = torch.float32
CTX_TOKENS = 77  # the UNet's text-conditioning length (the reference stubs the text encoder)


@dataclass
class ModelHandle:
    cfg: Any
    plan: ParallelPlan
    family: str
    make: Callable  # (generator, device, dtype) -> module
    forward: Callable
    loss: Callable  # (module, batch of tensors) -> f32 scalar

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

        return ModelHandle(cfg, plan, "lm", make, lambda m, tokens: tr.lm_forward(m, tokens, cfg, plan)[0],
                           lambda m, batch: tr.lm_loss(m, batch, cfg, plan))
    if isinstance(cfg, (ViTConfig, ResNetConfig)):
        cls = ViT if isinstance(cfg, ViTConfig) else ResNet

        def make(g, device, dtype):
            model = cls(cfg, generator=g, device=device)
            return model if dtype is None else model.to(dtype)

        return ModelHandle(cfg, plan, "vision", make, _forward, _cls_loss)
    trees = {SwinConfig: (Swin, "vision"), DiTConfig: (DiT, "diffusion"), UNetConfig: (UNet, "diffusion")}
    if type(cfg) in trees:
        cls, family = trees[type(cfg)]

        def make(g, device, dtype):
            return cls(cfg, generator=g, device=device, dtype=dtype or torch.bfloat16)

        if family == "vision":
            return ModelHandle(cfg, plan, family, make, _forward, _cls_loss)
        learn_sigma = isinstance(cfg, DiTConfig) and cfg.learn_sigma
        return ModelHandle(cfg, plan, family, make, _forward,
                           lambda m, batch: _diffusion_loss(m, batch, learn_sigma=learn_sigma))
    raise TypeError(f"unknown config type {type(cfg)}")


def _forward(m, *inputs):
    return m(*inputs)


def _cls_loss(m, batch) -> torch.Tensor:
    """Mean cross-entropy of f32 logits (``api.py:107-111``)."""
    logits = m(batch["images"]).to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"][:, None].long())[:, 0]
    return (lse - gold).mean()


def _diffusion_loss(m, batch, *, learn_sigma: bool) -> torch.Tensor:
    """Epsilon-prediction MSE at the given (t, noise), the DDPM objective
    with the cosine schedule abar = cos(pi/2 · t/1000)^2 (``api.py:114-122``);
    with ``learn_sigma`` the first C output channels are the epsilon."""
    x0, t, noise, cond = batch["latents"], batch["t"], batch["noise"], batch["cond"]
    tf = t.to(F32)
    abar = torch.cos(0.5 * math.pi * (tf / torch.full_like(tf, 1000.0))) ** 2
    abar = abar.reshape(-1, 1, 1, 1)
    x_t = (torch.sqrt(abar) * x0.to(F32) + torch.sqrt(1 - abar) * noise.to(F32)).to(x0.dtype)
    pred = m(x_t, t, cond).to(F32)
    eps = pred[..., :x0.shape[-1]] if learn_sigma else pred
    return (eps - noise.to(F32)).square().mean()


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
