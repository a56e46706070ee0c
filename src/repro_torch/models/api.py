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
cosine schedule.  ``leaves()`` is the model's ``{name: Leaf}`` table
(``models/layers.py``): ``struct()`` gives its meta tensors, ``pspecs(rules)``
its specs on the reference's logical dims (``models/ptree.py``), and
``n_params()`` its count.  ``input_specs`` gives a cell's inputs as meta
tensors, ``config_for_shape`` the config whose parameters serve a shape.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import DiTConfig, LMConfig, ResNetConfig, ShapeSpec, SwinConfig, UNetConfig, ViTConfig
from repro_torch.models import transformer as tr
from repro_torch.models.dit import DiT, dit_shapes
from repro_torch.models.ptree import tree_count, tree_pspec, tree_struct
from repro_torch.models.resnet import ResNet, resnet_shapes
from repro_torch.models.swin import Swin, swin_shapes
from repro_torch.models.transformer import ParallelPlan, TransformerLM
from repro_torch.models.unet import UNet, unet_shapes
from repro_torch.models.vit import ViT, vit_shapes

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
    leaves: Callable  # () -> {name: Leaf}, the module's parameters with the reference's dims and axes

    def init(self, generator: torch.Generator | None = None, device=None, dtype=None) -> torch.nn.Module:
        """The model's module with weights drawn from ``generator`` (zeros
        without one), on ``device`` (cuda unless ``device="cpu"``)."""
        return self.make(generator, device, dtype)

    def struct(self, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
        """{name: meta tensor} of every parameter: float32 leaves in float32,
        the rest in ``dtype``; nothing is allocated."""
        return tree_struct(self.leaves(), dtype)

    def pspecs(self, rules: dict) -> dict[str, tuple]:
        """{name: spec on the reference's dims} under logical-axis ``rules``
        (``ptree.port_spec`` maps one onto the port's layout)."""
        return tree_pspec(self.leaves(), rules)

    def n_params(self) -> int:
        """The number of parameters the reference's tree holds (the padded
        heads of a plan's model axis included)."""
        return tree_count(self.leaves())


def build(cfg, plan: ParallelPlan | None = None) -> ModelHandle:
    plan = plan or ParallelPlan()
    if isinstance(cfg, LMConfig):
        tr.check_supported(cfg, plan)

        def make(g, device, dtype):
            return TransformerLM(cfg, plan, generator=g, device=device, dtype=dtype or torch.bfloat16)

        return ModelHandle(cfg, plan, "lm", make, lambda m, tokens: tr.lm_forward(m, tokens, cfg, plan)[0],
                           lambda m, batch: tr.lm_loss(m, batch, cfg, plan), lambda: tr.lm_param_shapes(cfg, plan))
    if isinstance(cfg, (ViTConfig, ResNetConfig)):
        cls, shapes = (ViT, vit_shapes) if isinstance(cfg, ViTConfig) else (ResNet, resnet_shapes)

        def make(g, device, dtype):
            """float32 weights; with ``dtype``, the leaves that are not float32
            in the reference (all but the norms) cast to it."""
            model = cls(cfg, generator=g, device=device)
            if dtype is not None:
                f32 = {k for k, l in shapes(cfg).items() if l.f32}
                for k, p in model.named_parameters():
                    if k not in f32:
                        p.data = p.data.to(dtype)
            return model

        return ModelHandle(cfg, plan, "vision", make, _forward, _cls_loss, lambda: shapes(cfg))
    trees = {SwinConfig: (Swin, swin_shapes, "vision"), DiTConfig: (DiT, dit_shapes, "diffusion"),
             UNetConfig: (UNet, unet_shapes, "diffusion")}
    if type(cfg) in trees:
        cls, shapes, family = trees[type(cfg)]

        def make(g, device, dtype):
            return cls(cfg, generator=g, device=device, dtype=dtype or torch.bfloat16)

        if family == "vision":
            return ModelHandle(cfg, plan, family, make, _forward, _cls_loss, lambda: shapes(cfg))
        learn_sigma = isinstance(cfg, DiTConfig) and cfg.learn_sigma
        return ModelHandle(cfg, plan, family, make, _forward,
                           lambda m, batch: _diffusion_loss(m, batch, learn_sigma=learn_sigma), lambda: shapes(cfg))
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


# --------------------------------------------------------------------------- #
# input specs per (arch, shape): meta tensors, never allocated
# --------------------------------------------------------------------------- #


def input_specs(cfg, shape: ShapeSpec, plan: ParallelPlan | None = None) -> dict:
    """A cell's inputs as meta tensors of the reference's shapes and dtypes
    (``api.py:130-181``): token ids int32; images NHWC and latents NHWC in
    bf16; timesteps and class ids int32; the UNet's text context (B, 77,
    ctx_dim) bf16; a decode cell's cache from ``transformer.cache_spec``."""
    plan = plan or ParallelPlan()
    i32, bf16 = torch.int32, torch.bfloat16

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if isinstance(cfg, LMConfig):
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"batch": {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}}
        if shape.kind == "prefill":
            return {"tokens": meta((B, S), i32)}
        if shape.kind == "decode":
            return {"cache": {k: meta(shp, dt) for k, (shp, dt) in tr.cache_spec(cfg, plan, B, S).items()},
                    "token": meta((B,), i32)}
    if isinstance(cfg, (DiTConfig, UNetConfig)):
        B = shape.batch
        lat = shape.img_res // cfg.latent_factor
        cond = meta((B,), i32) if isinstance(cfg, DiTConfig) else meta((B, CTX_TOKENS, cfg.ctx_dim), bf16)
        latents = meta((B, lat, lat, cfg.in_channels), bf16)
        if shape.kind == "train":
            return {"batch": {"latents": latents, "t": meta((B,), i32),
                              "noise": meta((B, lat, lat, cfg.in_channels), bf16), "cond": cond}}
        return {"latents": latents, "t": meta((B,), i32), "cond": cond}  # gen: one denoise step
    if isinstance(cfg, (ViTConfig, SwinConfig, ResNetConfig)):
        B, R = shape.batch, shape.img_res
        if shape.kind == "train":
            return {"batch": {"images": meta((B, R, R, 3), bf16), "labels": meta((B,), i32)}}
        return {"images": meta((B, R, R, 3), bf16)}
    raise TypeError(type(cfg))


def config_for_shape(cfg, shape: ShapeSpec):
    """The config whose parameter tree serves ``shape`` (``api.py:184-193``):
    at another resolution Swin's window scales with it, as the Swin-384
    protocol does (7 -> 12 at 384 px), and ViT's position embedding takes
    the new token count; anything else keeps ``cfg``."""
    if isinstance(cfg, SwinConfig) and shape.img_res and shape.img_res != cfg.img_res:
        return dataclasses.replace(cfg, img_res=shape.img_res, window=max(cfg.window * shape.img_res // cfg.img_res, 1))
    if isinstance(cfg, ViTConfig) and shape.img_res and shape.img_res != cfg.img_res:
        return dataclasses.replace(cfg, img_res=shape.img_res)
    return cfg
