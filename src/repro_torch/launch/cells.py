"""Per-(arch × shape × mesh) cells: plans, rules, step functions, input
specs and shardings (port of ``repro.launch.cells``).

``make_plan``, ``make_rules``, ``optim_policy``, ``param_dtype_policy``
and ``input_shardings`` depend only on the mesh's axis names and sizes, so
a shape-only production mesh gives the reference's.  ``make_step`` gives
each kind's step as a torch function of a model module; where the
reference lowers and compiles a cell (``lower_cell``), the port counts its
step on the meta device (``count_cell``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import (
    DiTConfig,
    LMConfig,
    ResNetConfig,
    ShapeSpec,
    SwinConfig,
    UNetConfig,
    ViTConfig,
    get_arch,
)
from repro_torch.launch.roofline import CostCounter
from repro_torch.models import api
from repro_torch.models import transformer as tr
from repro_torch.models.ptree import bytes_per_chip
from repro_torch.models.transformer import ParallelPlan
from repro_torch.sharding import axes as ax
from repro_torch.sharding.fsdp import tree_fsdp
from repro_torch.train import optim

F32 = torch.float32


# --------------------------------------------------------------------------- #
# Plans / rules / optimizer policy per cell
# --------------------------------------------------------------------------- #


def make_plan(cfg, shape: ShapeSpec, mesh, *, analysis: bool = False, overrides: dict | None = None) -> ParallelPlan:
    sizes = ax.mesh_sizes(mesh)
    model_axis = sizes.get("model", 1)
    data_axis = sizes.get("data", 1) * sizes.get("pod", 1)
    kw: dict = dict(model_axis=model_axis, data_axis=data_axis, analysis_unroll=analysis)
    if isinstance(cfg, LMConfig):
        kw["attn_mode"] = "tp"  # the padded-head TP baseline
        if shape.kind == "train" and shape.seq_len >= 4096:
            kw["attn_chunk"] = 1024  # caps f32 score temps under remat
        elif shape.kind == "prefill" and shape.seq_len >= 8192:
            kw["attn_chunk"] = 2048
        if shape.kind == "decode" and cfg.n_kv_heads == cfg.n_heads and shape.seq_len >= 32768:
            kw["kv_cache_dtype"] = "int8"  # MHA KV does not fit in bf16 (qwen)
        kw["remat"] = shape.kind == "train"
        if cfg.moe is not None and shape.kind in ("train", "prefill"):
            kw["moe_grouped_dispatch"] = True
        if shape.kind == "decode":
            kw["pad_attention_heads"] = False  # decode never head-shards
            if cfg.use_mla:
                kw["mla_absorb"] = True
        if cfg.n_kv_heads == cfg.n_heads and shape.kind in ("train", "prefill"):
            kw["fuse_qkv"] = True  # one stacked QKV projection
    if overrides:
        kw.update(overrides)
    return ParallelPlan(**kw)


def make_rules(cfg, shape: ShapeSpec, mesh) -> dict:
    sizes = ax.mesh_sizes(mesh)
    multi = "pod" in sizes
    rules = dict(ax.multipod_rules() if multi else ax.DEFAULT_RULES)
    data_total = sizes.get("data", 1) * sizes.get("pod", 1)
    batch = shape.global_batch or shape.batch
    if batch and batch % data_total != 0:
        # tiny-batch serving cells: replicate batch; use data axis spatially
        rules["batch"] = None
        rules["spatial"] = ("pod", "data") if multi else "data"
        rules["seq_sp"] = (("pod", "data", "model") if multi else ("data", "model"))
    if isinstance(cfg, LMConfig) and shape.kind == "train":
        rules["seq_res"] = "model"  # Megatron-SP residual stream sharding
    return rules


def optim_policy(cfg) -> optim.OptimConfig:
    if api.build(cfg).n_params() > 100e9:  # arctic: bf16 moments or it does not fit
        return optim.OptimConfig(m_dtype="bfloat16", v_dtype="bfloat16")
    return optim.OptimConfig()


def param_dtype_policy(cfg, shape: ShapeSpec) -> torch.dtype:
    """Training stores float32 masters unless the model is huge; serving bf16."""
    if shape.kind != "train":
        return torch.bfloat16
    return torch.bfloat16 if api.build(cfg).n_params() > 100e9 else F32


# --------------------------------------------------------------------------- #
# Step functions per shape kind
# --------------------------------------------------------------------------- #


@contextlib.contextmanager
def _swapped(model: torch.nn.Module, tensors: dict[str, torch.Tensor]):
    """Hold ``tensors`` in place of the model's parameters of those names
    (forward and backward both see them), then put the parameters back."""
    saved = {}
    for name, t in tensors.items():
        mod_name, _, key = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        saved[name] = (mod, key, mod._parameters[key])
        mod._parameters[key] = t
    try:
        yield
    finally:
        for mod, key, p in saved.values():
            mod._parameters[key] = p


def make_step(handle: api.ModelHandle, cfg, shape: ShapeSpec, ocfg: optim.OptimConfig) -> Callable:
    """The step of ``shape.kind``, a function of the model module:

      train  : step(model, opt, batch) -> (loss, opt)   bf16 casts of the
               >=2-D float32 masters, ``loss.backward()``, ``apply_updates``
               (the masters and moments change in place)
      prefill: step(model, tokens)           ``lm_prefill``
      decode : step(model, cache, token)     ``lm_decode`` at pos = seq_len - 1
      gen    : step(model, latents, t, cond) one DDIM step (of shape.steps)
      serve  : step(model, images)           one forward

    Every kind but train runs under ``torch.no_grad()``."""
    plan = handle.plan

    if shape.kind == "train":

        def train_step(model, opt, batch):
            masters = dict(model.named_parameters())
            for p in masters.values():
                p.requires_grad_(True)
            cast = {k: p.to(torch.bfloat16) for k, p in masters.items() if p.dtype == F32 and p.ndim >= 2}
            with _swapped(model, cast):
                loss = handle.loss(model, batch)
                loss.backward()
            grads = {k: p.grad for k, p in masters.items()}
            _, opt = optim.apply_updates(ocfg, masters, grads, opt)
            for p in masters.values():
                p.grad = None
            return loss.detach(), opt

        return train_step

    if shape.kind == "prefill":

        @torch.no_grad()
        def prefill_step(model, tokens):
            return tr.lm_prefill(model, tokens, cfg, plan)

        return prefill_step

    if shape.kind == "decode":
        pos = shape.seq_len - 1

        @torch.no_grad()
        def decode_step(model, cache, token):
            return tr.lm_decode(model, cache, token, pos, cfg, plan)

        return decode_step

    if shape.kind == "gen":

        @torch.no_grad()
        def denoise_step(model, latents, t, cond):
            """One DDIM step of ``shape.steps``; the sampler loop is the host's."""
            eps = handle.forward(model, latents, t, cond).to(F32)
            eps = eps[..., :latents.shape[-1]]  # drop the sigma channels if any
            tt = t.to(F32).reshape(-1, 1, 1, 1)
            abar = torch.cos(0.5 * math.pi * (tt / 1000.0)) ** 2
            t_prev = torch.clamp_min(tt - 1000.0 / shape.steps, 0.0)
            abar_prev = torch.cos(0.5 * math.pi * (t_prev / 1000.0)) ** 2
            x0 = (latents.to(F32) - torch.sqrt(1 - abar) * eps) / torch.sqrt(torch.clamp_min(abar, 1e-8))
            x_prev = torch.sqrt(abar_prev) * x0 + torch.sqrt(1 - abar_prev) * eps
            return x_prev.to(latents.dtype)

        return denoise_step

    if shape.kind == "serve":

        @torch.no_grad()
        def serve_step(model, images):
            return handle.forward(model, images)

        return serve_step

    raise ValueError(shape.kind)


# --------------------------------------------------------------------------- #
# Input shardings
# --------------------------------------------------------------------------- #


def input_axes(cfg, shape: ShapeSpec, plan: ParallelPlan) -> dict:
    """The logical axes of each input of ``api.input_specs``: the batch dim
    on ``batch``, a latent's rows on ``spatial`` (taken only where the
    batch is not sharded), a decode cache's sequence on ``kv_seq``."""
    if isinstance(cfg, LMConfig):
        if shape.kind == "train":
            return {"batch": {"tokens": ("batch", None), "labels": ("batch", None)}}
        if shape.kind == "prefill":
            return {"tokens": ("batch", None)}
        if shape.kind == "decode":
            cache = {k: (None, "batch", "kv_seq") + (None,) * (len(shp) - 3)
                     for k, (shp, _) in tr.cache_spec(cfg, plan, 1, 1).items()}
            return {"cache": cache, "token": ("batch",)}
    if isinstance(cfg, (DiTConfig, UNetConfig)):
        lat = ("batch", "spatial", None, None)
        cond = ("batch",) if isinstance(cfg, DiTConfig) else ("batch", None, None)
        if shape.kind == "train":
            return {"batch": {"latents": lat, "t": ("batch",), "noise": lat, "cond": cond}}
        return {"latents": lat, "t": ("batch",), "cond": cond}
    if isinstance(cfg, (ViTConfig, SwinConfig, ResNetConfig)):
        img = ("batch", None, None, None)
        if shape.kind == "train":
            return {"batch": {"images": img, "labels": ("batch",)}}
        return {"images": img}
    raise TypeError(type(cfg))


def _zip(a: dict, b: dict, fn) -> dict:
    return {k: _zip(a[k], b[k], fn) if isinstance(a[k], dict) else fn(a[k], b[k]) for k in a}


def input_shardings(cfg, shape: ShapeSpec, mesh, rules, plan: ParallelPlan) -> dict:
    """Spec tree matching ``api.input_specs``: each input's ``input_axes``
    resolved under ``rules`` (whose ``_sizes`` are the mesh's)."""
    rules = dict(rules, _sizes=ax.mesh_sizes(mesh))
    return _zip(api.input_specs(cfg, shape, plan), input_axes(cfg, shape, plan),
                lambda t, axes: ax.resolve(t.shape, *axes, rules=rules))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# --------------------------------------------------------------------------- #
# Cell assembly
# --------------------------------------------------------------------------- #


@dataclass
class Cell:
    arch_id: str
    shape: ShapeSpec
    mesh: Any
    cfg: Any
    plan: ParallelPlan
    rules: dict
    handle: api.ModelHandle
    step: Callable
    ocfg: optim.OptimConfig
    param_dtype: torch.dtype
    param_struct: dict  # {name: meta tensor}
    param_specs: dict  # {name: spec on the reference's dims}, FSDP'd for train
    opt_struct: Optional[dict]  # train only
    inputs: dict  # api.input_specs
    input_specs: dict  # input_shardings
    n_params: int
    n_active_params: int

    @property
    def sizes(self) -> dict[str, int]:
        return self.rules["_sizes"]

    def state_bytes_per_chip(self) -> dict[str, int]:
        """Bytes one chip holds of the parameters, the optimizer state and
        the inputs, from the resolved specs: a lower bound on its memory
        (no activation or temporary is counted)."""
        leaves = self.handle.leaves()
        sizes = self.sizes
        # a parameter's spec is on the reference's dims; its bytes split alike
        ref_struct = {k: torch.empty([n for n, _ in leaves[k].ref], dtype=t.dtype, device="meta")
                      for k, t in self.param_struct.items()}
        params = bytes_per_chip(ref_struct, self.param_specs, sizes)
        opt = 0
        if self.opt_struct is not None:
            opt = 4  # the int32 step, replicated
            for key in ("m", "v", "err"):
                if key in self.opt_struct:
                    opt += bytes_per_chip({k: ref_struct[k].to(t.dtype) for k, t in self.opt_struct[key].items()},
                                          self.param_specs, sizes)
        inputs = bytes_per_chip(_flat(self.inputs), _flat(self.input_specs), sizes)
        return {"params": params, "opt_state": opt, "inputs": inputs, "total": params + opt + inputs}


def build_cell(arch_id: str, shape_name: str, mesh, *, analysis: bool = False,
               plan_overrides: dict | None = None, cfg_override=None,
               ocfg_overrides: dict | None = None) -> Cell:
    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    base_cfg = cfg_override if cfg_override is not None else spec.full
    cfg = api.config_for_shape(base_cfg, shape)
    plan = make_plan(cfg, shape, mesh, analysis=analysis, overrides=plan_overrides)
    rules = make_rules(cfg, shape, mesh)
    rules["_sizes"] = ax.mesh_sizes(mesh)
    handle = api.build(cfg, plan)

    ocfg = optim_policy(base_cfg) if shape.kind == "train" else optim.OptimConfig()
    if ocfg_overrides:
        ocfg = dataclasses.replace(ocfg, **ocfg_overrides)
    step = make_step(handle, cfg, shape, ocfg)

    pdt = param_dtype_policy(base_cfg, shape)
    pstruct = handle.struct(pdt)
    pspecs = handle.pspecs(rules)
    opt_struct = None
    if shape.kind == "train":
        leaves = handle.leaves()
        pspecs = tree_fsdp(pspecs, {k: [n for n, _ in leaves[k].ref] for k in pspecs}, mesh)
        opt_struct = optim.state_struct(ocfg, pstruct)
    n_params = handle.n_params()
    return Cell(arch_id=arch_id, shape=shape, mesh=mesh, cfg=cfg, plan=plan, rules=rules, handle=handle, step=step,
                ocfg=ocfg, param_dtype=pdt, param_struct=pstruct, param_specs=pspecs, opt_struct=opt_struct,
                inputs=api.input_specs(cfg, shape, plan),
                input_specs=input_shardings(cfg, shape, mesh, rules, plan), n_params=n_params,
                n_active_params=base_cfg.active_param_count if isinstance(base_cfg, LMConfig) else n_params)


def step_args(cell: Cell, model, inputs: dict, opt: Optional[dict] = None) -> tuple:
    """The step's arguments in order, after the model."""
    kind = cell.shape.kind
    if kind == "train":
        return (opt, inputs["batch"])
    if kind == "prefill":
        return (inputs["tokens"],)
    if kind == "decode":
        return (inputs["cache"], inputs["token"])
    if kind == "gen":
        return (inputs["latents"], inputs["t"], inputs["cond"])
    return (inputs["images"],)


def count_cell(cell: Cell) -> CostCounter:
    """Run the cell's step once on the meta device under a ``CostCounter``:
    its FLOPs and bytes at the cell's full shape, with nothing allocated."""
    with torch.device("meta"):
        model = cell.handle.init(None, "meta", cell.param_dtype)
    opt = optim.state_struct(cell.ocfg, cell.param_struct) if cell.opt_struct is not None else None
    with CostCounter() as counter:
        cell.step(model, *step_args(cell, model, cell.inputs, opt))
    return counter
