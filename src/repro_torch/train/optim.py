"""AdamW with configurable state dtypes (port of ``repro.train.optim``).

  * low-precision moments (bf16 m/v);
  * parameters are their own master copy: each update is computed in
    float32 and cast back to the parameter's dtype;
  * gradient clipping by global norm (``clip_norm=0`` disables it);
  * optional int8 gradient compression with error feedback.

Parameters, gradients and moments are ``{name: tensor}`` dicts keyed by a
module's parameter names (``init_state`` takes the module or such a
dict).  ``apply_updates`` writes the new values into the parameter and
moment tensors in place and returns them.

Against the reference, given the same gradients and the same clip factor,
the compression round trip (``torch.round`` rounds half to even, as
``jnp.round``), the moment updates, the update of each parameter and the
casts to bf16 are the same float32 operations in the same order.  The
clip's global norm sums the squared norms in the module's parameter
order, where the reference sums them in ``jax.tree.leaves`` order, so the
factor may differ in its last bits.  ``state_struct`` is the dry run's
stand-in for the state, on the meta device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

F32 = torch.float32


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    m_dtype: str = "float32"  # float32 | bfloat16
    v_dtype: str = "float32"
    compress_grads: bool = False  # int8 + error feedback


def named(params) -> dict[str, torch.Tensor]:
    """A module's parameters by name, or a ``{name: tensor}`` dict as it is."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def init_state(cfg: OptimConfig, params) -> dict:
    """{"step": int32 0, "m", "v": zeros in m_dtype / v_dtype, and "err":
    bf16 zeros with ``compress_grads``}, each on its parameter's device."""
    params = named(params)
    dt_m, dt_v = getattr(torch, cfg.m_dtype), getattr(torch, cfg.v_dtype)
    dev = next(iter(params.values())).device if params else torch.device("cpu")

    def zeros(dtype):
        return {k: torch.zeros(p.shape, dtype=dtype, device=p.device) for k, p in params.items()}

    state = {"step": torch.zeros((), dtype=torch.int32, device=dev), "m": zeros(dt_m), "v": zeros(dt_v)}
    if cfg.compress_grads:
        state["err"] = zeros(torch.bfloat16)
    return state


def state_struct(cfg: OptimConfig, param_struct: dict) -> dict:
    """``init_state``'s shapes and dtypes as meta tensors (the dry run's
    optimizer state; nothing is allocated): "step" int32, "m" and "v" in
    m_dtype / v_dtype, and "err" bf16 with ``compress_grads``."""
    dt_m, dt_v = getattr(torch, cfg.m_dtype), getattr(torch, cfg.v_dtype)

    def like(dtype):
        return {k: torch.empty(s.shape, dtype=dtype, device="meta") for k, s in param_struct.items()}

    st = {"step": torch.empty((), dtype=torch.int32, device="meta"), "m": like(dt_m), "v": like(dt_v)}
    if cfg.compress_grads:
        st["err"] = like(torch.bfloat16)
    return st


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded: torch's float32 ``sqrt`` on
    the CPU is off by one ulp on some inputs, so there the root is taken in
    float64 (whose rounding to float32 is then exact); CUDA's is correct."""
    return torch.sqrt(x.double()).to(F32) if x.device.type == "cpu" else torch.sqrt(x)


def _compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """int8 round trip with error feedback: returns (g_hat, new_err)."""
    gf = g.to(F32) + err.to(F32)
    amax = gf.abs().amax()
    # a tensor divisor: CUDA turns division by a host scalar into a product
    # with its reciprocal, which rounds differently
    scale = torch.clamp_min(amax, 1e-20) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    g_hat = q * scale
    return g_hat.to(g.dtype), (gf - g_hat).to(torch.bfloat16)


def clip_factor(cfg: OptimConfig, grads: dict) -> torch.Tensor:
    """min(1, clip_norm / max(global norm, 1e-9)) as a float32 scalar; 1
    with ``clip_norm=0``."""
    dev = next(iter(grads.values())).device
    if cfg.clip_norm <= 0:
        return torch.ones((), dtype=F32, device=dev)
    gn = _sqrt(sum(g.to(F32).square().sum() for g in grads.values()))
    return torch.clamp(torch.full((), cfg.clip_norm, dtype=F32, device=dev) / torch.clamp_min(gn, 1e-9), max=1.0)


def bias_corrections(cfg: OptimConfig, step: torch.Tensor):
    """(1 - b1^step, 1 - b2^step) in float32."""
    s = step.to(F32)
    return (1.0 - torch.pow(torch.full_like(s, cfg.b1), s), 1.0 - torch.pow(torch.full_like(s, cfg.b2), s))


def update_leaf(cfg: OptimConfig, p, g, m, v, clip, bc1, bc2):
    """One parameter's AdamW step in float32: (p_new, m_new, v_new), each
    cast to its input's dtype."""
    gf = g.to(F32) * clip
    m_new = cfg.b1 * m.to(F32) + (1 - cfg.b1) * gf
    v_new = cfg.b2 * v.to(F32) + (1 - cfg.b2) * gf.square()
    delta = (m_new / bc1) / (_sqrt(v_new / bc2) + cfg.eps)
    pf = p.to(F32)
    p_new = pf - cfg.lr * (delta + cfg.weight_decay * pf)
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


@torch.no_grad()
def apply_updates(cfg: OptimConfig, params, grads: dict, state: dict):
    """One AdamW step; returns (params, new state).  The parameter and
    moment tensors are updated in place, one parameter at a time, so the
    float32 temporaries of only one are alive at once."""
    params = named(params)
    step = state["step"] + 1
    grads = dict(grads)
    new_err = {}
    if cfg.compress_grads:
        for k in grads:
            grads[k], new_err[k] = _compress_decompress(grads[k], state["err"][k])
    clip = clip_factor(cfg, grads)
    bc1, bc2 = bias_corrections(cfg, step)
    for k, p in params.items():
        p_new, m_new, v_new = update_leaf(cfg, p, grads[k], state["m"][k], state["v"][k], clip, bc1, bc2)
        p.copy_(p_new)
        state["m"][k].copy_(m_new)
        state["v"][k].copy_(v_new)
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    if cfg.compress_grads:
        new_state["err"] = new_err
    return params, new_state
