"""Mixture-of-Experts FFN (port of ``repro.models.moe``).

GShard-style capacity dispatch, sort-based and gather-only, as in the
reference: each token's top-k experts are picked from an f32 softmax over
``x @ router``; slots are ranked within their expert in token order (a
stable sort), and a slot ranked at or past the capacity C goes to the drop
bin and adds zero (nothing is renormalised).  ``groups`` > 1 dispatches
each of G equal slices of the batch on its own (the reference's
``moe_grouped_dispatch``).  DeepSeek-style shared experts and Arctic's
parallel dense residual FFN are added to the routed output.

The expert weights keep the reference's ``(E, in, out)`` layout, which
``torch.bmm`` takes: ``wg``/``wu``/``wi`` (E, d, f), ``wd``/``wo`` (E, f,
d); the router keeps its (d, E) float32 layout; ``shared`` and ``dense``
are MLPs in ``F.linear``'s layout (``layers.apply_mlp``).  The expert
products are plain batched matrix products, as they are plain einsums
outside any Pallas kernel in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import F32, Leaf, apply_mlp, leaf, mlp_shapes


def moe_shapes(d: int, cfg: MoEConfig, act: str) -> dict[str, Leaf]:
    """``moe.py::moe_spec``: the leaves of one MoE layer, with the
    reference's layout, logical axes and fan-ins (E·d for
    ``wg``/``wu``/``wi``, E·f for ``wd``/``wo``, d for the router)."""
    e, f = cfg.n_routed, cfg.d_ff_expert
    out = {"router": leaf((d, "embed"), (e, "experts"), f32=True)}
    up = leaf((e, "experts"), (d, "embed"), (f, "mlp"))
    down = leaf((e, "experts"), (f, "mlp"), (d, "embed"))
    if act == "swiglu":
        out.update(wg=up, wu=up, wd=down)
    else:
        out.update(wi=up, wo=down)
    if cfg.n_shared:
        out.update({"shared." + k: v for k, v in mlp_shapes(d, f * cfg.n_shared, act).items()})
    if cfg.dense_residual_ff:
        out.update({"dense." + k: v for k, v in mlp_shapes(d, cfg.dense_residual_ff, act).items()})
    return out


def capacity_for(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert takes: ceil(T·k·capacity_factor/E), rounded up to a
    multiple of 8, at least 8."""
    c = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_routed)
    return max(8, ((c + 7) // 8) * 8)


def route(router: torch.Tensor, xf: torch.Tensor, cfg: MoEConfig):
    """xf (G, T, d) -> (gates (G, T, E) f32, top_v (G, T, k) f32, top_i
    (G, T, k)): the softmax of ``xf @ router`` in f32, its k largest in
    descending order, and those k renormalised to sum 1 (divided by
    max(sum, 1e-9))."""
    gates = torch.softmax(xf.to(F32) @ router, dim=-1)
    top_v, top_i = torch.topk(gates, cfg.top_k, dim=-1)
    return gates, top_v / torch.clamp_min(top_v.sum(-1, keepdim=True), 1e-9), top_i


def apply_moe(p, x: torch.Tensor, cfg: MoEConfig, act: str, *, groups: int = 1):
    """x (B, S, d) -> (out (B, S, d), aux load-balance loss, an f32 scalar).
    ``groups`` applies when it divides B; otherwise one group."""
    B, S, D = x.shape
    G = groups if (groups > 1 and B % groups == 0) else 1
    out, aux = _moe_tokens(p, x.reshape(G, B * S // G, D), cfg, act)
    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, act)
    if "dense" in p:
        out = out + apply_mlp(p["dense"], x, act)
    return out, aux


def _expert_mm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (G, E, C, a) times each expert's w (E, a, b) -> (G, E, C, b)."""
    G, E, C, a = h.shape
    out = torch.bmm(h.transpose(0, 1).reshape(E, G * C, a), w)
    return out.reshape(E, G, C, -1).transpose(0, 1)


def _moe_tokens(p, xf: torch.Tensor, cfg: MoEConfig, act: str):
    """Dispatch, expert FFN and combine for xf (G, T, d) -> ((G, T, d), aux)."""
    G, T, D = xf.shape
    E, K = cfg.n_routed, cfg.top_k
    C = capacity_for(T, cfg)
    dev = xf.device

    gates, top_v, top_i = route(p["router"], xf, cfg)
    # load-balance aux loss (Switch/GShard form)
    ones = torch.ones(G * T * K, dtype=F32, device=dev)  # a scatter-add: bincount reads its size back to the host
    ce = torch.zeros(E, dtype=F32, device=dev).index_add_(0, top_i.reshape(-1), ones) / (G * T * K)
    aux = cfg.aux_loss_coef * E * torch.sum(gates.mean((0, 1)) * ce)

    # sort-based capacity dispatch: slots grouped by expert, ranked in token order
    flat_e = top_i.reshape(G, T * K)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, sort_idx)
    pos_in_e = torch.arange(T * K, device=dev) - torch.searchsorted(sorted_e, sorted_e, side="left")
    slot = torch.where(pos_in_e < C, sorted_e * C + pos_in_e, E * C)  # E·C is the drop bin
    token_of = sort_idx // K

    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")
    ends = torch.searchsorted(sorted_e, experts, side="right")
    cand = starts[:, :, None] + torch.arange(C, device=dev)  # (G, E, C) sorted positions
    slot_valid = (cand < ends[:, :, None]).reshape(G, E * C, 1)
    tok_for_slot = torch.gather(token_of, -1, cand.reshape(G, E * C).clamp(0, T * K - 1))
    buf = torch.gather(xf, 1, tok_for_slot[..., None].expand(G, E * C, D))
    buf = torch.where(slot_valid, buf, 0).reshape(G, E, C, D)

    # grouped expert FFN
    if "wg" in p:
        g, u = _expert_mm(buf, p["wg"]), _expert_mm(buf, p["wu"])
        out_buf = _expert_mm(F.silu(g.to(F32)).to(xf.dtype) * u, p["wd"])
    else:
        h = F.gelu(_expert_mm(buf, p["wi"]).to(F32), approximate="tanh").to(xf.dtype)
        out_buf = _expert_mm(h, p["wo"])
    out_flat = torch.cat([out_buf.reshape(G, E * C, D), xf.new_zeros(G, 1, D)], dim=1)  # + drop bin

    # combine: each (token, k) reads its slot back, in token order
    slot_unsorted = torch.empty_like(slot).scatter_(-1, sort_idx, slot)
    vals = torch.gather(out_flat, 1, slot_unsorted[..., None].expand(G, T * K, D)).reshape(G, T, K, D)
    out = (vals.to(F32) * top_v[..., None]).sum(2).to(xf.dtype)
    return out, aux
