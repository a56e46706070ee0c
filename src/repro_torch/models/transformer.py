"""Decoder-only transformer LM, the dense GQA family (port of
``repro.models.transformer``).

Entry points, as in the reference:
  lm_forward   — full-sequence causal forward -> (B, S, V) logits
  lm_prefill   — full-sequence forward -> (last-token logits, KV cache)
  lm_decode    — one-token step against a fixed-length ring cache

``params`` is a ``TransformerLM``, whose parameter names are the reference
pytree's leaves with the stacked layers unstacked (``layers.3.attn.wq``),
as ``models/convert.py`` names them; weights are in ``F.linear``'s
``(out, in)`` layout: ``wq`` ``(H·Dh, d)``, ``wk``/``wv`` ``(KH·Dh, d)``,
``bq``/``bk``/``bv`` ``(H·Dh,)``/``(KH·Dh,)``, attention ``wo`` ``(d, H·Dh)``,
``wg``/``wu`` ``(d_ff, d)``, ``wd`` ``(d, d_ff)``, ``embed`` and ``unembed``
``(V, d)``.  Caches keep the reference's layout: ``k``/``v`` (L, B, S, KH, Dh)
and, for an int8 cache, ``k_scale``/``v_scale`` (L, B, S, 1, 1) bf16.

With ``ParallelPlan(kv_cache_dtype="int8", kv_scale_fold=True)`` every
decode step's attention goes to ``kernels.int8_kv_decode.ops.decode_attention``:
the hand-written CUDA kernel on the card, its plain version on the CPU.
MLA (DeepSeek-V2), MoE layers and the fused QKV projection are not ported
yet (ROADMAP A.12) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.int8_kv_decode.ops import decode_attention
from repro_torch.models.layers import (
    F32,
    _expand_kv,
    apply_mlp,
    apply_norm,
    apply_rope,
    attention_blockwise,
    attention_core,
)

NOT_PORTED = "is not ported yet (ROADMAP A.12)"


@dataclass(frozen=True)
class ParallelPlan:
    """The reference's parallelism and analysis knobs, by the same names.

    On one card ``model_axis`` must be 1.  ``kv_cache_dtype`` (bf16 | int8),
    ``kv_scale_fold`` and ``attn_chunk`` are honoured.  ``remat``,
    ``analysis_unroll``, ``pad_attention_heads``, ``data_axis`` and
    ``fused_unembed_loss`` do not change the numbers at ``model_axis`` 1
    (or serve only the loss or MoE, which are not ported), so they are
    accepted and ignored.  ``mla_absorb``,
    ``fuse_qkv``, ``moe_grouped_dispatch`` and ``attn_mode="sp"`` raise
    ``NotImplementedError``."""

    model_axis: int = 1
    data_axis: int = 1
    attn_mode: str = "tp"  # tp | sp
    pad_attention_heads: bool = True
    mla_absorb: bool = False
    analysis_unroll: bool = False
    remat: bool = True
    attn_chunk: int = 0  # >0: blockwise attention for prefill/forward
    kv_cache_dtype: str = "bf16"  # bf16 | int8
    fused_unembed_loss: bool = False
    fuse_qkv: bool = False
    moe_grouped_dispatch: bool = False
    kv_scale_fold: bool = False  # fold int8 KV scales into scores/probs


def check_supported(cfg: LMConfig, plan: ParallelPlan) -> None:
    """Raise on what the port does not run: MLA, MoE and the plan options
    that serve them or a mesh."""
    for flag, what in ((cfg.use_mla, "MLA attention (use_mla)"), (cfg.moe is not None, "MoE layers (cfg.moe)"),
                       (plan.mla_absorb, "absorbed MLA decode (mla_absorb)"),
                       (plan.fuse_qkv, "the fused QKV projection (fuse_qkv)"),
                       (plan.moe_grouped_dispatch, "grouped MoE dispatch (moe_grouped_dispatch)"),
                       (plan.attn_mode == "sp", "sequence-parallel attention (attn_mode='sp')")):
        if flag:
            raise NotImplementedError(f"{what} {NOT_PORTED}")
    if plan.attn_mode != "tp":
        raise ValueError(f"attn_mode must be 'tp' or 'sp', got {plan.attn_mode!r}")
    if plan.model_axis != 1:
        raise ValueError(f"the port runs on one card: model_axis must be 1, got {plan.model_axis}")
    if plan.kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {plan.kv_cache_dtype!r}")


def effective_heads(cfg: LMConfig, plan: ParallelPlan) -> tuple[int, int]:
    """(q_heads, kv_heads).  The reference pads the heads up to a multiple
    of ``model_axis``; at the one card's ``model_axis`` 1 that changes
    nothing."""
    return cfg.n_heads, cfg.n_kv_heads


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #


def _param_shapes(cfg: LMConfig, plan: ParallelPlan) -> dict[str, tuple[tuple[int, ...], int | None]]:
    """{name: (shape in the port's layout, fan-in of the reference layout,
    or None for a constant: a norm scale (1) or a bias (0))}."""
    d, Dh, f, V = cfg.d_model, cfg.d_head, cfg.d_ff, cfg.vocab_size
    h, kh = effective_heads(cfg, plan)
    norm = ("scale",) if cfg.norm == "rmsnorm" else ("scale", "bias")
    out: dict[str, tuple[tuple[int, ...], int | None]] = {"embed": ((V, d), d)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        layer = {"attn.wq": ((h * Dh, d), d * h), "attn.wk": ((kh * Dh, d), d * kh),
                 "attn.wv": ((kh * Dh, d), d * kh), "attn.wo": ((d, h * Dh), h * Dh)}
        if cfg.qkv_bias:
            layer.update({"attn.bq": ((h * Dh,), None), "attn.bk": ((kh * Dh,), None),
                          "attn.bv": ((kh * Dh,), None)})
        if cfg.ffn_act == "swiglu":
            layer.update({"mlp.wg": ((f, d), d), "mlp.wu": ((f, d), d), "mlp.wd": ((d, f), f)})
        else:
            layer.update({"mlp.wi": ((f, d), d), "mlp.wo": ((d, f), f)})
        for ln in ("ln1", "ln2"):
            layer.update({f"{ln}.{k}": ((d,), None) for k in norm})
        out.update({pre + k: v for k, v in layer.items()})
    out.update({f"final_norm.{k}": ((d,), None) for k in norm})
    if not cfg.tie_embeddings:
        out["unembed"] = ((V, d), d)
    return out


class TransformerLM(nn.Module):
    """The weights of a dense GQA LM.

    ``TransformerLM(cfg, plan, generator=g)`` draws them as
    ``models/ptree.py::tree_init`` does: normal, std 1/sqrt(fan_in) with the
    reference layout's fan-in (the product of all dims but the last, so
    d·H for ``wq``; H·Dh for ``wo``; d for ``embed``), norm scales 1 and
    biases 0.  Each leaf is drawn on the generator's device in ``dtype`` and
    copied into place, so a 12 B-parameter model drawn on the card never
    passes through float32 or the host.  Norm parameters are float32, as
    the reference's ``norm_spec`` makes them.  Without a generator the
    weights are zeros, to be overwritten by ``load_state_dict``.  No
    parameter requires grad (training is not ported), so the entry points
    build no autograd graph.
    """

    def __init__(self, cfg: LMConfig, plan: ParallelPlan | None = None, *,
                 generator: torch.Generator | None = None, device=None, dtype=torch.bfloat16):
        super().__init__()
        plan = plan or ParallelPlan()
        check_supported(cfg, plan)
        dev = resolve_device(device)
        self.cfg, self.plan = cfg, plan
        self._fan_in: dict[str, int] = {}
        layers = []
        for i in range(cfg.n_layers):
            layers.append(nn.ModuleDict({"ln1": nn.ParameterDict(), "attn": nn.ParameterDict(),
                                         "ln2": nn.ParameterDict(), "mlp": nn.ParameterDict()}))
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.ParameterDict()
        for name, (shape, fan_in) in _param_shapes(cfg, plan).items():
            is_norm = name.startswith("final_norm.") or ".ln" in name
            p = nn.Parameter(torch.zeros(shape, dtype=F32 if is_norm else dtype, device=dev),
                             requires_grad=False)
            if fan_in is not None:
                self._fan_in[name] = fan_in
            self._place(name, p)
        if generator is not None:
            self.reset_parameters(generator)

    def _place(self, name: str, p: nn.Parameter) -> None:
        parts = name.split(".")
        if len(parts) == 1:
            self.register_parameter(name, p)
        elif parts[0] == "final_norm":
            self.final_norm[parts[1]] = p
        else:
            self.layers[int(parts[1])][parts[2]][parts[3]] = p

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        gdev = generator.device
        for name, p in self.named_parameters():
            if name in self._fan_in:
                std = 1.0 / math.sqrt(max(self._fan_in[name], 1))
                p.copy_(torch.randn(p.shape, generator=generator, device=gdev, dtype=p.dtype).mul_(std))
            else:
                p.fill_(1.0 if name.endswith(".scale") else 0.0)


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #


def _gqa_qkv(p, x, cfg: LMConfig, positions):
    """x (B, S, d) -> q (B, S, H, Dh), k and v (B, S, KH, Dh); bias, then
    partial RoPE on q and k."""
    B, S, _ = x.shape
    Dh = cfg.d_head
    q = F.linear(x, p["wq"]).view(B, S, -1, Dh)
    k = F.linear(x, p["wk"]).view(B, S, -1, Dh)
    v = F.linear(x, p["wv"]).view(B, S, -1, Dh)
    if "bq" in p:
        q = q + p["bq"].view(-1, Dh)
        k = k + p["bk"].view(-1, Dh)
        v = v + p["bv"].view(-1, Dh)
    rot = int(cfg.d_head * cfg.rope_pct)
    q = apply_rope(q, positions, cfg.rope_theta, rot)
    k = apply_rope(k, positions, cfg.rope_theta, rot)
    return q, k, v


def _self_attention(p, x, cfg: LMConfig, plan: ParallelPlan, positions):
    """Full-sequence causal self-attention.  Returns (out @ wo, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    k_e, v_e = _expand_kv(k, q.shape[2]), _expand_kv(v, q.shape[2])
    if plan.attn_chunk and S > 2 * plan.attn_chunk:
        out = attention_blockwise(q, k_e, v_e, causal=True, chunk=plan.attn_chunk)
    else:
        out = attention_core(q, k_e, v_e, causal=True)
    return F.linear(out.reshape(B, S, -1), p["wo"]), (k, v)


def _quantize(x: torch.Tensor, first_reduced: int):
    """Per-token int8: amax over dims ``first_reduced``.. in f32, scale
    max(amax, 1e-6)/127, values rounded half to even and clipped to ±127
    from the f32 scale; the scale is stored as bf16."""
    xf = x.to(F32)
    amax = xf.abs().amax(dim=tuple(range(first_reduced, x.ndim)), keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _quantize_slot(x: torch.Tensor):
    """One new cache entry (B, 1, KH, Dh) (``transformer.py:253-258``)."""
    return _quantize(x, 2)


def _quantize_cache(cache: dict, plan: ParallelPlan) -> dict:
    """A stacked (L, B, S, KH, Dh) cache -> int8 with (L, B, S, 1, 1) bf16
    scales (``transformer.py:535-544``); unchanged for a bf16 plan."""
    if plan.kv_cache_dtype != "int8":
        return cache
    out = {}
    for name, x in cache.items():
        out[name], out[name + "_scale"] = _quantize(x, 3)
    return out


def _cache_write(cache: dict, name: str, new: torch.Tensor, slot: int, layer: int) -> None:
    """Write one token's K or V (B, 1, KH, Dh) into ring slot ``slot`` of
    layer ``layer``, quantized if the cache is int8.  The write is in place,
    PyTorch's idiom; the reference returns an updated copy."""
    if name + "_scale" in cache:
        q, s = _quantize_slot(new)
        cache[name][layer, :, slot] = q[:, 0]
        cache[name + "_scale"][layer, :, slot] = s[:, 0]
    else:
        cache[name][layer, :, slot] = new[:, 0].to(cache[name].dtype)


def _cache_read(cache: dict, name: str, layer: int) -> torch.Tensor:
    """bf16 view of one layer's cache leaf, dequantized if int8
    (``transformer.py:280-287``): the product is rounded to bf16 whatever
    the model's dtype, as in the reference."""
    x = cache[name][layer]
    if name + "_scale" in cache:
        s = cache[name + "_scale"][layer].to(F32)
        return (x.to(F32) * s).to(torch.bfloat16)
    return x.to(torch.bfloat16)


def _gqa_decode_attention(q, k, v):
    """Grouped decode attention without expanding K/V to the q heads:
    q (B, 1, H, D), k and v (B, S, KH, D) -> (B, 1, H, D).  Scores in q's
    dtype, softmax in f32, probabilities cast back before P·V."""
    B, T, H, Dh = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, T, KH, H // KH, Dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k).to(F32) / math.sqrt(Dh)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(B, T, H, Dh)


def _decode_attention(p, x, cfg: LMConfig, plan: ParallelPlan, cache: dict, pos: int, layer: int):
    """One-token attention against the ring cache (slot ``pos % S``): this
    layer's slot is written in place, then its slice is read.

    Three branches, as in the reference: a bf16 cache; an int8 cache read
    through a bf16 dequantized copy; and an int8 cache with
    ``kv_scale_fold``, which goes to ``decode_attention`` (the CUDA kernel on
    the card) with the scales as f32 (B, S).  Returns out @ wo."""
    B = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _gqa_qkv(p, x, cfg, positions)
    slot = pos % cache["k"].shape[2]
    _cache_write(cache, "k", k_new, slot, layer)
    _cache_write(cache, "v", v_new, slot, layer)
    if plan.kv_scale_fold and "k_scale" in cache:
        ks = cache["k_scale"][layer][:, :, 0, 0].to(F32)  # (B, S)
        vs = cache["v_scale"][layer][:, :, 0, 0].to(F32)
        out = decode_attention(q[:, 0], cache["k"][layer], ks, cache["v"][layer], vs)[:, None]
    else:
        k = _cache_read(cache, "k", layer).to(x.dtype)
        v = _cache_read(cache, "v", layer).to(x.dtype)
        out = _gqa_decode_attention(q, k, v)
    return F.linear(out.reshape(B, 1, -1), p["wo"])


# --------------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------------- #


def _unembed(params, x):
    table = getattr(params, "unembed", None)
    if table is None:
        table = params.embed
    return F.linear(x, table.to(x.dtype))


def _layer_fwd(p, x, cfg: LMConfig, plan: ParallelPlan, positions):
    attn_out, kv = _self_attention(p["attn"], apply_norm(p["ln1"], x, cfg.norm), cfg, plan, positions)
    x = x + attn_out
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.norm), cfg.ffn_act), kv


def lm_hidden(params, tokens, cfg: LMConfig, plan: ParallelPlan):
    """(B, S) -> final-normed hidden states (B, S, d) and the MoE aux loss
    (0 for a dense model)."""
    check_supported(cfg, plan)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = params.embed[tokens]
    for layer in params.layers:
        x, _ = _layer_fwd(layer, x, cfg, plan, positions)
    return apply_norm(params.final_norm, x, cfg.norm), torch.zeros((), dtype=F32, device=x.device)


def lm_forward(params, tokens, cfg: LMConfig, plan: ParallelPlan):
    """(B, S) int -> ((B, S, V) logits in the weights' dtype, aux loss)."""
    x, aux = lm_hidden(params, tokens, cfg, plan)
    return _unembed(params, x), aux


def cache_spec(cfg: LMConfig, plan: ParallelPlan, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of a decode KV cache of length ``seq``."""
    check_supported(cfg, plan)
    _, kh = effective_heads(cfg, plan)
    L = cfg.n_layers
    dt = torch.int8 if plan.kv_cache_dtype == "int8" else torch.bfloat16
    out = {name: ((L, batch, seq, kh, cfg.d_head), dt) for name in ("k", "v")}
    if plan.kv_cache_dtype == "int8":
        for name in ("k", "v"):
            out[name + "_scale"] = ((L, batch, seq, 1, 1), torch.bfloat16)
    return out


def lm_prefill(params, tokens, cfg: LMConfig, plan: ParallelPlan):
    """(B, S) -> (last-token logits (B, V), stacked KV cache).

    Each layer's K and V go into the stacked cache as soon as the layer has
    run, quantized per layer for an int8 plan (the same per-token amax as
    the reference's whole-cache ``_quantize_cache``), so the float cache of
    all layers is never held at once.  A bf16 plan keeps K and V in the
    model's dtype, as the reference does."""
    check_supported(cfg, plan)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = params.embed[tokens]
    cache: dict = {}
    for i, layer in enumerate(params.layers):
        x, (k, v) = _layer_fwd(layer, x, cfg, plan, positions)
        for name, t in _quantize_cache({"k": k[None], "v": v[None]}, plan).items():
            if name not in cache:
                cache[name] = torch.empty((cfg.n_layers,) + tuple(t.shape[1:]), dtype=t.dtype,
                                          device=t.device)
            cache[name][i] = t[0]
    x = apply_norm(params.final_norm, x[:, -1:], cfg.norm)
    return _unembed(params, x)[:, 0], cache


def lm_decode(params, cache: dict, token, pos: int, cfg: LMConfig, plan: ParallelPlan):
    """One decode step: token (B,) int, ``pos`` a Python int; the new K/V
    go to ring slot ``pos % S`` of ``cache``, in place.  Returns
    ((B, V) logits, the same cache)."""
    check_supported(cfg, plan)
    x = params.embed[token[:, None]]
    for i, layer in enumerate(params.layers):
        h = apply_norm(layer["ln1"], x, cfg.norm)
        x = x + _decode_attention(layer["attn"], h, cfg, plan, cache, pos, i)
        x = x + apply_mlp(layer["mlp"], apply_norm(layer["ln2"], x, cfg.norm), cfg.ffn_act)
    x = apply_norm(params.final_norm, x, cfg.norm)
    return _unembed(params, x)[:, 0], cache
