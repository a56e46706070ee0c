"""Decoder-only transformer LM: GQA (+QKV bias), MLA (DeepSeek-V2) and MoE
(port of ``repro.models.transformer``).

Entry points, as in the reference:
  lm_forward   — full-sequence causal forward -> ((B, S, V) logits, aux loss)
  lm_loss      — mean next-token cross-entropy + MoE aux (training)
  lm_prefill   — full-sequence forward -> (last-token logits, KV cache)
  lm_decode    — one-token step against a fixed-length ring cache

``params`` is a ``TransformerLM``, whose parameter names are the reference
pytree's leaves with the stacked layers unstacked (``layers.3.attn.wq``;
an MoE model's ``dense`` group first, then its ``moe`` group), as
``models/convert.py`` names them.  Projections are in ``F.linear``'s
``(out, in)`` layout: ``wq`` ``(H·Dh, d)``, ``wk``/``wv`` ``(KH·Dh, d)``,
``bq``/``bk``/``bv`` ``(H·Dh,)``/``(KH·Dh,)``, the fused ``wqkv``
``(3·H·Dh, d)`` and ``bqkv`` ``(3·H·Dh,)``, attention ``wo`` ``(d, H·Dh)``,
``wg``/``wu`` ``(d_ff, d)``, ``wd`` ``(d, d_ff)``, ``embed`` and ``unembed``
``(V, d)``; MLA's ``w_dkv`` ``(r + rope, d)``, ``w_uk`` ``(H·nope, r)``,
``w_uv`` ``(H·v, r)``, ``wq`` ``(H·(nope + rope), d)`` (or ``w_dq``
``(q_r, d)`` and ``w_uq`` ``(H·(nope + rope), q_r)``) and ``wo``
``(d, H·v)``.  The MoE leaves are ``models/moe.py``'s.

Caches keep the reference's layout: ``k``/``v`` (L, B, S, KH, Dh), or for
MLA the latent ``ckv`` (L, B, S, r) and ``k_rope`` (L, B, S, rope); an
int8 cache adds a per-token bf16 ``<name>_scale`` (L, B, S, 1, 1) or
(L, B, S, 1).  With ``ParallelPlan(kv_cache_dtype="int8",
kv_scale_fold=True)`` every GQA decode step's attention goes to
``kernels.int8_kv_decode.ops.decode_attention``: the hand-written CUDA
kernel on the card, its plain version on the CPU.  The MLA decode, naive
or absorbed (``mla_absorb``), is plain PyTorch, as it is plain jnp in the
reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.int8_kv_decode.ops import decode_attention
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    F32,
    HEADS_IN,
    HEADS_OUT,
    LINEAR,
    QKV,
    Leaf,
    ParamTree,
    _expand_kv,
    apply_mlp,
    apply_norm,
    apply_rope,
    attention_blockwise,
    attention_core,
    flat,
    leaf,
    mlp_shapes,
    norm_shapes,
    pad_heads,
)


@dataclass(frozen=True)
class ParallelPlan:
    """The reference's parallelism and analysis knobs, by the same names.

    ``model_axis`` > 1 pads the attention heads up to a multiple of it
    under ``attn_mode="tp"`` with ``pad_attention_heads``
    (``effective_heads``), as the reference does for its model-parallel
    mesh; the padded model runs on one card, and its dead heads change
    nothing when their ``wo`` columns and biases are 0.  ``kv_cache_dtype``
    (bf16 | int8), ``kv_scale_fold``, ``attn_chunk``, ``mla_absorb``,
    ``fuse_qkv`` (MHA only, as in the reference) and
    ``moe_grouped_dispatch`` (MoE prefill and forward in ``data_axis``
    groups when that divides the batch) are honoured.  ``attn_mode`` "tp"
    and "sp" differ only in how the reference shards attention (and in the
    padding), so on one card they compute the same.  ``remat``
    checkpoints each layer of ``lm_hidden`` under autograd.
    ``analysis_unroll`` and ``fused_unembed_loss`` do not change the
    numbers, so they are accepted and ignored."""

    model_axis: int = 1
    data_axis: int = 1  # the groups of grouped MoE dispatch
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
    """Raise on a model axis below 1 and on an unknown attention mode or
    cache dtype."""
    if plan.attn_mode not in ("tp", "sp"):
        raise ValueError(f"attn_mode must be 'tp' or 'sp', got {plan.attn_mode!r}")
    if plan.model_axis < 1:
        raise ValueError(f"model_axis must be at least 1, got {plan.model_axis}")
    if plan.kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {plan.kv_cache_dtype!r}")


def effective_heads(cfg: LMConfig, plan: ParallelPlan) -> tuple[int, int]:
    """(q_heads, kv_heads) after the padding to the model axis
    (``transformer.py:58-68``): under ``attn_mode="tp"`` with
    ``pad_attention_heads`` the q heads round up to a multiple of
    ``model_axis`` (qwen's 40 to 48 at 16), and an MHA model's kv heads
    follow them; a GQA model keeps its kv heads, so its head groups widen."""
    if plan.attn_mode != "tp" or not plan.pad_attention_heads:
        return cfg.n_heads, cfg.n_kv_heads
    h = pad_heads(cfg.n_heads, plan.model_axis)
    return h, (h if cfg.n_kv_heads == cfg.n_heads else cfg.n_kv_heads)


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #


def _attn_shapes(cfg: LMConfig, plan: ParallelPlan) -> dict[str, Leaf]:
    """``transformer.py::_attn_spec`` in the port's layout, with the
    reference layout's dims, logical axes and fan-ins."""
    d, Dh = cfg.d_model, cfg.d_head
    if cfg.use_mla:
        H, r, rope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
        qk = cfg.qk_nope_head_dim + rope
        out = {"w_dkv": leaf((d, "embed"), (r + rope, "kv_lora"), order=LINEAR),
               "w_uk": leaf((r, "kv_lora"), (H, "q_heads"), (cfg.qk_nope_head_dim, "head_dim"), order=HEADS_IN),
               "w_uv": leaf((r, "kv_lora"), (H, "q_heads"), (cfg.v_head_dim, "head_dim"), order=HEADS_IN),
               "wo": leaf((H, "q_heads"), (cfg.v_head_dim, "head_dim"), (d, "embed"), order=HEADS_OUT),
               **{"kv_norm." + k: v for k, v in norm_shapes(r, "rmsnorm").items()}}
        if cfg.q_lora_rank:
            qr = cfg.q_lora_rank
            out.update({"w_dq": leaf((d, "embed"), (qr, "kv_lora"), order=LINEAR),
                        "w_uq": leaf((qr, "kv_lora"), (H, "q_heads"), (qk, "head_dim"), order=HEADS_IN),
                        **{"q_norm." + k: v for k, v in norm_shapes(qr, "rmsnorm").items()}})
        else:
            out["wq"] = leaf((d, "embed"), (H, "q_heads"), (qk, "head_dim"), order=HEADS_IN)
        return out
    h, kh = effective_heads(cfg, plan)
    wo = leaf((h, "q_heads"), (Dh, "head_dim"), (d, "embed"), order=HEADS_OUT)
    if plan.fuse_qkv and kh == h:
        out = {"wqkv": leaf((3, "stack"), (d, "embed"), (h, "q_heads"), (Dh, "head_dim"), order=QKV), "wo": wo}
        if cfg.qkv_bias:
            out["bqkv"] = leaf((3, "stack"), (h, "q_heads"), (Dh, "head_dim"), order=flat(3), const=True)
        return out
    out = {"wq": leaf((d, "embed"), (h, "q_heads"), (Dh, "head_dim"), order=HEADS_IN),
           "wk": leaf((d, "embed"), (kh, "kv_heads"), (Dh, "head_dim"), order=HEADS_IN),
           "wv": leaf((d, "embed"), (kh, "kv_heads"), (Dh, "head_dim"), order=HEADS_IN), "wo": wo}
    if cfg.qkv_bias:
        out.update(bq=leaf((h, "q_heads"), (Dh, "head_dim"), order=flat(2), const=True),
                   bk=leaf((kh, "kv_heads"), (Dh, "head_dim"), order=flat(2), const=True),
                   bv=leaf((kh, "kv_heads"), (Dh, "head_dim"), order=flat(2), const=True))
    return out


def lm_param_shapes(cfg: LMConfig, plan: ParallelPlan) -> dict[str, Leaf]:
    """{dotted name: Leaf} of the whole model (``lm_param_spec``): a layer at
    or after ``moe.first_k_dense`` has ``moe``, the others ``mlp`` of width
    ``first_dense_ff or d_ff``.  The token table is sharded on d_model
    (``embed_tbl``), as the reference's is."""
    d, V = cfg.d_model, cfg.vocab_size
    out = {"embed": leaf((V, None), (d, "embed_tbl"), fan_in=d)}
    for i in range(cfg.n_layers):
        layer = {"ln1": norm_shapes(d, cfg.norm), "attn": _attn_shapes(cfg, plan), "ln2": norm_shapes(d, cfg.norm)}
        if cfg.moe is not None and i >= cfg.moe.first_k_dense:
            layer["moe"] = moe_lib.moe_shapes(d, cfg.moe, cfg.ffn_act)
        else:
            ff = (cfg.moe.first_dense_ff or cfg.d_ff) if cfg.moe is not None else cfg.d_ff
            layer["mlp"] = mlp_shapes(d, ff, cfg.ffn_act)
        out.update({f"layers.{i}.{g}.{k}": v for g, leaves in layer.items() for k, v in leaves.items()})
    out.update({"final_norm." + k: v for k, v in norm_shapes(d, cfg.norm).items()})
    if not cfg.tie_embeddings:
        out["unembed"] = leaf((d, "embed"), (V, "vocab"), order=LINEAR)
    return out


class TransformerLM(ParamTree):
    """The weights of an LM: dense GQA, MLA, MoE, or MLA with MoE.

    ``TransformerLM(cfg, plan, generator=g)`` draws them as ``ParamTree``
    does, with the reference layout's fan-in (the product of all dims but
    the last of the per-layer shape, so d·H for ``wq``, H·Dh for ``wo``, d
    for ``embed`` and the router, E·d for an expert's ``wg``).  Norm
    parameters (``kv_norm`` and ``q_norm`` too) and the MoE router are
    float32, as the reference's specs make them; the rest is in ``dtype``.
    No parameter requires grad until a trainer turns it on
    (``train/trainer.py``), so the serving entry points build no autograd
    graph.  ``model.layers`` iterates the layers in order.
    """

    def __init__(self, cfg: LMConfig, plan: ParallelPlan | None = None, *,
                 generator: torch.Generator | None = None, device=None, dtype=torch.bfloat16):
        plan = plan or ParallelPlan()
        check_supported(cfg, plan)
        super().__init__(lm_param_shapes(cfg, plan), generator=generator, device=device, dtype=dtype)
        self.cfg, self.plan = cfg, plan


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #


def _gqa_qkv(p, x, cfg: LMConfig, positions):
    """x (B, S, d) -> q (B, S, H, Dh), k and v (B, S, KH, Dh): one stacked
    projection (``wqkv``) or three, bias, then partial RoPE on q and k."""
    B, S, _ = x.shape
    Dh = cfg.d_head
    if "wqkv" in p:
        qkv = F.linear(x, p["wqkv"]).view(B, S, 3, -1, Dh)
        if "bqkv" in p:
            qkv = qkv + p["bqkv"].view(3, -1, Dh)
        q, k, v = qkv.unbind(2)
    else:
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


def _mla_qkv(p, x, cfg: LMConfig, positions):
    """x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope), the
    normed latent ckv (B, S, r) and k_rope (B, S, rope), RoPE applied to
    both rope parts (``transformer.py:202-216``)."""
    B, S, _ = x.shape
    H, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = apply_norm(p["q_norm"], F.linear(x, p["w_dq"]), "rmsnorm")
        q = F.linear(cq, p["w_uq"]).view(B, S, H, nope + rope)
    else:
        q = F.linear(x, p["wq"]).view(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta, rope)
    ckv_full = F.linear(x, p["w_dkv"])
    ckv = apply_norm(p["kv_norm"], ckv_full[..., :cfg.kv_lora_rank], "rmsnorm")
    k_rope = apply_rope(ckv_full[:, :, None, cfg.kv_lora_rank:], positions, cfg.rope_theta, rope)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def _mla_expand(p, ckv, k_rope, n_heads: int):
    """The latent ckv (B, S, r) and k_rope (B, S, rope) -> k (B, S, H,
    nope + rope), k_rope shared by every head, and v (B, S, H, v)."""
    B, S, _ = ckv.shape
    k_nope = F.linear(ckv, p["w_uk"]).view(B, S, n_heads, -1)
    v = F.linear(ckv, p["w_uv"]).view(B, S, n_heads, -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, n_heads, k_rope.shape[-1])], dim=-1)
    return k, v


def _self_attention(p, x, cfg: LMConfig, plan: ParallelPlan, positions):
    """Full-sequence causal self-attention.  Returns (out @ wo, the layer's
    cache entries: {"k", "v"}, or MLA's {"ckv", "k_rope"}).  MLA's softmax
    scale 1/sqrt(nope + rope) is ``attention_core``'s 1/sqrt of q's head."""
    B, S, _ = x.shape
    if cfg.use_mla:
        q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, positions)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k, v = _mla_expand(p, ckv, k_rope, cfg.n_heads)
        cache = {"ckv": ckv, "k_rope": k_rope}
    else:
        q, k, v = _gqa_qkv(p, x, cfg, positions)
        cache = {"k": k, "v": v}
        k, v = _expand_kv(k, q.shape[2]), _expand_kv(v, q.shape[2])
    if plan.attn_chunk and S > 2 * plan.attn_chunk:
        out = attention_blockwise(q, k, v, causal=True, chunk=plan.attn_chunk)
    else:
        out = attention_core(q, k, v, causal=True)
    return F.linear(out.reshape(B, S, -1), p["wo"]), cache


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
    """One new cache entry (B, 1, ...) (``transformer.py:253-258``)."""
    return _quantize(x, 2)


def _quantize_cache(cache: dict, plan: ParallelPlan) -> dict:
    """A stacked (L, B, S, ...) cache -> int8 with per-token bf16 scales
    (L, B, S, 1, ...) (``transformer.py:535-544``); unchanged for a bf16
    plan."""
    if plan.kv_cache_dtype != "int8":
        return cache
    out = {}
    for name, x in cache.items():
        out[name], out[name + "_scale"] = _quantize(x, 3)
    return out


def _cache_write(cache: dict, name: str, new: torch.Tensor, slot: int, layer: int) -> None:
    """Write one token's entry (B, 1, ...) into ring slot ``slot`` of layer
    ``layer``, quantized if the cache is int8.  The write is in place,
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


def _mla_decode_attention(p, x, cfg: LMConfig, plan: ParallelPlan, cache: dict, pos: int, layer: int):
    """MLA's one-token attention (``transformer.py:316-338``): write the new
    latent and k_rope into slot ``pos % S``, read this layer's through
    bf16, then either expand them to K and V per head (naive) or, with
    ``plan.mla_absorb``, score and mix in the latent space: q_nope·W_uk
    against ckv, plus q_rope against k_rope, and the mixed latent through
    W_uv.  The MLA branch ignores ``kv_scale_fold``, as the reference does.
    Returns (B, 1, H, v)."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, ckv_new, k_rope_new = _mla_qkv(p, x, cfg, positions)
    slot = pos % cache["ckv"].shape[2]
    _cache_write(cache, "ckv", ckv_new, slot, layer)
    _cache_write(cache, "k_rope", k_rope_new, slot, layer)
    ckv, k_rope = _cache_read(cache, "ckv", layer), _cache_read(cache, "k_rope", layer)
    if not plan.mla_absorb:
        k, v = _mla_expand(p, ckv.to(x.dtype), k_rope.to(x.dtype), cfg.n_heads)
        return attention_core(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=False)
    H, r = cfg.n_heads, cfg.kv_lora_rank
    w_uk = p["w_uk"].view(H, cfg.qk_nope_head_dim, r)
    w_uv = p["w_uv"].view(H, cfg.v_head_dim, r)
    q_lat = torch.einsum("bthk,hkr->bthr", q_nope, w_uk)
    s_lat = torch.einsum("bthr,bsr->bths", q_lat, ckv.to(q_lat.dtype))
    s_rope = torch.einsum("bthk,bsk->bths", q_rope, k_rope.to(q_rope.dtype))
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    probs = torch.softmax((s_lat + s_rope).to(F32) * scale, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bths,bsr->bthr", probs, ckv.to(probs.dtype))
    return torch.einsum("bthr,hkr->bthk", o_lat, w_uv)


def _decode_attention(p, x, cfg: LMConfig, plan: ParallelPlan, cache: dict, pos: int, layer: int):
    """One-token attention against the ring cache (slot ``pos % S``): this
    layer's slot is written in place, then its slice is read.

    MLA goes to ``_mla_decode_attention``.  GQA has three branches, as in
    the reference: a bf16 cache; an int8 cache read through a bf16
    dequantized copy; and an int8 cache with ``kv_scale_fold``, which goes
    to ``decode_attention`` (the CUDA kernel on the card) with the scales as
    f32 (B, S).  Returns out @ wo."""
    B = x.shape[0]
    if cfg.use_mla:
        out = _mla_decode_attention(p, x, cfg, plan, cache, pos, layer)
        return F.linear(out.reshape(B, 1, -1), p["wo"])
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


def _ffn(p, x, cfg: LMConfig, groups: int = 1):
    """The layer's FFN on the normed x: (out, aux), aux 0 for a dense MLP."""
    if "moe" in p:
        return moe_lib.apply_moe(p["moe"], x, cfg.moe, cfg.ffn_act, groups=groups)
    return apply_mlp(p["mlp"], x, cfg.ffn_act), torch.zeros((), dtype=F32, device=x.device)


def _layer_fwd(p, x, cfg: LMConfig, plan: ParallelPlan, positions):
    """Returns (x, the layer's aux loss, its cache entries).  Grouped MoE
    dispatch takes ``plan.data_axis`` groups."""
    attn_out, cache = _self_attention(p["attn"], apply_norm(p["ln1"], x, cfg.norm), cfg, plan, positions)
    x = x + attn_out
    groups = plan.data_axis if plan.moe_grouped_dispatch else 1
    ff, aux = _ffn(p, apply_norm(p["ln2"], x, cfg.norm), cfg, groups)
    return x + ff, aux, cache


def lm_hidden(params, tokens, cfg: LMConfig, plan: ParallelPlan, *, final_norm: bool = True):
    """(B, S) -> hidden states (B, S, d), final-normed unless
    ``final_norm=False``, and the MoE aux loss summed over layers (an f32 0
    for a dense model).  Under autograd with ``plan.remat`` each layer runs
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
    a train-mode layer): its activations are recomputed in the backward."""
    check_supported(cfg, plan)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = params.embed[tokens]
    total = torch.zeros((), dtype=F32, device=x.device)
    remat = plan.remat and torch.is_grad_enabled()

    def layer_fwd(layer, x):
        x, aux, _ = _layer_fwd(layer, x, cfg, plan, positions)
        return x, aux

    for layer in params.layers:
        x, aux = checkpoint(layer_fwd, layer, x, use_reentrant=False) if remat else layer_fwd(layer, x)
        total = total + aux
    if final_norm:
        x = apply_norm(params.final_norm, x, cfg.norm)
    return x, total


def lm_forward(params, tokens, cfg: LMConfig, plan: ParallelPlan):
    """(B, S) int -> ((B, S, V) logits in the weights' dtype, aux loss)."""
    x, aux = lm_hidden(params, tokens, cfg, plan)
    return _unembed(params, x), aux


def _xent_chunk(params, x_c, labels_c, cfg: LMConfig):
    """The summed cross-entropy of one sequence chunk: the final norm, the
    unembedding and the logsumexp in f32, all chunk-local."""
    x_c = apply_norm(params.final_norm, x_c, cfg.norm)
    logits = _unembed(params, x_c).to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels_c[..., None].long())[..., 0]
    return (lse - gold).sum()


def lm_loss(params, batch, cfg: LMConfig, plan: ParallelPlan):
    """batch = {tokens (B, S), labels (B, S)}; mean cross-entropy + MoE aux.

    From S = 4096 the unembedding and softmax run in 2,048-token chunks,
    each under ``torch.utils.checkpoint``, so the full (B, S, V) f32 logits
    never exist at once (``transformer.py:475-492``)."""
    x, aux = lm_hidden(params, batch["tokens"], cfg, plan, final_norm=False)
    B, S, _ = x.shape
    n_chunks = max(S // 2048, 1) if S >= 4096 else 1
    cs = S // n_chunks
    total = torch.zeros((), dtype=F32, device=x.device)
    for i in range(n_chunks):
        x_c = x[:, i * cs:(i + 1) * cs]
        l_c = batch["labels"][:, i * cs:(i + 1) * cs]
        total = total + checkpoint(_xent_chunk, params, x_c, l_c, cfg, use_reentrant=False)
    return total / torch.full_like(total, B * S) + aux


def cache_spec(cfg: LMConfig, plan: ParallelPlan, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of a decode KV cache of length ``seq``."""
    check_supported(cfg, plan)
    L = cfg.n_layers
    dt = torch.int8 if plan.kv_cache_dtype == "int8" else torch.bfloat16
    if cfg.use_mla:
        out = {"ckv": ((L, batch, seq, cfg.kv_lora_rank), dt),
               "k_rope": ((L, batch, seq, cfg.qk_rope_head_dim), dt)}
    else:
        _, kh = effective_heads(cfg, plan)
        out = {name: ((L, batch, seq, kh, cfg.d_head), dt) for name in ("k", "v")}
    if plan.kv_cache_dtype == "int8":
        for name, (shape, _) in list(out.items()):
            out[name + "_scale"] = (shape[:3] + (1,) * (len(shape) - 3), torch.bfloat16)
    return out


def lm_prefill(params, tokens, cfg: LMConfig, plan: ParallelPlan):
    """(B, S) -> (last-token logits (B, V), stacked KV cache).

    Each layer's cache entries go into the stacked cache as soon as the
    layer has run, quantized per layer for an int8 plan (the same per-token
    amax as the reference's whole-cache ``_quantize_cache``), so the float
    cache of all layers is never held at once.  A bf16 plan keeps them in
    the model's dtype, as the reference does."""
    check_supported(cfg, plan)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = params.embed[tokens]
    cache: dict = {}
    for i, layer in enumerate(params.layers):
        x, _, entries = _layer_fwd(layer, x, cfg, plan, positions)
        for name, t in _quantize_cache({k: v[None] for k, v in entries.items()}, plan).items():
            if name not in cache:
                cache[name] = torch.empty((cfg.n_layers,) + tuple(t.shape[1:]), dtype=t.dtype,
                                          device=t.device)
            cache[name][i] = t[0]
    x = apply_norm(params.final_norm, x[:, -1:], cfg.norm)
    return _unembed(params, x)[:, 0], cache


def lm_decode(params, cache: dict, token, pos: int, cfg: LMConfig, plan: ParallelPlan):
    """One decode step: token (B,) int, ``pos`` a Python int; the new cache
    entries go to ring slot ``pos % S`` of ``cache``, in place.  MoE layers
    dispatch in one group, as in the reference.  Returns ((B, V) logits,
    the same cache)."""
    check_supported(cfg, plan)
    x = params.embed[token[:, None]]
    for i, layer in enumerate(params.layers):
        h = apply_norm(layer["ln1"], x, cfg.norm)
        x = x + _decode_attention(layer["attn"], h, cfg, plan, cache, pos, i)
        x = x + _ffn(layer, apply_norm(layer["ln2"], x, cfg.norm), cfg)[0]
    x = apply_norm(params.final_norm, x, cfg.norm)
    return _unembed(params, x)[:, 0], cache
