"""Model configurations and the arch registry (port of
``repro.configs.base``): ResNet, ViT, Swin, the diffusion models (DiT and
the UNet) and the language models, the reference's whole zoo.

``LMConfig`` keeps every field of the reference's, the MoE and MLA ones
included, so that configs read the same; ``models/transformer.py`` runs
all of them: dense GQA, MLA and MoE.

Every arch provides ``full`` (the published configuration), ``smoke`` (a
reduced same-family one for CPU tests) and ``shapes``, its family's set
of (shape name -> ``ShapeSpec``) cells.  A shape's kind picks the step
that ``launch/cells.py`` builds:

  train    -> train_step(state, batch)
  prefill  -> prefill_step(params, tokens)          (LM)
  decode   -> decode_step(params, kv_cache, token)  (LM; one new token)
  gen      -> denoise_step(params, x_t, t, cond)    (diffusion; 1 of ``steps``)
  serve    -> serve_step(params, images)            (vision forward)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


# --------------------------------------------------------------------------- #
# Shape specs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell for an architecture."""

    name: str
    kind: str  # train | prefill | decode | gen | serve
    # LM fields
    seq_len: int = 0
    global_batch: int = 0
    # vision / diffusion fields
    img_res: int = 0
    batch: int = 0
    steps: int = 0  # diffusion sampler steps (the loop is the host's; one step is built)
    skip: bool = False
    skip_reason: str = ""


def lm_shapes(*, full_attention: bool) -> dict[str, ShapeSpec]:
    """The LM family's 4 shapes; ``long_500k`` is skipped for a pure
    full-attention arch, with the reference's reason."""
    return {
        "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
        "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
        "long_500k": ShapeSpec(
            "long_500k",
            "decode",
            seq_len=524288,
            global_batch=1,
            skip=full_attention,
            skip_reason=(
                "pure full-attention arch; assignment mandates sub-quadratic "
                "attention for long_500k (see DESIGN.md §Arch-applicability)"
            ),
        ),
    }


def diffusion_shapes() -> dict[str, ShapeSpec]:
    return {
        "train_256": ShapeSpec("train_256", "train", img_res=256, batch=256, steps=1000),
        "gen_1024": ShapeSpec("gen_1024", "gen", img_res=1024, batch=4, steps=50),
        "gen_fast": ShapeSpec("gen_fast", "gen", img_res=512, batch=16, steps=4),
        "train_1024": ShapeSpec("train_1024", "train", img_res=1024, batch=32, steps=1000),
    }


def vision_shapes() -> dict[str, ShapeSpec]:
    return {
        "cls_224": ShapeSpec("cls_224", "train", img_res=224, batch=256),
        "cls_384": ShapeSpec("cls_384", "train", img_res=384, batch=64),
        "serve_b1": ShapeSpec("serve_b1", "serve", img_res=224, batch=1),
        "serve_b128": ShapeSpec("serve_b128", "serve", img_res=224, batch=128),
    }


# --------------------------------------------------------------------------- #
# Model configs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ResNetConfig:
    name: str
    img_res: int
    depths: tuple[int, ...]
    width: int = 64
    n_classes: int = 1000
    family: str = "vision"

    @property
    def param_count(self) -> int:
        total = 3 * 49 * self.width  # stem 7x7
        cin = self.width
        for i, dep in enumerate(self.depths):
            mid = self.width * 2**i
            cout = mid * 4
            for _ in range(dep):
                total += cin * mid + 9 * mid * mid + mid * cout
                if cin != cout:
                    total += cin * cout
                cin = cout
        total += cin * self.n_classes
        return int(total)

    active_param_count = param_count


@dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    distill_token: bool = False  # DeiT
    family: str = "vision"

    @property
    def param_count(self) -> int:
        """The reference's formula: it leaves out the q/k/v and MLP biases."""
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 4 * d
        stem = 3 * self.patch**2 * d
        n_tok = (self.img_res // self.patch) ** 2 + 1 + (1 if self.distill_token else 0)
        pos = n_tok * d
        head = d * self.n_classes * (2 if self.distill_token else 1)
        return per_layer * self.n_layers + stem + pos + head + 2 * d

    active_param_count = param_count


@dataclass(frozen=True)
class DINOv3Config:
    """A DINOv3 ViT (arXiv:2508.10104): a class token and ``n_registers``
    register tokens before the patches, no absolute position embedding but
    an axial 2D RoPE of base ``rope_theta`` on the patch tokens' q and k,
    q and v biases and no k bias, a SwiGLU FFN with biases, LayerScale on
    both residual branches, and a linear head on the class token."""

    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_registers: int = 4
    rope_theta: float = 100.0
    n_classes: int = 1000
    family: str = "vision"

    @property
    def param_count(self) -> int:
        """Every leaf of ``models/dinov3.py::DINOv3``, biases included."""
        d, ff = self.d_model, self.d_ff
        attn = 4 * d * d + 3 * d  # wqkv, wo; bq, bv, bo
        mlp = 3 * d * ff + 2 * ff + d  # wg, wu, wd and their biases
        per_layer = attn + mlp + 4 * d + 2 * d  # two LayerNorms, two LayerScales
        stem = 3 * self.patch**2 * d + d
        tokens = (1 + self.n_registers) * d
        head = d * self.n_classes + self.n_classes
        return per_layer * self.n_layers + stem + tokens + 2 * d + head

    active_param_count = param_count


@dataclass(frozen=True)
class SwinConfig:
    name: str
    img_res: int
    patch: int
    window: int
    depths: tuple[int, ...]
    dims: tuple[int, ...]
    n_classes: int = 1000
    family: str = "vision"

    @property
    def heads(self) -> tuple[int, ...]:
        return tuple(d // 32 for d in self.dims)

    @property
    def param_count(self) -> int:
        total = 3 * self.patch**2 * self.dims[0]
        for i, (dep, dim) in enumerate(zip(self.depths, self.dims)):
            per = 4 * dim * dim + 2 * dim * 4 * dim + 4 * dim + (2 * self.window - 1) ** 2 * self.heads[i]
            total += dep * per
            if i < len(self.dims) - 1:
                total += 4 * dim * self.dims[i + 1]  # patch merging
        total += self.dims[-1] * self.n_classes
        return int(total)

    active_param_count = param_count


@dataclass(frozen=True)
class DiTConfig:
    name: str
    img_res: int  # nominal training resolution
    patch: int  # patch size on the latent grid
    n_layers: int
    d_model: int
    n_heads: int
    in_channels: int = 4
    latent_factor: int = 8  # img -> latent downsampling (SD VAE)
    n_classes: int = 1000
    learn_sigma: bool = True
    family: str = "diffusion"

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    @property
    def param_count(self) -> int:
        """The reference's formula; ``build(cfg).n_params()`` counts the tree."""
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 6 * d * d + 2 * d  # attn + mlp + adaLN mod
        x_emb = self.in_channels * self.patch**2 * d
        t_emb = 256 * d + d * d
        y_emb = (self.n_classes + 1) * d
        out_ch = self.in_channels * (2 if self.learn_sigma else 1)
        final = d * self.patch**2 * out_ch + 2 * d * d
        return per_layer * self.n_layers + x_emb + t_emb + y_emb + final

    active_param_count = param_count


@dataclass(frozen=True)
class UNetConfig:
    name: str
    img_res: int
    latent_res: int
    in_channels: int = 4
    ch: int = 320
    ch_mult: tuple[int, ...] = (1, 2, 4)
    n_res_blocks: int = 2
    transformer_depth: tuple[int, ...] = (1, 2, 10)
    ctx_dim: int = 2048
    head_dim: int = 64
    latent_factor: int = 8
    family: str = "diffusion"

    @property
    def param_count(self) -> int:
        """The analytic estimate; ``build(cfg).n_params()`` counts the tree."""
        return unet_param_estimate(self)

    active_param_count = param_count


def unet_param_estimate(c: UNetConfig) -> int:
    """Analytic estimate (resblocks + transformer blocks + in/out): a copy
    of ``repro.configs.base.unet_param_estimate``."""

    def res_block(cin, cout):
        return 9 * cin * cout + 9 * cout * cout + (cin * cout if cin != cout else 0) + 4 * c.ch * cout

    def tf_block(ch):
        # self-attn + cross-attn + geglu ff (4x)
        return 4 * ch * ch + 2 * ch * c.ctx_dim + 2 * ch * ch + 8 * ch * ch + 4 * ch * ch

    total = 9 * c.in_channels * c.ch + 9 * c.ch * c.in_channels  # conv in/out
    total += c.ch * 4 * c.ch + 4 * c.ch * 4 * c.ch  # time embed MLP
    chans = [c.ch * m for m in c.ch_mult]
    prev = c.ch
    for i, ch in enumerate(chans):
        for _ in range(c.n_res_blocks):
            total += res_block(prev, ch)
            total += c.transformer_depth[i] * tf_block(ch)
            prev = ch
        if i < len(chans) - 1:
            total += 9 * ch * ch  # downsample conv
    # mid
    total += 2 * res_block(prev, prev) + c.transformer_depth[-1] * tf_block(prev)
    # up path (mirror, with skip concat)
    for i, ch in reversed(list(enumerate(chans))):
        for _ in range(c.n_res_blocks + 1):
            total += res_block(prev + ch, ch)
            total += c.transformer_depth[i] * tf_block(ch)
            prev = ch
        if i > 0:
            total += 9 * ch * ch
    return int(total)


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    dense_residual_ff: int = 0  # arctic-style parallel dense FFN (0 = off)
    first_k_dense: int = 0  # first K layers use a dense FFN instead
    first_dense_ff: int = 0
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    ffn_act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # fraction of head dim rotated (stablelm: 0.25)
    tie_embeddings: bool = False
    # MLA (DeepSeek-V2): when set, n_kv_heads is ignored
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0  # 0 = direct q projection
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    moe: Optional[MoEConfig] = None
    family: str = "lm"

    @property
    def param_count(self) -> int:
        """The reference's formula (embedding + layers); it counts one
        vector per norm, so a LayerNorm's bias is left out."""
        return sum(int(x) for x in _lm_param_breakdown(self).values())

    @property
    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k + shared experts only)."""
        br = _lm_param_breakdown(self)
        total = sum(int(v) for v in br.values())
        if self.moe is None:
            return total
        routed_all = br["moe_routed"]
        return total - routed_all + routed_all * self.moe.top_k // max(self.moe.n_routed, 1)


def _lm_param_breakdown(c: LMConfig) -> dict[str, int]:
    """Copy of ``repro.configs.base._lm_param_breakdown``."""
    d = c.d_model
    emb = c.vocab_size * d * (1 if c.tie_embeddings else 2)
    if c.use_mla:
        qk_head = c.qk_nope_head_dim + c.qk_rope_head_dim
        q = (d * c.q_lora_rank + c.q_lora_rank * c.n_heads * qk_head) if c.q_lora_rank else d * c.n_heads * qk_head
        kv = d * (c.kv_lora_rank + c.qk_rope_head_dim) + c.kv_lora_rank * c.n_heads * (
            c.qk_nope_head_dim + c.v_head_dim
        )
        o = c.n_heads * c.v_head_dim * d
        attn = q + kv + o
    else:
        attn = d * c.n_heads * c.d_head + 2 * d * c.n_kv_heads * c.d_head + c.n_heads * c.d_head * d
        if c.qkv_bias:
            attn += (c.n_heads + 2 * c.n_kv_heads) * c.d_head
    ff_mult = 3 if c.ffn_act == "swiglu" else 2
    out: dict[str, int] = {"embedding": emb, "attention": attn * c.n_layers, "moe_routed": 0, "ffn_dense": 0}
    if c.moe is None:
        out["ffn_dense"] = ff_mult * d * c.d_ff * c.n_layers
    else:
        m = c.moe
        n_moe_layers = c.n_layers - m.first_k_dense
        out["moe_routed"] = ff_mult * d * m.d_ff_expert * m.n_routed * n_moe_layers
        shared = ff_mult * d * m.d_ff_expert * m.n_shared * n_moe_layers
        router = d * m.n_routed * n_moe_layers
        dense_res = ff_mult * d * m.dense_residual_ff * n_moe_layers if m.dense_residual_ff else 0
        first = ff_mult * d * (m.first_dense_ff or c.d_ff) * m.first_k_dense
        out["ffn_dense"] = shared + router + dense_res + first
    out["norms"] = (2 * c.n_layers + 1) * d
    return out


# --------------------------------------------------------------------------- #
# Arch spec + registry
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | moe-lm | diffusion | vision
    full: object
    smoke: object
    shapes: dict[str, ShapeSpec]
    source: str  # public citation
    notes: str = ""


_REGISTRY: dict[str, Callable[[], ArchSpec]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # import every config module so that its @register runs
    from repro_torch.configs import (  # noqa: F401
        arctic_480b,
        deepseek_v2_lite_16b,
        deit_b,
        dit_b2,
        qwen15_32b,
        resnet_50,
        stablelm_12b,
        swin_b,
        unet_sdxl,
        vit_s16,
    )
