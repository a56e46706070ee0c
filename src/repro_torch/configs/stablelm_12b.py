"""stablelm-12b — dense decoder LM (StableLM-2 family).

[hf:stabilityai/stablelm-2-12b (family config per assignment)]
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352; partial rotary
(rope_pct=0.25 per the StableLM-2 family).
"""
from repro_torch.configs.base import ArchSpec, LMConfig, lm_shapes, register

FULL = LMConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=160,
    d_ff=13824,
    vocab_size=100352,
    ffn_act="swiglu",
    norm="layernorm",
    rope_pct=0.25,
)

SMOKE = LMConfig(
    name="stablelm-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=192,
    vocab_size=256,
    ffn_act="swiglu",
    norm="layernorm",
    rope_pct=0.25,
)


@register("stablelm-12b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="stablelm-12b",
        family="lm",
        shapes=lm_shapes(full_attention=True),
        full=FULL,
        smoke=SMOKE,
        source="hf:stabilityai/stablelm-2-1_6b (scaled per assignment)",
    )
