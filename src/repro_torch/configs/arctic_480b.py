"""arctic-480b — dense-MoE hybrid decoder LM (Snowflake Arctic).

[hf:Snowflake/snowflake-arctic-base]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 with a parallel dense residual FFN per layer.
"""
from repro_torch.configs.base import ArchSpec, LMConfig, MoEConfig, lm_shapes, register

FULL = LMConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,
    vocab_size=32000,
    ffn_act="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        n_routed=128,
        top_k=2,
        d_ff_expert=4864,
        n_shared=0,
        dense_residual_ff=4864,
    ),
)

SMOKE = LMConfig(
    name="arctic-smoke",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=96,
    vocab_size=256,
    ffn_act="swiglu",
    moe=MoEConfig(n_routed=8, top_k=2, d_ff_expert=96, n_shared=0, dense_residual_ff=96),
)


@register("arctic-480b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="arctic-480b",
        family="moe-lm",
        shapes=lm_shapes(full_attention=True),
        full=FULL,
        smoke=SMOKE,
        source="hf:Snowflake/snowflake-arctic-base",
    )
