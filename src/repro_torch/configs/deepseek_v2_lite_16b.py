"""deepseek-v2-lite-16b — MLA + fine-grained MoE decoder LM.

[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]
27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, MLA kv_lora=512
(qk_nope=128, qk_rope=64, v_head=128), MoE: 2 shared + 64 routed, top-6,
first layer dense (d_ff=10944) per the HF config.
"""
from repro_torch.configs.base import ArchSpec, LMConfig, MoEConfig, lm_shapes, register

FULL = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,  # dense first layer width
    vocab_size=102400,
    ffn_act="swiglu",
    norm="rmsnorm",
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,  # lite variant projects q directly
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=MoEConfig(
        n_routed=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        first_k_dense=1,
        first_dense_ff=10944,
    ),
)

SMOKE = LMConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    ffn_act="swiglu",
    use_mla=True,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    moe=MoEConfig(n_routed=8, top_k=2, d_ff_expert=32, n_shared=1, first_k_dense=1, first_dense_ff=128),
)


@register("deepseek-v2-lite-16b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="deepseek-v2-lite-16b",
        family="moe-lm",
        shapes=lm_shapes(full_attention=True),
        full=FULL,
        smoke=SMOKE,
        source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite",
    )
