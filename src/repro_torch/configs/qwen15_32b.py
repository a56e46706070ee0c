"""qwen1.5-32b — dense decoder LM with QKV bias (Qwen1.5 family).

[hf:Qwen/Qwen1.5-32B (family config per assignment)]
64L d_model=5120 40H (kv=40, i.e. MHA) d_ff=27392 vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ArchSpec, LMConfig, lm_shapes, register

FULL = LMConfig(
    name="qwen1.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    ffn_act="swiglu",
    norm="rmsnorm",
)

SMOKE = LMConfig(
    name="qwen-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=192,
    vocab_size=256,
    qkv_bias=True,
    ffn_act="swiglu",
)


@register("qwen1.5-32b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen1.5-32b",
        family="lm",
        shapes=lm_shapes(full_attention=True),
        full=FULL,
        smoke=SMOKE,
        source="hf:Qwen/Qwen1.5-0.5B (scaled per assignment)",
    )
