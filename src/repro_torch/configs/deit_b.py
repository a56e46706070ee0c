"""deit-b — DeiT-Base with distillation token. [arXiv:2012.12877]

img_res=224 patch=16, 12L d_model=768 12H d_ff=3072, +1 distill token.
"""
from repro_torch.configs.base import ArchSpec, ViTConfig, register, vision_shapes

FULL = ViTConfig(
    name="deit-b",
    img_res=224,
    patch=16,
    n_layers=12,
    d_model=768,
    n_heads=12,
    d_ff=3072,
    distill_token=True,
)

SMOKE = ViTConfig(
    name="deit-smoke",
    img_res=32,
    patch=8,
    n_layers=2,
    d_model=64,
    n_heads=4,
    d_ff=128,
    n_classes=10,
    distill_token=True,
)


@register("deit-b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="deit-b",
        family="vision",
        shapes=vision_shapes(),
        full=FULL,
        smoke=SMOKE,
        source="arXiv:2012.12877",
    )
