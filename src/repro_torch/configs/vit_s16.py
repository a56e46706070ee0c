"""vit-s16 — ViT-Small/16. [arXiv:2010.11929]

img_res=224 patch=16, 12L d_model=384 6H d_ff=1536.
"""
from repro_torch.configs.base import ArchSpec, ViTConfig, register, vision_shapes

FULL = ViTConfig(
    name="vit-s16",
    img_res=224,
    patch=16,
    n_layers=12,
    d_model=384,
    n_heads=6,
    d_ff=1536,
)

SMOKE = ViTConfig(
    name="vit-smoke",
    img_res=32,
    patch=8,
    n_layers=2,
    d_model=48,
    n_heads=2,
    d_ff=96,
    n_classes=10,
)


@register("vit-s16")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="vit-s16",
        family="vision",
        shapes=vision_shapes(),
        full=FULL,
        smoke=SMOKE,
        source="arXiv:2010.11929",
    )
