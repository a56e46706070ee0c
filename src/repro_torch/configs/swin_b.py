"""swin-b — Swin Transformer Base. [arXiv:2103.14030]

img_res=224 patch=4 window=7, depths 2-2-18-2, dims 128-256-512-1024.
The model is ``models/swin.py``; the split planner's catalog reads this
configuration too.
"""
from repro_torch.configs.base import ArchSpec, SwinConfig, register, vision_shapes

FULL = SwinConfig(
    name="swin-b",
    img_res=224,
    patch=4,
    window=7,
    depths=(2, 2, 18, 2),
    dims=(128, 256, 512, 1024),
)

SMOKE = SwinConfig(
    name="swin-smoke",
    img_res=32,
    patch=2,
    window=4,
    depths=(1, 1),
    dims=(32, 64),
    n_classes=10,
)


@register("swin-b")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="swin-b",
        family="vision",
        shapes=vision_shapes(),
        full=FULL,
        smoke=SMOKE,
        source="arXiv:2103.14030",
    )
