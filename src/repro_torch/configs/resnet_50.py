"""resnet-50 — ResNet-50 (bottleneck). [arXiv:1512.03385]

img_res=224, depths 3-4-6-3, width=64, bottleneck blocks.
"""
from repro_torch.configs.base import ArchSpec, ResNetConfig, register, vision_shapes

FULL = ResNetConfig(
    name="resnet-50",
    img_res=224,
    depths=(3, 4, 6, 3),
    width=64,
)

SMOKE = ResNetConfig(
    name="resnet-smoke",
    img_res=32,
    depths=(1, 1),
    width=16,
    n_classes=10,
)


@register("resnet-50")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="resnet-50",
        family="vision",
        shapes=vision_shapes(),
        full=FULL,
        smoke=SMOKE,
        source="arXiv:1512.03385",
    )
