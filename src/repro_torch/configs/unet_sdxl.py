"""unet-sdxl — SDXL UNet backbone. [arXiv:2307.01952]

img_res=1024 (latent 128), ch=320, ch_mult=1-2-4, 2 res blocks/stage,
transformer_depth=1-2-10, cross-attn ctx_dim=2048.
"""
from repro_torch.configs.base import ArchSpec, UNetConfig, diffusion_shapes, register

FULL = UNetConfig(
    name="unet-sdxl",
    img_res=1024,
    latent_res=128,
    ch=320,
    ch_mult=(1, 2, 4),
    n_res_blocks=2,
    transformer_depth=(1, 2, 10),
    ctx_dim=2048,
)

SMOKE = UNetConfig(
    name="unet-smoke",
    img_res=64,
    latent_res=8,
    ch=32,
    ch_mult=(1, 2),
    n_res_blocks=1,
    transformer_depth=(1, 1),
    ctx_dim=64,
    head_dim=16,
)


@register("unet-sdxl")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="unet-sdxl",
        family="diffusion",
        shapes=diffusion_shapes(),
        full=FULL,
        smoke=SMOKE,
        source="arXiv:2307.01952",
    )
