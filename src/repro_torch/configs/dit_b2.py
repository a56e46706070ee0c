"""dit-b2 — Diffusion Transformer DiT-B/2. [arXiv:2212.09748]

img_res=256 (latent 32 via f=8 VAE), patch=2, 12L d_model=768 12H,
adaLN-Zero conditioning, class-conditional (1000), learn_sigma.
"""
from repro_torch.configs.base import ArchSpec, DiTConfig, diffusion_shapes, register

FULL = DiTConfig(
    name="dit-b2",
    img_res=256,
    patch=2,
    n_layers=12,
    d_model=768,
    n_heads=12,
)

SMOKE = DiTConfig(
    name="dit-smoke",
    img_res=32,
    patch=2,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_classes=10,
)


@register("dit-b2")
def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dit-b2",
        family="diffusion",
        shapes=diffusion_shapes(),
        full=FULL,
        smoke=SMOKE,
        source="arXiv:2212.09748",
    )
