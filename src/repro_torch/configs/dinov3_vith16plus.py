"""dinov3-vith16plus — DINOv3 ViT-H+/16, distilled. [arXiv:2508.10104]

img_res=224 patch=16, 32L d_model=1280 20H (head dim 64) d_ff=5120 SwiGLU,
1 class + 4 register tokens, 2D RoPE theta=100 on the 196 patch tokens,
LayerScale, LayerNorm eps 1e-5 (``facebook/dinov3-vith16plus-pretrain-lvd1689m``
on the Hugging Face hub).  No ImageNet head is published for H+: the head
here is a linear layer on the class token (the hub model's
``pooler_output``) to 1,000 classes.

Not in the arch registry: the registry mirrors the JAX package's zoo,
which has no DINOv3.  The benchmark's ``cbo-r50-dinov3h`` slow tier runs
``FULL``.
"""
from repro_torch.configs.base import DINOv3Config

FULL = DINOv3Config(
    name="dinov3-vith16plus",
    img_res=224,
    patch=16,
    n_layers=32,
    d_model=1280,
    n_heads=20,
    d_ff=5120,
    n_registers=4,
    rope_theta=100.0,
)

SMOKE = DINOv3Config(
    name="dinov3-smoke",
    img_res=32,
    patch=8,
    n_layers=2,
    d_model=64,
    n_heads=4,
    d_ff=128,
    n_registers=2,
    n_classes=10,
)
