"""Model configurations (port of ``repro.configs.base``: ResNet and ViT so far)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ResNetConfig:
    name: str
    img_res: int
    depths: tuple[int, ...]
    width: int = 64
    n_classes: int = 1000
    family: str = "vision"

    @property
    def param_count(self) -> int:
        total = 3 * 49 * self.width  # stem 7x7
        cin = self.width
        for i, dep in enumerate(self.depths):
            mid = self.width * 2**i
            cout = mid * 4
            for _ in range(dep):
                total += cin * mid + 9 * mid * mid + mid * cout
                if cin != cout:
                    total += cin * cout
                cin = cout
        total += cin * self.n_classes
        return int(total)


@dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    distill_token: bool = False  # DeiT
    family: str = "vision"

    @property
    def param_count(self) -> int:
        """The reference's formula: it leaves out the q/k/v and MLP biases."""
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 4 * d
        stem = 3 * self.patch**2 * d
        n_tok = (self.img_res // self.patch) ** 2 + 1 + (1 if self.distill_token else 0)
        pos = n_tok * d
        head = d * self.n_classes * (2 if self.distill_token else 1)
        return per_layer * self.n_layers + stem + pos + head + 2 * d
