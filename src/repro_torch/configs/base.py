"""Model configurations (port of ``repro.configs.base``; ResNet only so far)."""
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
