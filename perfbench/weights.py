"""The benchmark's own weights: every leaf of a tier's table drawn from one
generator on the device, in one call, in float32 (the type they are
served in)."""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's ``--seed``."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(1, np.uint64)[0] >> 1)


def draw(leaves: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for a table of ``{name: (shape, std | "one" |
    "zero")}``: one normal draw for all the drawn leaves, cut into views
    and scaled; the constants filled."""
    device = torch.device(device)
    drawn = [(n, shape, std) for n, (shape, std) in leaves.items() if not isinstance(std, str)]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    state, at = {}, 0
    for name, shape, std in drawn:
        n = math.prod(shape)
        state[name] = buf[at:at + n].view(shape).mul_(std)
        at += n
    for name, (shape, std) in leaves.items():
        if isinstance(std, str):
            state[name] = torch.full(shape, 1.0 if std == "one" else 0.0, device=device)
    return {name: state[name] for name in leaves}
