"""Reference parameter trees for the port's parity tests.

``draw_tree`` draws every leaf of a reference ``TensorSpec`` tree with
numpy from a seed, float32: fan-in leaves as ``ptree.tree_init`` scales
them, and the leaves the reference sets to a constant drawn too (zeros at
std ``zero_std``, ones as 1 + 0.1·N), so that a zero-initialised block
(adaLN-Zero, the UNet's ``proj_out``) cannot hide the path behind it.
``stand_in_tree`` is the same tree of zero-stride arrays, which hold no
memory, for converting a FULL tree's names and shapes on the meta device.
"""
import math

import jax
import numpy as np
import torch

from repro.models.ptree import TensorSpec
from repro_torch.models import convert


def _is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def draw_tree(spec, seed: int, zero_std: float = 0.02):
    rng = np.random.default_rng(seed)

    def one(leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.init == "zeros":
            return z * np.float32(zero_std)
        if leaf.init == "ones":
            return 1 + np.float32(0.1) * z
        fan = leaf.fan_in or (int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else leaf.shape[0])
        return z * np.float32(leaf.init_scale / math.sqrt(max(fan, 1)))

    return jax.tree.map(one, spec, is_leaf=_is_spec)


def stand_in_tree(spec):
    return jax.tree.map(lambda leaf: np.broadcast_to(np.zeros((), np.float32), leaf.shape), spec,
                        is_leaf=_is_spec)


def meta_state_dict(spec, monkeypatch) -> dict:
    """``params_from_jax`` of ``spec``'s tree with every leaf a meta tensor:
    the names and the converted shapes, nothing allocated."""
    monkeypatch.setattr(convert, "_to_tensor", lambda a: torch.empty(np.shape(a), device="meta"))
    return convert.params_from_jax(stand_in_tree(spec))
