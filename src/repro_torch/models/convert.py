"""Parameters of the JAX reference -> a state dict for the port's models.

``params_from_jax`` takes the reference's nested parameter dict with
numpy leaves (``jax.tree.map(np.asarray, params)``; no JAX needed here)
and returns a flat ``{dotted.name: tensor}`` state dict that keeps the
JAX leaf names.  Layouts change where PyTorch's differ: conv kernels
HWIO -> OIHW, dense ``w`` (in, out) -> ``(out, in)`` as ``F.linear`` takes
it.  Values are copied exactly; bfloat16 leaves stay bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16 has no torch counterpart in from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_jax(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(params_from_jax(val, prefix=f"{name}."))
            continue
        t = _to_tensor(val)
        if key == "w" and t.ndim == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        elif key == "w" and t.ndim == 2:
            t = t.t()  # (in, out) -> (out, in)
        out[name] = t.contiguous()
    return out
