"""Plain versions of the cascade's steps around the two models.

* ``qdq``: int8 quantize-dequantize of every weight matrix and kernel
  (names ending ``.w``, two or more dims, at least 64 values): symmetric,
  127 levels, round half to even, the scale taken as the largest
  magnitude along the output-channel axis (dim 0 of an OIHW conv or an
  ``(out, in)`` matrix), floored at 1e-8.
* ``platt_confidence``: the largest softmax probability, calibrated by
  Platt's sigmoid ``1 / (1 + exp(a p + b))``, in float64 (or, for the
  control, bfloat16).
* ``degrade``: bilinear, antialiased, down to ``res`` pixels and back.
* ``gate``: per stream, the frames below the stream's threshold, lowest
  confidence first (ties in slot order), at most the stream's capacity.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def qdq(state: dict, bits: int = 8) -> dict:
    qmax = 2 ** (bits - 1) - 1
    out = {}
    for name, w in state.items():
        if name.endswith(".w") and w.ndim >= 2 and w.numel() >= 64:
            scale = w.float().abs().amax(dim=0, keepdim=True).clamp(min=1e-8) / qmax
            w = (torch.clamp(torch.round(w.float() / scale), -qmax, qmax) * scale).to(w.dtype)
        out[name] = w
    return out


def platt_confidence(logits: torch.Tensor, a: float, b: float, dtype=torch.float64) -> torch.Tensor:
    """In ``dtype`` throughout (float64 for the reference), as float64."""
    p = torch.softmax(logits.to(dtype), dim=-1).amax(dim=-1)
    return (1.0 / (1.0 + torch.exp(a * p + b))).double()


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1)


def degrade(images: torch.Tensor, res: int) -> torch.Tensor:
    H = images.shape[1]
    if res >= H:
        return images
    return _resize(_resize(images, res), H).contiguous()


def gate(conf: np.ndarray, theta: np.ndarray, cap: np.ndarray, valid: np.ndarray):
    """conf, valid (S, b); theta, cap (S,) -> (stream, slot) of the
    escalated frames, stream by stream, lowest confidence first."""
    streams, slots = [], []
    for s in range(conf.shape[0]):
        below = [j for j in range(conf.shape[1]) if valid[s, j] and conf[s, j] < theta[s]]
        below.sort(key=lambda j: (conf[s, j], j))
        take = below[: max(int(cap[s]), 0)]
        streams += [s] * len(take)
        slots += take
    return np.asarray(streams, dtype=np.int64), np.asarray(slots, dtype=np.int64)
