"""Plain PyTorch version of the conv epilogue: what ``models/resnet.py``
runs between a convolution and the next conv or pool, eagerly.

t = acc·scale + bias             (float32, the product and the sum each rounded)
no residual:   y = (relu(t) if act else t) in acc's dtype
with residual: y = t in acc's dtype + idn; relu(y) if act
then the consumer's SAME pad (top, bottom, left, right) filled with ``fill``.

The CUDA kernel (``kernel.py``) computes the same bits, border included.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def conv_epilogue_ref(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      idn: torch.Tensor | None = None, *, act: bool,
                      pad: tuple[int, int, int, int] = (0, 0, 0, 0), fill: float = 0.0) -> torch.Tensor:
    """acc (N, C, H, W), scale and bias (C,) f32, idn like acc or None ->
    (N, C, H + top + bottom, W + left + right) in acc's dtype."""
    y = acc.to(F32) * scale[:, None, None] + bias[:, None, None]
    if idn is None:
        y = (F.relu(y) if act else y).to(acc.dtype)
    else:
        y = y.to(acc.dtype) + idn
        y = F.relu(y) if act else y
    top, bottom, left, right = pad
    if top == bottom == left == right == 0:
        return y
    return F.pad(y, (left, right, top, bottom), value=fill)
