"""The CBO data plane: two-tier cascade execution (port of ``repro.core.cascade``).

Per batch of inputs:
  1. fast tier (quantized "NPU" model) classifies everything;
  2. confidence = calibrated max-softmax;
  3. the K lowest-confidence inputs *below threshold* are gathered (K
     chosen by the CBO planner) and re-run on the slow tier at the planned
     resolution;
  4. slow predictions are scattered back over the fast ones.

Shapes stay static as in the reference: K frames always go through the
slow tier and a validity mask drops those that were not gated.  The
gather order must match ``jax.lax.top_k``, which breaks ties toward the
lower index (every non-gated frame scores ``-inf``, so ties are routine):
a stable descending sort gives exactly that; ``torch.topk`` promises no
order.  Reduced resolution r is realised as downsample(r) -> upsample
(native) with antialiasing, as ``jax.image.resize(..., "bilinear")`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.confidence import max_softmax
from repro_torch.kernels.fused_calib_gate.ops import calibrated_gate

F32 = torch.float32


@dataclass(frozen=True)
class CascadeOut:
    preds: torch.Tensor  # (B,) final predictions
    fast_preds: torch.Tensor  # (B,) fast-tier predictions
    conf: torch.Tensor  # (B,) calibrated confidence
    escalated: torch.Tensor  # (B,) bool — actually re-run on slow tier
    esc_idx: torch.Tensor  # (K,) gathered indices (padded)


def _resize(images, size: int):
    """Bilinear NHWC resize with antialiasing (``jax.image.resize`` semantics)."""
    x = images.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def degrade_resolution(images, res: int):
    """Simulate offloading at resolution ``res``: down- then up-sample."""
    H = images.shape[1]
    if res >= H:
        return images
    return _resize(_resize(images, res), H).to(images.dtype).contiguous()


def fast_pass(fast_forward, calibrate, images, *, use_fused: bool = False, platt_ab=None):
    """Fast-tier half of the cascade: predictions + calibrated confidence.

    ``use_fused=True`` takes the fused softmax-max -> Platt -> gate op
    (``kernels/fused_calib_gate``; the CUDA kernel for CUDA logits) with
    ``platt_ab=(a, b)``, bypassing ``calibrate``.
    """
    logits = fast_forward(images)
    if use_fused:
        if platt_ab is None:
            raise ValueError("use_fused=True requires platt_ab=(a, b) Platt coefficients")
        a, b = platt_ab
        # theta=0: the gate output is unused here — thresholds come from the
        # planner after confidences are known
        conf, _ = calibrated_gate(logits.to(F32).contiguous(), float(a), float(b), 0.0)
        return logits.argmax(dim=-1), conf
    return logits.argmax(dim=-1), calibrate(max_softmax(logits)).to(F32)


def cascade_classify(fast_forward: Callable, slow_forward: Callable, calibrate: Callable,
                     images, *, threshold: float, capacity: int, resolution: int,
                     use_fused: bool = False, platt_ab=None) -> CascadeOut:
    """Run the two-tier cascade on one batch of images (NHWC)."""
    B = images.shape[0]
    K = min(capacity, B)
    fast_preds, conf = fast_pass(fast_forward, calibrate, images,
                                 use_fused=use_fused, platt_ab=platt_ab)
    gate = conf < threshold
    score = torch.where(gate, -conf, torch.full_like(conf, -torch.inf))  # lowest first
    esc_idx = torch.sort(score, descending=True, stable=True).indices[:K]
    valid = gate[esc_idx]

    esc_imgs = degrade_resolution(images[esc_idx], resolution)
    slow_preds = slow_forward(esc_imgs).argmax(dim=-1)

    merged = fast_preds.clone()
    merged[esc_idx] = torch.where(valid, slow_preds, fast_preds[esc_idx])
    escalated = torch.zeros(B, dtype=torch.bool, device=images.device)
    escalated[esc_idx] = valid
    return CascadeOut(merged, fast_preds, conf, escalated, esc_idx)


def slow_pass_multires(slow_forward, images, resolutions):
    """Slow-tier half for a gathered escalation batch: each frame degraded
    at its own planned resolution, then ONE slow-tier call for the batch.
    Each distinct resolution copies its row indices from host memory."""
    res = np.asarray(resolutions)
    if len(res) != images.shape[0]:
        raise ValueError("one resolution per gathered image")
    degraded = images.clone()
    for r in np.unique(res):
        sel = torch.as_tensor(np.flatnonzero(res == r), device=images.device)
        degraded[sel] = degrade_resolution(images[sel], int(r))
    return slow_forward(degraded).argmax(dim=-1)
