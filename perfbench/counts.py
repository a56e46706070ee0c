"""Operations and bytes the benchmark counts itself, and the chip's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
494.7 TFLOP/s in TF32 on the tensor cores, the fastest arithmetic that a
float32 configuration may use in any product, and 3.35 TB/s of HBM3.

``frame_flops`` counts one frame of a tier's plain reference forward with
``torch.utils.flop_counter`` on the meta device: products and
convolutions, two operations a multiply-add.  ``attention_bound_s`` is the
least time one attention call needs: the larger of its 4·B·H·Sq·Sk·D
operations at the TF32 peak and q, k, v read once and o written once at
the HBM peak.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_TF32_FLOPS = 494.7e12
PEAK_HBM_BYTES = 3.35e12


def frame_flops(tier, cfg: dict) -> int:
    """Operations of one frame through ``tier``'s reference forward."""
    state = {n: torch.empty(shape, device="meta") for n, (shape, _) in tier.leaves(cfg).items()}
    images = torch.empty((1, cfg["img_res"], cfg["img_res"], 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        tier.reference(cfg)(state, images)
    return int(counter.get_total_flops())


def attention_flops(B: int, Sq: int, Sk: int, H: int, D: int) -> int:
    return 4 * B * H * Sq * Sk * D


def attention_bytes(B: int, Sq: int, Sk: int, H: int, D: int, elem_bytes: int) -> int:
    return (2 * B * Sq * H * D + 2 * B * Sk * H * D) * elem_bytes


def attention_bound_s(B: int, Sq: int, Sk: int, H: int, D: int, elem_bytes: int = 4) -> float:
    return max(attention_flops(B, Sq, Sk, H, D) / PEAK_TF32_FLOPS,
               attention_bytes(B, Sq, Sk, H, D, elem_bytes) / PEAK_HBM_BYTES)
