"""Dispatch for the fused calibrate+gate op, by the device of the logits.

A CUDA tensor goes to the hand-written kernel (``kernel.calib_gate``),
which launches or raises; a CPU tensor goes to the plain version
(``ref.calib_gate_ref``).  There is no other fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_calib_gate.kernel import calib_gate
from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref


def calibrated_gate(logits: torch.Tensor, a: float, b: float, theta: float):
    """(B,V) logits -> (calibrated confidence (B,), offload gate (B,))."""
    if logits.is_cuda:
        return calib_gate(logits, a, b, theta)
    if logits.device.type != "cpu":
        raise ValueError(f"calibrated_gate runs on cuda or cpu, got {logits.device}")
    return calib_gate_ref(logits, a, b, theta)
