"""Dispatch for the fused calibrate+gate op, by the device of the logits.

A CUDA tensor goes to the hand-written kernel (``kernel.calib_gate``),
which launches or raises; a CPU tensor goes to the plain version
(``ref.calib_gate_ref``); a meta tensor gets empty outputs of the
kernel's shapes and dtypes, for counting a step without running it.
There is no other fallback.  On ``cuda`` and ``meta`` the call reports
``cost.calib_gate_cost`` to the open cost counters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cost import calib_gate_cost, counted
from repro_torch.kernels.fused_calib_gate.kernel import calib_gate
from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref


def calibrated_gate(logits: torch.Tensor, a: float, b: float, theta: float):
    """(B,V) logits -> (calibrated confidence (B,), offload gate (B,))."""
    if logits.device.type == "cpu":
        return calib_gate_ref(logits, a, b, theta)
    if not (logits.is_cuda or logits.is_meta):
        raise ValueError(f"calibrated_gate runs on cuda, cpu or meta, got {logits.device}")
    B, V = logits.shape
    with counted("calib_gate", calib_gate_cost, B, V, logits.element_size()):
        if logits.is_meta:
            return logits.new_empty(B, dtype=torch.float32), logits.new_empty(B, dtype=torch.bool)
        return calib_gate(logits, a, b, theta)
