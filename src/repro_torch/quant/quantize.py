"""Post-training quantization over state dicts (port of ``repro.quant.quantize``).

  * ``qdq_tree``      — quantize->dequantize round trip: the fast tier's
                        "NPU" precision error on plain float tensors;
  * ``quantize_tree`` — int8 values + scales (``QTensor``) per weight;
  * ``fp16_tree``     — the paper's FP16-NPU cast round trip.

``axis`` is the axis the absolute maximum is taken over, as in the
reference.  The reference's default ``axis=-1`` is the output-channel axis
of its layouts (HWIO conv, ``(in, out)`` dense); in the port's OIHW and
``(out, in)`` layouts that axis is 0, so ``axis=0`` here gives the
reference's scales, value for value.  ``torch.round`` rounds half to
even as ``jnp.round`` does, so the int8 values match bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

F32 = torch.float32


@dataclass(frozen=True)
class QTensor:
    values: torch.Tensor  # int8
    scale: torch.Tensor  # f32, broadcastable to values

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.values.to(F32) * self.scale).to(dtype)


def quantize_tensor(w: torch.Tensor, *, axis=0, bits: int = 8) -> QTensor:
    """Symmetric quantization: max over ``axis``, or per-tensor
    (``axis=None`` — the crude NPU-compiler regime; much larger error)."""
    qmax = 2 ** (bits - 1) - 1
    wf = w.to(F32)
    if axis is None:
        amax = wf.abs().amax().reshape([1] * w.ndim)
    else:
        amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    return QTensor(q, scale)


def _is_weight(name: str, x: torch.Tensor) -> bool:
    """Quantize matmul/conv weights; keep norms, biases, tables in fp."""
    if x.ndim < 2:
        return False
    leaf = name.rsplit(".", 1)[-1]
    if any(s in leaf for s in ("scale", "bias", "norm", "pos_embed", "cls", "rel_bias")):
        return False
    return x.numel() >= 64


def qdq_tree(state: dict, *, bits: int = 8, axis=0) -> dict:
    """Quantization-error injection (QDQ). Same names/dtypes."""
    return {k: quantize_tensor(v, axis=axis, bits=bits).dequantize(v.dtype)
            if _is_weight(k, v) else v for k, v in state.items()}


def quantize_tree(state: dict, *, bits: int = 8, axis=0) -> dict:
    """True int8 state: weights become ``QTensor``s, the rest pass through."""
    return {k: quantize_tensor(v, axis=axis, bits=bits) if _is_weight(k, v) else v
            for k, v in state.items()}


def dequantize_tree(qstate: dict, dtype=torch.bfloat16) -> dict:
    return {k: v.dequantize(dtype) if isinstance(v, QTensor) else v for k, v in qstate.items()}


def fp16_tree(state: dict) -> dict:
    """The paper's NPU numerics: FP16 weights (cast round trip)."""
    return {k: v.to(torch.float16).to(v.dtype) for k, v in state.items()}
