"""Dispatch for the W8A8 int8 matmul, by the device of the inputs
(port of ``repro.kernels.int8_matmul.ops``).

``use_kernel="auto"`` sends a CUDA tensor to the hand-written kernel
(``kernel.int8_matmul``), which launches or raises, and a CPU tensor to
the plain version (``ref.int8_matmul_ref``); ``use_kernel="ref"`` forces
the plain version, as in the reference.  A meta tensor gets an empty
output of the kernel's shape and dtype, for counting a step without
running it.  There is no other fallback.  On ``cuda`` and ``meta`` the
kernel's call reports ``cost.int8_matmul_cost`` to the open cost
counters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cost import counted, int8_matmul_cost
from repro_torch.kernels.int8_matmul import ref
from repro_torch.kernels.int8_matmul.kernel import int8_matmul


def _matmul(xq, xs, wq, ws, out_dtype, use_kernel: str) -> torch.Tensor:
    if use_kernel not in ("auto", "ref"):
        raise ValueError(f"use_kernel must be 'auto' or 'ref', got {use_kernel!r}")
    if use_kernel == "ref" or xq.device.type == "cpu":
        return ref.int8_matmul_ref(xq, xs, wq, ws, out_dtype)
    if not (xq.is_cuda or xq.is_meta):
        raise ValueError(f"int8 matmul runs on cuda, cpu or meta, got {xq.device}")
    (M, K), N = xq.shape, wq.shape[1]
    with counted("int8_matmul", int8_matmul_cost, M, K, N, out_dtype.itemsize):
        if xq.is_meta:
            return xq.new_empty((M, N), dtype=out_dtype)
        return int8_matmul(*(t.contiguous() for t in (xq, xs, wq, ws)), out_dtype=out_dtype)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype=torch.float32,
                     use_kernel: str = "auto") -> torch.Tensor:
    """fp inputs -> per-row / per-column int8 -> int8 GEMM -> dequant."""
    xq, xs = ref.quantize_rows(x)
    wq, ws = ref.quantize_cols(w)
    return _matmul(xq, xs, wq, ws, out_dtype, use_kernel)


def quantized_dense_apply(qtensor, x: torch.Tensor, *, out_dtype=torch.bfloat16,
                          use_kernel: str = "auto") -> torch.Tensor:
    """Apply a pre-quantized (K, N) weight (``quant.QTensor``) to
    activations (..., K): the fast tier's int8 linear layer.

    The weight's scale must be one per output column, (1, N) or (N,), as
    ``quantize_tensor(w, axis=0)`` gives it; any other shape raises (the
    reference reshapes a per-input-row (K, 1) scale into a wrong broadcast).
    """
    w_q = qtensor.values
    K, N = w_q.shape
    if tuple(qtensor.scale.shape) not in ((1, N), (N,)):
        raise ValueError(f"quantized_dense_apply needs a per-output-column scale (1, {N}) or"
                         f" ({N},) for a ({K}, {N}) weight, got {tuple(qtensor.scale.shape)}")
    xq, xs = ref.quantize_rows(x.reshape(-1, x.shape[-1]))
    out = _matmul(xq, xs, w_q, qtensor.scale.reshape(1, N), out_dtype, use_kernel)
    return out.reshape(*x.shape[:-1], N)
