"""The slow tier's f(batch) sweep, timed on the card.

Port of ``benchmarks/bench_kernels.py::batch_sweep`` and of the rescaling
in ``benchmarks/bench_slowtier.py::latency_model``.  One "request" is a
small serving-sized forward slice: a causal attention over 256 tokens
(4 heads of 64, bfloat16) and a 512 x 512 int8 projection of 32 rows;
batch b stacks b requests along the leading axis, as a continuous-batching
replica would.  On ``cuda`` the attention launches the flash-attention
kernel and the projection the int8-matmul kernel, timed with CUDA events;
on the CPU both take their plain versions, timed by the host clock (a CPU
time is not a device time).  The three curve families are fitted to the
per-batch totals and the lowest-RMSE fit is the ``batch_fit``.

``latency_model_from_fit`` turns that fit into the slow tier's latency
curve: the measured *shape* (fixed against marginal cost) is kept and the
scale is set so that f(1) is the simulated server's T^o.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.int8_matmul.ops import quantized_matmul
from repro_torch.slowtier.batching import LatencyModel, StepBatch, model_coeffs, model_from_coeffs
from repro_torch.slowtier.calibrate import fit_latency_model

BATCH_SIZES = (1, 2, 4, 8, 16, 32)
SWEEP_S, SWEEP_H, SWEEP_D = 256, 4, 64
SWEEP_ROWS, SWEEP_K, SWEEP_N = 32, 512, 512


def _time(fn, n: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` over ``n`` calls after one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


@torch.inference_mode()
def batch_sweep(device=None, n_timing: int = 5) -> dict:
    """Time f(batch) on the port's kernels and fit the latency curves.

    Returns the reference's keys: ``batch_sizes``, ``rows`` (``batch``,
    ``attn_us``, ``matmul_us``, ``total_s``), ``fits`` (per family:
    ``kind``, ``coeffs``, ``rmse_us``) and ``batch_fit`` (the best fit).
    Each batch size makes ``1 + n_timing`` calls of each kernel.
    """
    dev = resolve_device(device)
    rows = []
    for b in BATCH_SIZES:
        g = torch.Generator().manual_seed(0)
        q = torch.randn(b, SWEEP_S, SWEEP_H, SWEEP_D, generator=g).to(dev, torch.bfloat16)
        x = torch.randn(b * SWEEP_ROWS, SWEEP_K, generator=g).to(dev)
        w = torch.randn(SWEEP_K, SWEEP_N, generator=g).to(dev)
        t_attn = _time(lambda: attention(q, q, q, causal=True), n_timing, dev)
        t_mm = _time(lambda: quantized_matmul(x, w), n_timing, dev)
        rows.append({"batch": b, "attn_us": round(t_attn * 1e6, 1),
                     "matmul_us": round(t_mm * 1e6, 1), "total_s": t_attn + t_mm})
    ns = np.array([r["batch"] for r in rows], dtype=np.float64)
    ys = np.array([r["total_s"] for r in rows])
    fits = {}
    for kind in ("flat", "linear", "step"):
        model, rmse = fit_latency_model(ns, ys, kind=kind)
        k, coeffs = model_coeffs(model)
        fits[kind] = {"kind": k, "coeffs": [float(c) for c in coeffs],
                      "rmse_us": round(rmse * 1e6, 2)}
    best_kind = min(fits, key=lambda k: fits[k]["rmse_us"])
    return {"batch_sizes": list(BATCH_SIZES), "rows": rows, "fits": fits,
            "batch_fit": fits[best_kind]}


def latency_model_from_fit(fit: dict, server_time: float) -> LatencyModel:
    """Rescale a ``batch_fit`` so that f(1) == ``server_time``.

    Flat and linear fits scale every coefficient, as the reference does.
    A step fit scales its time coefficients (base, per page) and keeps its
    page size; the reference scales the page size too, which turns a
    kernel-time fit into pages of thousands of requests.
    """
    kind, coeffs = fit["kind"], tuple(fit["coeffs"])
    f1 = float(model_from_coeffs(kind, coeffs).batch_latency(1))
    if not f1 > 0:
        raise ValueError(f"the fit gives f(1) = {f1}; cannot scale it to a server time")
    scale = server_time / f1
    if kind == "step":
        return StepBatch(coeffs[0] * scale, coeffs[1] * scale, int(coeffs[2]))
    return model_from_coeffs(kind, tuple(c * scale for c in coeffs))
