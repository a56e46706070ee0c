"""Fit slow-tier latency curves f(batch) from measured (batch, seconds) pairs
(port of ``repro.slowtier.calibrate``; host numpy, copied).

The source of measurements is ``slowtier/sweep.py::batch_sweep``: it times
the port's kernels (``kernels/flash_attention``, ``kernels/int8_matmul``)
across batch sizes on the card and feeds the (n, seconds) rows here.  Each
fitter returns a ``slowtier.batching`` latency model plus its RMSE on the
sample, so the calibration recipe is: sweep → ``fit_latency_model`` → pass
the winning model into ``ContinuousBatching`` / ``ReplicaPool(batching=...)``.

All fits are least squares on the *batch* latency (not amortized
per-request), matching how ``form_batches`` consumes the model.  Intercepts
are clamped at zero — timer noise can produce a small negative base, which
would make f non-physical (negative latency at n=0).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .batching import FlatService, LatencyModel, LinearBatch, StepBatch

__all__ = ["fit_flat", "fit_linear", "fit_step", "fit_latency_model"]


def _as_samples(batch_sizes, seconds):
    n = np.asarray(batch_sizes, dtype=np.float64)
    y = np.asarray(seconds, dtype=np.float64)
    if n.shape != y.shape or n.ndim != 1 or n.size == 0:
        raise ValueError("batch_sizes and seconds must be equal-length 1-D")
    if np.any(n < 1):
        raise ValueError("batch sizes must be >= 1")
    return n, y


def _rmse(model: LatencyModel, n, y) -> float:
    return float(np.sqrt(np.mean((model.batch_latency(n) - y) ** 2)))


def fit_flat(batch_sizes, seconds) -> Tuple[FlatService, float]:
    """Best constant per-request time: minimizes ||st·n - y||² (through the
    origin — a flat server has no fixed per-pass cost by definition)."""
    n, y = _as_samples(batch_sizes, seconds)
    st = float(np.dot(n, y) / np.dot(n, n))
    model = FlatService(max(st, 0.0))
    return model, _rmse(model, n, y)


def fit_linear(batch_sizes, seconds) -> Tuple[LinearBatch, float]:
    """Affine fit f(n) = base + per_item·n (base clamped at 0)."""
    n, y = _as_samples(batch_sizes, seconds)
    A = np.stack([np.ones_like(n), n], axis=1)
    (base, per_item), *_ = np.linalg.lstsq(A, y, rcond=None)
    model = LinearBatch(max(float(base), 0.0), max(float(per_item), 0.0))
    return model, _rmse(model, n, y)


def fit_step(batch_sizes, seconds, *, page_size: int = 8,
             max_pages=None) -> Tuple[StepBatch, float]:
    """Staircase fit f(n) = base + per_page·ceil(n / page_size)."""
    n, y = _as_samples(batch_sizes, seconds)
    pages = np.ceil(n / page_size)
    A = np.stack([np.ones_like(n), pages], axis=1)
    (base, per_page), *_ = np.linalg.lstsq(A, y, rcond=None)
    model = StepBatch(max(float(base), 0.0), max(float(per_page), 0.0),
                      page_size, max_pages)
    return model, _rmse(model, n, y)


def fit_latency_model(batch_sizes, seconds, kind: str = "linear", *,
                      page_size: int = 8,
                      max_pages=None) -> Tuple[LatencyModel, float]:
    """Dispatch on curve family; ``kind='best'`` returns the lowest-RMSE fit
    among flat/linear/step."""
    if kind == "flat":
        return fit_flat(batch_sizes, seconds)
    if kind == "linear":
        return fit_linear(batch_sizes, seconds)
    if kind == "step":
        return fit_step(batch_sizes, seconds, page_size=page_size,
                        max_pages=max_pages)
    if kind == "best":
        fits = [fit_flat(batch_sizes, seconds),
                fit_linear(batch_sizes, seconds),
                fit_step(batch_sizes, seconds, page_size=page_size,
                         max_pages=max_pages)]
        return min(fits, key=lambda mr: mr[1])
    raise ValueError(f"unknown latency curve kind: {kind!r}")
