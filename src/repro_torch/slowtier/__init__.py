"""Continuous-batching slow tier (port of ``repro.slowtier``).

Models each slow-tier replica as a continuous-batching inference server:
batch-size-dependent latency curves, admission windows, paged-memory
occupancy caps, and least-squares calibration of the curve from the
kernel sweep (``sweep.batch_sweep``, on the card).
``repro_torch.net.replicas.ReplicaPool`` delegates its service model here
when constructed with ``batching=``.
"""
from .batching import (BatchingReplica, ContinuousBatching, FlatService,
                       LatencyModel, LinearBatch, StepBatch, form_batches,
                       form_batches_looped, model_coeffs, model_from_coeffs)
from .calibrate import fit_flat, fit_latency_model, fit_linear, fit_step

__all__ = [
    "LatencyModel", "FlatService", "LinearBatch", "StepBatch",
    "ContinuousBatching", "BatchingReplica",
    "form_batches", "form_batches_looped",
    "model_coeffs", "model_from_coeffs",
    "fit_flat", "fit_linear", "fit_step", "fit_latency_model",
]
