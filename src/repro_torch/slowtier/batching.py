"""Continuous-batching slow tier: latency curves, admission windows, batch
formation (port of ``repro.slowtier.batching``; host numpy, copied).

The paper's edge server charges a flat ``server_time`` per offloaded frame.
Real inference servers (TGI-style continuous batching with paged KV memory)
serve *batches*: requests that land close together share one forward pass and
amortize to far cheaper than the same count serialized.  This module models
one replica of such a server:

* a **latency curve** ``f(n)`` — wall-clock to serve one batch of ``n``
  requests (``FlatService`` is the paper's constant, ``LinearBatch`` a fitted
  affine curve, ``StepBatch`` a paged-memory staircase with an occupancy cap);
* an **admission window** — a batch opens when the replica frees up (or the
  first request arrives, whichever is later) and admits every request that
  lands within ``window_s`` of that opening, up to the occupancy cap;
  over-cap requests *spill* to the next batch;
* **batch formation** — ``form_batches`` runs the whole per-replica Lindley
  recursion over a sorted arrival vector in one pass per batch (numpy);
  ``form_batches_looped`` is the one-request-at-a-time reference oracle the
  fuzz tests pin it against.

``ReplicaPool`` (``repro_torch.net.replicas``) delegates here when constructed with
``batching=``; the **degenerate** configuration (``FlatService``, zero window,
cap 1) is routed back through the pool's legacy serial recursion so it stays
bit-for-bit identical to the pre-batching slow tier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "LatencyModel", "FlatService", "LinearBatch", "StepBatch",
    "ContinuousBatching", "BatchingReplica",
    "form_batches", "form_batches_looped",
    "model_coeffs", "model_from_coeffs",
]


# --------------------------------------------------------------------------- #
# latency curves f(n)
# --------------------------------------------------------------------------- #


class LatencyModel:
    """f(batch): wall-clock seconds to serve one batch of ``n`` requests."""

    capacity = None  # max requests per batch imposed by the model (None = ∞)

    def batch_latency(self, n):
        raise NotImplementedError

    def per_request(self, n):
        """Amortized per-request cost at (possibly fractional) occupancy
        ``n`` — the planner's calibrated ``server_time`` estimate."""
        n = np.maximum(np.asarray(n, dtype=np.float64), 1.0)
        return self.batch_latency(n) / n


@dataclass(frozen=True)
class FlatService(LatencyModel):
    """The paper's constant server: a batch of n costs n back-to-back passes.

    Batching never amortizes anything here — ``per_request`` is flat — which
    makes this the degenerate curve the legacy ``ReplicaPool`` semantics
    correspond to.
    """

    server_time: float

    def batch_latency(self, n):
        return np.asarray(n, dtype=np.float64) * self.server_time


@dataclass(frozen=True)
class LinearBatch(LatencyModel):
    """Affine curve f(n) = base + per_item·n.

    ``base`` is the fixed per-pass cost (kernel launch, weight streaming,
    attention over the shared prefix); ``per_item`` the marginal cost of one
    more batch row.  ``base > 0`` is what makes batching pay.
    """

    base: float
    per_item: float

    def batch_latency(self, n):
        return self.base + self.per_item * np.asarray(n, dtype=np.float64)


@dataclass(frozen=True)
class StepBatch(LatencyModel):
    """Paged-memory staircase: f(n) = base + per_page·ceil(n / page_size).

    Models a server whose marginal cost is per memory *page*, not per
    request (paged attention): latency steps up each time a batch spills
    into a new page.  ``max_pages`` bounds occupancy — a batch can hold at
    most ``max_pages * page_size`` requests; the rest spill to the next
    batch.
    """

    base: float
    per_page: float
    page_size: int = 8
    max_pages: Optional[int] = None

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.max_pages is not None and self.max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {self.max_pages}")

    @property
    def capacity(self):
        if self.max_pages is None:
            return None
        return self.max_pages * self.page_size

    def batch_latency(self, n):
        pages = np.ceil(np.asarray(n, dtype=np.float64) / self.page_size)
        return self.base + self.per_page * pages


def model_coeffs(model: LatencyModel) -> Tuple[str, Tuple[float, ...]]:
    """Flatten a latency model to ``(kind, coeffs)`` for backends that can't
    carry Python objects (the jitted jax engine keeps these in its static
    spec and re-evaluates f with ``jnp``)."""
    if isinstance(model, FlatService):
        return "flat", (float(model.server_time),)
    if isinstance(model, LinearBatch):
        return "linear", (float(model.base), float(model.per_item))
    if isinstance(model, StepBatch):
        return "step", (float(model.base), float(model.per_page),
                        float(model.page_size))
    raise ValueError(f"unknown latency model: {model!r}")


def model_from_coeffs(kind: str, coeffs) -> LatencyModel:
    """Inverse of :func:`model_coeffs`."""
    if kind == "flat":
        return FlatService(coeffs[0])
    if kind == "linear":
        return LinearBatch(coeffs[0], coeffs[1])
    if kind == "step":
        return StepBatch(coeffs[0], coeffs[1], int(coeffs[2]))
    raise ValueError(f"unknown latency model kind: {kind!r}")


# --------------------------------------------------------------------------- #
# replica configuration
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ContinuousBatching:
    """Per-replica continuous-batching configuration.

    ``window_s``: a batch opening at ``t_open`` admits every request with
    arrival ``<= t_open + window_s`` (boundary ties join).  ``max_batch``
    caps occupancy on top of whatever cap the model imposes
    (``StepBatch.max_pages``); the effective cap is the min of both.
    """

    model: LatencyModel
    window_s: float = 0.0
    max_batch: Optional[int] = None

    def __post_init__(self):
        if self.window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {self.window_s}")
        if self.max_batch is not None and self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")

    @property
    def cap(self) -> float:
        caps = [c for c in (self.max_batch, self.model.capacity)
                if c is not None]
        return float(min(caps)) if caps else np.inf

    @property
    def degenerate(self) -> bool:
        """True when this config is exactly the legacy serial queue: flat
        curve, zero window, one request per batch.  ``ReplicaPool`` routes
        degenerate configs through its original recursion so they stay
        bit-for-bit with the pre-batching slow tier (the vectorized batch
        path computes the same reals via a different float expression)."""
        return (self.window_s == 0.0 and self.cap == 1.0
                and isinstance(self.model, FlatService))


# Alias in the modeling vocabulary: one replica of a continuous-batching
# inference server *is* its batching config.
BatchingReplica = ContinuousBatching


# --------------------------------------------------------------------------- #
# batch formation (the per-replica Lindley recursion over batches)
# --------------------------------------------------------------------------- #


def form_batches(arrival, cfg: ContinuousBatching, *, busy0: float = 0.0):
    """Form batches over one replica's pending requests; one pass per batch.

    ``arrival`` must be sorted ascending (ties allowed).  Returns four arrays
    aligned with ``arrival``:

    * ``done[i]`` — completion time of request i's batch,
    * ``service[i]`` — that batch's ``f(n)`` (the processing time the server
      reports for every member),
    * ``batch_size[i]`` — ``n`` of the batch serving request i,
    * ``batch_id[i]`` — 0-based batch ordinal on this replica.

    Semantics per batch: the batch *opens* at ``t_open = max(busy, arrival of
    the first pending request)``; every pending request with ``arrival <=
    t_open + window_s`` is admitted (boundary ties join), up to the occupancy
    cap.  If the cap binds, the batch *launches* as soon as its last admitted
    member has landed (``max(t_open, arrival[last])`` — no point waiting out
    the window for requests that can't join) and the excess spills to the
    next batch; otherwise it launches when the window closes
    (``t_open + window_s``).  The batch completes at ``launch + f(n)`` and
    the replica is busy until then.
    """
    arr = np.asarray(arrival, dtype=np.float64)
    n = arr.shape[0]
    done = np.empty(n, dtype=np.float64)
    service = np.empty(n, dtype=np.float64)
    batch_size = np.empty(n, dtype=np.int64)
    batch_id = np.empty(n, dtype=np.int64)
    model, w, cap = cfg.model, cfg.window_s, cfg.cap
    busy = float(busy0)
    p = 0
    b = 0
    while p < n:
        t_open = max(busy, arr[p])
        close = t_open + w
        hi = int(np.searchsorted(arr, close, side="right"))
        count = int(min(hi - p, cap))
        if hi - p > count:  # cap binds: spill, launch at last member's landing
            t_start = max(t_open, float(arr[p + count - 1]))
        else:
            t_start = close
        f = float(model.batch_latency(count))
        done[p:p + count] = t_start + f
        service[p:p + count] = f
        batch_size[p:p + count] = count
        batch_id[p:p + count] = b
        busy = t_start + f
        p += count
        b += 1
    return done, service, batch_size, batch_id


def form_batches_looped(arrival, cfg: ContinuousBatching, *, busy0: float = 0.0):
    """One-request-at-a-time reference for :func:`form_batches`.

    Implements the admission rules literally (walk requests, admit while
    within the window and under the cap) with the same float expressions, so
    the two must agree *bit-for-bit* (the fuzz oracle of the tests).
    """
    arr = [float(a) for a in np.asarray(arrival, dtype=np.float64)]
    n = len(arr)
    done = [0.0] * n
    service = [0.0] * n
    batch_size = [0] * n
    batch_id = [0] * n
    busy = float(busy0)
    i = 0
    b = 0
    while i < n:
        t_open = max(busy, arr[i])
        close = t_open + cfg.window_s
        members = [i]
        j = i + 1
        while j < n and arr[j] <= close and len(members) < cfg.cap:
            members.append(j)
            j += 1
        spilled = j < n and arr[j] <= close  # admission stopped by the cap
        t_start = max(t_open, arr[members[-1]]) if spilled else close
        f = float(cfg.model.batch_latency(len(members)))
        for k in members:
            done[k] = t_start + f
            service[k] = f
            batch_size[k] = len(members)
            batch_id[k] = b
        busy = t_start + f
        i = j
        b += 1
    return (np.asarray(done), np.asarray(service),
            np.asarray(batch_size, dtype=np.int64),
            np.asarray(batch_id, dtype=np.int64))
