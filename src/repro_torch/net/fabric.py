"""The edge fabric: cells x replicas topology behind the serving engines
(port of ``repro.net.fabric``; host numpy, copied).  Cell uplinks are
constant, "pcg"-jittered or trace-driven; ``transmit(collect_detail=True)``
keeps the per-row lifecycle detail the frame tracer (``obs/trace.py``) reads.

``core/netsim.py`` models ONE uplink feeding ONE implicit server — the
paper's single-phone testbed.  Real edge deployments are a topology: many
radio cells (each a serial uplink shared by the streams attached to it),
feeding a pool of slow-tier replicas behind a placement policy.
``EdgeFabric`` is that topology as one object:

  * ``Cell``        — a per-cell ``Uplink`` plus the subset of streams
                      attached to it; the partition is an (S,) cell-id
                      vector (geography: a stream keeps its cell);
  * ``ReplicaPool`` — K slow-tier replicas, per-replica queues
                      (``net/replicas.py``);
  * ``Placement``   — round_robin / jsq / least_land assignment of each
                      escalation to a replica (``net/placement.py``).

``transmit`` is the fabric's one data-plane verb: a round's escalation
batch goes in (already in scheduler order), per-cell upload batches run
through their own uplinks (one vectorized Lindley recursion per cell),
completed uploads are placed onto replicas, the pool serves them, and
reply-land times come out.  The round loop stays free of per-stream
Python: the only loops are over C cells and K replicas.

``EdgeFabric.degenerate(uplink)`` — 1 cell, 1 replica, infinite-capacity
service — reproduces the legacy shared-uplink pipeline bit-for-bit; it is
what ``MultiStreamServer`` builds when no fabric is passed, so every
pre-fabric test and snapshot still pins the same floats.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.netsim import Uplink
from repro_torch.net.placement import Placement
from repro_torch.net.replicas import ReplicaPool

__all__ = ["Cell", "EdgeFabric"]


@dataclass
class Cell:
    """One radio cell: a serial uplink and the streams attached to it."""

    cell_id: int
    uplink: Uplink
    streams: np.ndarray  # (s_c,) global stream ids attached to this cell

    @property
    def n_streams(self) -> int:
        return len(self.streams)


class EdgeFabric:
    """Cells + replica pool + placement, wired for batched rounds."""

    def __init__(self, uplinks: Uplink | Sequence[Uplink], pool: ReplicaPool, *,
                 n_streams: int | None = None, cell_of=None,
                 placement: str | Placement = "round_robin"):
        ups = [uplinks] if isinstance(uplinks, Uplink) else list(uplinks)
        if not ups:
            raise ValueError("fabric needs at least one cell uplink")
        self.pool = pool
        self.placement = (placement if isinstance(placement, Placement)
                          else Placement(placement))
        C = len(ups)
        if cell_of is None:
            if n_streams is None:
                raise ValueError("pass cell_of or n_streams")
            cell_of = np.arange(int(n_streams)) % C  # balanced default partition
        self.cell_of = np.asarray(cell_of, dtype=np.int64)
        if len(self.cell_of) == 0 or (self.cell_of < 0).any() or (self.cell_of >= C).any():
            raise ValueError(f"cell_of must map every stream to one of {C} cells")
        if n_streams is not None and len(self.cell_of) != int(n_streams):
            raise ValueError("cell_of length must equal n_streams")
        lats = {u.latency for u in ups}
        if len(lats) != 1:
            # the decision plane's Env carries one scalar latency; relax this
            # when policies learn per-stream latency
            raise ValueError("all cell uplinks must share one latency")
        self.latency = float(lats.pop())
        self.cells = [Cell(c, u, np.flatnonzero(self.cell_of == c))
                      for c, u in enumerate(ups)]
        # per-row actual service times of the most recent transmit batch —
        # replies carry their own processing time (servers timestamp it),
        # so estimators can subtract the true service component even on
        # heterogeneous pools
        self.last_service_time = np.zeros(0, dtype=np.float64)
        # per-row lifecycle detail of the most recent transmit batch when
        # requested (``transmit(collect_detail=True)``, telemetry tracing)
        self.last_detail = None

    # -- shape ------------------------------------------------------------- #

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    @property
    def n_streams(self) -> int:
        return len(self.cell_of)

    @property
    def n_replicas(self) -> int:
        return self.pool.n_replicas

    @property
    def server_time(self) -> float:
        """Nominal T^o the planners/estimators assume."""
        return self.pool.nominal_server_time

    def expected_server_time(self) -> float:
        """Occupancy-calibrated T^o: with a continuous-batching pool this is
        the amortized f(expected_batch)/expected_batch at the observed
        occupancy EWMA; otherwise the nominal mean (bit-equal to
        ``server_time``)."""
        return self.pool.expected_server_time()

    @property
    def occupancy(self) -> float:
        """Observed per-request batch-occupancy EWMA of the slow tier
        (1.0 = serial regime / no batching)."""
        return float(self.pool.avg_batch)

    @property
    def n_transfers(self) -> int:
        return int(sum(c.uplink.n_transfers for c in self.cells))

    def stream_bandwidth(self) -> np.ndarray:
        """(S,) nominal uplink rate of each stream's cell — the optimistic
        full-link prior the fleet's EWMA estimators start from, and the
        scheduler's cost normalizer.  Trace-driven cells use the trace's
        time-weighted mean."""
        bw = np.asarray([c.uplink.trace.mean_bps if c.uplink.trace is not None
                         else c.uplink.bandwidth_bps for c in self.cells])
        return bw[self.cell_of]

    def true_bandwidth(self, t: float) -> np.ndarray:
        """(S,) true instantaneous uplink rate of each stream's cell at
        time ``t`` — the telemetry recorder's ground truth against the
        fleet's EWMA estimates.  Pure: ``Uplink.bandwidth_at`` derives
        jitter per (seed, second) deterministically, so sampling here
        never perturbs the simulation."""
        if not np.isfinite(t):
            return np.full(self.n_streams, np.nan)
        bw = np.asarray([c.uplink.current_bandwidth(float(t))
                         for c in self.cells])
        return bw[self.cell_of]

    # -- data plane --------------------------------------------------------- #

    def transmit(self, stream, payload_bytes, t_submit, *,
                 service_scale=None, collect_detail: bool = False) -> np.ndarray:
        """Route one round's escalations: per-cell uplink upload (rows keep
        their scheduler order within each cell), replica placement on the
        upload-completion times, pool service, reply latency.  Returns
        reply-land times aligned with the input rows.

        ``service_scale`` (optional, per-row) scales each job's replica
        service time — split-computation offloads run only the model suffix
        server-side (``srv_frac``); 1.0 rows are a float no-op.

        ``collect_detail`` additionally stores per-row lifecycle detail in
        ``self.last_detail`` (upload start/end, replica, batch id, service
        completion) for the frame tracer; off is the default and costs
        nothing."""
        stream = np.asarray(stream, dtype=np.int64)
        payloads = np.asarray(payload_bytes, dtype=np.float64)
        subs = np.asarray(t_submit, dtype=np.float64)
        self.last_detail = None
        if len(stream) == 0:
            self.last_service_time = np.zeros(0, dtype=np.float64)
            return np.zeros(0, dtype=np.float64)
        end_tx = np.empty(len(stream), dtype=np.float64)
        up_start = np.empty(len(stream), dtype=np.float64) if collect_detail else None
        rows_cell = self.cell_of[stream]
        for cell in self.cells:
            rows = np.flatnonzero(rows_cell == cell.cell_id)
            if len(rows):
                end_tx[rows] = cell.uplink.upload_batch(payloads[rows], subs[rows])
                if collect_detail:
                    up_start[rows] = cell.uplink.last_starts
        replica = self.placement.assign(self.pool, end_tx)
        done = self.pool.process(end_tx, replica, service_scale=service_scale)
        # batched service reports the member's whole-batch f(n); without
        # batching this is exactly server_time[replica] as before
        self.last_service_time = self.pool.last_service
        if collect_detail:
            self.last_detail = {
                "cell": rows_cell, "up_start": up_start, "up_end": end_tx.copy(),
                "replica": replica, "service": self.pool.last_service.copy(),
                "batch_id": self.pool.last_batch_id.copy(), "done": done.copy(),
            }
        return done + self.latency

    def reset(self):
        for cell in self.cells:
            cell.uplink.reset()
        self.pool.reset()
        self.placement.reset()

    # -- contention counters ------------------------------------------------ #

    def summary(self) -> dict:
        """Per-cell and per-replica contention counters (metrics embed a
        rounded view of this)."""
        return {
            "cells": self.n_cells,
            "replicas": self.n_replicas,
            "placement": self.placement.policy,
            "cell_transfers": [int(c.uplink.n_transfers) for c in self.cells],
            "cell_busy_s": [float(c.uplink.busy_seconds) for c in self.cells],
            "cell_queued_s": [float(c.uplink.queued_seconds) for c in self.cells],
            "replica_jobs": self.pool.n_jobs.tolist(),
            "replica_busy_s": self.pool.busy_seconds.tolist(),
            "replica_queued_s": self.pool.queued_seconds.tolist(),
        }

    # -- constructors -------------------------------------------------------- #

    @classmethod
    def degenerate(cls, uplink: Uplink, n_streams: int) -> "EdgeFabric":
        """1 cell, 1 replica, infinite-capacity service: the legacy
        single-uplink pipeline, bit-for-bit (snapshot-pinned)."""
        pool = ReplicaPool(1, uplink.server_time, serial=False)
        return cls(uplink, pool, n_streams=n_streams, placement="round_robin")

    @classmethod
    def build(cls, *, n_streams: int, n_cells: int = 1, n_replicas: int = 1,
              bandwidth_bps: float = 1e6, latency: float = 0.05,
              server_time: float = 0.037, placement: str = "round_robin",
              jitter: float = 0.0, seed: int = 0, traces=None,
              serial_replicas: bool = True, batching=None) -> "EdgeFabric":
        """Convenience constructor: C homogeneous cells (optionally each
        replaying its own bandwidth trace) in front of K serial replicas
        (optionally continuous-batching ones).  Cell c gets seed ``seed + c``
        so jittered cells decorrelate."""
        traces = list(traces) if traces is not None else [None] * n_cells
        if len(traces) != n_cells:
            raise ValueError("need one trace (or None) per cell")
        ups = [Uplink(bandwidth_bps=bandwidth_bps, latency=latency,
                      server_time=server_time, jitter=jitter, seed=seed + c,
                      trace=traces[c])
               for c in range(n_cells)]
        pool = ReplicaPool(n_replicas, server_time, serial=serial_replicas,
                           batching=batching)
        return cls(ups, pool, n_streams=n_streams, placement=placement)
