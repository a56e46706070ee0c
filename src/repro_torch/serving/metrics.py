"""Serving metrics (port of ``repro.serving.metrics``).

``ServeMetrics`` is the single-stream record.  ``AggregateMetrics`` keeps
(S,) counter vectors for a multi-stream run plus the fabric's contention
counters, and adds the cross-stream views: frame-weighted accuracy, the
per-stream accuracy spread and Jain's fairness index over per-stream
offload counts.

  * ``accuracy``            — correct answers over frames (frame-weighted);
  * ``offload_frac``        — escalations whose reply landed in time;
  * ``deadline_miss_frac``  — escalations that fell back to the fast answer;
  * latencies               — per frame: fast path for locals, land time for
                              offloads, clipped at the deadline for misses.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ServeMetrics:
    n_frames: int = 0
    n_offloaded: int = 0
    n_deadline_miss: int = 0  # escalations that fell back
    n_correct: int = 0
    latencies: list = field(default_factory=list)

    @property
    def accuracy(self) -> float:
        return self.n_correct / max(self.n_frames, 1)

    @property
    def offload_frac(self) -> float:
        return self.n_offloaded / max(self.n_frames, 1)

    @property
    def deadline_miss_frac(self) -> float:
        return self.n_deadline_miss / max(self.n_frames, 1)

    def update_batch(self, n_frames: int, n_offloaded: int, n_deadline_miss: int,
                     n_correct: int, latencies) -> None:
        """Fold one round's numpy results in."""
        self.n_frames += int(n_frames)
        self.n_offloaded += int(n_offloaded)
        self.n_deadline_miss += int(n_deadline_miss)
        self.n_correct += int(n_correct)
        self.latencies.extend(float(x) for x in np.atleast_1d(latencies))

    def summary(self) -> dict:
        # no latencies observed -> the percentiles do not exist (null, not 0 ms)
        lat = np.asarray(self.latencies, dtype=np.float64)
        return {
            "frames": self.n_frames,
            "accuracy": round(self.accuracy, 4),
            "offload_frac": round(self.offload_frac, 4),
            "deadline_miss_frac": round(self.deadline_miss_frac, 4),
            "p50_latency_ms": (round(float(np.percentile(lat, 50)) * 1e3, 2)
                               if lat.size else None),
            "p99_latency_ms": (round(float(np.percentile(lat, 99)) * 1e3, 2)
                               if lat.size else None),
        }


def jain_index(x) -> float:
    """Jain's fairness index: 1.0 = perfectly even, 1/n = one stream hogs."""
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0 or x.sum() <= 0:
        return 1.0
    return float(x.sum() ** 2 / (x.size * (x**2).sum()))


class AggregateMetrics:
    """Struct-of-arrays fleet metrics: (S,) counter vectors folded once per
    round (``update_round``) so the serving engine's inner loop carries no
    per-stream Python.  ``per_stream`` materializes the familiar
    ``ServeMetrics`` views lazily (tests, reports); latencies are kept as
    per-round (S, B) chunks plus validity masks until then."""

    def __init__(self, n_streams: int, uplink=None, fabric=None):
        self.n_streams = int(n_streams)
        self.uplink = uplink  # the shared Uplink (for contention counters)
        self.fabric = fabric  # EdgeFabric (per-cell / per-replica counters)
        self.wall_time: float = 0.0  # simulated horizon (last arrival + deadline)
        self._frames = np.zeros(n_streams, dtype=np.int64)
        self._offloaded = np.zeros(n_streams, dtype=np.int64)
        self._missed = np.zeros(n_streams, dtype=np.int64)
        self._correct = np.zeros(n_streams, dtype=np.int64)
        self._lat_chunks: list = []  # [(lat (S, b), valid (S, b))]
        self._cache: list | None = None

    @classmethod
    def for_streams(cls, n_streams: int, uplink=None, fabric=None) -> "AggregateMetrics":
        return cls(n_streams, uplink=uplink, fabric=fabric)

    def update_round(self, n_frames, n_offloaded, n_missed, n_correct,
                     latencies, valid) -> None:
        """Fold one round's (S,)-vector counters and (S, b) latencies in."""
        self._frames += np.asarray(n_frames, dtype=np.int64)
        self._offloaded += np.asarray(n_offloaded, dtype=np.int64)
        self._missed += np.asarray(n_missed, dtype=np.int64)
        self._correct += np.asarray(n_correct, dtype=np.int64)
        self._lat_chunks.append((np.asarray(latencies, dtype=np.float64),
                                 np.asarray(valid, dtype=bool)))
        self._cache = None

    @property
    def per_stream(self) -> list:
        """Per-stream ``ServeMetrics`` views (index = stream id)."""
        if self._cache is None:
            out = []
            for s in range(self.n_streams):
                m = ServeMetrics(
                    n_frames=int(self._frames[s]), n_offloaded=int(self._offloaded[s]),
                    n_deadline_miss=int(self._missed[s]), n_correct=int(self._correct[s]))
                m.latencies = [float(x) for lat, ok in self._lat_chunks
                               for x in lat[s][ok[s]]]
                out.append(m)
            self._cache = out
        return self._cache

    def __getitem__(self, s: int) -> ServeMetrics:
        return self.per_stream[s]

    # -- aggregate (frame-weighted) views -------------------------------- #
    @property
    def n_frames(self) -> int:
        return int(self._frames.sum())

    @property
    def n_offloaded(self) -> int:
        return int(self._offloaded.sum())

    @property
    def n_deadline_miss(self) -> int:
        return int(self._missed.sum())

    @property
    def accuracy(self) -> float:
        return int(self._correct.sum()) / max(self.n_frames, 1)

    @property
    def offload_frac(self) -> float:
        return self.n_offloaded / max(self.n_frames, 1)

    @property
    def deadline_miss_frac(self) -> float:
        return self.n_deadline_miss / max(self.n_frames, 1)

    @property
    def offload_fairness(self) -> float:
        """Jain index over per-stream successful-offload counts."""
        return jain_index(self._offloaded)

    def summary(self) -> dict:
        lats = (np.concatenate([lat[ok] for lat, ok in self._lat_chunks])
                if self._lat_chunks else np.zeros(0))
        # straight from the SoA counters — no per-stream materialization
        acc = self._correct / np.maximum(self._frames, 1)
        out = {
            "streams": self.n_streams,
            "frames": self.n_frames,
            "accuracy": round(self.accuracy, 4),
            "offload_frac": round(self.offload_frac, 4),
            "deadline_miss_frac": round(self.deadline_miss_frac, 4),
            "p50_latency_ms": (round(float(np.percentile(lats, 50)) * 1e3, 2)
                               if lats.size else None),
            "p99_latency_ms": (round(float(np.percentile(lats, 99)) * 1e3, 2)
                               if lats.size else None),
            "stream_acc_min": round(float(min(acc)), 4),
            "stream_acc_max": round(float(max(acc)), 4),
            "offload_fairness": round(self.offload_fairness, 4),
        }
        fs = self.fabric.summary() if self.fabric is not None else None
        multi_cell = self.fabric is not None and self.fabric.n_cells > 1
        if multi_cell:
            # the uplink_* keys stay fabric-wide under a multi-cell fabric:
            # totals over every cell, utilization averaged per cell (1.0 =
            # every radio saturated) — never just cell 0's counters
            out["uplink_queued_s"] = round(sum(fs["cell_queued_s"]), 4)
            out["uplink_busy_s"] = round(sum(fs["cell_busy_s"]), 4)
            if self.wall_time > 0:
                out["uplink_utilization"] = round(
                    sum(fs["cell_busy_s"]) / (self.fabric.n_cells * self.wall_time), 4)
        elif self.uplink is not None:
            out["uplink_queued_s"] = round(float(self.uplink.queued_seconds), 4)
            out["uplink_busy_s"] = round(float(self.uplink.busy_seconds), 4)
            if self.wall_time > 0:
                out["uplink_utilization"] = round(self.uplink.utilization(self.wall_time), 4)
        if self.fabric is not None and (self.fabric.n_cells > 1
                                        or self.fabric.n_replicas > 1):
            # topology contention: where escalations queued — on the radio
            # (cell uplinks) or at the slow tier (replica pool)
            out["cells"] = fs["cells"]
            out["replicas"] = fs["replicas"]
            out["placement"] = fs["placement"]
            out["cell_queued_s"] = [round(x, 4) for x in fs["cell_queued_s"]]
            out["cell_busy_s"] = [round(x, 4) for x in fs["cell_busy_s"]]
            out["replica_queued_s"] = [round(x, 4) for x in fs["replica_queued_s"]]
            out["replica_busy_s"] = [round(x, 4) for x in fs["replica_busy_s"]]
            # utilization only means "overload when > 1" for serial queues;
            # an infinite-capacity (serial=False) pool never queues, so the
            # ratio would misread as saturation
            if self.wall_time > 0 and self.fabric.pool.serial:
                out["replica_utilization"] = [
                    round(float(x), 4)
                    for x in self.fabric.pool.utilization(self.wall_time)]
        return out
