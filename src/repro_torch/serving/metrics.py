"""Serving metrics (port of ``repro.serving.metrics``; single stream).

  * ``accuracy``            — correct answers over frames;
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
