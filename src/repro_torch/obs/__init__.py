"""Fleet telemetry: per-round time series, frame tracing, phase profiling
(port of ``repro.obs``; host numpy).

The observability layer behind ``MultiStreamServer(..., telemetry=...)``.
A part left off costs next to nothing: the engine skips the recorder's and
the tracer's rows, and sends its spans to ``profile.NULL_PROFILER``, whose
methods do nothing.

  * ``timeseries.FleetRecorder`` — per-round SoA time series of the
    control loop's observables (counters, bandwidth EWMA against truth,
    cell/replica contention, occupancy, decision histograms);
  * ``trace.FrameTracer`` — per-escalation lifecycle spans with
    cell/replica/batch ids, exported as Chrome trace-event JSON;
  * ``profile.PhaseProfiler`` — the numpy round loop's host spans (a
    ``round`` root over slice / h2d / fast / fast_wait / plan / gate /
    slow / slow_wait / transmit / fold / hook), their per-phase totals
    and the per-round ``syncs`` and ``staged`` counters.

``Telemetry`` is the bundle the engine consumes: pick the parts with
flags; the server binds the fleet's dimensions at construction.
``profile.aot_split`` warms up and captures the round engine's CUDA graph,
timing the capture apart from the steady state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.obs.profile import NULL_PROFILER, NullProfiler, PhaseProfiler, aot_split
from repro_torch.obs.timeseries import FleetRecorder, relock_lags
from repro_torch.obs.trace import FrameTracer, export_chrome_trace

__all__ = ["Telemetry", "FleetRecorder", "FrameTracer", "PhaseProfiler", "NullProfiler",
           "NULL_PROFILER", "export_chrome_trace", "relock_lags", "aot_split"]


@dataclass
class Telemetry:
    """What to observe: ``record`` (per-round series, cheap, default on),
    ``trace`` (per-frame lifecycle spans), ``profile`` (the round loop's
    host spans and counters).  Pass to ``MultiStreamServer(telemetry=...)``; the server
    calls ``bind`` with the fleet's dimensions and the parts materialize
    lazily (pre-built parts are kept)."""

    record: bool = True
    trace: bool = False
    profile: bool = False
    recorder: Optional[FleetRecorder] = None
    tracer: Optional[FrameTracer] = None
    profiler: Optional[PhaseProfiler] = None

    def bind(self, *, n_streams: int, n_cells: int, n_replicas: int,
             n_actions: int) -> "Telemetry":
        if self.record and self.recorder is None:
            self.recorder = FleetRecorder(n_streams, n_cells, n_replicas,
                                          n_actions)
        if self.trace and self.tracer is None:
            self.tracer = FrameTracer()
        if self.profile and self.profiler is None:
            self.profiler = PhaseProfiler()
        return self
