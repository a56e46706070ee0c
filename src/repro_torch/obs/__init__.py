"""Fleet telemetry: per-round time series, frame tracing, phase profiling
(port of ``repro.obs``; host numpy).

The observability layer behind ``MultiStreamServer(..., telemetry=...)``:
zero cost when off (the engine holds ``None`` and skips every hook).

  * ``timeseries.FleetRecorder`` — per-round SoA time series of the
    control loop's observables (counters, bandwidth EWMA against truth,
    cell/replica contention, occupancy, decision histograms);
  * ``trace.FrameTracer`` — per-escalation lifecycle spans with
    cell/replica/batch ids, exported as Chrome trace-event JSON;
  * ``profile.PhaseProfiler`` — host wall-clock phase breakdown (plan /
    serve / transmit / fold).

``Telemetry`` is the bundle the engine consumes: pick the parts with
flags; the server binds the fleet's dimensions at construction.
``profile.aot_split`` warms up and captures the round engine's CUDA graph,
timing the capture apart from the steady state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.obs.profile import DEFAULT, PhaseProfiler, aot_split
from repro_torch.obs.timeseries import FleetRecorder, relock_lags
from repro_torch.obs.trace import FrameTracer, export_chrome_trace

__all__ = ["Telemetry", "FleetRecorder", "FrameTracer", "PhaseProfiler",
           "export_chrome_trace", "relock_lags", "DEFAULT", "aot_split"]


@dataclass
class Telemetry:
    """What to observe: ``record`` (per-round series, cheap, default on),
    ``trace`` (per-frame lifecycle spans), ``profile`` (per-phase host
    wall clock).  Pass to ``MultiStreamServer(telemetry=...)``; the server
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
