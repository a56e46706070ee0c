"""Serving: the single-stream ``CascadeServer`` and the multi-stream
``MultiStreamServer`` over an edge fabric, with their events, fair
scheduler and metrics (port of ``repro.serving``)."""
from repro_torch.serving.engine import CascadeServer, MultiStreamServer, ServeConfig
from repro_torch.serving.events import ArrivalSchedule, EscalationBatch, select_escalations
from repro_torch.serving.metrics import AggregateMetrics, ServeMetrics, jain_index
from repro_torch.serving.scheduler import FairScheduler

__all__ = ["CascadeServer", "MultiStreamServer", "ServeConfig", "ArrivalSchedule",
           "EscalationBatch", "select_escalations", "AggregateMetrics", "ServeMetrics",
           "jain_index", "FairScheduler"]
