"""Serving engine and metrics."""
from repro_torch.serving.engine import CascadeServer, ServeConfig
from repro_torch.serving.metrics import ServeMetrics

__all__ = ["CascadeServer", "ServeConfig", "ServeMetrics"]
