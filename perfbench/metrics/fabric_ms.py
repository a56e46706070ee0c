"""Host milliseconds in ``EdgeFabric.transmit`` a round, the mean over the window's rounds."""
import numpy as np


def read(rec):
    vals = [r["fabric_ms"] for r in rec.rounds if "fabric_ms" in r]
    return float(np.mean(vals)) if vals else None
