"""Host milliseconds in ``FleetRunner.plan_all`` a round, the mean over the window's rounds."""
import numpy as np


def read(rec):
    vals = [r["plan_ms"] for r in rec.rounds if "plan_ms" in r]
    return float(np.mean(vals)) if vals else None
