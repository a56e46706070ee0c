"""The 95th percentile of a round's wall milliseconds, over every round of the window."""
import numpy as np


def read(rec):
    return float(np.percentile([r["wall_ms"] for r in rec.rounds], 95)) if rec.rounds else None
