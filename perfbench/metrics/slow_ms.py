"""The slow tier's CUDA-event milliseconds a round (0 in a round with no
escalation), the mean over the window's rounds."""
import numpy as np


def read(rec):
    vals = [r["slow_ms"] for r in rec.rounds if "slow_ms" in r]
    return float(np.mean(vals)) if vals else None
