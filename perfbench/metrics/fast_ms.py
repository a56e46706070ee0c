"""The fast tier's CUDA-event milliseconds a round, the mean over the window's rounds."""
import numpy as np


def read(rec):
    vals = [r["fast_ms"] for r in rec.rounds if "fast_ms" in r]
    return float(np.mean(vals)) if vals else None
