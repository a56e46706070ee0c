"""A round's wall milliseconds less the tiers', the planner's and the
fabric's: the serving loop's own time (frame slice and copy, syncs, the
gate, the fold), the mean over the window's rounds."""
import numpy as np


def read(rec):
    vals = [r["wall_ms"] - r["fast_ms"] - r["slow_ms"] - r["plan_ms"] - r["fabric_ms"]
            for r in rec.rounds if "fast_ms" in r]
    return float(np.mean(vals)) if vals else None
