"""Percent of the H100's TF32 peak (494.7 TFLOP/s) that the model
operations of every fast-tier and slow-tier frame of the traced slice
make over the slice's wall seconds."""
from perfbench.counts import PEAK_TF32_FLOPS


def read(rec):
    sl = rec.slice
    if sl is None or sl.window_s <= 0 or sl.flops <= 0:
        return None
    return 100.0 * sl.flops / (sl.window_s * PEAK_TF32_FLOPS)
