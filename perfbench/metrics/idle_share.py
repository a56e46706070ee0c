"""Percent of the traced slice's wall time with no device interval
running (kernels, copies and sets as one union)."""


def read(rec):
    sl = rec.slice
    return 100.0 * (1.0 - sl.busy_s / sl.window_s) if sl is not None and sl.window_s > 0 else None
