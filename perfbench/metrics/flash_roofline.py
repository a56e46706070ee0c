"""Percent: the least time the slice's attention calls need (each call's
4·B·H·Sq·Sk·D operations at the TF32 peak or its q, k, v and o bytes at
the HBM peak, the larger) over the device time of the flash-attention
kernels in the trace."""


def read(rec):
    sl = rec.slice
    if sl is None or sl.flash_s <= 0 or sl.attention_bound_s <= 0:
        return None
    return 100.0 * sl.attention_bound_s / sl.flash_s
