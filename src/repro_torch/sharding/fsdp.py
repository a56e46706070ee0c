"""FSDP/ZeRO-3 specs (port of ``repro.sharding.fsdp``): extend a
model-parallel spec with the data (and pod) axes on the largest
still-unsharded divisible dim.

Used for training parameters and optimizer state.  Specs are tuples with
one entry per dim (``models/ptree.py``); ``mesh`` is a ``DeviceMesh`` or a
shape-only mesh.
"""
from __future__ import annotations

import math

from repro_torch.sharding.axes import mesh_sizes


def fsdp_spec(pspec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Add ('data'[, 'pod']) to the best unsharded dim of one leaf."""
    axes = mesh_sizes(mesh)
    free = [a for a in ("pod", "data") if a in axes and not _used(pspec, a)]
    if not free:
        return pspec
    factor = math.prod(axes[a] for a in free)
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    # largest unsharded dim divisible by the combined factor
    cand = [(d, i) for i, (d, e) in enumerate(zip(shape, entries)) if e is None and d % factor == 0 and d >= factor]
    if not cand:
        # try 'data' alone
        if "data" in free and len(free) > 1:
            factor = axes["data"]
            cand = [(d, i) for i, (d, e) in enumerate(zip(shape, entries)) if e is None and d % factor == 0]
            free = ["data"]
        if not cand:
            return pspec
    _, idx = max(cand)
    entries[idx] = tuple(free) if len(free) > 1 else free[0]
    return tuple(entries)


def _used(pspec: tuple, axis: str) -> bool:
    return any(e == axis or (isinstance(e, tuple) and axis in e) for e in pspec)


def tree_fsdp(pspecs: dict, shapes: dict, mesh) -> dict:
    """``fsdp_spec`` of every leaf: ``shapes`` gives each leaf's dims in the
    specs' view (the reference's dims for parameters)."""
    return {k: fsdp_spec(ps, tuple(shapes[k]), mesh) for k, ps in pspecs.items()}
