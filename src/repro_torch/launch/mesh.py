"""Meshes (port of ``repro.launch.mesh``).

The production meshes are shape-only (``ShapeMesh``): the dry run analyses
a 256- or 512-chip cell from its axis names and sizes on one card.  The
local and streams meshes are real ``torch.distributed`` ``DeviceMesh``es,
one process per card; they need a process group, which ``process_group``
makes for one process (world size 1) without a TCP port.  Importing this
module touches no device and sets no environment variable.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ShapeMesh:
    """A mesh of axis names and sizes, with no devices behind it."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The (data 16, model 16) mesh, or (pod 2, data 16, model 16)."""
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


@contextlib.contextmanager
def process_group(device=None):
    """A default process group of this one process (rank 0, world size 1,
    an in-memory ``HashStore``, so no TCP port and no collision between
    test workers): NCCL for ``cuda`` (the default), gloo for ``cpu``.  If a
    group exists already it is used and left alone; the one made here is
    destroyed on exit."""
    import torch.distributed as dist

    dev = resolve_device(device)
    made = not dist.is_initialized()
    if made:
        if dev.type == "cuda":  # this process's card, before the mesh picks one
            import torch

            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
                                rank=0, world_size=1)
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def _n_devices(dev) -> int:
    """The cards a mesh can span: one process drives one card, so the
    group's world size, and for ``cuda`` no more than the cards present."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs a process group: make one with launch.mesh.process_group()")
    n = dist.get_world_size()
    return min(n, torch.cuda.device_count()) if dev.type == "cuda" else n


def make_local_mesh(model_axis: int = 1, data_axis: int = 1, *, device=None):
    """A ("data", "model") ``DeviceMesh`` over the cards there are: each
    axis clamped to them as the reference clamps to its devices (on one
    card, (1, 1)); ``cuda`` unless ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    n = _n_devices(dev)
    model_axis = min(model_axis, n)
    data_axis = min(data_axis, n // model_axis)
    return init_device_mesh(dev.type, (data_axis, model_axis), mesh_dim_names=("data", "model"))


def make_streams_mesh(n_devices: int | None = None, *, device=None):
    """A pure data-parallel (n, 1) ("data", "model") ``DeviceMesh`` for
    fleet serving; raises when ``n_devices`` exceeds the cards there are."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    have = _n_devices(dev)
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise ValueError(f"asked for {n} devices, the process group spans {have}")
    return init_device_mesh(dev.type, (n, 1), mesh_dim_names=("data", "model"))
