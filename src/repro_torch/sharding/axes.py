"""Logical-axis sharding rules (port of ``repro.sharding.axes``).

Models never name mesh axes; a rules table resolves logical axes to mesh
axes inside ``sharding_ctx``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` or a shape-only mesh (axis
names and sizes: ``launch/mesh.py::ShapeMesh``, or any object with
``axis_names`` and ``devices.shape``, as the reference's tests fake one),
which lets the production meshes be analysed on one card.

``shard`` and ``host_shard`` are no-ops off a mesh and on a shape-only
one.  On a ``DeviceMesh`` each returns a ``DTensor`` whose placements are
the resolved spec: ``shard`` redistributes a ``DTensor`` (or distributes a
plain tensor), ``host_shard`` distributes a host tensor onto the mesh's
device type.  A plain tensor is distributed from each process's own copy
(``src_data_rank=None``), as ``jax.device_put`` places each host's data:
no collective runs, so a one-process mesh needs no communicator.  The port's models do not call ``shard`` (on one card it
changes no number); the dry run's card mode places its inputs with
``host_shard``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_state = threading.local()


DEFAULT_RULES: dict[str, Optional[str]] = {
    # activations
    "batch": "data",
    "seq": None,  # sharded over "model" only in SP regions (explicit)
    "seq_sp": "model",
    "seq_res": None,  # residual-stream sequence sharding (Megatron-SP); train rules set 'model'
    "kv_seq": "model",  # decode KV cache sequence splits
    "embed": None,
    "heads_act": "model",
    "head_dim_act": None,
    "mlp_act": "model",
    "vocab_act": "model",
    "experts_act": "model",
    "spatial": "data",  # diffusion gen small-batch spatial rows
    "streams": "data",  # serving fleet stream axis
    # params
    "layers": None,
    "stack": None,
    "vocab": "model",
    "embed_tbl": "model",  # token-embedding table: shard d_model, gather local
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "kv_lora": None,
    "conv_in": None,
    "conv_out": "model",
    "classes": None,
    "ctx": None,
}


def multipod_rules() -> dict[str, Optional[str]]:
    """On the (pod, data, model) mesh, batch shards over (pod, data)."""
    r = dict(DEFAULT_RULES)
    r["batch"] = ("pod", "data")
    r["spatial"] = ("pod", "data")
    return r


def is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a shape-only mesh."""
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    shape = mesh.devices.shape if hasattr(mesh, "devices") else mesh.shape  # a faked mesh, or a ShapeMesh
    return dict(zip(mesh.axis_names, shape))


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[dict] = None):
    """Resolve logical axes on ``mesh`` with ``rules`` (default: the
    multi-pod rules on a mesh with a ``pod`` axis, else ``DEFAULT_RULES``),
    whose ``_sizes`` are the mesh's."""
    prev = getattr(_state, "ctx", None)
    if mesh is not None:
        sizes = mesh_sizes(mesh)
        rules = dict(rules or (multipod_rules() if "pod" in sizes else DEFAULT_RULES))
        rules["_sizes"] = sizes
    _state.ctx = (mesh, rules)
    try:
        yield
    finally:
        _state.ctx = prev


def current_rules() -> Optional[dict]:
    ctx = getattr(_state, "ctx", None)
    return ctx[1] if ctx else None


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def _resolve(rules, dim_size, ax, used):
    """The mesh axis (or axes) of one dim of size ``dim_size`` on logical
    axis ``ax``: none if unmapped, if every mapped mesh axis is already in
    ``used``, or if their product does not divide the dim."""
    mesh_ax = rules.get(ax) if ax else None
    if mesh_ax is None:
        return None
    axes = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
    axes = tuple(a for a in axes if a not in used)
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= rules["_sizes"].get(a, 1)
    if dim_size % total != 0:
        return None
    used.update(axes)
    return axes if len(axes) > 1 else axes[0]


def resolve(shape, *axes: Optional[str], rules: Optional[dict] = None) -> tuple:
    """The spec of a tensor of ``shape`` on ``axes`` (one logical axis or
    None per dim) under ``rules`` (default: the current context's)."""
    rules = rules if rules is not None else current_rules()
    if len(axes) != len(shape):
        raise ValueError(f"got {len(axes)} axes for a rank-{len(shape)} tensor")
    used: set = set()
    return tuple(_resolve(rules, d, a, used) for d, a in zip(shape, axes))


def placements(spec: tuple, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that shards tensor dim i (a tuple entry shards one tensor dim
    over several mesh dims, outermost first), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    of = {}
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                of[a] = i
    return tuple(Shard(of[name]) if name in of else Replicate() for name in mesh.mesh_dim_names)


def logical_axis_multiple(name: str) -> int:
    """Device count a dimension must be a multiple of to shard over the
    logical axis ``name`` under the current rules context; 1 off-mesh or
    when the axis maps to no mesh axis."""
    ctx = getattr(_state, "ctx", None)
    if not ctx or ctx[0] is None:
        return 1
    _, rules = ctx
    mesh_ax = rules.get(name)
    if mesh_ax is None:
        return 1
    axes = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
    total = 1
    for a in axes:
        total *= rules["_sizes"].get(a, 1)
    return total


def _device_ctx():
    ctx = getattr(_state, "ctx", None)
    if not ctx or ctx[0] is None or not is_device_mesh(ctx[0]):
        return None
    return ctx


def shard(x, *axes: Optional[str]):
    """Constrain a tensor's sharding by logical axis names: a ``DTensor``
    with the resolved placements on a ``DeviceMesh`` (redistributed if
    ``x`` is one already); ``x`` itself off a mesh or on a shape-only one."""
    ctx = _device_ctx()
    if ctx is None:
        return x
    mesh, rules = ctx
    pl = placements(resolve(x.shape, *axes, rules=rules), mesh)
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def host_shard(x: torch.Tensor, *axes: Optional[str]):
    """Place a host tensor on the mesh with the resolved sharding for its
    logical axes: the input-side companion to ``shard``.  No-op off a mesh
    and on a shape-only one."""
    ctx = _device_ctx()
    if ctx is None:
        return x
    mesh, rules = ctx
    pl = placements(resolve(x.shape, *axes, rules=rules), mesh)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x.to(mesh.device_type), mesh, pl, src_data_rank=None)
