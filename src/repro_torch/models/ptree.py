"""Parameter-tree specification (port of ``repro.models.ptree``): shapes,
sharding and napkin math from a model's ``{name: Leaf}`` table.

A model's parameters are its ``Leaf`` table (``models/layers.py``): each
leaf's shape in the port's layout, its init, and the reference's dims with
their logical axes.  From that table come

  * ``tree_struct`` — meta tensors of each leaf's shape and dtype (the
    dry run's stand-ins; nothing is allocated);
  * ``tree_pspec``  — each leaf's spec under logical-axis rules;
  * ``port_spec``   — a spec on the port's layout;
  * ``tree_bytes``, ``tree_count`` — parameter bytes and count.

Init is ``layers.ParamTree`` (and the ResNet and ViT modules' own draws).

**A spec is resolved on the reference's dims**, not on the port's.  The
port merges dims (``wq`` (d, H, Dh) is ``(H·Dh, d)`` here), and the
reference decides divisibility per logical dim: qwen's 40 heads on a
16-wide model axis are replicated, where the merged 5,120 would divide.
So a spec is a tuple with one entry per reference dim (a mesh axis, a
tuple of mesh axes, or None), as the reference's ``PartitionSpec`` is;
``port_spec`` then maps it onto the port's layout.  A stacked layer's
leading ``layers`` dim is not in the view: the port holds each layer as
its own tensors, the rules never shard ``layers``, and FSDP picks no
``layers`` dim for any arch on the production meshes
(``tests/test_torch_sharding.py`` holds all three to the reference).
"""
from __future__ import annotations

import math
import torch

from repro_torch.models.layers import Leaf

Spec = tuple  # one entry per reference dim: a mesh axis, a tuple of them, or None


def tree_struct(leaves: dict[str, Leaf], dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """{name: meta tensor}: each leaf's port shape, in float32 for a
    float32 leaf and in ``dtype`` otherwise."""
    return {k: torch.empty(l.shape, dtype=torch.float32 if l.f32 else dtype, device="meta")
            for k, l in leaves.items()}


def leaf_pspec(l: Leaf, rules: dict) -> Spec:
    """The reference's ``tree_pspec`` of one leaf: each reference dim's
    logical axis through ``rules``; a mesh axis already used by an earlier
    dim, or whose size (``rules["_sizes"]``) does not divide the dim, is
    dropped (replicated)."""
    sizes = rules.get("_sizes", {})
    spec, used = [], set()
    for dim, ax in l.ref:
        mesh_ax = rules.get(ax) if ax else None
        if mesh_ax is None or mesh_ax in used or dim % max(sizes.get(mesh_ax, 1), 1) != 0:
            spec.append(None)
        else:
            spec.append(mesh_ax)
            used.add(mesh_ax)
    return tuple(spec)


def tree_pspec(leaves: dict[str, Leaf], rules: dict) -> dict[str, Spec]:
    """{name: spec on the reference's dims} under ``rules``."""
    return {k: leaf_pspec(l, rules) for k, l in leaves.items()}


def port_spec(l: Leaf, spec: Spec) -> tuple[tuple[int, ...], Spec]:
    """``spec`` (on the reference's dims) on the port's layout: (a view
    shape of the port's tensor, one spec entry per view dim).

    A port dim that merges reference dims shards as its outermost one
    does, so where only that one is sharded the view is the port's own
    shape (``wq`` (H·Dh, d) sharded on H).  Where a sharded reference dim
    is not the outermost of its port dim, the view splits the port dim in
    front of it: ``wqkv`` (3·H·Dh, d) with H sharded is viewed as (3,
    H·Dh, d), sharded on its dim 1, since sharding the merged dim would
    split the 3 of q, k and v instead of the heads; ``bqkv`` likewise as
    (3, H·Dh)."""
    sizes = [n for n, _ in l.ref]
    view, out = [], []
    for group in l.order:
        seg = [group[0]]
        for i in group[1:]:
            if spec[i] is not None:
                view.append(math.prod(sizes[j] for j in seg))
                out.append(spec[seg[0]])
                seg = []
            seg.append(i)
        view.append(math.prod(sizes[j] for j in seg))
        out.append(spec[seg[0]])
    return tuple(view), tuple(out)


def spec_shards(spec: Spec, sizes: dict[str, int]) -> int:
    """How many pieces ``spec`` cuts a tensor into on a mesh of ``sizes``."""
    n = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                n *= sizes.get(a, 1)
    return n


def bytes_per_chip(structs: dict[str, torch.Tensor], specs: dict[str, Spec], sizes: dict[str, int]) -> int:
    """Bytes one chip holds of ``structs`` sharded by ``specs``."""
    return sum(t.numel() * t.element_size() // spec_shards(specs[k], sizes) for k, t in structs.items())


def tree_bytes(leaves: dict[str, Leaf], bytes_per_el: int = 2) -> int:
    return sum(math.prod(l.shape) * bytes_per_el for l in leaves.values())


def tree_count(leaves: dict[str, Leaf]) -> int:
    return sum(math.prod(l.shape) for l in leaves.values())
