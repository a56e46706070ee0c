"""Roofline accounting for one NVIDIA H100 (port of
``repro.launch.roofline``).

Hardware model: H100 SXM, from NVIDIA's datasheet: 989 TFLOP/s dense bf16
and 1,979 TOPS dense int8 on the tensor cores, 3.35 TB/s of HBM3, and
NVLink 4's 900 GB/s a GPU both ways (450 GB/s each way) for the link
term.  HBM capacity is the card's own (``hbm_bytes``).  The reference's
constants are TPU v5e figures; none of them is used here.

In place of XLA's ``cost_analysis()`` the port counts a step with
``CostCounter``, op by op, on ``meta`` tensors (a FULL cell costs no
memory) or on the card.  XLA's SPMD partitioner has no counterpart, so
there are no collective bytes: a record leaves the collective term at 0
and says so, and per-chip numbers are the global ones over the chips.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kernel_cost

PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_INT8 = 1979e12
HBM_BW = 3.35e12
LINK_BW = 450e9  # NVLink 4, one direction
HBM_BYTES_NOMINAL = 80e9  # the H100 SXM's 80 GB

# allocations that read and write nothing
_ALLOC = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
          torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def hbm_bytes() -> float:
    """The card's memory where there is one, else the H100 SXM's 80 GB."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES_NOMINAL


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class CostCounter(TorchDispatchMode):
    """FLOPs and bytes of the aten ops run under it, on any device.

    * FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
      convolutions and their backwards, SDPA); other ops count 0, as
      ``FlopCounterMode`` counts them.
    * Bytes: for each op that is not a view or a bare allocation, the
      bytes of its distinct tensor inputs and outputs (an in-place op's
      tensor once): the memory traffic of the step run eagerly, op by op,
      with nothing fused.
    * A hand-written kernel's call is reported by its dispatcher
      (``kernels/cost.py``), by its formula, on ``cuda`` and ``meta``
      alike; the aten ops inside the call are not counted.

    ``per_kernel`` holds each kernel's (calls, flops, bytes).

    An op on ``meta`` tensors whose inputs repeat an earlier call's
    metadata (shapes, strides, dtypes and every other argument) is not run
    again: its counts are added again and its outputs made afresh as empty
    meta tensors of the first call's shapes and strides (an in-place op
    returns its input, as it did).  A meta op's outputs depend on nothing
    else, so the counts are the same; a FULL cell's many alike layers and
    optimizer updates then cost one run each.  Views, ops on tensors of
    any other device and ops with no tensor input always run."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.paused = 0
        self.per_kernel: dict[str, list] = defaultdict(lambda: [0, 0, 0])
        self.memo: dict = {}

    def add_kernel(self, name: str, flops: int, n_bytes: int) -> None:
        if self.paused:
            return
        self.flops += flops
        self.bytes += n_bytes
        row = self.per_kernel[name]
        row[0] += 1
        row[1] += flops
        row[2] += n_bytes

    def __enter__(self):
        kernel_cost.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _cost(self, func, args, kwargs, out) -> tuple[int, int]:
        packet = func._overloadpacket
        flops = int(flop_registry[packet](*args, **kwargs, out_val=out)) if packet in flop_registry else 0
        n_bytes = 0
        if not func.is_view and packet not in _ALLOC:
            seen = {id(t): t for t in _tensors((args, kwargs, out))}
            n_bytes = sum(t.numel() * t.element_size() for t in seen.values())
        return flops, n_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        if not self.paused and not func.is_view:
            key = _memo_key(func, args, kwargs)
            hit = self.memo.get(key) if key is not None else None
            if hit is not None:
                desc, flops, n_bytes = hit
                self.flops += flops
                self.bytes += n_bytes
                return args[0] if desc == "self" else _rebuild(desc)
        out = func(*args, **kwargs)
        if self.paused:
            return out
        flops, n_bytes = self._cost(func, args, kwargs, out)
        self.flops += flops
        self.bytes += n_bytes
        if key is not None:
            desc = _describe(func, args, out)
            if desc is not None:
                self.memo[key] = (desc, flops, n_bytes)
        return out


def _sig(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError
        return ("T", tuple(x.shape), x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y) for y in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _sig(v)) for k, v in x.items()))
    hash(x)
    return x


def _memo_key(func, args, kwargs):
    """The op and its arguments' metadata, or None where there is no tensor
    among them, or one is not a meta tensor or not hashable."""
    try:
        key = func, _sig(args), _sig(kwargs)
    except TypeError:
        return None
    return key if any(True for _ in _tensors((args, kwargs))) else None


def _describe(func, args, out):
    """How to make ``out`` again: "self" for an in-place op that returned
    its first argument, the shapes, strides and dtypes of fresh outputs,
    or None (not memoised) for anything else."""
    if func._schema.is_mutable:
        return "self" if args and out is args[0] else None
    ids = {id(t) for t in _tensors(args)}

    def one(x):
        if isinstance(x, torch.Tensor):
            if id(x) in ids or x.storage_offset():
                raise TypeError
            return ("T", tuple(x.shape), x.stride(), x.dtype)
        if isinstance(x, (list, tuple)):
            return (type(x).__name__,) + tuple(one(y) for y in x)
        raise TypeError

    try:
        return one(out)
    except TypeError:
        return None


def _rebuild(desc):
    if desc[0] == "T":
        _, shape, stride, dtype = desc
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    items = [_rebuild(d) for d in desc[1:]]
    return tuple(items) if desc[0] == "tuple" else items


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def fraction_of_roofline(self) -> float:
        """useful-time / bound-time if perfectly overlapped = compute/bound."""
        return self.compute_s / max(self.bound_s, 1e-30)


def roofline_terms(flops: float, bytes_: float, coll_bytes: float, *, peak=PEAK_FLOPS_BF16) -> Roofline:
    return Roofline(flops / peak, bytes_ / HBM_BW, coll_bytes / LINK_BW)


def model_flops(family: str, kind: str, *, n_active: int, tokens: int = 0, batch: int = 0,
                decode_attn: float = 0.0) -> float:
    """The 'useful FLOPs' convention:
      LM train: 6·N·tokens; prefill: 2·N·tokens (+causal attn not counted);
      decode:   2·N·batch + explicit attention term (dominates at 32k);
      vision/diffusion: 2·N·batch fwd, 6·N·batch train (conv reuse makes the
      counted/model ratio > 1 by design — reported, not hidden).
    """
    if family in ("lm", "moe-lm"):
        if kind == "train":
            return 6.0 * n_active * tokens
        if kind == "prefill":
            return 2.0 * n_active * tokens
        return 2.0 * n_active * batch + decode_attn
    return (6.0 if kind == "train" else 2.0) * n_active * batch
