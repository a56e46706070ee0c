"""CUDA wrapper for the fused softmax-max -> Platt -> gate kernel.

Replaces the Pallas TPU kernel ``repro/kernels/fused_calib_gate/kernel.py``
(``calib_gate``).  The kernel (``csrc/calib_gate.cu``) is memory-bound: its
least time is B·V·elem bytes / 3.35 TB/s, and at the serving shape
(B=16, V=1000) it is bound by the launch and one memory round trip.  Each
thread issues its 16-byte loads before it uses any; a wide row is split
over a thread-block cluster whose blocks merge through distributed shared
memory (``split_plan``).  It is built by ``nvcc`` for ``sm_90a`` on first
use (``kernels/build.py``).

``calib_gate`` takes contiguous 2-D float32, bfloat16 or float16 CUDA
tensors, as the TPU kernel takes any float logits, and raises on anything
else: a CUDA tensor never takes the plain version, and a CPU tensor never
reaches here (``ops.calibrated_gate`` dispatches).  A call is one launch,
with no workspace and no state on the card, so calls may run at once on
two streams and a call can be captured in a CUDA graph.
Under autograd (grad enabled and a float input that requires grad) it
raises: the kernel has no backward (``kernels.forbid_autograd``).
``calib_gate.launches`` counts launches, and only launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.build import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "calib_gate.cu",
    {"calib_gate_launch": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, _I,
                           _F, _F, _F, _P],
     "calib_gate_max_clusters": [_I, _I, _I, _I, ctypes.POINTER(_I)]},
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# as in the kernel
VEC_BYTES = 16  # one vector load
MAX_SPLITS = 16  # blocks a row, one cluster
MAX_THREADS = 512  # a block
VPTS = (1, 2, 4, 8)  # vectors a thread a chunk
# the plan's choices
MIN_SPLIT_BYTES = 8192  # a row is split only while each block still reads this much
LONG_CHUNK_ELEMS = 16  # a thread's chunk where a slice takes many chunks


class SplitPlan(NamedTuple):
    splits: int  # blocks a row, one cluster
    threads: int  # a block
    vpt: int  # 16-byte vectors a thread loads before it uses any


def split_plan(B: int, V: int, elem_bytes: int, n_sms: int,
               max_clusters: Optional[Callable[[SplitPlan], int]] = None, *,
               splits: Optional[int] = None, vpt: Optional[int] = None) -> SplitPlan:
    """Blocks a row, threads a block and vectors a thread for (B, V) logits
    of ``elem_bytes`` on ``n_sms`` SMs.

    A row is split in two while the rows' blocks still fit in one wave (one
    block a SM) and each block still reads ``MIN_SPLIT_BYTES``, at most 16
    ways.  A block takes the fewest vectors a thread that cover its slice
    in one chunk with at most 512 threads, and as many threads as that
    needs; a slice too long for that takes ``LONG_CHUNK_ELEMS`` elements a
    thread a chunk and 512 threads.  ``max_clusters(plan)``, where given,
    says how many clusters of the plan fit on the card at once; while fewer
    than B fit (a cluster of 16 must fit in one GPC), the split is halved.
    ``splits`` and ``vpt`` force those choices (for measurements and
    tests)."""
    row_bytes = V * elem_bytes
    row_vecs = -(-row_bytes // VEC_BYTES)
    s = splits
    if s is None:
        s = 1
        while s < MAX_SPLITS and 2 * s * B <= n_sms and row_bytes >= 2 * s * MIN_SPLIT_BYTES:
            s *= 2
    while True:
        slice_vecs = -(-row_vecs // s)
        v = vpt or next((n for n in VPTS if slice_vecs <= MAX_THREADS * n),
                        LONG_CHUNK_ELEMS * elem_bytes // VEC_BYTES)
        plan = SplitPlan(s, max(32, min(MAX_THREADS, -(-slice_vecs // (32 * v)) * 32)), v)
        if splits is not None or s == 1 or max_clusters is None or max_clusters(plan) >= B:
            return plan
        s //= 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def max_clusters(index: int, dtype: torch.dtype, plan: SplitPlan) -> int:
    """Clusters of ``plan`` resident at once on CUDA device ``index``."""
    out = _I()
    with torch.cuda.device(index):
        err = LIBRARY.load().calib_gate_max_clusters(DTYPES[dtype], plan.vpt, plan.splits,
                                                      plan.threads, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"calib_gate_max_clusters failed with cudaError {err}")
    return out.value


def plan_for(logits: torch.Tensor) -> SplitPlan:
    """The launch plan of ``calib_gate`` for these CUDA logits."""
    B, V = logits.shape
    index = logits.device.index
    return split_plan(B, V, logits.element_size(), _sm_count(index),
                      functools.partial(max_clusters, index, logits.dtype))


def calib_gate(logits: torch.Tensor, a: float, b: float, theta: float):
    """logits (B, V) f32, bf16 or f16 on CUDA -> (calibrated conf (B,) f32, gate (B,) bool)."""
    forbid_autograd("calib_gate", logits)
    if not logits.is_cuda:
        raise ValueError(f"calib_gate launches a CUDA kernel; got a tensor on {logits.device}")
    if logits.dtype not in DTYPES:
        raise TypeError(f"calib_gate takes float32, bfloat16 or float16 logits, got {logits.dtype}")
    if logits.ndim != 2 or logits.shape[1] < 1:
        raise ValueError(f"calib_gate takes (B, V>=1) logits, got shape {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("calib_gate takes contiguous logits")
    B, V = logits.shape
    calib = torch.empty(B, dtype=torch.float32, device=logits.device)
    gate = torch.empty(B, dtype=torch.bool, device=logits.device)
    if B == 0:
        return calib, gate
    plan = plan_for(logits)
    lib = LIBRARY.load()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.calib_gate_launch(logits.data_ptr(), calib.data_ptr(), gate.data_ptr(), B, V,
                                    DTYPES[logits.dtype], plan.splits, plan.threads, plan.vpt,
                                    float(a), float(b), float(theta), stream)
    if err != 0:
        raise RuntimeError(f"calib_gate launch failed with cudaError {err}")
    calib_gate.launches += 1
    return calib, gate


calib_gate.launches = 0
