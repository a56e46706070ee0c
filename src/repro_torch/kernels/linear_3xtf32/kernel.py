"""CUDA wrapper for the 3xTF32 dense product: ``y = x·Wᵀ + b`` in f32 on
the tensor cores.

A port-only kernel: the JAX package leaves dense products to XLA, so there
is no Pallas kernel to port.  The kernel (``csrc/linear_3xtf32.cu``) is
bound by operations at the port's shapes: three TF32 products a product,
3 · 2·M·N·K at 494.7 TFLOP/s (bytes bound only at a handful of rows).  A
producer warp keeps TMA loads of x's and W's tiles in flight through a ring
of shared-memory stages; warps that give up their registers split each W
tile into TF32 halves in shared memory; two warpgroups split their x
fragments in registers and run ``wgmma`` (A from registers, W from shared
memory), 12 a stage of 32.  ``tile_plan`` picks the block's width BN from
M and N.  It is built by ``nvcc`` for ``sm_90a`` on first use
(``kernels/build.py``).

``linear_3xtf32`` takes f32 CUDA tensors: x (M, K) with unit inner stride,
a row stride and base that TMA can address (multiples of 16 bytes), w
(N, K) contiguous, b (N,) contiguous or None, with M, N, K >= 1 and N and K
multiples of 4; it raises on anything else, and never falls back to
another path.  Its output matches ``ref.linear_3xtf32_ref`` to the f32
rounding of the sums.  A call is one launch, with no workspace, so calls
may run at once on two streams and a call can be captured in a CUDA graph.
Under autograd (grad enabled and an input that requires grad) it raises:
the kernel has no backward (``kernels.forbid_autograd``).
``linear_3xtf32.launches`` counts launches, and only launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.build import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "linear_3xtf32.cu",
    {"linear_3xtf32_launch": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _P],
     "linear_3xtf32_plan": [_I, ctypes.POINTER(_I)]},
)
BM = 128  # output rows a block, as in the kernel
BK = 32  # f32 of K a stage
BNS = (64, 96, 128, 160)  # the kernel's block widths
# a block's fixed cost a tile in columns' worth of work: loading and
# splitting x's fragments, the ring's fill, the epilogue
TILE_OVERHEAD = 32
MAX_DIM = 2**31 - 1
F32 = torch.float32


class KernelPlan(NamedTuple):
    """What ``linear_3xtf32_plan`` reports for one instantiation."""
    bm: int
    bn: int
    bk: int
    stages: int
    threads: int
    smem_bytes: int  # dynamic shared memory a block
    registers: int  # a thread at launch (the warpgroups then trade them with setmaxnreg)
    local_bytes: int  # local memory a thread (spills)
    blocks_per_sm: int  # resident blocks a SM, from the occupancy calculator


def n_tiles(M: int, N: int, bn: int) -> int:
    return -(-M // BM) * -(-N // bn)


@functools.lru_cache(maxsize=4096)
def tile_plan(M: int, N: int, n_sms: int) -> int:
    """The block width BN for an (M, ·) x (·, N) product on a card of
    ``n_sms`` SMs, one block a SM: the width whose waves of blocks,
    each costing its width plus ``TILE_OVERHEAD``, take the least time;
    the wider on a tie.  On an H100 at DINOv3 ViT-H+'s products at ~2,000
    rows that is 160 (N = 1,280 in one wave of 128 blocks, not 1.2 waves
    of 128 x 128)."""
    def cost(bn):
        return -(-n_tiles(M, N, bn) // n_sms) * (bn + TILE_OVERHEAD)

    return min(reversed(BNS), key=cost)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def launch_plan(index: int, bn: int) -> KernelPlan:
    """The kernel's configuration on CUDA device ``index`` for width
    ``bn``: tile, ring, registers, shared memory and resident blocks a SM."""
    result = (_I * 9)()
    with torch.cuda.device(index):
        err = LIBRARY.load().linear_3xtf32_plan(bn, result)
    if err != 0:
        raise RuntimeError(f"linear_3xtf32_plan failed with cudaError {err}")
    plan = KernelPlan(*result)
    if (plan.bm, plan.bn, plan.bk) != (BM, bn, BK):
        raise RuntimeError(f"linear_3xtf32: the kernel reports {plan}, the wrapper plans BM {BM}, BN {bn}, BK {BK}")
    return plan


def _refuse(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take (``linear_3xtf32`` calls it
    only where ``takes`` is false)."""
    forbid_autograd("linear_3xtf32", x, w, b)
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"linear_3xtf32 launches a CUDA kernel; got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"linear_3xtf32: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"linear_3xtf32 takes float32 tensors; {name} is {t.dtype}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"linear_3xtf32 takes x (M, K) and w (N, K), got {tuple(x.shape)} and {tuple(w.shape)}")
    (M, K), N = x.shape, w.shape[0]
    if b is not None and (b.shape != (N,) or not b.is_contiguous()):
        raise ValueError(f"linear_3xtf32 takes a contiguous ({N},) bias, got {tuple(b.shape)}")
    if min(M, N, K) < 1 or max(M, N, K) > MAX_DIM:
        raise ValueError(f"linear_3xtf32 takes 1 <= M, N, K < 2^31, got M={M}, N={N}, K={K}")
    if N % 4 or K % 4:
        raise ValueError(f"linear_3xtf32 takes N and K that are multiples of 4 (TMA's 16-byte strides),"
                         f" got N={N}, K={K}")
    if not w.is_contiguous():
        raise ValueError("linear_3xtf32 takes a contiguous w")
    raise ValueError(f"linear_3xtf32 takes rows of x with unit inner stride, a row stride that is a multiple"
                     f" of 4 and 16-byte aligned bases; got strides {x.stride()}")


def takes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> bool:
    """Whether the kernel takes these operands as they lie: everything
    ``_refuse`` checks, in one pass (a launch's host path is part of a
    host-bound tier's time), with x (..., K) either (M, K) with a row
    stride TMA can address or contiguous of any rank, its rows then read
    in place as one (M, K) matrix."""
    if x.dtype != F32 or w.dtype != F32 or not x.is_cuda or x.ndim < 2 or w.ndim != 2:
        return False
    K, (N, Kw) = x.shape[-1], w.shape
    index = x.get_device()
    if (Kw != K or w.get_device() != index or not 1 <= N <= MAX_DIM or not 1 <= K <= MAX_DIM
            or not 1 <= x.numel() // K <= MAX_DIM or N % 4 or K % 4 or not w.is_contiguous() or w.data_ptr() % 16
            or x.data_ptr() % 16):
        return False
    if x.ndim == 2:
        ld, inner = x.stride()
        if inner != 1 or ld % 4 or ld < K:
            return False
    elif not x.is_contiguous():
        return False
    if b is not None and (b.dtype != F32 or b.get_device() != index or b.shape != (N,) or not b.is_contiguous()):
        return False
    return not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                             or (b is not None and b.requires_grad)))


def linear_3xtf32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                  bn: int | None = None) -> torch.Tensor:
    """x (M, K), w (N, K), b (N,) or None, f32 on CUDA -> (M, N) f32.
    ``bn`` overrides ``tile_plan``'s width (for timing the plans)."""
    if x.ndim != 2 or not takes(x, w, b):
        _refuse(x, w, b)
    return launch(x, w, b, bn)


def launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, bn: int | None = None) -> torch.Tensor:
    """``linear_3xtf32`` on operands that ``takes`` has admitted: x
    (..., K) -> (..., N), x's rows read in place (no view of them made)."""
    K, N = x.shape[-1], w.shape[0]
    M = x.numel() // K
    index = x.get_device()
    bn = tile_plan(M, N, _sm_count(index)) if bn is None else bn
    if bn not in BNS:
        raise ValueError(f"linear_3xtf32 has block widths {BNS}, got {bn}")
    out = x.new_empty(x.shape[:-1] + (N,))
    # the device's current stream as a raw handle (0.1 us; current_stream()
    # and a device context took 15 us a call on the card's host, against
    # F.linear's 20 us whole); the launch makes x's device current itself
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = _launch()(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
                    M, N, K, x.stride(0) if x.ndim == 2 else K, bn, index, stream)
    if err != 0:
        raise RuntimeError(f"linear_3xtf32 launch failed with cudaError {err}")
    linear_3xtf32.launches += 1
    return out


linear_3xtf32.launches = 0


@functools.lru_cache(maxsize=None)
def _launch():
    """The library's launch function, built and bound at first use."""
    return LIBRARY.load().linear_3xtf32_launch
