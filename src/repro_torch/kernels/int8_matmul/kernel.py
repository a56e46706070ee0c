"""CUDA wrapper for the W8A8 int8 matmul kernel.

Replaces the Pallas TPU kernel ``repro/kernels/int8_matmul/kernel.py``
(``int8_matmul``).  The kernel (``csrc/int8_matmul.cu``) multiplies on the
int8 tensor cores (``mma.sync`` s8·s8→s32) and applies the dequant
epilogue ``acc · x_scale · w_scale`` in float32.  K streams in 64-byte
tiles through a ring of ``cp.async`` stages; B's fragments are built in
registers from its row-major staging (no transpose pass); the output is
stored 16 bytes at a time.  At large shapes it is bound by operations
(2·M·N·K at 1,979 TOP/s), at the serving sweep's small M by bytes and,
in practice, by memory round trips and L2 traffic, so ``tile_plan`` picks
the smallest of three block tiles that still gives few blocks a SM.  One
block walks the whole of K for its tile: K is not split.  It is built by
``nvcc`` for ``sm_90a`` on first use (``kernels/build.py``).

``int8_matmul`` takes contiguous int8 CUDA operands and float32 scales of
shapes (M, 1) or (M,) and (1, N) or (N,), any M, N >= 1 and K >= 0, and
raises on anything else: a CUDA tensor never takes the plain version, and
a CPU tensor never reaches here (``ops`` dispatches).  Operands whose rows
are not 16-byte aligned take the kernel's byte-load copies.
``int8_matmul_acc`` returns the raw int32 accumulator, so a check can hold
the integer product itself to the plain version.  Under autograd (grad
enabled and a float input that requires grad) either raises: the kernel
has no backward (``kernels.forbid_autograd``).  ``int8_matmul.launches``
counts launches of the kernel by either function, and only launches.

A call allocates only its output.  Nothing in a call waits on the card,
so after one warm-up call at a shape the call can be captured in a CUDA
graph.
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
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "int8_matmul.cu",
    {"int8_matmul_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
     "int8_matmul_plan": [_I, _I, _I, ctypes.POINTER(_I)]},
)
MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
BK = 64  # bytes of K a tile, as in the kernel
STAGES = 4  # K tiles in the kernel's cp.async ring
# tile_plan takes a small tile while its blocks number at most this many a SM
SMALL_TILE_BLOCKS_A_SM = 2


class TileConfig(NamedTuple):
    """One of the kernel's block tiles."""
    name: str
    bm: int  # output rows a block
    bn: int  # output columns a block
    threads: int


# as the kernel's Tile128x128, Tile32x64, Tile16x32, by index; byte-load
# copies: the last
CONFIGS = (TileConfig("128x128", 128, 128, 256),
           TileConfig("32x64", 32, 64, 128),
           TileConfig("16x32", 16, 32, 64))
NARROW = 2


class TilePlan(NamedTuple):
    """How one call is cut: block tile and grid, one block an output tile."""
    config: int  # index into CONFIGS
    bm: int
    bn: int
    n_tiles: int  # output tiles


class KernelPlan(NamedTuple):
    """What ``int8_matmul_plan`` reports for one instantiation."""
    bm: int
    bn: int
    bk: int
    stages: int
    threads: int
    smem_bytes: int  # dynamic shared memory a block
    registers: int  # a thread
    local_bytes: int  # local memory a thread (spills)
    blocks_per_sm: int  # resident blocks a SM, from the occupancy calculator


@functools.lru_cache(maxsize=4096)
def tile_plan(M: int, N: int, K: int, n_sms: int, aligned: bool = True) -> TilePlan:
    """The block tile for an (M, K) x (K, N) product on a card of
    ``n_sms`` SMs: 16 x 32, else 32 x 64, whichever first gives at most
    ``SMALL_TILE_BLOCKS_A_SM`` blocks a SM, else 128 x 128.  On an H100
    that is 16 x 32 at the f(batch) sweep's M <= 256 (the shortest chain),
    32 x 64 at M = 512 and 1024 (16 x 32 tiles there re-read A and B 16-32
    times through L2) and 128 x 128 at ``bench_kernels``'s and DeiT-B's
    shapes: the fastest tile measured at each of these shapes but the
    sweep's M = 256, where 32 x 64 was 0.03 us faster (PERF.md §6).
    Operands that are not 16-byte aligned (``aligned=False``) take the
    16 x 32 tile, the one with byte-load copies.  K does not enter the
    choice: every block walks the whole of K."""
    def tiles(c):
        return -(-M // CONFIGS[c].bm) * -(-N // CONFIGS[c].bn)

    c = NARROW if not aligned else next(
        (c for c in (NARROW, 1) if tiles(c) <= SMALL_TILE_BLOCKS_A_SM * n_sms), 0)
    cfg = CONFIGS[c]
    return TilePlan(c, cfg.bm, cfg.bn, tiles(c))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def launch_plan(index: int, config: int, mode: int = 0, vec: bool = True) -> KernelPlan:
    """The kernel's configuration on CUDA device ``index`` for block tile
    ``config``, output ``mode`` and copy width: tile, ring, registers,
    shared memory and resident blocks a SM."""
    result = (_I * 9)()
    with torch.cuda.device(index):
        err = LIBRARY.load().int8_matmul_plan(config, mode, int(vec), result)
    if err != 0:
        raise RuntimeError(f"int8_matmul_plan failed with cudaError {err}")
    plan = KernelPlan(*result)
    cfg = CONFIGS[config]
    if (plan.bm, plan.bn, plan.bk, plan.stages, plan.threads) != (cfg.bm, cfg.bn, BK, STAGES, cfg.threads):
        raise RuntimeError(f"int8_matmul: the kernel reports {plan}, the wrapper plans {cfg}, BK {BK}")
    return plan


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"int8_matmul launches a CUDA kernel; got {name} on {t.device}")
    if t.device != device:
        raise ValueError(f"int8_matmul: {name} on {t.device}, x_q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"int8_matmul: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"int8_matmul takes contiguous operands; {name} is not")


def _check_scale(name: str, s: torch.Tensor, device, shapes) -> None:
    _check_operand(name, s, torch.float32, device)
    if tuple(s.shape) not in shapes:
        raise ValueError(f"int8_matmul: {name} has shape {tuple(s.shape)}, expected one of {shapes}")


def _launch(x_q, x_scale, w_q, w_scale, mode: int, out_dtype: torch.dtype) -> torch.Tensor:
    forbid_autograd("int8_matmul", x_q, x_scale, w_q, w_scale)
    _check_operand("x_q", x_q, torch.int8, x_q.device)
    _check_operand("w_q", w_q, torch.int8, x_q.device)
    if x_q.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"int8_matmul takes 2-D operands, got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    M, K = x_q.shape
    K2, N = w_q.shape
    if K != K2:
        raise ValueError(f"int8_matmul: x_q {tuple(x_q.shape)} and w_q {tuple(w_q.shape)} differ in K")
    if mode != MODES[torch.int32]:
        _check_scale("x_scale", x_scale, x_q.device, ((M, 1), (M,)))
        _check_scale("w_scale", w_scale, x_q.device, ((1, N), (N,)))
    if max(M, N, K) > 2**31 - 1:
        raise ValueError(f"int8_matmul: M={M}, N={N}, K={K} past the kernel's 32-bit sizes")
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    aligned = (K % 16 == 0 and N % 16 == 0 and x_q.data_ptr() % 16 == 0
               and w_q.data_ptr() % 16 == 0)
    vec_out = int(N % (16 // out.element_size()) == 0 and out.data_ptr() % 16 == 0)
    index = x_q.device.index
    plan = tile_plan(M, N, K, _sm_count(index), aligned)
    if plan.n_tiles > 2**31 - 1:
        raise ValueError(f"int8_matmul: {plan.n_tiles} output tiles for M={M}, N={N}")
    launch_plan(index, plan.config, mode, aligned)
    xs = None if x_scale is None else x_scale.data_ptr()
    ws = None if w_scale is None else w_scale.data_ptr()
    lib = LIBRARY.load()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        err = lib.int8_matmul_launch(x_q.data_ptr(), xs, w_q.data_ptr(), ws, out.data_ptr(), mode, M, N,
                                     K, plan.config, int(aligned), vec_out, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed with cudaError {err}")
    int8_matmul.launches += 1
    return out


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, *, out_dtype=torch.float32) -> torch.Tensor:
    """x_q (M,K) int8, x_scale (M,1) f32, w_q (K,N) int8, w_scale (1,N) f32
    on CUDA -> (M,N) in ``out_dtype`` (float32 or bfloat16)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul writes float32 or bfloat16, got {out_dtype}")
    return _launch(x_q, x_scale, w_q, w_scale, MODES[out_dtype], out_dtype)


def int8_matmul_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The kernel's raw int32 accumulator: (M,K) int8 × (K,N) int8 on CUDA -> (M,N) int32."""
    return _launch(x_q, None, w_q, None, MODES[torch.int32], torch.int32)


int8_matmul.launches = 0
