"""CUDA wrapper for the W8A8 int8 matmul kernel.

Replaces the Pallas TPU kernel ``repro/kernels/int8_matmul/kernel.py``
(``int8_matmul``).  The kernel (``csrc/int8_matmul.cu``) multiplies on the
int8 tensor cores (``mma.sync`` s8·s8→s32) and applies the dequant
epilogue ``acc · x_scale · w_scale`` in float32.  At large shapes it is
bound by operations (2·M·N·K at 1,979 TOP/s), at the serving sweep's small
M by bytes.  It is built by ``nvcc`` for ``sm_90a`` on first use
(``kernels/build.py``).

``int8_matmul`` takes contiguous int8 CUDA operands and float32 scales of
shapes (M, 1) or (M,) and (1, N) or (N,), and raises on anything else: a
CUDA tensor never takes the plain version, and a CPU tensor never reaches
here (``ops`` dispatches).  ``int8_matmul_acc`` returns the raw int32
accumulator, so a check can hold the integer product itself to the plain
version.  ``int8_matmul.launches`` counts launches of the kernel by either
function, and only launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "int8_matmul.cu",
    {"int8_matmul_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
)
MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
BLOCK_M = 64  # output rows per block, as in the kernel


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
    if -(-M // BLOCK_M) > 65535 or max(M, N, K) > 2**31 - 1:
        raise ValueError(f"int8_matmul: grid too large for M={M}, N={N}, K={K}")
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    vec_a = int(K % 16 == 0 and x_q.data_ptr() % 16 == 0)
    vec_b = int(N % 16 == 0 and w_q.data_ptr() % 16 == 0)
    xs = 0 if x_scale is None else x_scale.data_ptr()
    ws = 0 if w_scale is None else w_scale.data_ptr()
    lib = LIBRARY.load()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        err = lib.int8_matmul_launch(x_q.data_ptr(), xs, w_q.data_ptr(), ws, out.data_ptr(),
                                     mode, M, N, K, vec_a, vec_b, stream)
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
