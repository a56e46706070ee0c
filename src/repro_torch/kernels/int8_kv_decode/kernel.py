"""CUDA wrapper for the int8-KV flash-decode kernel.

Replaces the Pallas TPU kernel ``repro/kernels/int8_kv_decode/kernel.py``
(``int8_kv_decode``).  The kernel (``csrc/int8_kv_decode.cu``) reads the
int8 cache in place, folds the per-token K scale into the scores and the
V scale into the probabilities, and splits the sequence across blocks
(flash-decode's split-K) with a second small kernel merging the splits.
It is bound by bytes: about 8 operations per cache byte at G = 4.  It is
built by ``nvcc`` for ``sm_90a`` on first use (``kernels/build.py``).

``int8_kv_decode`` takes a contiguous float32 or bfloat16 q (B, H, D),
contiguous int8 caches (B, S, KH, D) and contiguous float32 scales (B, S),
all on one CUDA device, with D a multiple of 16 up to 256 and G = H/KH
at most 8; it raises on anything else.  A CUDA tensor never takes the
plain version, and a CPU tensor never reaches here (``ops`` dispatches).
``int8_kv_decode.launches`` counts launches, and only launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "int8_kv_decode.cu",
    {"int8_kv_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P]},
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 128  # tokens per shared-memory tile, as in the kernel
MAX_D = 256
MAX_G = 8
BLOCKS_PER_SM = 4  # split S until the grid holds about this many blocks per SM


def split_plan(n_heads_kv: int, S: int, n_sms: int) -> tuple[int, int]:
    """(n_splits, tiles_per_split) for ``n_heads_kv`` = B·KH sequences of S
    tokens: split the 128-token tiles until the grid has about
    ``BLOCKS_PER_SM`` blocks per SM, never leaving a split empty."""
    n_tiles = -(-S // TILE)
    want = max(1, min(n_tiles, -(-BLOCKS_PER_SM * n_sms // n_heads_kv)))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k_q, k_s, v_q, v_s) -> None:
    for name, t in (("q", q), ("k_q", k_q), ("k_s", k_s), ("v_q", v_q), ("v_s", v_s)):
        if not t.is_cuda:
            raise ValueError(f"int8_kv_decode launches a CUDA kernel; got {name} on {t.device}")
        if t.device != q.device:
            raise ValueError(f"int8_kv_decode: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_kv_decode takes contiguous tensors; {name} is not")
    if q.dtype not in DTYPES:
        raise TypeError(f"int8_kv_decode takes a float32 or bfloat16 q, got {q.dtype}")
    for name, t, dtype in (("k_q", k_q, torch.int8), ("v_q", v_q, torch.int8),
                           ("k_s", k_s, torch.float32), ("v_s", v_s, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"int8_kv_decode: {name} must be {dtype}, got {t.dtype}")
    if q.ndim != 3 or k_q.ndim != 4:
        raise ValueError(f"int8_kv_decode takes q (B, H, D) and caches (B, S, KH, D);"
                         f" got {tuple(q.shape)} and {tuple(k_q.shape)}")
    B, H, D = q.shape
    _, S, KH, _ = k_q.shape
    if v_q.shape != k_q.shape or k_q.shape[0] != B or k_q.shape[3] != D:
        raise ValueError(f"int8_kv_decode: q {tuple(q.shape)}, k_q {tuple(k_q.shape)},"
                         f" v_q {tuple(v_q.shape)} do not agree in B or D")
    if k_s.shape != (B, S) or v_s.shape != (B, S):
        raise ValueError(f"int8_kv_decode: scales {tuple(k_s.shape)}, {tuple(v_s.shape)},"
                         f" expected {(B, S)}")
    if S < 1 or KH < 1 or H % KH != 0 or H // KH > MAX_G:
        raise ValueError(f"int8_kv_decode takes S >= 1 and H = G·KH with G <= {MAX_G};"
                         f" got S {S}, H {H}, KH {KH}")
    if D % 16 != 0 or not 16 <= D <= MAX_D:
        raise ValueError(f"int8_kv_decode takes head dims that are multiples of 16 up to {MAX_D}, got {D}")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("int8_kv_decode reads the caches 16 bytes at a time; they must be 16-byte aligned")


def int8_kv_decode(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor, v_q: torch.Tensor,
                   v_s: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); k_q, v_q (B, S, KH, D) int8; k_s, v_s (B, S) f32, on CUDA
    -> (B, H, D) in q's dtype."""
    _check(q, k_q, k_s, v_q, v_s)
    B, H, D = q.shape
    S, KH = k_q.shape[1], k_q.shape[2]
    G = H // KH
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_splits, per = split_plan(B * KH, S, _sm_count(q.device.index or 0))
    rows = B * KH * n_splits
    m_ws = torch.empty((rows, G), dtype=torch.float32, device=q.device)
    l_ws = torch.empty((rows, G), dtype=torch.float32, device=q.device)
    acc_ws = torch.empty((rows, G, D), dtype=torch.float32, device=q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.int8_kv_decode_launch(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
                                        v_s.data_ptr(), out.data_ptr(), m_ws.data_ptr(),
                                        l_ws.data_ptr(), acc_ws.data_ptr(), DTYPES[q.dtype], B, H,
                                        KH, S, D, n_splits, per, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"int8_kv_decode launch failed with cudaError {err}")
    int8_kv_decode.launches += 1
    return out


int8_kv_decode.launches = 0
