"""CUDA wrapper for the int8-KV flash-decode kernel.

Replaces the Pallas TPU kernel ``repro/kernels/int8_kv_decode/kernel.py``
(``int8_kv_decode``).  The kernel (``csrc/int8_kv_decode.cu``) reads the
int8 cache in place through a ring of ``cp.async`` stages, widens int8 to
fp16 with integer instructions and one f16x2 subtraction (no I2F), runs
q·K and P·V on the tensor cores with q and P split into fp16 parts (so
nothing is rounded below f32), folds the per-token K scale into the
scores and the V scale into the probabilities, and splits the sequence
across blocks (flash-decode's split-K); the last block of each (b, kv
head) to finish merges the splits, so a call is one launch.  It is bound
by bytes: about 8 operations per cache byte at G = 4.  It is built by
``nvcc`` for ``sm_90a`` on first use (``kernels/build.py``).

``int8_kv_decode`` takes a contiguous float32 or bfloat16 q (B, H, D),
contiguous int8 caches (B, S, KH, D) and contiguous float32 scales (B, S),
all on one CUDA device, with S >= 1, D a multiple of 16 up to 256 and
G = H/KH at most 8; it raises on anything else.  A CUDA tensor never takes
the plain version, and a CPU tensor never reaches here (``ops``
dispatches).  Under autograd (grad enabled and a float input that
requires grad) it raises: the kernel has no backward
(``kernels.forbid_autograd``).  ``int8_kv_decode.launches`` counts
launches, and only launches.

A call allocates the output and, when S is split, one float32 buffer of
partials; the per-(b, kv head) arrival counters live in one int32 buffer a
device, zeroed once and grown when B·KH grows, which every launch leaves
zero; so two calls on one device must not run at once on two streams.
Nothing in a call waits on the card, so after one warm-up call at a
shape (which makes the counters and the launch plan) the call can be
captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.build import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "int8_kv_decode.cu",
    {"int8_kv_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P],
     "int8_kv_decode_plan": [_I, _I, ctypes.POINTER(_I)]},
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # tokens per shared-memory tile, as in the kernel
MAX_D = 256
MAX_G = 8
MAX_SPLITS = 256  # as in the kernel, whose merge keeps m and l per (split, g) in shared memory
# a tile's time over a split's share of the in-kernel merge, about 5 on an
# H100 (one block of 4 warps a SM: ~1.5 us a tile, ~0.3 us a merged split):
# T(n) ~ tiles/n + n/5 tiles' time is least at n = sqrt(5 tiles)
MERGE_RATIO = 5


class LaunchPlan(NamedTuple):
    """What ``int8_kv_decode_plan`` reports for one (dtype, D)."""
    blocks_per_sm: int  # resident blocks a SM, from the occupancy calculator
    smem_bytes: int  # shared memory a block
    tile: int  # tokens a tile
    stages: int  # tiles in the cp.async ring
    tile_bytes: int  # K and V bytes of one tile


def split_plan(n_heads_kv: int, S: int, n_sms: int, blocks_per_sm: int) -> tuple[int, int]:
    """(n_splits, tiles_per_split) for ``n_heads_kv`` = B·KH sequences of S
    tokens: split the 64-token tiles until the grid fills, without going
    past, one wave of ``blocks_per_sm`` blocks on each of ``n_sms`` SMs (a
    second, partial wave would double the time of the first), into at most
    ``MAX_SPLITS`` splits and at most sqrt(``MERGE_RATIO`` x tiles), where a
    split's share of the merge would cost more than its tiles save, never
    leaving a split empty."""
    n_tiles = -(-S // TILE)
    want = max(1, min(n_tiles, MAX_SPLITS, math.isqrt(MERGE_RATIO * n_tiles),
                      blocks_per_sm * n_sms // n_heads_kv))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def launch_plan(index: int, dtype: torch.dtype, D: int) -> LaunchPlan:
    """The kernel's launch configuration on CUDA device ``index`` for q of
    ``dtype`` and head dim D."""
    result = (_I * 5)()
    with torch.cuda.device(index):
        err = LIBRARY.load().int8_kv_decode_plan(DTYPES[dtype], D, result)
    if err != 0:
        raise RuntimeError(f"int8_kv_decode_plan failed with cudaError {err}")
    plan = LaunchPlan(*result)
    if plan.tile != TILE or plan.blocks_per_sm < 1:
        raise RuntimeError(f"int8_kv_decode: the kernel reports {plan}, the wrapper tiles by {TILE}")
    return plan


_COUNTERS: dict[int, torch.Tensor] = {}
_RETIRED: list[torch.Tensor] = []  # outgrown counters, kept for graphs captured with them


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's arrival counters, at least ``n`` of them, all zero
    between launches."""
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


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
    forbid_autograd("int8_kv_decode", q, k_q, k_s, v_q, v_s)
    _check(q, k_q, k_s, v_q, v_s)
    B, H, D = q.shape
    S, KH = k_q.shape[1], k_q.shape[2]
    G = H // KH
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    index = q.device.index
    plan = launch_plan(index, q.dtype, D)
    n_splits, per = split_plan(B * KH, S, _sm_count(index), plan.blocks_per_sm)
    ws = counters = None
    if n_splits > 1:
        ws = torch.empty(B * KH * n_splits * (G * D + 16), dtype=torch.float32, device=q.device)
        counters = _counters(q.device, B * KH)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.int8_kv_decode_launch(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
                                        v_s.data_ptr(), out.data_ptr(),
                                        None if ws is None else ws.data_ptr(),
                                        None if counters is None else counters.data_ptr(),
                                        DTYPES[q.dtype], B, H, KH, S, D, n_splits, per,
                                        1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"int8_kv_decode launch failed with cudaError {err}")
    int8_kv_decode.launches += 1
    return out


int8_kv_decode.launches = 0
