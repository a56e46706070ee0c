"""CUDA wrapper for the conv epilogue kernel: frozen-BN affine, residual,
ReLU and the consumer's SAME pad after one ResNet convolution, one pass.

A port-only kernel: the TPU reference leaves this epilogue to XLA, which
fuses it into the convolution, so there is no Pallas kernel to port.  The
kernel (``csrc/conv_epilogue.cu``) is memory-bound: its least time is the
bytes of acc (and idn) read once and of the padded output written once
over 3.35 TB/s.  It maps the output element by element, all of a
thread's loads in flight before it uses any.  It is built by ``nvcc`` for ``sm_90a`` on first use
(``kernels/build.py``).

``conv_epilogue`` takes a contiguous 4-D float32, bfloat16 or float16
CUDA ``acc``, contiguous float32 ``scale`` and ``bias`` of its channels,
an optional contiguous ``idn`` of acc's shape and dtype, and non-negative
pads; it raises on anything else, and on an output of 2^31 elements or
more.  Its output is bit-equal to ``ref.conv_epilogue_ref`` on the card.
A call is one launch, with no workspace and no state on the card, so calls
may run at once on two streams and a call can be captured in a CUDA graph.
Under autograd (grad enabled and a float input that requires grad) it
raises: the kernel has no backward of its own (``kernels.forbid_autograd``);
the dispatcher (``ops.py``) calls it from ``ConvEpilogue``, which gives it
one.
``conv_epilogue.launches`` counts launches, and only launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import forbid_autograd
from repro_torch.kernels.build import CudaLibrary

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "conv_epilogue.cu",
    {"conv_epilogue_launch": [_P, _P, _P, _P, _P, _L, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                              ctypes.c_float, _P]},
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_ELEMS = 2**31  # the kernel's indices are 32-bit


def conv_epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  idn: torch.Tensor | None = None, *, act: bool,
                  pad: tuple[int, int, int, int] = (0, 0, 0, 0), fill: float = 0.0) -> torch.Tensor:
    """acc (N, C, H, W) f32, bf16 or f16 on CUDA, scale and bias (C,) f32,
    idn like acc or None -> (N, C, H + top + bottom, W + left + right) in
    acc's dtype: ``ref.conv_epilogue_ref``'s bits."""
    forbid_autograd("conv_epilogue", acc, scale, bias, idn)
    if acc.dtype not in DTYPES:
        raise TypeError(f"conv_epilogue takes a float32, bfloat16 or float16 acc, got {acc.dtype}")
    if acc.ndim != 4:
        raise ValueError(f"conv_epilogue takes an (N, C, H, W) acc, got shape {tuple(acc.shape)}")
    N, C, H, W = acc.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (C,) or t.device != acc.device:
            raise ValueError(f"conv_epilogue takes a float32 ({C},) {name} on {acc.device}, got"
                             f" {t.dtype} {tuple(t.shape)} on {t.device}")
    if idn is not None and (idn.dtype != acc.dtype or idn.shape != acc.shape or idn.device != acc.device):
        raise ValueError(f"conv_epilogue takes an idn of acc's dtype, shape and device, got {idn.dtype}"
                         f" {tuple(idn.shape)} on {idn.device}")
    if not all(t.is_contiguous() for t in (acc, scale, bias, idn) if t is not None):
        raise ValueError("conv_epilogue takes contiguous tensors")
    pad = tuple(int(p) for p in pad)
    if len(pad) != 4 or min(pad) < 0:
        raise ValueError(f"conv_epilogue takes a pad (top, bottom, left, right) >= 0, got {pad}")
    top, bottom, left, right = pad
    shape = (N, C, H + top + bottom, W + left + right)
    if N * C * shape[2] * shape[3] >= MAX_ELEMS:
        raise ValueError(f"conv_epilogue's output {shape} has 2^31 elements or more")
    if not acc.is_cuda:
        raise ValueError(f"conv_epilogue launches a CUDA kernel; got a tensor on {acc.device}")
    out = torch.empty(shape, dtype=acc.dtype, device=acc.device)
    if acc.numel() == 0:
        return out.fill_(fill)
    lib = LIBRARY.load()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.conv_epilogue_launch(acc.data_ptr(), None if idn is None else idn.data_ptr(),
                                       scale.data_ptr(), bias.data_ptr(), out.data_ptr(), N, C, H, W,
                                       top, bottom, left, right, DTYPES[acc.dtype], int(bool(act)),
                                       float(fill), stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue launch failed with cudaError {err}")
    conv_epilogue.launches += 1
    return out


conv_epilogue.launches = 0
