"""Dispatch for the conv epilogue, by the device of the conv output and
by autograd.

A CUDA tensor goes to the hand-written kernel (``kernel.conv_epilogue``),
which launches or raises, and reports ``cost.conv_epilogue_cost`` to the
open cost counters.  Where autograd would record the call (grad enabled
and an input that requires grad), the call goes through
``ConvEpilogue``: its forward is the kernel, its backward the closed-form
gradient of the plain version (``conv_epilogue_backward``), so training
on the card runs the kernel too.  A meta call under autograd takes the
same function, its forward an empty output of the kernel's shape reported
by the same formula, so a train step counts on meta what it counts on the
card (the backward's ops op by op).  CPU tensors, and meta tensors with
nothing for autograd to record, take the plain version
(``ref.conv_epilogue_ref``): the eager sequence, counted op by op on
``meta``.  There is no other fallback and no knob.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv_epilogue.kernel import conv_epilogue as conv_epilogue_kernel
from repro_torch.kernels.conv_epilogue.ref import conv_epilogue_ref
from repro_torch.kernels.cost import conv_epilogue_cost, counted

F32 = torch.float32


def conv_epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  idn: torch.Tensor | None = None, *, act: bool,
                  pad: tuple[int, int, int, int] = (0, 0, 0, 0), fill: float = 0.0) -> torch.Tensor:
    """acc (N, C, H, W) -> the frozen-BN affine, the residual ``idn`` where
    given, the ReLU where ``act`` (after the residual) and the consumer's
    SAME ``pad`` (top, bottom, left, right) filled with ``fill``."""
    records = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (acc, scale, bias, idn))
    if acc.device.type == "cpu" or (acc.is_meta and not records):
        return conv_epilogue_ref(acc, scale, bias, idn, act=act, pad=pad, fill=fill)
    if not (acc.is_cuda or acc.is_meta):
        raise ValueError(f"conv_epilogue runs on cuda, cpu or meta, got {acc.device}")
    pad = tuple(int(p) for p in pad)
    with counted("conv_epilogue", conv_epilogue_cost, *acc.shape, pad, acc.element_size(), idn is not None):
        if records:
            return ConvEpilogue.apply(acc, scale, bias, idn, act, pad, fill)
        return conv_epilogue_kernel(acc, scale, bias, idn, act=act, pad=pad, fill=fill)


class ConvEpilogue(torch.autograd.Function):
    """The kernel (an empty output on meta) forward, ``conv_epilogue_backward``
    backward."""

    @staticmethod
    def forward(ctx, acc, scale, bias, idn, act, pad, fill):
        if acc.is_meta:
            N, C, H, W = acc.shape
            out = acc.new_empty((N, C, H + pad[0] + pad[1], W + pad[2] + pad[3]))
        else:
            out = conv_epilogue_kernel(acc, scale, bias, idn, act=act, pad=pad, fill=fill)
        ctx.act, ctx.pad, ctx.residual = act, pad, idn is not None
        ctx.save_for_backward(acc, scale, bias, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        acc, scale, bias, out = ctx.saved_tensors
        grads = conv_epilogue_backward(grad, acc, scale, bias, out, residual=ctx.residual, act=ctx.act,
                                       pad=ctx.pad, needs=ctx.needs_input_grad[:4])
        return (*grads, None, None, None)


def conv_epilogue_backward(grad: torch.Tensor, acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           out: torch.Tensor, *, residual: bool, act: bool, pad: tuple[int, int, int, int],
                           needs=(True, True, True, True)):
    """The grads of ``ref.conv_epilogue_ref`` for (acc, scale, bias, idn),
    each None where ``needs`` says so, from the output's grad: the same ops
    autograd runs through the plain version, so the same bits.  The pad's
    grad is the interior; the ReLU passes it where its result is not <= 0
    (NaN passes, as ``threshold_backward`` does): that result is the
    output itself after a residual, else the sign of t = acc·scale + bias,
    recomputed; the residual's grad is the ReLU's, in acc's dtype; t's is
    that in float32; acc's is t's times the scale, scale's t's times acc
    and bias's t's, each summed over N, H and W as autograd's ``sum_to``
    sums a broadcast."""
    top, _, left, _ = pad
    H, W = acc.shape[2:]
    g = grad[:, :, top:top + H, left:left + W]
    a32 = acc.to(F32)
    grad_idn = None
    if residual:
        if act:
            g = torch.ops.aten.threshold_backward(g, out[:, :, top:top + H, left:left + W], 0)
        grad_idn = g if needs[3] else None
        g = g.to(F32)
    else:
        g = g.to(F32)
        if act:
            g = torch.ops.aten.threshold_backward(g, a32 * scale[:, None, None] + bias[:, None, None], 0)
    grad_acc = (g * scale[:, None, None]).to(acc.dtype) if needs[0] else None
    grad_scale = (g * a32).sum((0, 2, 3), keepdim=True).view(-1) if needs[1] else None
    grad_bias = g.sum((0, 2, 3), keepdim=True).view(-1) if needs[2] else None
    return grad_acc, grad_scale, grad_bias, grad_idn
