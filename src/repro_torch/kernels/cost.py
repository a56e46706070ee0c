"""FLOPs and bytes of one call of each hand-written kernel, and the hook by
which a dispatcher reports them.

Each ``*_cost`` gives (operations, bytes) by one formula: the operations
the function needs on these inputs, and its inputs read once and its
outputs written once.  ``chip_smoke.py``'s bound functions divide the same
numbers by the card's peaks.  A dispatcher (each kernel's ``ops.py``)
reports its call on ``cuda`` and on ``meta`` through ``counted``: every
open ``launch/roofline.py::CostCounter`` adds the formula's numbers and
counts none of the aten ops made inside the call (the output's
allocation, a meta tensor's ``empty``).  With no counter open the
formula is not computed and the call enters a shared no-op context.
"""
from __future__ import annotations

import contextlib

ACTIVE: list = []  # the open CostCounters, innermost last


def causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs a top-left causal mask lets through: query i
    sees keys 0..i, at most Sk of them."""
    if Sq <= Sk:
        return Sq * (Sq + 1) // 2
    return Sk * (Sk + 1) // 2 + (Sq - Sk) * Sk


def attention_cost(B: int, Sq: int, Sk: int, H: int, D: int, causal: bool, elem_bytes: int,
                   same_qkv: bool = False) -> tuple[int, int]:
    """4·D operations per (query, visible key) pair per head (q·k and p·v);
    q, k, v read once (one tensor when the caller passes q as k and v) and
    o written once."""
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    n_elems = 2 * B * Sq * H * D + (0 if same_qkv else 2 * B * Sk * H * D)
    return 4 * B * H * D * pairs, n_elems * elem_bytes


def calib_gate_cost(B: int, V: int, elem_bytes: int) -> tuple[int, int]:
    """4 operations a logit (compare, subtract, exp, add); the logits read
    once, calib (f32) and gate (bool) written once."""
    return 4 * B * V, B * V * elem_bytes + B * 4 + B


def int8_matmul_cost(M: int, K: int, N: int, out_bytes: int) -> tuple[int, int]:
    """2·M·N·K int8 operations; x_q, w_q and both f32 scales read once, the
    (M, N) output written once."""
    return 2 * M * N * K, M * K + K * N + 4 * M + 4 * N + M * N * out_bytes


def decode_cost(B: int, S: int, KH: int, G: int, D: int, q_bytes: int) -> tuple[int, int]:
    """4·B·H·S·D operations (q·k and p·v, H = KH·G); the int8 K and V
    caches, both f32 scales and q read once, the output written once."""
    return 4 * B * KH * G * S * D, 2 * B * S * KH * D + 2 * B * S * 4 + 2 * B * KH * G * D * q_bytes


def conv_epilogue_cost(N: int, C: int, H: int, W: int, pad: tuple[int, int, int, int],
                       elem_bytes: int, residual: bool) -> tuple[int, int]:
    """0 operations, as ``torch.utils.flop_counter`` counts the eager
    affine, add and ReLU it replaces (so the card counts what ``meta``
    does); acc (and idn) read once, scale and bias once, the padded output
    written once."""
    top, bottom, left, right = pad
    n_out = N * C * (H + top + bottom) * (W + left + right)
    return 0, N * C * H * W * elem_bytes * (2 if residual else 1) + 8 * C + n_out * elem_bytes


def linear_cost(M: int, N: int, K: int, bias: bool) -> tuple[int, int]:
    """2·M·N·K operations, as ``torch.utils.flop_counter`` counts the
    ``addmm``/``mm`` of the F.linear it replaces (the 3xTF32 kernel's three
    TF32 products are its way to f32, not more work); x, w (and b) read
    once, y written once, all f32."""
    return 2 * M * N * K, 4 * (M * K + N * K + (N if bias else 0) + M * N)


_NOT_COUNTED = contextlib.nullcontext()


def counted(kernel: str, cost, *args):
    """Report one call of ``kernel``, whose (flops, bytes) are
    ``cost(*args)``, to every open counter, and keep the aten ops made
    inside it out of their counts; with no counter open, do nothing."""
    if not ACTIVE:
        return _NOT_COUNTED
    return _report(kernel, *cost(*args))


@contextlib.contextmanager
def _report(kernel: str, flops: int, n_bytes: int):
    for c in ACTIVE:
        c.add_kernel(kernel, flops, n_bytes)
        c.paused += 1
    try:
        yield
    finally:
        for c in ACTIVE:
            c.paused -= 1
