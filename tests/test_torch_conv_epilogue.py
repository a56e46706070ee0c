"""The conv epilogue (``kernels/conv_epilogue``) on the CPU.

* ``ref.conv_epilogue_ref`` bit for bit against the eager sequence that
  ``models/resnet.py`` ran before it (affine, ReLU, cast, and the next
  conv's or the pool's ``_pad_same``), for every call kind ResNet-50
  makes, in float32 and bfloat16, NaN, infinities and -0.0 included.
* ``ResNet``'s forward bit-equal to a frozen copy of the old ``Conv`` and
  ``Bottleneck`` (kept below) at SMOKE and the ``odd`` config, its grads
  too, and its meta count (``CostCounter``) equal.
* The dispatcher: CPU tensors, and meta tensors with nothing for autograd
  to record, take the plain version and launch nothing; on meta under
  autograd the call takes ``ConvEpilogue``, as on the card, and counts
  the kernel's formula.
* ``ConvEpilogue``'s closed-form backward (with the plain version in the
  kernel's place) bit-equal to autograd's grads through the plain
  version, for every call kind in float32 and bfloat16, and only the
  grads asked for.
* The wrapper refusing a wrong dtype, shape, device or layout.
* The CUDA kernel's index arithmetic emulated in numpy (constants read
  from the ``.cu``): its multiply-high division, and each output element's
  border test, source element and channel, padded or not; each gathers the
  plain version's output exactly.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ResNetConfig
from repro_torch.configs.resnet_50 import SMOKE
from repro_torch.kernels.conv_epilogue import kernel as ce_kernel
from repro_torch.kernels.conv_epilogue import ops
from repro_torch.kernels.conv_epilogue.ops import conv_epilogue
from repro_torch.kernels.conv_epilogue.ref import conv_epilogue_ref
from repro_torch.launch.roofline import CostCounter
from repro_torch.models.layers import _pad_same, _same_pad
from repro_torch.models.resnet import ResNet

F32 = torch.float32
ODD = ResNetConfig(name="odd", img_res=37, depths=(1, 1, 1), width=8, n_classes=7)
CU = (Path(ce_kernel.__file__).parent / "csrc" / "conv_epilogue.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+);", CU).group(1))


THREADS, EPT = (_const(n) for n in ("THREADS", "EPT"))
INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(INT_VIEW[a.dtype]), b.contiguous().view(INT_VIEW[b.dtype]))


# --------------------------------------------------------------------------- #
# The frozen copy: models/resnet.py's Conv and Bottleneck before the epilogue
# --------------------------------------------------------------------------- #

def _old_affine(y, scale, bias, act, dtype):
    """The old ``Conv.forward`` after its conv."""
    y = y.to(F32) * scale[:, None, None] + bias[:, None, None]
    return (F.relu(y) if act else y).to(dtype)


def _old_conv(conv, x, act):
    y = F.conv2d(_pad_same(x, conv.k, conv.stride), conv.w.to(x.dtype), stride=conv.stride)
    return _old_affine(y, conv.scale, conv.bias, act, x.dtype)


def _old_block(blk, x):
    y = _old_conv(blk.c3, _old_conv(blk.c2, _old_conv(blk.c1, x, True), True), False)
    idn = x if blk.proj is None else _old_conv(blk.proj, x, False)
    return F.relu(y + idn)


def _old_forward(model, images):
    x = images.permute(0, 3, 1, 2).contiguous()
    x = _old_conv(model.stem, x, True)
    x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)
    for i, dep in enumerate(model.cfg.depths):
        stage = getattr(model, f"stage{i}")
        for b in range(dep):
            x = _old_block(stage[f"b{b}"], x)
    return F.linear(x.to(F32).mean(dim=(2, 3)), model.head.w.to(F32), model.head.b.to(F32))


# --------------------------------------------------------------------------- #
# Inputs
# --------------------------------------------------------------------------- #

def _acc(shape, dtype, seed):
    """Conv outputs with NaN, +-inf and -0.0 sprinkled in."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2
    flat = x.view(-1)
    idx = torch.randperm(flat.numel(), generator=g)[:12]
    flat[idx[:3]] = math.nan
    flat[idx[3:5]] = math.inf
    flat[idx[5:7]] = -math.inf
    flat[idx[7:12]] = -0.0
    return x.to(dtype)


def _affine(C, seed):
    g = torch.Generator().manual_seed(seed)
    scale = torch.randn(C, generator=g)
    bias = torch.randn(C, generator=g)
    scale[0], bias[0] = 1.0, -0.0  # -0.0 products stay -0.0 in channel 0
    return scale, bias


# (name, acc shape, with a residual, act, consumer's (k, stride) or None, fill)
KINDS = [
    ("stem into the pool's -inf border", (2, 8, 16, 16), False, True, (3, 2), -math.inf),
    ("stem into the pool's border, odd", (2, 8, 19, 19), False, True, (3, 2), -math.inf),
    ("c1 into c2 at stride 1, even", (2, 8, 8, 8), False, True, (3, 1), 0.0),
    ("c1 into c2 at stride 1, odd", (2, 8, 7, 9), False, True, (3, 1), 0.0),
    ("c1 into c2 at stride 2, even", (2, 8, 8, 8), False, True, (3, 2), 0.0),
    ("c1 into c2 at stride 2, odd", (2, 8, 9, 7), False, True, (3, 2), 0.0),
    ("c2", (2, 8, 7, 7), False, True, None, 0.0),
    ("c3 with the residual", (2, 16, 7, 7), True, True, None, 0.0),
    ("proj", (2, 16, 7, 7), False, False, None, 0.0),
]


def _pad_for(shape, k_s):
    if k_s is None:
        return (0, 0, 0, 0)
    return (*_same_pad(shape[2], *k_s), *_same_pad(shape[3], *k_s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
def test_ref_matches_the_eager_sequence(kind, dtype):
    _, shape, residual, act, k_s, fill = kind
    acc = _acc(shape, dtype, seed=1)
    scale, bias = _affine(shape[1], seed=2)
    idn = _acc(shape, dtype, seed=3) if residual else None
    got = conv_epilogue_ref(acc, scale, bias, idn, act=act, pad=_pad_for(shape, k_s), fill=fill)
    if residual:  # the old c3 (no ReLU) and the block's relu(y + idn)
        want = _old_affine(acc, scale, bias, False, dtype) + idn
        want = F.relu(want) if act else want
    else:
        want = _old_affine(acc, scale, bias, act, dtype)
        if k_s is not None:  # the consumer's own pad, as the old conv and pool took it
            want = _pad_same(want, *k_s, value=fill)
    assert _bits_equal(got, want)
    assert bool(torch.isnan(got).any()), "the NaNs must reach the output"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", [SMOKE, ODD], ids=["smoke", "odd"])
def test_resnet_matches_the_frozen_forward(cfg, dtype):
    model = ResNet(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    with torch.no_grad():  # scale and bias away from 1 and 0, so the affine matters
        for name, p in model.named_parameters():
            if name.endswith((".scale", ".bias")):
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))) * 0.5
                        + (1.0 if name.endswith(".scale") else 0.0))
    images = torch.randn(3, cfg.img_res, cfg.img_res, 3, generator=torch.Generator().manual_seed(5)).to(dtype)
    before = ce_kernel.conv_epilogue.launches
    with torch.no_grad():
        got, want = model(images), _old_forward(model, images)
    assert ce_kernel.conv_epilogue.launches == before
    assert got.dtype == F32 and _bits_equal(got, want)


def test_resnet_grads_match_the_frozen_forward():
    """Under autograd the model takes the plain version: the same loss and
    the same grads as the old forward."""
    images = torch.randn(2, ODD.img_res, ODD.img_res, 3, generator=torch.Generator().manual_seed(6))
    grads = []
    for fwd in (lambda m: m(images), lambda m: _old_forward(m, images)):
        model = ResNet(ODD, generator=torch.Generator().manual_seed(7), device="cpu")
        loss = fwd(model).square().mean()
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (l_new, g_new), (l_old, g_old) = grads
    assert torch.equal(l_new, l_old)
    assert set(g_new) == set(g_old) and all(torch.equal(g_new[n], g_old[n]) for n in g_new)


def test_resnet_meta_count_is_unchanged():
    """The dry run counts the plain version op by op on meta: the same FLOPs
    and bytes as the old forward."""
    from repro_torch.configs.resnet_50 import FULL

    model = ResNet(FULL, device="meta")
    images = torch.empty(2, FULL.img_res, FULL.img_res, 3, device="meta")
    counts = []
    for fwd in (model, lambda x: _old_forward(model, x)):
        with torch.no_grad(), CostCounter() as c:
            out = fwd(images)
        assert out.is_meta and out.shape == (2, FULL.n_classes)
        counts.append((c.flops, c.bytes, dict(c.per_kernel)))
    assert counts[0] == counts[1]
    assert counts[0][2] == {}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dispatch_takes_the_plain_version(device):
    shape, pad = (2, 8, 9, 7), (1, 1, 1, 1)
    acc = _acc(shape, F32, seed=8).to(device)
    scale, bias = (t.to(device) for t in _affine(8, seed=9))
    before = ce_kernel.conv_epilogue.launches
    got = conv_epilogue(acc, scale, bias, act=True, pad=pad, fill=-math.inf)
    assert ce_kernel.conv_epilogue.launches == before
    assert got.shape == (2, 8, 11, 9) and got.device.type == device
    if device == "cpu":
        assert _bits_equal(got, conv_epilogue_ref(acc, scale, bias, act=True, pad=pad, fill=-math.inf))


def test_dispatch_under_autograd_is_differentiable():
    acc = torch.randn(2, 4, 5, 5, requires_grad=True)
    idn = torch.randn(2, 4, 5, 5)
    scale = torch.randn(4, requires_grad=True)
    bias = torch.randn(4, requires_grad=True)
    out = conv_epilogue(acc, scale, bias, idn, act=True)
    out.sum().backward()
    assert out.grad_fn is not None
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (acc, scale, bias))


def _ref_as_kernel(acc, scale, bias, idn=None, *, act, pad=(0, 0, 0, 0), fill=0.0):
    """The plain version in the kernel's place, so ``ConvEpilogue`` runs on
    the CPU (its backward does not look at how the forward was made)."""
    return conv_epilogue_ref(acc, scale, bias, idn, act=act, pad=pad, fill=fill)


def _grads(fn, leaves, seed):
    """fn(*leaves) and the leaves' grads (None where a leaf needs none) for a
    drawn upstream grad of the output's shape and dtype."""
    out = fn(*leaves)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(out.dtype)
    out.backward(g)
    return out.detach(), [None if t is None else t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
def test_backward_equals_the_plain_versions_grads(kind, dtype, monkeypatch):
    """``ConvEpilogue``'s closed-form backward gives autograd's grads through
    the plain version bit for bit, for every call kind, NaN, infinities and
    -0.0 in acc and idn included."""
    monkeypatch.setattr(ops, "conv_epilogue_kernel", _ref_as_kernel)
    _, shape, residual, act, k_s, fill = kind
    pad = _pad_for(shape, k_s)
    results = []
    for fn in (lambda a, s, b, r: conv_epilogue_ref(a, s, b, r, act=act, pad=pad, fill=fill),
               lambda a, s, b, r: ops.ConvEpilogue.apply(a, s, b, r, act, pad, fill)):
        acc = _acc(shape, dtype, seed=20).requires_grad_(True)
        scale, bias = (t.requires_grad_(True) for t in _affine(shape[1], seed=21))
        idn = _acc(shape, dtype, seed=22).requires_grad_(True) if residual else None
        results.append(_grads(fn, (acc, scale, bias, idn), seed=23))
    (out_ref, g_ref), (out, g) = results
    assert _bits_equal(out, out_ref)
    for want, got in zip(g_ref, g):
        assert (want is None and got is None) or _bits_equal(got, want)


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, True), (False, False, True)],
                         ids=["acc", "scale-bias", "bias"])
def test_backward_computes_only_the_grads_asked_for(needs, monkeypatch):
    monkeypatch.setattr(ops, "conv_epilogue_kernel", _ref_as_kernel)
    shape = (2, 8, 7, 7)
    acc, (scale, bias), idn = _acc(shape, F32, seed=24), _affine(8, seed=25), _acc(shape, F32, seed=26)
    leaves = [t.requires_grad_(n) for t, n in zip((acc, scale, bias), needs)]
    _, want = _grads(lambda a, s, b: conv_epilogue_ref(a, s, b, idn, act=True), leaves, seed=27)
    leaves = [t.detach().requires_grad_(n) for t, n in zip((acc, scale, bias), needs)]
    _, got = _grads(lambda a, s, b: ops.ConvEpilogue.apply(a, s, b, idn, True, (0, 0, 0, 0), 0.0), leaves, seed=27)
    for n, w, x in zip(needs, want, got):
        assert (x is not None) == n and (not n or _bits_equal(x, w))


def test_dispatch_on_meta_under_autograd_counts_the_cards_call():
    """On meta under autograd the call takes ``ConvEpilogue``, as on the
    card: one call at ``cost.conv_epilogue_cost``, an output of the
    kernel's shape, no launch; its backward runs on meta, op by op."""
    from repro_torch.kernels.cost import conv_epilogue_cost

    shape, pad = (2, 8, 9, 7), (1, 1, 0, 1)
    acc = torch.empty(shape, device="meta", requires_grad=True)
    idn = torch.empty(shape, device="meta")
    scale, bias = torch.empty(8, device="meta"), torch.empty(8, device="meta")
    before = ce_kernel.conv_epilogue.launches
    with CostCounter() as c:
        out = conv_epilogue(acc, scale, bias, idn, act=True, pad=pad)
    assert ce_kernel.conv_epilogue.launches == before
    assert out.is_meta and out.shape == (2, 8, 11, 8) and type(out.grad_fn).__name__ == "ConvEpilogueBackward"
    assert (c.flops, c.bytes) == conv_epilogue_cost(*shape, pad, 4, True)
    assert dict(c.per_kernel) == {"conv_epilogue": [1, *conv_epilogue_cost(*shape, pad, 4, True)]}
    with CostCounter() as c:
        out.backward(torch.empty(out.shape, device="meta"))
    assert acc.grad.is_meta and acc.grad.shape == shape and c.bytes > 0 and dict(c.per_kernel) == {}


def _good(device="cpu"):
    return (torch.zeros(2, 4, 6, 6, device=device), torch.ones(4, device=device), torch.zeros(4, device=device))


REFUSALS = [
    ("float64 acc", lambda a, s, b: (a.double(), s, b, None, (0, 0, 0, 0)), TypeError, "float32, bfloat16"),
    ("int acc", lambda a, s, b: (a.int(), s, b, None, (0, 0, 0, 0)), TypeError, "float32, bfloat16"),
    ("3-D acc", lambda a, s, b: (a[0], s, b, None, (0, 0, 0, 0)), ValueError, r"\(N, C, H, W\)"),
    ("short scale", lambda a, s, b: (a, s[:3], b, None, (0, 0, 0, 0)), ValueError, "scale"),
    ("bf16 bias", lambda a, s, b: (a, s, b.bfloat16(), None, (0, 0, 0, 0)), ValueError, "bias"),
    ("idn of another shape", lambda a, s, b: (a, s, b, a[:1], (0, 0, 0, 0)), ValueError, "idn"),
    ("idn of another dtype", lambda a, s, b: (a, s, b, a.bfloat16(), (0, 0, 0, 0)), ValueError, "idn"),
    ("strided acc", lambda a, s, b: (a.transpose(2, 3), s, b, None, (0, 0, 0, 0)), ValueError, "contiguous"),
    ("channels-last acc", lambda a, s, b: (a.to(memory_format=torch.channels_last), s, b, None, (0, 0, 0, 0)),
     ValueError, "contiguous"),
    ("strided idn", lambda a, s, b: (a, s, b, a.transpose(2, 3), (0, 0, 0, 0)), ValueError, "contiguous"),
    ("strided scale", lambda a, s, b: (a, torch.ones(8)[::2], b, None, (0, 0, 0, 0)), ValueError, "contiguous"),
    ("negative pad", lambda a, s, b: (a, s, b, None, (0, -1, 0, 0)), ValueError, "pad"),
    ("three pads", lambda a, s, b: (a, s, b, None, (1, 1, 1)), ValueError, "pad"),
    ("a CPU tensor", lambda a, s, b: (a, s, b, None, (1, 1, 1, 1)), ValueError, "CUDA kernel"),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_wrapper_refuses(case):
    _, make, exc, match = case
    acc, scale, bias, idn, pad = make(*_good())
    before = ce_kernel.conv_epilogue.launches
    with pytest.raises(exc, match=match):
        ce_kernel.conv_epilogue(acc, scale, bias, idn, act=True, pad=pad)
    assert ce_kernel.conv_epilogue.launches == before


def test_wrapper_refuses_under_autograd():
    acc, scale, bias = _good()
    scale.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ce_kernel.conv_epilogue(acc, scale, bias, act=True)


# --------------------------------------------------------------------------- #
# The kernel's index arithmetic, emulated
# --------------------------------------------------------------------------- #

def _make_div(d: int) -> tuple[int, int, int]:
    """``make_div`` in the .cu: (d, m, s)."""
    s = 0
    while s < 32 and (1 << s) < d:
        s += 1
    return d, (((1 << 32) * ((1 << s) - d)) // d + 1) & 0xFFFFFFFF, s


def _divide(n, f):
    """``divide`` in the .cu on uint64 arrays holding uint32 values."""
    _, m, s = f
    n = np.asarray(n, dtype=np.uint64)
    hi = (n * np.uint64(m)) >> np.uint64(32)
    return ((hi + n) & np.uint64(0xFFFFFFFF)) >> np.uint64(s)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 9, 49, 64, 196, 225, 784, 841, 2048, 3249, 3364, 12544, 12769,
                               65535, 1 << 20, 2**31 - 1])
def test_fast_division(d):
    rng = np.random.default_rng(d)
    n = np.concatenate([np.arange(0, 5000), rng.integers(0, 2**31, 20000),
                        2**31 - 1 - np.arange(0, 1000), d * np.arange(0, 1000), d * np.arange(1, 1000) - 1])
    n = n[(n >= 0) & (n < 2**31)].astype(np.uint64)
    assert np.array_equal(_divide(n, _make_div(d)), n // np.uint64(d))


def _emulate_kernel(acc, scale, bias, idn, act, pad, fill):
    """The kernel's grid and index map: every output element's
    border test, source element and channel from its multiply-high
    divisions, then the plain version's arithmetic there."""
    N, C, H, W = acc.shape
    top, bottom, left, right = pad
    Ho, Wo = H + top + bottom, W + left + right
    n_out = N * C * Ho * Wo
    blocks = -(-n_out // (THREADS * EPT))
    b, j, t = np.meshgrid(np.arange(blocks), np.arange(EPT), np.arange(THREADS), indexing="ij")
    o = (b * THREADS * EPT + j * THREADS + t).ravel().astype(np.uint64)
    o = o[o < n_out]
    assert np.array_equal(np.sort(o), np.arange(n_out, dtype=np.uint64))
    M = np.uint64(0xFFFFFFFF)
    p = _divide(o, _make_div(Ho * Wo))
    rem = o - p * np.uint64(Ho * Wo)
    ho = _divide(rem, _make_div(Wo))
    hi = (ho - np.uint64(top)) & M  # uint32 wrap below 0
    wi = (rem - ho * np.uint64(Wo) - np.uint64(left)) & M
    inside = (hi < np.uint64(H)) & (wi < np.uint64(W))
    src = ((p * np.uint64(H) + hi) * np.uint64(W) + wi)[inside]
    c = (p - _divide(p, _make_div(C)) * np.uint64(C))[inside]
    # against the true map
    n_, c_, h_, w_ = np.unravel_index(o.astype(np.int64), (N, C, Ho, Wo))
    true_inside = (h_ >= top) & (h_ < top + H) & (w_ >= left) & (w_ < left + W)
    assert np.array_equal(inside, true_inside)
    assert np.array_equal(c.astype(np.int64), c_[inside])
    want_src = np.ravel_multi_index((n_[inside], c_[inside], h_[inside] - top, w_[inside] - left), (N, C, H, W))
    assert np.array_equal(src.astype(np.int64), want_src)
    src_t, ch = torch.from_numpy(src.astype(np.int64)), torch.from_numpy(c.astype(np.int64))
    tv = acc.reshape(-1)[src_t].to(F32) * scale[ch] + bias[ch]
    if idn is None:
        y = (F.relu(tv) if act else tv).to(acc.dtype)
    else:
        y = tv.to(acc.dtype) + idn.reshape(-1)[src_t]
        y = F.relu(y) if act else y
    out = torch.full((n_out,), fill, dtype=acc.dtype)
    out[torch.from_numpy(o[inside].astype(np.int64))] = y
    return out.view(N, C, Ho, Wo)


# every epilogue shape of ResNet-50 at 224 px (N = 1, C cut to 8 or 16: the
# planes are what the index map sees), and small odd ones
EMULATED = [
    ((1, 8, 112, 112), False, True, (0, 1, 0, 1), -math.inf),  # stem into the pool
    ((1, 8, 56, 56), False, True, (1, 1, 1, 1), 0.0),  # stage 0 c1
    ((1, 8, 56, 56), False, True, (0, 1, 0, 1), 0.0),  # stage 1 b0 c1 (stride-2 c2)
    ((1, 8, 28, 28), False, True, (1, 1, 1, 1), 0.0),
    ((1, 8, 28, 28), False, True, (0, 1, 0, 1), 0.0),
    ((1, 8, 14, 14), False, True, (1, 1, 1, 1), 0.0),
    ((1, 8, 14, 14), False, True, (0, 1, 0, 1), 0.0),
    ((1, 8, 7, 7), False, True, (1, 1, 1, 1), 0.0),
    ((1, 8, 56, 56), False, True, None, 0.0),  # c2
    ((2, 16, 28, 28), True, True, None, 0.0),  # c3 with the residual
    ((3, 16, 14, 14), True, True, None, 0.0),
    ((3, 16, 7, 7), True, True, None, 0.0),
    ((3, 16, 7, 7), False, False, None, 0.0),  # proj
    ((2, 3, 9, 7), True, True, (1, 1, 1, 1), 0.0),  # odd, a residual with a pad
    ((2, 3, 9, 7), False, False, (2, 3, 0, 1), 5.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", EMULATED, ids=[f"{c[0]}-{'res' if c[1] else 'nores'}-{c[3]}" for c in EMULATED])
def test_kernel_index_map_gathers_the_plain_output(case, dtype):
    shape, residual, act, pad, fill = case
    acc = _acc(shape, dtype, seed=10)
    scale, bias = _affine(shape[1], seed=11)
    idn = _acc(shape, dtype, seed=12) if residual else None
    pad = pad or (0, 0, 0, 0)
    want = conv_epilogue_ref(acc, scale, bias, idn, act=act, pad=pad, fill=fill)
    assert _bits_equal(_emulate_kernel(acc, scale, bias, idn, act, pad, fill), want)
