"""Tests of the port that run its CUDA kernels: they need an NVIDIA GPU and
skip without one.  This file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel against plain version: ``calib`` within 1e-6 (the row sum in
another order, across a cluster's blocks), ``gate`` exact, for float32,
bfloat16 and float16 logits, at every split of a row, from a CUDA graph
and on two streams at once; attention within 2e-5 in float32 (three
TF32 products a product, each within ~2^-20 of f32's, and the softmax
summed in another order) and (rtol, atol) = (8e-3, 5e-3) in
bfloat16: the tensor-core kernel rounds P to bf16 before P·V (at most
2^-8 of each term, atol) and both round the output once (one bf16 step,
at most 2^-7 of it, rtol); ``tests/test_torch_flash.py`` holds both kernels'
arithmetic to the reference on the CPU.  Card against CPU, TF32 off: through a whole SMOKE fast
pass ``conf`` within 1e-5, through a ``deit-smoke`` forward the logits
within 1e-4.  The int8 matmul is bit-equal to its plain version: the
int32 product exactly, the float32 output bit for bit, the bfloat16 output
after the same one rounding.  The int8-KV decode kernel against its plain
version: within 2e-5 (rtol and atol) with a float32 q (the softmax summed
in another order, across splits), (rtol, atol) = (8e-3, 1e-4) with a
bfloat16 q (one bf16 step of the output where the two f32 results straddle
a rounding); bit for bit from call to call and under CUDA-graph replay;
through a stablelm-smoke
prefill and int8-fold decode, card against CPU, the logits within 1e-4
and the greedy tokens equal.  The language-model zoo, card against CPU,
float32, TF32 off: an MoE layer (routes and capacity drops equal, outputs
within 1e-5, aux within 1e-6), deepseek-v2-lite-smoke's MLA decode naive
and absorbed (logits within 1e-4), and Arctic-480B's attention geometry
(G = 7) decoding through the kernel (logits within 2e-3).  The round engine (``serving/engine_torch.py``)
on the card against the CPU: integer outputs equal, floats within the
differential tolerances (``cumsum`` is a parallel scan on the card); its
step syncs nothing with the host and its CUDA-graph replay equals the
eager step bit for bit; the counter-jitter factors and every normal
bit-equal on both devices.  Swin, DiT and the UNet (smoke configs, every
zero-initialised leaf drawn) default to the card; card against CPU,
float32, TF32 off, within 1e-4, DiT and the UNet launching the flash
kernel once a layer or twice a transformer block, Swin and the CPU never.
The conv epilogue is bit-equal to its plain version on the card at every
call kind of ResNet-50 (N = 1, 7, 128; float32, bfloat16, float16; NaN
payloads and signed zeros included), on misaligned and odd shapes, from
a CUDA graph and on two streams at once; ResNet-50 FULL's logits at
(128, 224, 224, 3) equal the plain path's bit for bit with 53 launches a
forward; under autograd the dispatcher launches it too and its
closed-form backward gives the plain version's grads bit for bit, alone
and through a resnet-smoke loss.  No kernel has a backward of its own:
each wrapper raises under autograd (and a ViT's backward on the card with
it), and launches under ``no_grad``; one batch
of the paper's slow tier gives the CPU's loss within 1e-5 relative and
its grads within 1e-4 of their scale.  The dry run's counter: each kernel
dispatcher reports the same cost on the card as on meta, and a bf16
deit-smoke forward and a resnet-smoke train step count the same FLOPs and
bytes on both (the train step's conv epilogues at the kernel's formula on
both); ``host_shard`` on a one-card NCCL ``DeviceMesh``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.deit_b import SMOKE as DEIT_SMOKE
from repro_torch.configs.resnet_50 import SMOKE
from repro_torch.core.cascade import fast_pass
from repro_torch.kernels.conv_epilogue import kernel as ce_kernel
from repro_torch.kernels.conv_epilogue.ref import conv_epilogue_ref as ce_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused_calib_gate import kernel as cg_kernel
from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref
from repro_torch.kernels.int8_matmul import kernel as i8_kernel
from repro_torch.kernels.int8_kv_decode import kernel as kv_kernel
from repro_torch.kernels.int8_kv_decode.ref import decode_attention_ref
from repro_torch.kernels.int8_matmul import ref as i8_ref
from repro_torch.models.resnet import ResNet
from repro_torch.models.vit import ViT
from repro_torch.quant.quantize import qdq_tree

PLATT = [(-6.0, 2.0, 0.7), (-1.0, 0.0, 0.5), (-20.0, 5.0, 0.3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _logits(B, V, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale).astype(np.float32)


def _calib_logits(B, V, seed, device, dtype=torch.float32, misaligned=False):
    x = torch.as_tensor(_logits(B, V, seed=seed), device=device).to(dtype)
    if misaligned:  # one element past a 16-byte aligned base
        x = torch.empty(B * V + 1, dtype=dtype, device=device)[1:].view(B, V).copy_(x)
    return x


def _calib_matches_plain(x):
    for a, b, theta in PLATT:
        before = cg_kernel.calib_gate.launches
        ck, gk = cg_kernel.calib_gate(x, a, b, theta)
        torch.cuda.synchronize()
        assert cg_kernel.calib_gate.launches == before + 1
        cr, gr = calib_gate_ref(x, a, b, theta)
        assert ck.dtype == torch.float32 and gk.dtype == torch.bool
        torch.testing.assert_close(ck, cr, rtol=0, atol=1e-6)
        assert torch.equal(gk, gr)


# the paths' shapes, LM vocabularies (bf16 as StableLM's decode gives them),
# bench_kernels' (not resident in L2), one row, odd rows on a misaligned base
CALIB_CASES = [(16, 1000, "float32", False), (128, 4096, "float32", False), (37, 1001, "float32", False),
               (8, 152064, "float32", False), (1, 1, "float32", False), (8, 100352, "bfloat16", False),
               (256, 102400, "float32", False), (256, 102400, "bfloat16", False), (1, 152064, "float32", False),
               (37, 1001, "bfloat16", True), (37, 1001, "float16", True), (5, 3, "float16", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,V,dtype,misaligned", CALIB_CASES)
def test_calib_gate_cuda_matches_plain_version(cuda_device, B, V, dtype, misaligned):
    _calib_matches_plain(_calib_logits(B, V, B * V, cuda_device, getattr(torch, dtype), misaligned))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calib_gate_cuda_every_split(cuda_device, monkeypatch, splits, dtype):
    """Every cluster size the kernel takes, forced at (8, 152064)."""
    plan = cg_kernel.split_plan
    monkeypatch.setattr(cg_kernel, "split_plan", lambda *a, **kw: plan(*a, splits=splits))
    x = _calib_logits(8, 152064, splits, cuda_device, getattr(torch, dtype))
    assert cg_kernel.plan_for(x).splits == splits
    _calib_matches_plain(x)


@pytest.mark.cuda
def test_calib_gate_cuda_graph_replay(cuda_device):
    """A call captured in a CUDA graph replays the kernel on new logits."""
    x = _calib_logits(8, 152064, 3, cuda_device)
    assert cg_kernel.plan_for(x).splits > 1  # a cluster launch
    cg_kernel.calib_gate(x, -6.0, 2.0, 0.5)  # warm: built, plan and occupancy known
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            calib, gate = cg_kernel.calib_gate(x, -6.0, 2.0, 0.5)
    for seed in (4, 5):
        x.copy_(_calib_logits(8, 152064, seed, cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        cr, gr = calib_gate_ref(x, -6.0, 2.0, 0.5)
        torch.testing.assert_close(calib, cr, rtol=0, atol=1e-6)
        assert torch.equal(gate, gr)


@pytest.mark.cuda
def test_calib_gate_cuda_two_streams_at_once(cuda_device):
    """Calls on two streams may overlap: the kernel keeps no state on the card."""
    xs = [_calib_logits(8, 152064, seed, cuda_device) for seed in (6, 7)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    out = [[], []]
    for _ in range(20):
        for i in (0, 1):
            with torch.cuda.stream(streams[i]):
                out[i].append(cg_kernel.calib_gate(xs[i], -6.0, 2.0, 0.5))
    torch.cuda.synchronize()
    for i in (0, 1):
        cr, gr = calib_gate_ref(xs[i], -6.0, 2.0, 0.5)
        for ck, gk in out[i]:
            torch.testing.assert_close(ck, cr, rtol=0, atol=1e-6)
            assert torch.equal(gk, gr)


@pytest.mark.cuda
def test_calib_gate_cuda_extreme_rows_finite(cuda_device):
    x = torch.as_tensor(_logits(6, 700, seed=1, scale=50.0), device=cuda_device)
    x[0] = -torch.inf
    x[1] = 1e4
    x[2] = -1e4
    x[3, :350] = -1e4
    ck, gk = cg_kernel.calib_gate(x, -6.0, 2.0, 0.5)
    cr, gr = calib_gate_ref(x, -6.0, 2.0, 0.5)
    assert torch.isfinite(ck).all()
    torch.testing.assert_close(ck, cr, rtol=0, atol=1e-6)
    assert torch.equal(gk, gr)


@pytest.mark.cuda
def test_calib_gate_cuda_rejects_what_it_cannot_take(cuda_device):
    """float16 and bfloat16 are taken, as the TPU kernel takes them; float64,
    integers, non-contiguous and 3-D logits raise without a launch."""
    x = torch.as_tensor(_logits(4, 10, seed=0), device=cuda_device)
    for dtype in (torch.float16, torch.bfloat16):
        c, g = cg_kernel.calib_gate(x.to(dtype), -6.0, 2.0, 0.5)
        cr, gr = calib_gate_ref(x.to(dtype), -6.0, 2.0, 0.5)
        torch.testing.assert_close(c, cr, rtol=0, atol=1e-6)
        assert torch.equal(g, gr)
    before = cg_kernel.calib_gate.launches
    for bad in (x.double(), x.to(torch.int32), x.to(torch.int8)):
        with pytest.raises(TypeError):
            cg_kernel.calib_gate(bad, -6.0, 2.0, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        cg_kernel.calib_gate(torch.zeros(10, 4, device=cuda_device).t(), -6.0, 2.0, 0.5)
    with pytest.raises(ValueError, match="shape"):
        cg_kernel.calib_gate(x.view(2, 2, 10), -6.0, 2.0, 0.5)
    assert cg_kernel.calib_gate.launches == before
    c, g = cg_kernel.calib_gate(x[:0], -6.0, 2.0, 0.5)
    assert c.shape == g.shape == (0,)


@pytest.mark.cuda
def test_fast_pass_card_matches_cpu(cuda_device):
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = ResNet(SMOKE, generator=torch.Generator().manual_seed(0), device="cpu")
        cpu.load_state_dict(qdq_tree(cpu.state_dict()))
        card = ResNet(SMOKE, device=cuda_device)
        card.load_state_dict(cpu.state_dict())
        x = torch.as_tensor(np.random.default_rng(2).standard_normal((16, 32, 32, 3)).astype(np.float32))
        before = cg_kernel.calib_gate.launches
        with torch.inference_mode():
            pc, cc = fast_pass(cpu, None, x, use_fused=True, platt_ab=(-20.0, 5.0))
            pg, cg = fast_pass(card, None, x.to(cuda_device), use_fused=True, platt_ab=(-20.0, 5.0))
        assert cg_kernel.calib_gate.launches == before + 1
        assert cg.is_cuda and pg.is_cuda
        torch.testing.assert_close(cg.cpu(), cc, rtol=0, atol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _resnet50_epilogues(N):
    """Every conv-epilogue call of one ResNet-50 FULL forward at N frames,
    recorded on meta by ``chip_smoke.resnet50_epilogue_calls``: (acc shape,
    with a residual, act, pad, fill)."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import resnet50_epilogue_calls

    return [call[1:] for call in resnet50_epilogue_calls(N)]


def _ce_inputs(shape, residual, dtype, seed, device):
    """A conv output (and a residual) with NaN, +-inf and -0.0 sprinkled in;
    scale and bias with channel 0 at (1, -0.0), so -0.0 products survive."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw():
        x = torch.randn(shape, generator=g, device=device) * 2
        flat = x.view(-1)
        idx = torch.randint(0, flat.numel(), (64,), generator=g, device=device)
        flat[idx[:16]] = float("nan")
        flat[idx[16:24]] = float("inf")
        flat[idx[24:32]] = -float("inf")
        flat[idx[32:]] = -0.0
        flat[:4] = -0.0
        return x.to(dtype)

    C = shape[1]
    scale = torch.randn(C, generator=g, device=device)
    bias = torch.randn(C, generator=g, device=device)
    scale[0], bias[0] = 1.0, -0.0
    return draw(), scale, bias, (draw() if residual else None)


_CE_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _ce_bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(_CE_INT[a.dtype]), b.view(_CE_INT[b.dtype]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("N", [1, 7, 128])
def test_conv_epilogue_cuda_bit_equal_to_plain_version(cuda_device, N, dtype):
    """Every epilogue shape of ResNet-50 at N frames: the kernel's output,
    border and interior, NaN payloads and signed zeros included, equals the
    plain version's on the card bit for bit."""
    kinds = sorted(set(_resnet50_epilogues(N)), key=str)
    assert len(kinds) == 20
    for i, (shape, residual, act, pad, fill) in enumerate(kinds):
        acc, scale, bias, idn = _ce_inputs(shape, residual, dtype, seed=100 + i, device=cuda_device)
        before = ce_kernel.conv_epilogue.launches
        with torch.no_grad():
            got = ce_kernel.conv_epilogue(acc, scale, bias, idn, act=act, pad=pad, fill=fill)
            want = ce_ref(acc, scale, bias, idn, act=act, pad=pad, fill=fill)
        torch.cuda.synchronize()
        assert ce_kernel.conv_epilogue.launches == before + 1
        assert _ce_bits_equal(got, want), (shape, residual, act, pad, fill)
        assert bool(torch.isnan(got).any())
        del acc, idn, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_epilogue_cuda_misaligned_and_odd_shapes(cuda_device, dtype):
    """Views one element past a 16-byte boundary, planes of one element
    and odd sizes equal the plain version bit for bit."""
    def misaligned(x):
        return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape).copy_(x)

    for shape, residual, pad in [((3, 5, 7, 7), True, (0, 0, 0, 0)), ((2, 3, 1, 1), False, (0, 0, 0, 0)),
                                 ((2, 3, 1, 2), True, (1, 1, 0, 2)), ((1, 1, 3, 5), False, (0, 0, 0, 0)),
                                 ((4, 6, 9, 11), True, (2, 0, 1, 3))]:
        acc, scale, bias, idn = _ce_inputs(shape, residual, dtype, seed=7, device=cuda_device)
        want = ce_ref(acc, scale, bias, idn, act=True, pad=pad, fill=-1.5)
        for a, r in ((acc, idn), (misaligned(acc), idn), (acc, None if idn is None else misaligned(idn))):
            with torch.no_grad():
                got = ce_kernel.conv_epilogue(a, scale, bias, r, act=True, pad=pad, fill=-1.5)
            assert _ce_bits_equal(got, want), (shape, residual, pad)


@pytest.mark.cuda
def test_resnet50_full_card_bit_equal_to_plain_path(cuda_device, monkeypatch):
    """ResNet-50 FULL at (128, 224, 224, 3) with int8 QDQ weights and drawn
    frozen-BN scales and biases: the kernel's logits equal the plain path's
    on the card (the eager epilogue, the same convolutions) bit for bit,
    and each forward launches the kernel exactly 53 times."""
    from repro_torch.configs.resnet_50 import FULL
    from repro_torch.models import resnet

    model = ResNet(FULL, generator=torch.Generator(device="cuda").manual_seed(3), device=cuda_device)
    model.load_state_dict(qdq_tree(model.state_dict()))
    g = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.copy_(torch.rand(p.shape, generator=g, device=cuda_device) + 0.5)
            elif name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g, device=cuda_device) * 0.1)
    x = torch.randn(128, 224, 224, 3, generator=g, device=cuda_device)
    before = ce_kernel.conv_epilogue.launches
    with torch.inference_mode():
        got = model(x)
        torch.cuda.synchronize()
        assert ce_kernel.conv_epilogue.launches == before + 53
        again = model(x)
        torch.cuda.synchronize()
        assert ce_kernel.conv_epilogue.launches == before + 106
        monkeypatch.setattr(resnet, "conv_epilogue", ce_ref)
        want = model(x)
    torch.cuda.synchronize()
    assert ce_kernel.conv_epilogue.launches == before + 106
    assert got.shape == (128, FULL.n_classes) and bool(torch.isfinite(got).all())
    assert _ce_bits_equal(got, want) and _ce_bits_equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_epilogue_cuda_backward_equals_the_plain_versions_grads(cuda_device, dtype):
    """Under autograd the dispatcher launches the kernel once a call (through
    ``ConvEpilogue``) and its backward gives autograd's grads through the
    plain version on the card bit for bit, at every call kind of ResNet-50
    at 7 frames, NaN and -0.0 in acc and idn included."""
    from repro_torch.kernels.conv_epilogue.ops import conv_epilogue

    for i, (shape, residual, act, pad, fill) in enumerate(sorted(set(_resnet50_epilogues(7)), key=str)):
        results = []
        for fn in (conv_epilogue, ce_ref):
            acc, scale, bias, idn = _ce_inputs(shape, residual, dtype, seed=200 + i, device=cuda_device)
            leaves = [t.requires_grad_(True) for t in (acc, scale, bias, idn) if t is not None]
            before = ce_kernel.conv_epilogue.launches
            out = fn(acc, scale, bias, idn, act=act, pad=pad, fill=fill)
            assert ce_kernel.conv_epilogue.launches == before + (fn is conv_epilogue)
            g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(i), device=cuda_device)
            out.backward(g.to(dtype))
            results.append((out.detach(), [t.grad for t in leaves]))
        (got, got_grads), (want, want_grads) = results
        assert _ce_bits_equal(got, want), (shape, residual, pad)
        for x, w in zip(got_grads, want_grads):
            assert _ce_bits_equal(x, w), (shape, residual, pad)


@pytest.mark.cuda
def test_resnet_under_autograd_on_the_card_launches_the_kernel(cuda_device, monkeypatch):
    """With grad enabled and parameters that require grad the model launches
    the kernel once a conv, and its loss and grads equal the plain
    epilogue's bit for bit (cuDNN deterministic, so the convolutions'
    backward is too); under ``no_grad`` it launches as many."""
    from repro_torch.models import resnet

    model = ResNet(SMOKE, generator=torch.Generator(device="cuda").manual_seed(5), device=cuda_device)
    x = torch.randn(4, 32, 32, 3, device=cuda_device)
    n_convs = 1 + sum(3 + (b == 0) for d in SMOKE.depths for b in range(d))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    results = []
    for epilogue in (resnet.conv_epilogue, ce_ref):
        monkeypatch.setattr(resnet, "conv_epilogue", epilogue)
        model.zero_grad(set_to_none=True)
        before = ce_kernel.conv_epilogue.launches
        loss = model(x).square().mean()
        loss.backward()
        assert ce_kernel.conv_epilogue.launches == before + (n_convs if epilogue is not ce_ref else 0)
        results.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (loss, grads), (loss_ref, grads_ref) = results
    assert torch.equal(loss, loss_ref)
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
    assert all(_ce_bits_equal(grads[n], grads_ref[n]) for n in grads)
    monkeypatch.undo()
    before = ce_kernel.conv_epilogue.launches
    with torch.no_grad():
        plain = model(x)
    assert ce_kernel.conv_epilogue.launches == before + n_convs
    torch.testing.assert_close(plain, model(x).detach(), rtol=0, atol=0)


@pytest.mark.cuda
def test_conv_epilogue_cuda_graph_replay(cuda_device):
    """A call captured in a CUDA graph replays the kernel on new inputs, on
    both paths."""
    for shape, residual, pad in [((8, 64, 28, 28), True, (0, 0, 0, 0)), ((8, 64, 28, 28), False, (0, 1, 0, 1))]:
        acc, scale, bias, idn = _ce_inputs(shape, residual, torch.float32, seed=9, device=cuda_device)
        with torch.no_grad():
            ce_kernel.conv_epilogue(acc, scale, bias, idn, act=True, pad=pad)  # warm: built and loaded
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = ce_kernel.conv_epilogue(acc, scale, bias, idn, act=True, pad=pad)
            for seed in (10, 11):
                new = _ce_inputs(shape, residual, torch.float32, seed=seed, device=cuda_device)
                acc.copy_(new[0])
                if residual:
                    idn.copy_(new[3])
                graph.replay()
                torch.cuda.synchronize()
                assert _ce_bits_equal(out, ce_ref(acc, scale, bias, idn, act=True, pad=pad))


@pytest.mark.cuda
def test_conv_epilogue_cuda_two_streams_at_once(cuda_device):
    """Calls on two streams may overlap: the kernel keeps no state on the card."""
    ins = [_ce_inputs((16, 256, 56, 56), True, torch.float32, seed=s, device=cuda_device) for s in (12, 13)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    out = [[], []]
    with torch.no_grad():
        for _ in range(10):
            for i in (0, 1):
                with torch.cuda.stream(streams[i]):
                    acc, scale, bias, idn = ins[i]
                    out[i].append(ce_kernel.conv_epilogue(acc, scale, bias, idn, act=True))
                    out[i].append(ce_kernel.conv_epilogue(acc, scale, bias, act=True, pad=(1, 1, 1, 1)))
    torch.cuda.synchronize()
    for i in (0, 1):
        acc, scale, bias, idn = ins[i]
        want = (ce_ref(acc, scale, bias, idn, act=True), ce_ref(acc, scale, bias, act=True, pad=(1, 1, 1, 1)))
        for k, got in enumerate(out[i]):
            assert _ce_bits_equal(got, want[k % 2])


def _qkv(B, Sq, Sk, H, D, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((B, S, H, D)).astype(np.float32),
                                 device=device).to(dtype) for S in (Sq, Sk, Sk))


# the path's shapes, the reference sweep's, ragged Sq != Sk and S = 1, a
# last key tile of 6 at D = 16 and 128 (whose key tiles are 32 long)
FLASH_CASES = [(16, 198, 198, 12, 64, False), (3, 198, 198, 12, 64, False),
               (1, 256, 256, 2, 64, True), (1, 256, 256, 2, 64, False),
               (2, 512, 512, 4, 64, True), (2, 512, 512, 4, 64, False),
               (2, 384, 384, 2, 128, True), (2, 384, 384, 2, 128, False),
               (1, 1024, 1024, 1, 64, True), (1, 1024, 1024, 1, 64, False),
               (1, 100, 300, 2, 64, True), (1, 300, 100, 2, 128, True),
               (1, 1, 1, 1, 64, False), (2, 1, 1, 3, 128, True),
               (5, 18, 18, 4, 16, False), (2, 70, 70, 3, 16, True),  # deit-smoke's head dim
               (2, 198, 198, 3, 16, False), (2, 198, 198, 3, 128, False), (1, 100, 300, 2, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", FLASH_CASES)
def test_flash_attention_cuda_matches_plain_version(cuda_device, B, Sq, Sk, H, D, causal):
    q, k, v = _qkv(B, Sq, Sk, H, D, seed=Sq * 7 + Sk, device=cuda_device)
    before = fa_kernel.flash_attention.launches
    out = fa_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    assert out.shape == (B, Sq, H, D) and out.dtype == torch.float32
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=causal), rtol=0, atol=2e-5)


# bf16, on the tensor cores: head dims 16/64/128, causal and not, ragged
# Sq != Sk both ways, S = 1, the f(batch) sweep's attention(q, q, q) at
# b = 1 and 32, and DeiT-B's shape (a last key tile of 6)
BF16_CASES = [(1, 16, 16, 1, 16, False, False), (1, 16, 16, 1, 16, True, False),
              (5, 18, 18, 4, 16, False, False), (2, 70, 70, 3, 16, True, False),
              (2, 256, 256, 2, 64, True, False), (2, 256, 256, 2, 64, False, False),
              (2, 384, 384, 2, 128, True, False), (2, 384, 384, 2, 128, False, False),
              (1, 100, 300, 2, 64, True, False), (1, 300, 100, 2, 64, True, False),
              (1, 100, 300, 2, 128, False, False), (1, 300, 100, 2, 128, True, False),
              (1, 1, 1, 1, 64, False, False), (2, 1, 1, 3, 128, True, False),
              (1, 256, 256, 4, 64, True, True), (32, 256, 256, 4, 64, True, True),
              (3, 198, 198, 12, 64, False, False), (1, 1024, 1024, 1, 64, True, False)]
BF16_TOL = (8e-3, 5e-3)  # (rtol, atol); see the module docstring


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal,same", BF16_CASES)
def test_flash_attention_cuda_bf16(cuda_device, B, Sq, Sk, H, D, causal, same):
    q, k, v = _qkv(B, Sq, Sk, H, D, seed=Sq * 5 + Sk + D, device=cuda_device, dtype=torch.bfloat16)
    if same:
        k = v = q
    before = fa_kernel.flash_attention.launches
    out = fa_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    assert out.shape == (B, Sq, H, D) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, causal=causal).float(),
                               rtol=BF16_TOL[0], atol=BF16_TOL[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_reads_strided_views(cuda_device, dtype):
    """q, k, v as views into one fused projection (inner stride 1), as the ViT passes them."""
    rng = np.random.default_rng(5)
    qkv = torch.as_tensor(rng.standard_normal((3, 198, 3, 12, 64)).astype(np.float32), device=cuda_device)
    qkv = qkv.to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = fa_kernel.flash_attention(q, k, v, causal=False)
    want = fa_kernel.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_cuda_rejects_what_it_cannot_take(cuda_device):
    q, k, v = _qkv(1, 16, 16, 2, 64, seed=0, device=cuda_device)
    before = fa_kernel.flash_attention.launches
    with pytest.raises(TypeError):
        fa_kernel.flash_attention(q.half(), k.half(), v.half(), causal=False)
    with pytest.raises(ValueError, match="head dims"):
        fa_kernel.flash_attention(q[..., :32], k[..., :32], v[..., :32], causal=False)
    with pytest.raises(ValueError, match="head dims"):
        fa_kernel.flash_attention(q[..., :24], k[..., :24], v[..., :24], causal=False)
    with pytest.raises(ValueError, match="inner stride"):
        fa_kernel.flash_attention(q.transpose(2, 3), k, v, causal=False)
    with pytest.raises(ValueError, match="do not agree"):
        fa_kernel.flash_attention(q, k[:, :, :1], v, causal=False)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa_kernel.flash_attention(q, k.cpu(), v, causal=False)
    # both dtypes go through 16-byte cp.async copies: a stride of 65
    # elements, or a data pointer one element off, raises rather than launching
    _, k1, v1 = _qkv(1, 16, 16, 1, 64, seed=0, device=cuda_device)
    odd_seq = torch.zeros(1, 16, 1, 65, device=cuda_device)[..., :64]
    assert odd_seq.stride(1) == 65
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_kernel.flash_attention(odd_seq, k1, v1, causal=False)
    shifted32 = torch.zeros(1 * 16 * 2 * 64 + 1, device=cuda_device)[1:].view(1, 16, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_kernel.flash_attention(q, shifted32, v, causal=False)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    odd = torch.zeros(1, 16, 2, 65, dtype=torch.bfloat16, device=cuda_device)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_kernel.flash_attention(odd, kb, vb, causal=False)
    shifted = torch.zeros(1 * 16 * 2 * 64 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(1, 16, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_kernel.flash_attention(qb, shifted, vb, causal=False)
    assert fa_kernel.flash_attention.launches == before


@pytest.mark.cuda
def test_deit_forward_card_matches_cpu(cuda_device):
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = ViT(DEIT_SMOKE, generator=torch.Generator().manual_seed(0), device="cpu")
        card = ViT(DEIT_SMOKE, device=cuda_device)
        card.load_state_dict(cpu.state_dict())
        x = torch.as_tensor(np.random.default_rng(3).standard_normal((5, 32, 32, 3)).astype(np.float32))
        before = fa_kernel.flash_attention.launches
        with torch.inference_mode():
            lc, lg = cpu(x), card(x.to(cuda_device))
        assert fa_kernel.flash_attention.launches == before + DEIT_SMOKE.n_layers
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


# the f(batch) sweep's (32·b, 512, 512) and two smaller M, below
# torch._int_mm's M > 16; a ragged shape, a long ragged K (byte-load
# copies), the reference benchmark's, and DeiT-B's projections
# at 16 frames
INT8_CASES = [(32 * b, 512, 512) for b in (1, 2, 4, 8, 16, 32)] + [
    (1, 512, 512), (16, 512, 512), (37, 100, 77), (64, 4100, 72), (1024, 4096, 4096),
    (3168, 768, 2304), (3168, 768, 3072), (3168, 3072, 768)]


def _quantized(M, K, N, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((M, K)).astype(np.float32), device=device)
    w = torch.as_tensor(rng.standard_normal((K, N)).astype(np.float32), device=device)
    return (*i8_ref.quantize_rows(x), *i8_ref.quantize_cols(w))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", INT8_CASES)
def test_int8_matmul_cuda_bit_equal_to_plain_version(cuda_device, M, K, N):
    xq, xs, wq, ws = _quantized(M, K, N, seed=M + K + N, device=cuda_device)
    before = i8_kernel.int8_matmul.launches
    acc = i8_kernel.int8_matmul_acc(xq, wq)
    out32 = i8_kernel.int8_matmul(xq, xs, wq, ws, out_dtype=torch.float32)
    out16 = i8_kernel.int8_matmul(xq, xs, wq, ws, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert i8_kernel.int8_matmul.launches == before + 3
    assert acc.dtype == torch.int32 and out32.dtype == torch.float32 and out16.dtype == torch.bfloat16
    assert torch.equal(acc, i8_ref.int8_acc_ref(xq, wq))
    assert torch.equal(out32, i8_ref.int8_matmul_ref(xq, xs, wq, ws, torch.float32))
    assert torch.equal(out16, i8_ref.int8_matmul_ref(xq, xs, wq, ws, torch.bfloat16))


def _held_to_plain_version(xq, xs, wq, ws):
    acc = i8_kernel.int8_matmul_acc(xq, wq)
    out32 = i8_kernel.int8_matmul(xq, xs, wq, ws, out_dtype=torch.float32)
    out16 = i8_kernel.int8_matmul(xq, xs, wq, ws, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(acc, i8_ref.int8_acc_ref(xq, wq))
    assert torch.equal(out32, i8_ref.int8_matmul_ref(xq, xs, wq, ws, torch.float32))
    assert torch.equal(out16, i8_ref.int8_matmul_ref(xq, xs, wq, ws, torch.bfloat16))
    return acc


@pytest.mark.cuda
def test_int8_matmul_cuda_extreme_values_exact(cuda_device):
    """(33, 16384, 40), every entry at ±127 or -128: the int32 sums reach
    ~2^28 and stay exact over 256 K tiles in one block.  Row 0 of x_q and
    columns 0 and 1 of w_q are constant (-128, -128 and 127), so entry
    (0, 0) is 2^28 and (0, 1) is -128·127·16384; the rest are random."""
    rng = np.random.default_rng(31)
    x, w = (rng.choice(np.array([-128, -127, 127], np.int8), size=shape)
            for shape in ((33, 16384), (16384, 40)))
    x[0], w[:, 0], w[:, 1] = -128, -128, 127
    xq, wq = torch.as_tensor(x, device=cuda_device), torch.as_tensor(w, device=cuda_device)
    xs = torch.as_tensor(rng.uniform(1e-3, 1e-2, (33, 1)).astype(np.float32), device=cuda_device)
    ws = torch.as_tensor(rng.uniform(1e-3, 1e-2, (1, 40)).astype(np.float32), device=cuda_device)
    acc = _held_to_plain_version(xq, xs, wq, ws)
    assert int(acc[0, 0]) == 2**28 and int(acc[0, 1]) == -128 * 127 * 16384


@pytest.mark.cuda
def test_int8_matmul_cuda_misaligned_views(cuda_device):
    """(37, 100, 77) with x_q and w_q one byte past an aligned base: the
    byte-load copies, bit-equal to the plain version."""
    xq, xs, wq, ws = _quantized(37, 100, 77, seed=32, device=cuda_device)
    xq1, wq1 = (torch.empty(t.numel() + 1, dtype=torch.int8, device=cuda_device)[1:].view(t.shape).copy_(t)
                for t in (xq, wq))
    assert xq1.data_ptr() % 16 == 1 and wq1.data_ptr() % 16 == 1 and xq1.is_contiguous()
    acc = _held_to_plain_version(xq1, xs, wq1, ws)
    assert torch.equal(acc, i8_kernel.int8_matmul_acc(xq, wq))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1024, 512, 512), (32, 4096, 128)])
def test_int8_matmul_cuda_graph_replay(cuda_device, M, K, N):
    """At the sweep's (1024, 512, 512), and at a long K over few output
    tiles: one warm-up call, one call captured in a CUDA graph, then new
    x_q values copied in and the graph replayed, twice; each replay
    matches an eager call bit for bit."""
    xq, xs, wq, ws = _quantized(M, K, N, seed=33, device=cuda_device)
    i8_kernel.int8_matmul(xq, xs, wq, ws)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = i8_kernel.int8_matmul(xq, xs, wq, ws)
    for seed in (34, 35):
        fresh = _quantized(M, K, N, seed=seed, device=cuda_device)[0]
        xq.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, i8_kernel.int8_matmul(fresh, xs, wq, ws))
        assert torch.equal(out, i8_ref.int8_matmul_ref(fresh, xs, wq, ws))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(32, 512, 512), (1024, 512, 512), (32, 4096, 128)])
def test_int8_matmul_cuda_repeats_bit_for_bit(cuda_device, M, K, N):
    """The sweep's (32, 512, 512) and (1024, 512, 512), and a long K over
    few output tiles, 50 times back to back: every output equals the
    first and the plain version's, which a ring stage reused before every
    warp had read it would break."""
    xq, xs, wq, ws = _quantized(M, K, N, seed=36 + M, device=cuda_device)
    outs = [i8_kernel.int8_matmul(xq, xs, wq, ws) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(outs[0], i8_ref.int8_matmul_ref(xq, xs, wq, ws))


@pytest.mark.cuda
def test_int8_matmul_cuda_rejects_what_it_cannot_take(cuda_device):
    xq, xs, wq, ws = _quantized(40, 64, 48, seed=0, device=cuda_device)
    before = i8_kernel.int8_matmul.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        i8_kernel.int8_matmul(xq.cpu(), xs.cpu(), wq.cpu(), ws.cpu())
    with pytest.raises(TypeError):
        i8_kernel.int8_matmul(xq.float(), xs, wq, ws)
    with pytest.raises(TypeError):
        i8_kernel.int8_matmul(xq, xs.double(), wq, ws)
    with pytest.raises(ValueError, match="differ in K"):
        i8_kernel.int8_matmul(xq, xs, wq[:32], ws)
    with pytest.raises(ValueError, match="shape"):
        i8_kernel.int8_matmul(xq, xs, wq, ws[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        i8_kernel.int8_matmul(xq, xs, wq.t().contiguous().t(), ws)
    with pytest.raises(TypeError):
        i8_kernel.int8_matmul(xq, xs, wq, ws, out_dtype=torch.float16)
    assert i8_kernel.int8_matmul.launches == before
    assert i8_kernel.int8_matmul(xq[:0], xs[:0], wq, ws).shape == (0, 48)
    assert i8_kernel.int8_matmul.launches == before  # nothing to launch


@pytest.mark.cuda
def test_batch_sweep_runs_on_the_card(cuda_device):
    from repro_torch.slowtier.sweep import BATCH_SIZES, batch_sweep

    before = (i8_kernel.int8_matmul.launches, fa_kernel.flash_attention.launches)
    out = batch_sweep(device="cuda", n_timing=1)
    per_kernel = 2 * len(BATCH_SIZES)  # a warm-up and one timed call a batch size
    assert i8_kernel.int8_matmul.launches == before[0] + per_kernel
    assert fa_kernel.flash_attention.launches == before[1] + per_kernel
    assert [r["batch"] for r in out["rows"]] == list(BATCH_SIZES)
    assert all(r["attn_us"] > 0 and r["matmul_us"] > 0 for r in out["rows"])
    assert out["batch_fit"]["kind"] in ("flat", "linear", "step")


# (B, S, KH, G, D): test_kernels_decode.py's sweep; StableLM-12B's decode
# shape; Qwen-like MHA; ragged S; the smoke configs' head dim 16; G 8 at D 256;
# G 7 (Arctic's 56 query heads over 8), 5 and 6, which run the G = 8 code
KV_CASES = [(1, 512, 1, 1, 64), (2, 1024, 4, 3, 64), (2, 512, 8, 1, 128), (1, 2048, 2, 4, 64),
            (8, 2048, 8, 4, 160), (2, 1024, 40, 1, 128), (2, 2047, 8, 4, 160), (2, 1, 8, 4, 160),
            (2, 12, 2, 2, 16), (1, 300, 2, 8, 256), (2, 1000, 8, 7, 128), (1, 777, 2, 5, 64),
            (2, 333, 1, 6, 32)]
# (rtol, atol) against the plain version, as chip_smoke.py's DECODE_TOL: f32,
# the softmax summed in another order; bf16, one bf16 step of the output
# (2^-7 of it) where the two f32 results straddle a rounding, plus f32 noise
KV_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (8e-3, 1e-4)}


def _kv_inputs(B, S, KH, G, D, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, KH * G, D)).astype(np.float32),
              rng.integers(-127, 128, (B, S, KH, D)).astype(np.int8),
              rng.uniform(0.005, 0.02, (B, S)).astype(np.float32),
              rng.integers(-127, 128, (B, S, KH, D)).astype(np.int8),
              rng.uniform(0.005, 0.02, (B, S)).astype(np.float32))
    q, kq, ks, vq, vs = (torch.as_tensor(a, device=device) for a in arrays)
    return q.to(dtype), kq, ks, vq, vs


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,KH,G,D", KV_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_kv_decode_cuda_matches_plain_version(cuda_device, B, S, KH, G, D, dtype):
    args = _kv_inputs(B, S, KH, G, D, seed=S + KH * G, device=cuda_device, dtype=dtype)
    before = kv_kernel.int8_kv_decode.launches
    out = kv_kernel.int8_kv_decode(*args)
    torch.cuda.synchronize()
    assert kv_kernel.int8_kv_decode.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, KH * G, D) and torch.isfinite(out).all()
    rtol, atol = KV_TOL[dtype]
    torch.testing.assert_close(out.float(), decode_attention_ref(*args).float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_int8_kv_decode_cuda_extreme_scales(cuda_device):
    q, kq, _, vq, _ = _kv_inputs(1, 256, 1, 2, 32, seed=0, device=cuda_device)
    ks = torch.full((1, 256), 1e-8, device=cuda_device)
    vs = torch.full((1, 256), 10.0, device=cuda_device)
    out = kv_kernel.int8_kv_decode(q, kq, ks, vq, vs)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, decode_attention_ref(q, kq, ks, vq, vs), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_int8_kv_decode_cuda_graph_replay(cuda_device):
    """At path 4's shape (split S, merged in the launch): one warm-up call,
    one call captured in a CUDA graph, then new q values copied in and the
    graph replayed, twice; each replay matches an eager call bit for bit
    (the arrival counters are zero again after every launch)."""
    q, kq, ks, vq, vs = _kv_inputs(8, 2048, 8, 4, 160, seed=21, device=cuda_device,
                                   dtype=torch.bfloat16)
    kv_kernel.int8_kv_decode(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kv_kernel.int8_kv_decode(q, kq, ks, vq, vs)
    for seed in (22, 23):
        fresh = _kv_inputs(8, 1, 8, 4, 160, seed=seed, device=cuda_device, dtype=torch.bfloat16)[0]
        q.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, kv_kernel.int8_kv_decode(fresh, kq, ks, vq, vs))


@pytest.mark.cuda
def test_int8_kv_decode_cuda_repeats_bit_for_bit(cuda_device):
    """Path 4's shape 50 times back to back: every output equals the first,
    which a merge that read another split's partials before they landed
    would break."""
    args = _kv_inputs(8, 2048, 8, 4, 160, seed=24, device=cuda_device, dtype=torch.bfloat16)
    outs = [kv_kernel.int8_kv_decode(*args) for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    rtol, atol = KV_TOL[torch.bfloat16]
    torch.testing.assert_close(outs[0].float(), decode_attention_ref(*args).float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_int8_kv_decode_cuda_rejects_what_it_cannot_take(cuda_device):
    q, kq, ks, vq, vs = _kv_inputs(2, 64, 2, 2, 64, seed=0, device=cuda_device)
    before = kv_kernel.int8_kv_decode.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        kv_kernel.int8_kv_decode(q.cpu(), kq.cpu(), ks.cpu(), vq.cpu(), vs.cpu())
    with pytest.raises(TypeError):
        kv_kernel.int8_kv_decode(q.half(), kq, ks, vq, vs)
    with pytest.raises(TypeError):
        kv_kernel.int8_kv_decode(q, kq.float(), ks, vq, vs)
    with pytest.raises(TypeError):
        kv_kernel.int8_kv_decode(q, kq, ks.bfloat16(), vq, vs)
    with pytest.raises(ValueError, match="contiguous"):
        kv_kernel.int8_kv_decode(q, kq.transpose(1, 2).contiguous().transpose(1, 2), ks, vq, vs)
    with pytest.raises(ValueError, match="scales"):
        kv_kernel.int8_kv_decode(q, kq, ks[:, :32].contiguous(), vq, vs)
    with pytest.raises(ValueError, match="head dims"):
        kv_kernel.int8_kv_decode(q[..., :24].contiguous(), kq[..., :24].contiguous(), ks,
                                 vq[..., :24].contiguous(), vs)
    with pytest.raises(ValueError, match="G <="):
        big = _kv_inputs(1, 8, 1, 9, 64, seed=1, device=cuda_device)
        kv_kernel.int8_kv_decode(*big)
    assert kv_kernel.int8_kv_decode.launches == before


@pytest.mark.cuda
def test_stablelm_smoke_fold_decode_card_matches_cpu(cuda_device):
    """stablelm-smoke in float32 with an int8 cache and the scale fold: the
    card's decode goes through the kernel, the CPU's through the plain
    version; prefill, then four decode steps past a ring wrap."""
    from repro_torch.configs.stablelm_12b import SMOKE as LM_SMOKE
    from repro_torch.models.transformer import ParallelPlan, TransformerLM, lm_decode, lm_prefill

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        plan = ParallelPlan(kv_cache_dtype="int8", kv_scale_fold=True)
        cpu = TransformerLM(LM_SMOKE, plan, generator=torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
        card = TransformerLM(LM_SMOKE, plan, device=cuda_device, dtype=torch.float32)
        card.load_state_dict(cpu.state_dict())
        tokens = torch.as_tensor(np.random.default_rng(3).integers(0, LM_SMOKE.vocab_size, (2, 10)))
        lc, cache_c = lm_prefill(cpu, tokens, LM_SMOKE, plan)
        lg, cache_g = lm_prefill(card, tokens.to(cuda_device), LM_SMOKE, plan)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
        before = kv_kernel.int8_kv_decode.launches
        for pos in range(10, 14):
            tok = lc.argmax(-1)
            assert torch.equal(lg.argmax(-1).cpu(), tok)
            lc, cache_c = lm_decode(cpu, cache_c, tok, pos, LM_SMOKE, plan)
            lg, cache_g = lm_decode(card, cache_g, tok.to(cuda_device), pos, LM_SMOKE, plan)
            torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
        assert kv_kernel.int8_kv_decode.launches == before + 4 * LM_SMOKE.n_layers
        assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _lm_card_and_cpu(cfg, plan, device, seed=0):
    from repro_torch.models.transformer import TransformerLM

    cpu = TransformerLM(cfg, plan, generator=torch.Generator().manual_seed(seed), device="cpu",
                        dtype=torch.float32)
    card = TransformerLM(cfg, plan, device=device, dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_layer_card_matches_cpu(cuda_device, no_tf32, groups):
    """One MoE layer at arctic-smoke's expert widths with 16 experts, a
    dense residual and a shared expert, float32: the same routes (every
    token's k-th and (k+1)-th gates apart by more than 1e-5), the same
    capacity drops (a router pulled toward expert 5 overflows it), outputs
    within 1e-5 and the aux loss within 1e-6."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe

    cfg = MoEConfig(n_routed=16, top_k=2, d_ff_expert=96, n_shared=1, dense_residual_ff=96)
    d, gen = 64, torch.Generator().manual_seed(5)
    p = {}
    for name, leaf in moe.moe_shapes(d, cfg, "swiglu").items():
        w = torch.randn(leaf.shape, generator=gen) / np.sqrt(leaf.fan_in)
        node = p
        for key in name.split(".")[:-1]:
            node = node.setdefault(key, {})
        node[name.split(".")[-1]] = w
    p["router"][:, 5] += 0.05
    x = torch.randn(4, 32, d, generator=gen) + 0.5
    out = {}
    for dev in ("cpu", cuda_device):
        pd = {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict) else v.to(dev)) for k, v in p.items()}
        xf = x.to(dev).reshape(groups, -1, d)
        gates, _, top_i = moe.route(pd["router"], xf, cfg)
        srt = torch.sort(gates, dim=-1, descending=True).values
        assert float((srt[..., 1] - srt[..., 2]).min()) > 1e-5
        y, aux = moe.apply_moe(pd, x.to(dev), cfg, "swiglu", groups=groups)
        out[str(dev)] = (top_i.cpu(), y.cpu(), float(aux))
    (ti_c, y_c, a_c), (ti_g, y_g, a_g) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(ti_c, ti_g)
    assert int((ti_c == 5).sum()) > moe.capacity_for(128 // groups, cfg) * groups  # expert 5 overflows
    torch.testing.assert_close(y_g, y_c, rtol=0, atol=1e-5)
    assert abs(a_g - a_c) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_mla_decode_card_matches_cpu(cuda_device, no_tf32, absorb):
    """deepseek-v2-lite-smoke in float32 (MLA and an MoE layer): prefill,
    then four decode steps past a ring wrap, naive or absorbed, card
    against CPU within 1e-4 and the greedy tokens equal; no int8-KV kernel
    runs, and the f32 MLPs' products run the 3xTF32 kernel."""
    from repro_torch.configs.deepseek_v2_lite_16b import SMOKE as DSV2_SMOKE
    from repro_torch.kernels.linear_3xtf32 import kernel as linear_kernel
    from repro_torch.models.transformer import ParallelPlan, lm_decode, lm_prefill

    plan = ParallelPlan(mla_absorb=absorb, pad_attention_heads=False)
    cpu, card = _lm_card_and_cpu(DSV2_SMOKE, plan, cuda_device, seed=1)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, DSV2_SMOKE.vocab_size, (2, 10)))
    linear_before = linear_kernel.linear_3xtf32.launches
    lc, cache_c = lm_prefill(cpu, tokens, DSV2_SMOKE, plan)
    lg, cache_g = lm_prefill(card, tokens.to(cuda_device), DSV2_SMOKE, plan)
    torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
    before = kv_kernel.int8_kv_decode.launches
    for pos in range(10, 14):
        tok = lc.argmax(-1)
        assert torch.equal(lg.argmax(-1).cpu(), tok)
        lc, cache_c = lm_decode(cpu, cache_c, tok, pos, DSV2_SMOKE, plan)
        lg, cache_g = lm_decode(card, cache_g, tok.to(cuda_device), pos, DSV2_SMOKE, plan)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
    assert kv_kernel.int8_kv_decode.launches == before
    assert linear_kernel.linear_3xtf32.launches > linear_before
    assert cache_g["ckv"].device.type == cuda_device.type and cache_g["ckv"].shape == cache_c["ckv"].shape


@pytest.mark.cuda
def test_arctic_geometry_fold_decode_card_matches_cpu(cuda_device, no_tf32):
    """Arctic-480B's attention geometry (56 query heads over 8 KV heads of
    128: G = 7) at d 512, one layer of 8 experts and a dense residual, int8
    cache with the scales folded: the card's decode goes through the
    kernel, the CPU's through the plain version; logits within 2e-3 (one
    int8 step of a cache entry where the devices' f32 K/V straddle a
    rounding boundary) and the greedy tokens equal."""
    import dataclasses

    from repro_torch.configs.arctic_480b import FULL as ARCTIC
    from repro_torch.models.transformer import ParallelPlan, lm_decode, lm_prefill

    cfg = dataclasses.replace(ARCTIC, name="arctic-geometry", n_layers=1, d_model=512, d_ff=256, vocab_size=512,
                              moe=dataclasses.replace(ARCTIC.moe, n_routed=8, d_ff_expert=256,
                                                      dense_residual_ff=256))
    plan = ParallelPlan(kv_cache_dtype="int8", kv_scale_fold=True)
    cpu, card = _lm_card_and_cpu(cfg, plan, cuda_device, seed=2)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40)))
    lc, cache_c = lm_prefill(cpu, tokens, cfg, plan)
    lg, cache_g = lm_prefill(card, tokens.to(cuda_device), cfg, plan)
    before = kv_kernel.int8_kv_decode.launches
    for pos in range(40, 44):
        tok = lc.argmax(-1)
        assert torch.equal(lg.argmax(-1).cpu(), tok)
        lc, cache_c = lm_decode(cpu, cache_c, tok, pos, cfg, plan)
        lg, cache_g = lm_decode(card, cache_g, tok.to(cuda_device), pos, cfg, plan)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=2e-3)
    assert kv_kernel.int8_kv_decode.launches == before + 4
    assert cache_g["k"].shape == (1, 2, 40, 8, 128)
    assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))


def _fleet_backlog(S, mb, seed):
    """``tests/test_fleet_jax.py::fuzz_backlog``: ascending arrivals on the
    1/32 grid, uniform confidences, 80 % of the streams active."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, mb + 1, size=S)
    stream = np.repeat(np.arange(S), lens)
    t0 = rng.integers(0, 64, size=S) / 32.0
    pos = np.concatenate([np.arange(n) for n in lens]) if lens.sum() else np.zeros(0)
    arrival = t0[stream] + pos / 32.0
    conf = rng.uniform(0.05, 0.95, size=lens.sum())
    now = t0 + (lens + 0.5) / 32.0
    bw = rng.uniform(2e5, 1e7, size=S)
    active = rng.random(S) < 0.8
    return stream, arrival, conf, np.where(active, now, np.inf), bw, active


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["cbo", "threshold", "local", "server", "greedy-rate", "cbo-split"])
def test_fleet_planner_card_matches_cpu(cuda_device, policy):
    """``FleetRunner(backend="torch")`` on the card against the same runner
    on the CPU: the integer fields and theta bit-equal (the same float32
    operations in the same order; sums only in the gains and base
    accuracies, within 1e-4), also under a T^o override; ``overflow`` and
    ``inexact`` clear on both."""
    from repro_torch.core.netsim import payload_sizes, png_size_model
    from repro_torch.policy.fleet import FleetRunner
    from repro_torch.policy.registry import make_policy
    from repro_torch.policy.types import ActionTable

    name = policy.split("-split")[0]
    kw = dict(max_backlog=12, **({"frame_interval": 1.0 / 32.0} if name == "server" else {}))
    actions = None
    if policy.endswith("split"):
        frames = ActionTable.frames_only(sizes=payload_sizes(png_size_model, np.asarray((4, 8))),
                                         acc=np.asarray((0.7, 0.99)))
        actions = ActionTable(kind=np.r_[frames.kind, 1, 1], res=np.r_[frames.res, 1, 1],
                              cut=np.r_[frames.cut, 0, 1], sizes=np.r_[frames.sizes, 1.5e3, 2.0e3],
                              acc=np.r_[frames.acc, 0.984375, 0.99], t_dev=np.r_[frames.t_dev, 2.0 ** -10, 2.0 ** -8],
                              srv_frac=np.r_[frames.srv_frac, 0.5, 0.25], names=frames.names + ("c0", "c1"))
    for S, seed, st in ((17, 1, None), (4099, 2, None), (4099, 3, 0.0515625)):
        plans = {}
        for dev in (cuda_device, "cpu"):
            r = FleetRunner([make_policy(name, **kw) for _ in range(S)], resolutions=(4, 8),
                            acc_server=(0.7, 0.99), deadline=0.2, latency=0.05, server_time=0.037,
                            size_of=png_size_model, bw_init=50e6 / 8, backend="torch", device=dev,
                            actions=actions)
            stream, arrival, conf, now, bw, active = _fleet_backlog(S, 12, seed)
            r.observe_frames(stream, arrival, conf)
            r.bw_est[:] = bw
            if st is not None:
                r.server_time = st
            plans[str(dev)] = r.plan_all(now, active)
            assert not r.last_overflow.any() and not r.last_inexact.any(), (policy, S, str(dev))
        pc, pg = plans["cpu"], plans[str(cuda_device)]
        for k in ("resolution", "n_offloads", "n_frames", "off_stream", "off_pos", "off_res",
                  "off_kind", "planned", "theta"):
            assert np.array_equal(getattr(pc, k), getattr(pg, k)), (policy, S, k)
        np.testing.assert_allclose(pg.total_gain, pc.total_gain, atol=1e-4)
        np.testing.assert_allclose(pg.base_acc, pc.base_acc, atol=1e-4)
        assert len(pc.off_stream) > 0 or name == "local"


@pytest.mark.cuda
def test_fleet_pad_defaults_to_the_card(cuda_device):
    """``pad_fleet`` and ``fleet_from_state`` without a device land on the
    card, as the reference's ``jnp.asarray`` lands on the accelerator."""
    from repro_torch.policy import fleet_torch as ft
    from repro_torch.policy.fleet import FleetState

    stream, arrival, conf, _, _, _ = _fleet_backlog(33, 12, 4)
    lens = np.bincount(stream, minlength=33)
    state = FleetState(33, max_backlog=[12] * 33)
    state.extend(stream, arrival, conf)
    for fleet in (ft.pad_fleet(arrival, conf, lens, 12), ft.fleet_from_state(state, 12)):
        assert all(x.device.type == "cuda" for x in fleet)
        cpu = ft.pad_fleet(arrival, conf, lens, 12, device="cpu")
        assert all(torch.equal(a.cpu(), b) for a, b in zip(fleet, cpu))


@pytest.mark.cuda
def test_fleet_segment_ops_and_ewma_card_match_cpu(cuda_device):
    """The segment ops and ``ewma_fold`` (its exact fused multiply-add in
    float64) bit-equal on the card and the CPU, over-deep streams and
    out-of-range rows included."""
    from repro_torch.policy import fleet_torch as ft

    rng = np.random.default_rng(0)
    S, L, B, N = 257, 12, 5, 3000
    lens = rng.integers(0, L + 1, size=S).astype(np.int32)
    arr = ((rng.integers(0, 64, size=(S, 1)) + np.arange(L)) / 32.0).astype(np.float32)
    conf = rng.uniform(0.05, 0.95, size=(S, L)).astype(np.float32)
    now = (rng.integers(0, 80, size=S) / 32.0).astype(np.float32)
    new_arr = (3.0 + rng.integers(0, 8, size=(S, B)) / 32.0).astype(np.float32)
    new_conf = rng.uniform(0.05, 0.95, size=(S, B)).astype(np.float32)
    masks = [rng.random(S) < 0.7, rng.random((S, L)) < 0.3, rng.random(S) < 0.2, rng.random((S, B)) < 0.6]
    stream = np.r_[rng.integers(0, 8, size=N // 2), rng.integers(-3, S + 3, size=N - N // 2)]
    rate = rng.uniform(1e5, 1e7, size=N).astype(np.float32)
    ok = rng.random(N) < 0.7
    bw = rng.uniform(1e5, 1e7, size=S).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        fleet = ft.PaddedFleet(t(arr), t(conf), t(lens))
        do, take, clear, new_ok = (t(m) for m in masks)
        res = [ft.prune_fleet(fleet, t(now), 0.2, do), ft.consume_fleet(fleet, take, clear),
               ft.extend_fleet(fleet, t(new_arr), t(new_conf), new_ok, L),
               ft.extend_fleet(fleet, t(new_arr), t(new_conf), new_ok, t(np.full(S, 7, np.int32))),
               ft.clear_fleet(fleet, clear)]
        fold = ft.ewma_fold(t(bw), 0.3, t(stream), t(rate), t(ok), S, 6)
        out[dev.type] = [x.cpu().numpy() for f in res for x in f] + [fold.cpu().numpy()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _engine_case(S, dev, *, R=4, batch=8, backlog=8, live=False, varying=False):
    """``bench_fleet_control.py::bench_jax_one``'s synthetic rounds (cbo,
    6 Mbps) on ``dev``: one cell and replica, or (``live``) two cells,
    two replicas batching continuously with jsq placement, and
    (``varying``) a traced cell and a counter-jittered one."""
    from repro_torch.core.netsim import mbps, payload_sizes, png_size_model
    from repro_torch.net.traces import regime_shift_trace
    from repro_torch.policy.fleet_torch import spec_for_policy
    from repro_torch.policy.registry import make_policy
    from repro_torch.serving import engine_torch as et

    sizes = payload_sizes(png_size_model, np.asarray((4, 8)))
    planner = spec_for_policy(make_policy("cbo", max_backlog=backlog), sizes=sizes,
                              acc_server=(0.7, 0.99), deadline=0.2, latency=0.05, server_time=0.037)
    C = K = 2 if (live or varying) else 1
    kw = dict(n_streams=S, batch=batch, n_cells=C, n_replicas=K, planner=planner,
              collect="trace", telemetry=True)
    extra = {}
    if live:
        kw.update(placement="jsq", serial_replicas=True, batch_kind="linear",
                  batch_coeffs=(0.03125, 0.0078125), batch_window=0.03125)
    if varying:
        kw.update(varying=True, cell_jitter=(0.0, 0.3), cell_seed=(0, 1), cell_trace=(True, False),
                  cell_loop=(True, False))
        t, bps = regime_shift_trace(levels_mbps=(20.0, 4.0), period=0.75).grid(pad_to=4)
        extra = dict(trace_t=np.stack([t, np.r_[0.0, np.full(3, np.inf)]]),
                     trace_bps=np.stack([bps, np.full(4, mbps(6.0))]), trace_dur=[1.5, np.inf])
    spec = et.EngineSpec(**kw)
    bw = mbps(6.0)
    rng = np.random.default_rng(0)
    base = (np.arange(R * batch, dtype=np.float32) / 32.0).reshape(R, 1, batch)
    cols = (np.broadcast_to(base, (R, S, batch)).copy(), np.ones((R, S, batch), bool),
            rng.uniform(0.0, 1.0, (R, S, batch)).astype(np.float32),
            rng.random((R, S, batch)) < 0.7, rng.random((R, S, batch, 2)) < 0.9)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev).float()  # noqa: E731
    params = et.EngineParams(
        sizes=f(sizes), cell_bw=f([bw] * C), cell_of=torch.as_tensor(np.arange(S) % C, device=dev),
        replica_st=f([0.037, 0.0555][:K]), stream_bw=f(np.full(S, bw)), weights=f(np.ones(S)),
        bw_init=f(np.full(S, bw)), **{k: f(v) for k, v in extra.items()})
    inputs = et.RoundInputs(*(torch.as_tensor(c, device=dev) for c in cols))
    return spec, params, inputs


def _engine_outputs(carry, ys):
    from repro_torch.serving import engine_torch as et

    names = [f"carry{i}" for i in range(len(et._leaves(carry)))] + \
        [k for k, v in ys._asdict().items() if v is not None]
    return dict(zip(names, (t.cpu().numpy() for t in et._leaves(carry) + et._leaves(ys))))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "live", "varying"])
def test_round_engine_card_matches_cpu(cuda_device, case):
    """The round engine on the card (one CUDA-graph replay a round) against
    the same engine on the CPU: integer outputs equal, floats within the
    differential tolerances (``cumsum`` is a parallel scan on the card)."""
    from repro_torch.serving import engine_torch as et

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        spec, params, inputs = _engine_case(64, dev, live=case == "live", varying=case == "varying")
        out[dev.type] = _engine_outputs(*et.simulate(spec, params, inputs))
    for k, a in out["cpu"].items():
        b = out["cuda"][k]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-2, atol=1e-4, err_msg=k)
        else:
            assert np.array_equal(a, b), k
    assert out["cpu"]["off_counts"].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "live", "varying"])
def test_round_engine_step_syncs_nothing_and_replays_as_eager(cuda_device, case):
    """No host synchronization inside a round on the card (the step under
    ``set_sync_debug_mode("error")``), and the captured graph's rounds equal
    the eager step's bit for bit."""
    from repro_torch.serving import engine_torch as et

    spec, params, inputs = _engine_case(64, cuda_device, live=case == "live", varying=case == "varying")
    eager = et.RoundLoop(spec, params, et.init_carry(spec, params), inputs)
    eager.step()  # first call: constants and output buffers
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(eager.n_rounds - 1):
            eager.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graphed = et.simulate(spec, params, inputs)
    a, b = _engine_outputs(eager.carry, eager.ys), _engine_outputs(*graphed)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.cuda
def test_round_engine_graph_runs_bit_equal_at_fleet_scale(cuda_device):
    """Two graph runs of the same rounds over 800,000 rows (100,000
    streams x 8) give the same bits: the engine's float running sums have
    one association on the card (``_log_step_scan``); torch's CUDA
    ``cumsum`` does not at this size."""
    from repro_torch.serving import engine_torch as et

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand(1 << 23, generator=g, device=cuda_device)
    assert torch.equal(et._cumsum(x), et._cumsum(x))
    outs = []
    for _ in range(2):
        spec, params, inputs = _engine_case(100_000, cuda_device, R=2)
        outs.append(_engine_outputs(*et.simulate(spec, params, inputs)))
    for k, a in outs[0].items():
        assert np.array_equal(a, outs[1][k]), k
    assert outs[0]["off_counts"].sum() > 0


@pytest.mark.cuda
def test_counter_jitter_factors_card_bit_equal_cpu(cuda_device):
    from repro_torch.core.threefry import counter_jitter_factors, normal_from_bits

    secs = torch.arange(65536, dtype=torch.int64)
    for seed, jitter in ((0, 0.3), (7, 0.2), (12345, 0.25)):
        cpu = counter_jitter_factors(seed, secs, jitter)
        card = counter_jitter_factors(seed, secs.to(cuda_device), jitter)
        assert card.is_cuda and torch.equal(card.cpu(), cpu)
    bits = torch.arange(2**23, dtype=torch.int64) << 9  # every uniform
    assert torch.equal(normal_from_bits(bits.to(cuda_device)).cpu(), normal_from_bits(bits))


@pytest.mark.cuda
def test_threefry_defaults_to_the_card(cuda_device):
    """``prng_key`` and ``counter_jitter_factors`` of host seconds, given no
    device, land on the card and equal the CPU's."""
    from repro_torch.core.threefry import counter_jitter_factors, prng_key

    assert prng_key(12345).is_cuda
    assert torch.equal(prng_key(12345).cpu(), prng_key(12345, device="cpu"))
    card = counter_jitter_factors(7, np.arange(4096), 0.3)
    assert card.is_cuda
    assert torch.equal(card.cpu(), counter_jitter_factors(7, np.arange(4096), 0.3, device="cpu"))


@pytest.mark.cuda
def test_multistream_torch_backend_defaults_to_the_card(cuda_device):
    """``MultiStreamServer(backend="torch")`` with no device runs on the card,
    and its rounds equal the same server's on the CPU in every integer
    field, over a counter-jittered 2-cell fabric."""
    from _diff import assert_round_equal

    from repro_torch.core.netsim import Uplink, mbps
    from repro_torch.net import EdgeFabric, ReplicaPool
    from repro_torch.serving import FairScheduler, MultiStreamServer, ServeConfig
    from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers

    S = 6
    imgs, labels = synthetic_streams(S, 48, seed=3)
    recs, metrics = {}, {}
    for dev in (None, "cpu"):
        fast, slow, cal = synthetic_tiers()
        cfg = ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), batch_size=16,
                          frame_rate=32.0, deadline=0.2)
        ups = [Uplink(bandwidth_bps=mbps(30.0), latency=0.05, server_time=cfg.server_time, seed=c,
                      jitter=0.3, jitter_mode="counter") for c in range(2)]
        pool = ReplicaPool(2, np.array([cfg.server_time, cfg.server_time * 1.5]), serial=True)
        srv = MultiStreamServer(cfg, fast, slow, cal, None, n_streams=S,
                                scheduler=FairScheduler("round_robin"),
                                fabric=EdgeFabric(ups, pool, n_streams=S, placement="jsq"),
                                backend="torch", device=dev)
        assert srv.device.type == ("cuda" if dev is None else "cpu")
        r = []
        srv.round_hook = r.append
        metrics[dev] = srv.process_streams(imgs, labels)
        recs[dev] = r
    for i, (a, b) in enumerate(zip(recs["cpu"], recs[None])):
        assert_round_equal(a, b, ctx=f"round {i}")
    assert metrics["cpu"].summary() == metrics[None].summary()


@pytest.mark.cuda
def test_multistream_stages_frames_through_one_pinned_buffer(cuda_device, monkeypatch):
    """The numpy loop on the card fills each round's frames into a pinned
    ``FrameStage`` and copies them without blocking.  Over a clip of five
    rounds (the last of 8 frames) its answers, confidences, round records
    and metrics are bit-equal to the same server with the stage's two
    steps put back to the slice and the pageable copy; ``staged`` counts
    one a round, ``syncs`` 4 + k with k planned resolutions escalated, else
    2; a second server takes the first one's freed pinned block back."""
    from repro_torch.core.netsim import Uplink, mbps
    from repro_torch.net import EdgeFabric, ReplicaPool
    from repro_torch.obs import Telemetry
    from repro_torch.serving import FairScheduler, MultiStreamServer, ServeConfig
    from repro_torch.serving import engine
    from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers

    S = 6
    imgs, labels = synthetic_streams(S, 72, seed=3)
    stages, outs = [], []

    class Kept(engine.FrameStage):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            stages.append(self)

    def logged(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            outs[-1].append([t.cpu() for t in (out if isinstance(out, tuple) else (out,))])
            return out
        return call

    monkeypatch.setattr(engine, "FrameStage", Kept)
    monkeypatch.setattr(engine, "fast_pass", logged(engine.fast_pass))
    monkeypatch.setattr(engine, "slow_pass_multires", logged(engine.slow_pass_multires))

    def serve():
        fast, slow, cal = synthetic_tiers()
        cfg = ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), batch_size=16,
                          frame_rate=32.0, deadline=0.2)
        ups = [Uplink(bandwidth_bps=mbps(30.0), latency=0.05, server_time=cfg.server_time, seed=c)
               for c in range(2)]
        pool = ReplicaPool(2, np.array([cfg.server_time, cfg.server_time * 1.5]), serial=True)
        tel = Telemetry(record=False, profile=True)
        srv = MultiStreamServer(cfg, fast, slow, cal, None, n_streams=S,
                                scheduler=FairScheduler("round_robin"),
                                fabric=EdgeFabric(ups, pool, n_streams=S, placement="jsq"),
                                telemetry=tel, device=cuda_device)
        outs.append([])
        recs = []
        srv.round_hook = recs.append
        summary = srv.process_streams(imgs, labels).summary()
        return summary, recs, outs[-1], tel.profiler

    staged = serve()
    assert len(stages) == 1 and stages[0].buf.is_pinned()
    assert stages[0].buf.shape == (S * 16, *imgs.shape[2:])
    with monkeypatch.context() as m:
        m.setattr(engine.FrameStage, "fill", lambda self, start, b: self.src.numpy()[
            :, start : start + b].reshape(-1, *self.src.shape[2:]))
        m.setattr(engine.FrameStage, "to_device", lambda self, host: torch.as_tensor(host, device=self.device))
        plain = serve()
    assert staged[0] == plain[0]
    assert len(staged[1]) == len(plain[1]) == 5
    for r, (a, b) in enumerate(zip(staged[1], plain[1])):
        assert set(a) == set(b), r
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), (r, k)
    assert len(staged[2]) == len(plain[2])
    for a, b in zip(staged[2], plain[2]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    prof = staged[3]
    assert prof.counters["staged"] == {r: 1 for r in range(5)}
    saw_k = set()
    for r, hook in enumerate(staged[1]):
        esc_streams = np.nonzero(hook["esc"])[0]
        k = len(np.unique(hook["res_idx"][esc_streams]))
        saw_k.add(k)
        assert prof.counters["syncs"][r] == (4 + k if k else 2), (r, k)
    assert saw_k - {0}

    stages.clear()
    del staged, plain
    torch.cuda.synchronize()
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    serve()
    assert stages[0].buf.is_pinned()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before


def _unet_attention_calls(cfg) -> int:
    """Flash launches of one UNet forward: a self and a cross call per
    transformer block, down (n_res_blocks a stage), mid and up
    (n_res_blocks + 1 a stage)."""
    blocks = sum(d * (2 * cfg.n_res_blocks + 1) for d in cfg.transformer_depth) + cfg.transformer_depth[-1]
    return 2 * blocks


@pytest.mark.cuda
def test_swin_dit_unet_default_to_the_card(cuda_device):
    from repro_torch.configs.dit_b2 import SMOKE as DIT_SMOKE
    from repro_torch.configs.swin_b import SMOKE as SWIN_SMOKE
    from repro_torch.configs.unet_sdxl import SMOKE as UNET_SMOKE
    from repro_torch.models.api import build

    for cfg in (SWIN_SMOKE, DIT_SMOKE, UNET_SMOKE):
        model = build(cfg).init(torch.Generator(device="cuda").manual_seed(0))
        assert all(p.is_cuda for p in model.parameters()), cfg.name


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["swin", "dit", "unet"])
def test_swin_dit_unet_card_match_cpu_and_count_launches(cuda_device, no_tf32, which):
    """float32, TF32 off, every zero-initialised leaf drawn: the card's
    forward (DiT and the UNet through the flash kernel, the counted number
    of launches; Swin through none) against the CPU's (which launches
    nothing) within 1e-4, ``test_torch_vit.py``'s limit."""
    from repro_torch.configs.dit_b2 import SMOKE as DIT_SMOKE
    from repro_torch.configs.swin_b import SMOKE as SWIN_SMOKE
    from repro_torch.configs.unet_sdxl import SMOKE as UNET_SMOKE
    from repro_torch.models.dit import DiT
    from repro_torch.models.swin import Swin
    from repro_torch.models.unet import UNet

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.default_rng(5)
        if which == "swin":
            cls, cfg, calls = Swin, SWIN_SMOKE, 0
            inputs = [torch.as_tensor(rng.standard_normal((3, 32, 32, 3)).astype(np.float32))]
        elif which == "dit":
            cls, cfg, calls = DiT, DIT_SMOKE, DIT_SMOKE.n_layers
            inputs = [torch.as_tensor(rng.standard_normal((3, 4, 4, 4)).astype(np.float32)),
                      torch.as_tensor([0, 499, 999]), torch.as_tensor([0, 5, 10])]
        else:
            cls, cfg, calls = UNet, UNET_SMOKE, _unet_attention_calls(UNET_SMOKE)
            inputs = [torch.as_tensor(rng.standard_normal((2, 8, 8, 4)).astype(np.float32)),
                      torch.as_tensor([3, 900]), torch.as_tensor(rng.standard_normal((2, 77, 64)).astype(np.float32))]
        cpu = cls(cfg, device="cpu", dtype=torch.float32)
        cpu.reset_parameters(torch.Generator().manual_seed(1), zero_std=0.02)
        card = cls(cfg, device=cuda_device, dtype=torch.float32)
        card.load_state_dict(cpu.state_dict())
        before = fa_kernel.flash_attention.launches
        with torch.inference_mode():
            oc = cpu(*inputs)
            assert fa_kernel.flash_attention.launches == before
            og = card(*(t.to(cuda_device) for t in inputs))
        assert fa_kernel.flash_attention.launches == before + calls
        assert og.is_cuda and og.shape == oc.shape and float(oc.abs().max()) > 0.1
        torch.testing.assert_close(og.cpu(), oc, rtol=0, atol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
def test_unet_bf16_launches_flash_at_each_attention(cuda_device):
    """bf16 on the card: the self and the 77-key cross attention of every
    transformer block launch the kernel, nothing falls back."""
    from repro_torch.configs.unet_sdxl import SMOKE as UNET_SMOKE
    from repro_torch.models.unet import UNet

    g = torch.Generator(device="cuda").manual_seed(2)
    model = UNet(UNET_SMOKE, generator=g, device=cuda_device)
    model.reset_parameters(g, zero_std=0.02)
    x = torch.randn(2, 8, 8, 4, generator=g, device="cuda").bfloat16()
    ctx = torch.randn(2, 77, UNET_SMOKE.ctx_dim, generator=g, device="cuda").bfloat16()
    before = fa_kernel.flash_attention.launches
    with torch.inference_mode():
        out = model(x, torch.tensor([10, 500], device="cuda"), ctx)
    assert fa_kernel.flash_attention.launches == before + _unet_attention_calls(UNET_SMOKE) == before + 14
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


def _wrapper_calls(device):
    """Each kernel wrapper with small inputs whose float leaves ask for grad."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def f32(*shape):
        return torch.randn(*shape, generator=g, device=device).requires_grad_(True)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=device, dtype=torch.int8)

    return {
        "calib_gate": (cg_kernel.calib_gate, lambda: cg_kernel.calib_gate(f32(4, 10), -6.0, 2.0, 0.5)),
        "flash_attention": (fa_kernel.flash_attention,
                            lambda: fa_kernel.flash_attention(f32(1, 64, 2, 64), f32(1, 64, 2, 64), f32(1, 64, 2, 64),
                                                              causal=False)),
        "int8_matmul": (i8_kernel.int8_matmul,
                        lambda: i8_kernel.int8_matmul(s8(16, 32), f32(16, 1).abs(), s8(32, 16),
                                                      torch.rand(1, 16, generator=g, device=device))),
        "int8_kv_decode": (kv_kernel.int8_kv_decode,
                           lambda: kv_kernel.int8_kv_decode(f32(2, 4, 64), s8(2, 32, 2, 64),
                                                            torch.rand(2, 32, generator=g, device=device), s8(2, 32, 2, 64),
                                                            torch.rand(2, 32, generator=g, device=device))),
        "conv_epilogue": (ce_kernel.conv_epilogue,
                          lambda: ce_kernel.conv_epilogue(f32(2, 4, 6, 6), f32(4), f32(4), act=True, pad=(1, 1, 1, 1))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["calib_gate", "flash_attention", "int8_matmul", "int8_kv_decode", "conv_epilogue"])
def test_kernel_wrappers_raise_under_autograd(cuda_device, name):
    """No kernel has a backward: with grad enabled and an input that
    requires grad the wrapper raises before it launches; under ``no_grad``
    (the same inputs) and ``inference_mode`` it launches."""
    wrapper, call = _wrapper_calls(cuda_device)[name]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert wrapper.launches == before
    with torch.no_grad():
        out = call()
    with torch.inference_mode():
        call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert not (out[0] if isinstance(out, tuple) else out).requires_grad


@pytest.mark.cuda
def test_vit_backward_on_the_card_raises(cuda_device):
    """A ViT's parameters ask for grad; its attention on the card is the
    flash kernel, whose output has no grad_fn.  A forward under autograd
    raises instead of leaving ``wqkv.grad`` at None after a backward."""
    model = ViT(DEIT_SMOKE, generator=torch.Generator().manual_seed(0), device=cuda_device)
    x = torch.randn(2, DEIT_SMOKE.img_res, DEIT_SMOKE.img_res, 3, device=cuda_device)
    assert model.layers[0].attn.wqkv.requires_grad
    with pytest.raises(RuntimeError, match="no backward"):
        model(x).sum().backward()
    assert model.layers[0].attn.wqkv.grad is None
    with torch.inference_mode():
        assert torch.isfinite(model(x)).all()


@pytest.mark.cuda
def test_slow_tier_grads_card_match_cpu(cuda_device):
    """One batch of the paper's slow tier (``bench/stack.py``'s SLOW_CFG),
    float32, TF32 off: the loss within 1e-5 relative and every gradient
    leaf within 1e-4 of its scale (the larger of its largest magnitude and
    1e-3 of the model's), cuDNN's convolutions against the CPU's."""
    from repro_torch.bench.stack import DATA_CFG, SLOW_CFG, init_tier
    from repro_torch.data.video import make_dataset
    from repro_torch.models.api import build

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        data = make_dataset(DATA_CFG, 6, seed=0)
        batch = {"images": torch.as_tensor(data["frames"][:64]), "labels": torch.as_tensor(data["labels"][:64]).long()}
        loss_fn = build(SLOW_CFG).loss
        out = {}
        for dev in ("cpu", cuda_device):
            model = init_tier(SLOW_CFG, 0, dev)
            params = dict(model.named_parameters())
            loss = loss_fn(model, {k: v.to(dev) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(params.values()))
            out[str(dev)] = (float(loss.detach()), {k: g.cpu() for k, g in zip(params, grads)})
        (lc, gc), (lg, gg) = out["cpu"], out[str(cuda_device)]
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        floor = 1e-3 * max(float(g.abs().max()) for g in gc.values())
        for k in gc:
            scale = max(float(gc[k].abs().max()), floor)
            assert float((gg[k] - gc[k]).abs().max()) <= 1e-4 * scale, k
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _dispatcher_calls(device):
    """Each kernel's dispatcher (``ops.py``) on ``device``, with inputs of
    that device's kind (meta tensors hold no values)."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.fused_calib_gate.ops import calibrated_gate
    from repro_torch.kernels.int8_kv_decode.ops import decode_attention
    from repro_torch.kernels.int8_matmul.ops import quantized_matmul

    g = torch.Generator().manual_seed(0)

    def f(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(device)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(device)

    return {
        "calib_gate": lambda: calibrated_gate(f(8, 1000), -6.0, 2.0, 0.5),
        "flash_attention": lambda: attention(*(f(2, 80, 4, 64, dtype=torch.bfloat16) for _ in range(3)), causal=True),
        "int8_matmul": lambda: quantized_matmul(f(32, 64), f(64, 48)),
        "int8_kv_decode": lambda: decode_attention(f(2, 8, 64), s8(2, 40, 2, 64), f(2, 40).abs(), s8(2, 40, 2, 64),
                                                   f(2, 40).abs()),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["calib_gate", "flash_attention", "int8_matmul", "int8_kv_decode"])
def test_dispatchers_report_the_same_cost_on_the_card_and_on_meta(cuda_device, name):
    """On the card a dispatcher launches its kernel once and reports
    ``kernels/cost.py``'s formula to the open counter; on meta it launches
    nothing and reports the same numbers."""
    from repro_torch.launch.roofline import CostCounter

    wrapper = {"calib_gate": cg_kernel.calib_gate, "flash_attention": fa_kernel.flash_attention,
               "int8_matmul": i8_kernel.int8_matmul, "int8_kv_decode": kv_kernel.int8_kv_decode}[name]
    counts = {}
    for dev in ("cuda", "meta"):
        call = _dispatcher_calls(dev)[name]
        before = wrapper.launches
        with torch.no_grad(), CostCounter() as c:
            call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + (dev == "cuda")
        counts[dev] = c.per_kernel[name]
    assert counts["cuda"] == counts["meta"] and counts["cuda"][0] == 1


@pytest.mark.cuda
def test_counts_on_the_card_equal_meta_counts(cuda_device):
    """deit-smoke's bf16 forward (the flash kernel, D = 16) and a
    resnet-smoke train step (bf16 casts of float32 masters, backward,
    AdamW) counted on the card and on meta: the same FLOPs and bytes."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cells import make_step
    from repro_torch.launch.roofline import CostCounter
    from repro_torch.models import api
    from repro_torch.train import optim

    deit, resnet = api.build(DEIT_SMOKE), api.build(SMOKE)
    shape = ShapeSpec("cls", "train", img_res=SMOKE.img_res, batch=4)
    step = make_step(resnet, SMOKE, shape, optim.OptimConfig())
    counts = {}
    for dev in ("cuda", "meta"):
        with torch.device(dev):
            vit = deit.init(torch.Generator(device="cuda").manual_seed(0) if dev == "cuda" else None, dev,
                            torch.bfloat16)
            rn = resnet.init(torch.Generator(device="cuda").manual_seed(1) if dev == "cuda" else None, dev,
                             torch.float32)
        imgs = torch.randn(4, DEIT_SMOKE.img_res, DEIT_SMOKE.img_res, 3, device="cpu").to(dev, torch.bfloat16)
        batch = {"images": torch.randn(4, SMOKE.img_res, SMOKE.img_res, 3).to(dev, torch.bfloat16),
                 "labels": torch.randint(0, SMOKE.n_classes, (4,)).to(dev, torch.int32)}
        opt = optim.init_state(optim.OptimConfig(), rn)
        with CostCounter() as c:
            with torch.no_grad():
                deit.forward(vit, imgs)
            step(rn, opt, batch)
        counts[dev] = (c.flops, c.bytes, dict(c.per_kernel))
    assert counts["cuda"] == counts["meta"]
    assert counts["cuda"][2]["flash_attention"][0] == DEIT_SMOKE.n_layers
    assert counts["cuda"][2]["conv_epilogue"][0] == 1 + sum(3 + (b == 0) for d in SMOKE.depths for b in range(d))


@pytest.mark.cuda
def test_host_shard_on_a_one_card_mesh(cuda_device):
    """A (1, 1) ``DeviceMesh`` over the card in a one-process NCCL group:
    ``host_shard`` places a host tensor on the card as a ``DTensor`` with
    the resolved placements, and its local shard is the whole tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_local_mesh, process_group
    from repro_torch.sharding.axes import host_shard, sharding_ctx

    with process_group("cuda"):
        mesh = make_local_mesh(model_axis=8, device="cuda")
        assert mesh.device_type == "cuda" and tuple(mesh.mesh.shape) == (1, 1)
        x = torch.arange(24.0).reshape(4, 6)
        with sharding_ctx(mesh):
            d = host_shard(x, "batch", None)
        assert isinstance(d, DTensor) and d.placements == (Shard(0), Replicate())
        assert d.to_local().is_cuda and torch.equal(d.to_local().cpu(), x)
