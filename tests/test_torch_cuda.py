"""Tests of the port that run its CUDA kernels: they need an NVIDIA GPU and
skip without one.  This file imports neither JAX nor the JAX package, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel against plain version: ``calib`` within 1e-6 (the row sum in
another order), ``gate`` exact.  Card against CPU through a whole SMOKE
fast pass, TF32 off: ``conf`` within 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.resnet_50 import SMOKE
from repro_torch.core.cascade import fast_pass
from repro_torch.kernels.fused_calib_gate import kernel as cg_kernel
from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref
from repro_torch.models.resnet import ResNet
from repro_torch.quant.quantize import qdq_tree

PLATT = [(-6.0, 2.0, 0.7), (-1.0, 0.0, 0.5), (-20.0, 5.0, 0.3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _logits(B, V, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("B,V", [(16, 1000), (128, 4096), (37, 1001), (8, 152064), (1, 1)])
def test_calib_gate_cuda_matches_plain_version(cuda_device, B, V):
    x = torch.as_tensor(_logits(B, V, seed=B * V), device=cuda_device)
    for a, b, theta in PLATT:
        before = cg_kernel.calib_gate.launches
        ck, gk = cg_kernel.calib_gate(x, a, b, theta)
        torch.cuda.synchronize()
        assert cg_kernel.calib_gate.launches == before + 1
        cr, gr = calib_gate_ref(x, a, b, theta)
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
    x = torch.zeros(4, 10, device=cuda_device)
    with pytest.raises(TypeError):
        cg_kernel.calib_gate(x.half(), -6.0, 2.0, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        cg_kernel.calib_gate(x.t(), -6.0, 2.0, 0.5)
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
