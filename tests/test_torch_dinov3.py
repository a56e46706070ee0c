"""The port's DINOv3 ViT (``models/dinov3.py``) against a plain forward.

The oracle (``tests/_dinov3_ref.py``) writes out ``transformers``'
DINOv3 equations in float32 on the port's parameter names; every leaf is
drawn at random (norm scales 1 + 0.1·N, biases and tokens at 0.02,
LayerScale at 1), so that a bias, a norm or a LayerScale the program drops
changes the logits.  On the CPU the attention is the flash kernel's plain
version; the ``cuda`` tests hold the kernel at DINOv3 ViT-H+'s attention
shape and the model card against CPU.  No JAX here: the JAX package has no
DINOv3.
"""
import math

import numpy as np
import pytest
import torch

import _dinov3_ref
from repro_torch.configs.dinov3_vith16plus import FULL, SMOKE
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import dinov3 as dinov3_mod
from repro_torch.models.dinov3 import DINOv3
from repro_torch.models.layers import apply_rope_2d, rope_2d_table
from repro_torch.obs.profile import PhaseProfiler

SMOKE_RTOL = 1e-5  # f32 products summed in another order, 2 layers
FULL_RTOL = 1e-4  # the same at d = 1280, d_ff = 5120 over 201 tokens


def _draw(model: DINOv3, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, p in model.named_parameters():
        z = torch.randn(p.shape, generator=g)
        if p.ndim == 2 and name != "reg_tokens":
            state[name] = z / math.sqrt(p.shape[1])
        elif name.endswith((".ls1", ".ls2")):
            state[name] = z
        elif name.endswith(".scale"):
            state[name] = 1 + 0.1 * z
        else:
            state[name] = 0.02 * z
    return state


def _both(cfg, n: int, seed: int):
    model = DINOv3(cfg, device="cpu")
    state = _draw(model, seed)
    model.load_state_dict(state, strict=True)
    x = torch.randn(n, cfg.img_res, cfg.img_res, 3, generator=torch.Generator().manual_seed(seed + 1))
    with torch.inference_mode():
        got = model(x)
    want = _dinov3_ref.forward(state, x, patch=cfg.patch, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                               n_registers=cfg.n_registers, rope_theta=cfg.rope_theta)
    return got, want


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_smoke_forward_matches_plain(seed):
    got, want = _both(SMOKE, 5, seed)
    assert got.shape == (5, SMOKE.n_classes) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= SMOKE_RTOL * float(want.abs().max())


def test_one_layer_at_published_widths_matches_plain():
    cfg = FULL.__class__(**{**FULL.__dict__, "n_layers": 1})
    got, want = _both(cfg, 1, 3)
    assert got.shape == (1, 1000)
    assert float((got - want).abs().max()) <= FULL_RTOL * float(want.abs().max())


def test_param_count_counts_every_leaf():
    for cfg in (SMOKE, FULL.__class__(**{**FULL.__dict__, "n_layers": 1})):
        model = DINOv3(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) == cfg.param_count
    assert FULL.param_count == 32 * 26_237_440 + 16 * 16 * 3 * 1280 + 1280 + 5 * 1280 + 2 * 1280 + 1_281_000


@pytest.mark.parametrize("n_h,n_w,d_head", [(14, 14, 64), (4, 4, 16), (3, 5, 64)])
def test_rope_table_matches_closed_form(n_h, n_w, d_head):
    cos, sin = rope_2d_table(n_h, n_w, d_head, 100.0)
    q = d_head // 4
    want = np.empty((n_h * n_w, d_head))
    for r in range(n_h):
        for c in range(n_w):
            y, x = 2 * (r + 0.5) / n_h - 1, 2 * (c + 0.5) / n_w - 1
            for j in range(q):
                f = 2 * math.pi * 100.0 ** (-j / q)
                for t in (0, 2 * q):  # tiled twice
                    want[r * n_w + c, t + j] = y * f
                    want[r * n_w + c, t + q + j] = x * f
    assert cos.shape == sin.shape == (n_h * n_w, d_head) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.cos(want), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.sin(want), atol=2e-6)


def test_rope_rotates_patches_only():
    n_prefix, H, D = 5, 3, 16
    cos, sin = rope_2d_table(2, 3, D, 100.0)
    x = torch.randn(2, n_prefix + 6, H, D, generator=torch.Generator().manual_seed(4))
    out = apply_rope_2d(x, cos, sin, n_prefix)
    assert out.is_contiguous() and out.shape == x.shape
    assert torch.equal(out[:, :n_prefix], x[:, :n_prefix])
    pat = x[:, n_prefix:]
    rot = torch.cat((-pat[..., D // 2:], pat[..., :D // 2]), dim=-1)
    torch.testing.assert_close(out[:, n_prefix:], pat * cos[:, None] + rot * sin[:, None], rtol=0, atol=1e-6)
    # a rotation: each patch token's norm a head is kept
    torch.testing.assert_close(out.norm(dim=-1), x.norm(dim=-1), rtol=1e-5, atol=0)
    # q and k rotated at once, as the model passes them: (2, B, S, H, D) of a strided view
    qkv = torch.randn(2, n_prefix + 6, 3, H, D, generator=torch.Generator().manual_seed(5))
    both = apply_rope_2d(qkv[:, :, :2].permute(2, 0, 1, 3, 4), cos, sin, n_prefix)
    assert both[0].is_contiguous() and both[1].is_contiguous()
    torch.testing.assert_close(both[1], apply_rope_2d(qkv[:, :, 1], cos, sin, n_prefix), rtol=0, atol=0)


def test_no_k_bias_in_the_forward(monkeypatch):
    """With the qkv weight zero, q is the q bias, v the v bias, and k is 0."""
    model = DINOv3(SMOKE, device="cpu")
    model.load_state_dict(_draw(model, 6))
    assert not any(".bk" in n for n, _ in model.named_parameters())
    for layer in model.layers:
        layer.attn.wqkv.data.zero_()
    seen = []
    monkeypatch.setattr(dinov3_mod, "apply_rope_2d", lambda x, *a: seen.append(x.clone()) or apply_rope_2d(x, *a))
    with torch.inference_mode():
        model(torch.randn(2, 32, 32, 3))
    assert len(seen) == SMOKE.n_layers
    for qk, layer in zip(seen, model.layers):
        H, dh = SMOKE.n_heads, SMOKE.d_model // SMOKE.n_heads
        assert torch.equal(qk[1], torch.zeros_like(qk[1]))
        assert torch.equal(qk[0], layer.attn.bq.view(H, dh).expand_as(qk[0]))


def test_layer_scale_and_biases_reach_the_logits():
    model = DINOv3(SMOKE, device="cpu")
    state = _draw(model, 8)
    model.load_state_dict(state)
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(9))
    with torch.inference_mode():
        base = model(x)
        for key in ("layers.1.ls1", "layers.1.ls2", "layers.0.attn.bq", "layers.0.attn.bv", "layers.0.mlp.bg",
                    "layers.0.mlp.bu", "layers.0.mlp.bd", "reg_tokens"):
            model.load_state_dict({**state, key: torch.ones_like(state[key])})
            assert not torch.allclose(model(x), base, rtol=0, atol=1e-4), key


def _range_counts(prof) -> dict:
    names = [e.name for e in prof.events()]
    return {n: names.count(n) for n in ("vit.rope", "vit.attn")}


def test_model_ranges_only_inside_the_loops_profiled_spans():
    from repro_torch.configs.deit_b import SMOKE as DEIT_SMOKE
    from repro_torch.models.vit import ViT

    dino = DINOv3(SMOKE, device="cpu")
    dino.load_state_dict(_draw(dino, 10))
    deit = ViT(DEIT_SMOKE, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 32, 32, 3)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.inference_mode():
        with torch.profiler.profile(activities=acts) as off:
            dino(x), deit(x)
        prof = PhaseProfiler()
        with torch.profiler.profile(activities=acts) as on:
            prof.open_round()
            prof.open("slow")
            dino(x), deit(x)
            prof.close_all()
        outside = PhaseProfiler()
        outside.open("slow")  # no recording profiler: the span holds no range
        with torch.profiler.profile(activities=acts) as later:
            dino(x)
        outside.close()
    assert _range_counts(off) == {"vit.rope": 0, "vit.attn": 0}
    assert _range_counts(later) == {"vit.rope": 0, "vit.attn": 0}
    assert _range_counts(on) == {"vit.rope": SMOKE.n_layers, "vit.attn": SMOKE.n_layers + DEIT_SMOKE.n_layers}
    names = {e.name for e in on.events()}
    assert not any("flash_attention" in n or "calib_gate" in n for n in names if n.startswith("vit."))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_attention_cuda_at_dinov3_shape(cuda_device):
    """(4, 201, 20, 64) f32: q and k rotated and contiguous, v a strided
    view of the projection, as ``models/dinov3.py`` passes them."""
    B, S, H, D = 4, 201, 20, 64
    rng = np.random.default_rng(201)
    qkv = torch.as_tensor(rng.standard_normal((B, S, 3, H, D)).astype(np.float32), device=cuda_device)
    cos, sin = rope_2d_table(14, 14, D, 100.0, cuda_device)
    qk = apply_rope_2d(qkv[:, :, :2].permute(2, 0, 1, 3, 4), cos, sin, 5)
    q, k, v = qk[0], qk[1], qkv[:, :, 2]
    assert q.is_contiguous() and k.is_contiguous() and not v.is_contiguous()
    before = fa_kernel.flash_attention.launches
    out = fa_kernel.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=False), rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_dinov3_forward_card_matches_cpu(cuda_device):
    cpu = DINOv3(SMOKE, device="cpu")
    state = _draw(cpu, 11)
    cpu.load_state_dict(state)
    card = DINOv3(SMOKE, device=cuda_device)
    card.load_state_dict(state)
    x = torch.randn(6, 32, 32, 3, generator=torch.Generator().manual_seed(12))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            before = fa_kernel.flash_attention.launches
            got = card(x.to(cuda_device)).cpu()
            assert fa_kernel.flash_attention.launches == before + SMOKE.n_layers
            want = cpu(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
