"""The port's diffusion models (``models/dit.py``, ``models/unet.py``) and
their configs against the JAX reference.

Every leaf of the reference tree is drawn with numpy from a seed
(``_ref_tree.draw_tree``), the zero-initialised ones too (adaLN-Zero's
modulation and final layer, the UNet's ``proj_out``, every bias at std
0.02): on the reference's init those make each block's output exactly 0,
and a parity test would pass with attention never run.  The tree goes
through ``params_from_jax`` into the port's module; the same numpy
latents, timesteps and conditioning go through both forwards, float32.

DiT's eps + sigma agree within ``DIT_ATOL`` = 1e-4 and the UNet's eps
within ``UNET_ATOL`` = 1e-4, ``test_torch_vit.py``'s limit: float32 sums
in another order through 2 layers, or 2 stages of convolutions and
attention, on outputs of magnitude 0.5 to 2.  The largest differences
measured over three seeds were 2.5e-7 (DiT) and 2.6e-6 (UNet).  The
SAME stride-2 padding, the nearest 2x upsampling and DiT's sincos grid are
bit-equal (the convolution on an integer grid, where every sum is exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ref_tree import draw_tree, meta_state_dict
from repro.configs import base as jbase
from repro.configs.dit_b2 import FULL as JAX_DIT_B2, SMOKE as JAX_DIT_SMOKE
from repro.configs.unet_sdxl import FULL as JAX_UNET_SDXL, SMOKE as JAX_UNET_SMOKE
from repro.models import api as japi
from repro.models import dit as jdit
from repro.models import layers as jlayers
from repro.models import unet as junet
from repro.models.ptree import tree_count
from repro_torch.configs import base as tbase
from repro_torch.configs.dit_b2 import FULL as DIT_B2, SMOKE as DIT_SMOKE
from repro_torch.configs.unet_sdxl import FULL as UNET_SDXL, SMOKE as UNET_SMOKE
from repro_torch.models import api as tapi
from repro_torch.models import dit as tdit
from repro_torch.models import layers as tlayers
from repro_torch.models import unet as tunet
from repro_torch.models.convert import params_from_jax

DIT_ATOL = 1e-4
UNET_ATOL = 1e-4


def _dit_inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    lat = cfg.img_res // cfg.latent_factor
    latents = rng.standard_normal((B, lat, lat, cfg.in_channels)).astype(np.float32)
    return latents, rng.integers(0, 1000, B).astype(np.int32), rng.integers(0, cfg.n_classes + 1, B).astype(np.int32)


def _unet_inputs(cfg, B, seed):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((B, cfg.latent_res, cfg.latent_res, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((B, japi.CTX_TOKENS, cfg.ctx_dim)).astype(np.float32)
    return latents, rng.integers(0, 1000, B).astype(np.int32), ctx


def _torch(*arrays):
    return [torch.as_tensor(a).long() if a.dtype == np.int32 else torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_dit_smoke_matches_reference(seed):
    pn = draw_tree(jdit.dit_param_spec(JAX_DIT_SMOKE), seed)
    model = tdit.DiT(DIT_SMOKE, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(pn), strict=True)
    inputs = _dit_inputs(DIT_SMOKE, 3, seed)
    ref = np.asarray(jdit.dit_forward(jax.tree.map(jnp.asarray, pn), *map(jnp.asarray, inputs), JAX_DIT_SMOKE))
    with torch.no_grad():
        out = model(*_torch(*inputs))
    assert out.shape == (3, 4, 4, 8) and out.dtype == torch.float32  # eps and sigma
    assert np.abs(ref).max() > 0.1  # the zero-initialised leaves were drawn: the output is not 0
    np.testing.assert_allclose(out.numpy(), ref, atol=DIT_ATOL, rtol=0)


def test_dit_at_a_second_latent_size_matches_reference():
    """The sincos grid follows the latent size: 16 x 16 latents, 64 tokens."""
    pn = draw_tree(jdit.dit_param_spec(JAX_DIT_SMOKE), 5)
    model = tdit.DiT(DIT_SMOKE, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(pn), strict=True)
    latents, t, y = _dit_inputs(dataclasses.replace(DIT_SMOKE, img_res=128), 2, 5)
    ref = np.asarray(jdit.dit_forward(jax.tree.map(jnp.asarray, pn), jnp.asarray(latents), jnp.asarray(t),
                                      jnp.asarray(y), JAX_DIT_SMOKE, unroll=True))
    with torch.no_grad():
        out = model(*_torch(latents, t, y))
    assert out.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=DIT_ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_unet_smoke_matches_reference(seed):
    pn = draw_tree(junet.unet_param_spec(JAX_UNET_SMOKE), seed)
    model = tunet.UNet(UNET_SMOKE, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(pn), strict=True)
    inputs = _unet_inputs(UNET_SMOKE, 2, seed)
    ref = np.asarray(junet.unet_forward(jax.tree.map(jnp.asarray, pn), *map(jnp.asarray, inputs), JAX_UNET_SMOKE))
    with torch.no_grad():
        out = model(*_torch(*inputs))
    assert out.shape == (2, 8, 8, 4) and out.dtype == torch.float32
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=UNET_ATOL, rtol=0)


@pytest.mark.parametrize("n", [8, 9, 7])
def test_same_stride2_conv_bit_equal(n):
    """On an even size SAME pads (0, 1), on an odd one (1, 1): integer
    inputs and weights keep every sum exact, so the two agree bit for bit,
    and a symmetric ``padding=1`` does not."""
    rng = np.random.default_rng(n)
    x = rng.integers(-3, 4, (2, n, n, 5)).astype(np.float32)
    w = rng.integers(-2, 3, (3, 3, 5, 6)).astype(np.float32)  # HWIO
    b = rng.integers(-2, 3, (6,)).astype(np.float32)
    ref = np.asarray(junet._conv({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride=2))
    tp = {"w": torch.as_tensor(w).permute(3, 2, 0, 1).contiguous(), "b": torch.as_tensor(b)}
    got = tunet._conv(tp, torch.as_tensor(x), stride=2)
    assert got.shape == ref.shape == (2, -(-n // 2), -(-n // 2), 6)
    np.testing.assert_array_equal(got.numpy(), ref)
    sym = torch.nn.functional.conv2d(torch.as_tensor(x).permute(0, 3, 1, 2), tp["w"], stride=2, padding=1)
    assert np.array_equal((sym.permute(0, 2, 3, 1) + tp["b"]).numpy(), ref) == (n % 2 == 1)
    same1 = np.asarray(junet._conv({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    np.testing.assert_array_equal(tunet._conv(tp, torch.as_tensor(x)).numpy(), same1)


@pytest.mark.parametrize("shape", [(2, 3, 5, 2), (1, 4, 4, 7)])
def test_nearest_upsample_bit_equal(shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) * 2 + 1  # odd values
    B, H, W, C = shape
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (B, 2 * H, 2 * W, C), "nearest"))
    np.testing.assert_array_equal(tunet.upsample_nearest_2x(torch.as_tensor(x)).numpy(), ref)


@pytest.mark.parametrize("C", [32, 64, 8])
def test_group_norm_matches_reference(C):
    """min(32, C) groups of contiguous channels, float32 statistics,
    float32 scale and bias before the cast back.  From bfloat16 both round
    the same float32 value once, so they differ by at most one bfloat16
    step where float32 noise straddles a rounding boundary (2^-7 of the
    value, rtol 8e-3)."""
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((2, 4, 3, C)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(C).astype(np.float32), "bias": rng.standard_normal(C).astype(np.float32)}
    ref = np.asarray(junet.apply_gn(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = tunet.apply_gn({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    xb = torch.as_tensor(x).bfloat16()
    refb = np.asarray(junet.apply_gn(jax.tree.map(jnp.asarray, p), jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)))
    gotb = tunet.apply_gn({k: torch.as_tensor(v) for k, v in p.items()}, xb)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(), refb.astype(np.float32), atol=1e-5, rtol=8e-3)


def test_sinusoidal_embedding_and_sincos_grid_match_reference():
    """The embedding within ``2**-14``: XLA's float32 ``exp`` and torch's
    differ in the last bit for some frequencies (16 of 160 at dim 320), and
    at t = 999 one float32 step of the angle t·f is 2^-14.  The sincos
    grid, float64 on the host in both, is bit-equal."""
    t = np.array([0, 1, 249, 499, 749, 999], np.int32)
    for dim in (256, 320, 32):
        ref = np.asarray(jlayers.sinusoidal_embedding(jnp.asarray(t), dim))
        got = tlayers.sinusoidal_embedding(torch.as_tensor(t).long(), dim)
        assert got.dtype == torch.float32 and got.shape == (6, dim)
        np.testing.assert_allclose(got.numpy(), ref, atol=2**-14, rtol=0)
        assert (got[0, :dim // 2] == 1).all() and (got[0, dim // 2:] == 0).all()  # t = 0: the cos half first
    for h, w, d in ((4, 4, 64), (32, 32, 768), (2, 3, 16)):
        np.testing.assert_array_equal(tdit._sincos_pos_2d(h, w, d), np.asarray(jdit._sincos_pos_2d(h, w, d)))


@pytest.mark.parametrize("which", ["dit-b2", "dit-smoke", "unet-sdxl", "unet-smoke"])
def test_params_from_jax_loads_strict(which, monkeypatch):
    """Every converted leaf has a parameter of the port's shape, and every
    parameter a leaf; FULL on the meta device, SMOKE with real values
    (the UNet's attention leaves and DiT's t_embed checked by value)."""
    jcfg, tcfg, spec_fn, cls = {
        "dit-b2": (JAX_DIT_B2, DIT_B2, jdit.dit_param_spec, tdit.DiT),
        "dit-smoke": (JAX_DIT_SMOKE, DIT_SMOKE, jdit.dit_param_spec, tdit.DiT),
        "unet-sdxl": (JAX_UNET_SDXL, UNET_SDXL, junet.unet_param_spec, tunet.UNet),
        "unet-smoke": (JAX_UNET_SMOKE, UNET_SMOKE, junet.unet_param_spec, tunet.UNet)}[which]
    spec = spec_fn(jcfg)
    if which.endswith("smoke"):
        pn = draw_tree(spec, seed=3)
        sd = params_from_jax(pn)
        model = cls(tcfg, device="cpu", dtype=torch.float32)
        model.load_state_dict(sd, strict=True)
        got = model.state_dict()
        if cls is tdit.DiT:
            np.testing.assert_array_equal(got["t_embed.w1"].numpy(), pn["t_embed"]["w1"].T)
            np.testing.assert_array_equal(got["layers.1.adaln.w"].numpy(), pn["layers"]["all"]["adaln"]["w"][1].T)
            np.testing.assert_array_equal(got["y_embed"].numpy(), pn["y_embed"])
        else:
            blk = pn["down"]["stage1"]["b0"]["tf"]["blocks"]["b0"]
            ch = blk["self_q"].shape[0]
            np.testing.assert_array_equal(got["down.stage1.b0.tf.blocks.b0.cross_k"].numpy(),
                                          blk["cross_k"].reshape(blk["cross_k"].shape[0], -1).T)
            np.testing.assert_array_equal(got["down.stage1.b0.tf.blocks.b0.self_o"].numpy(),
                                          blk["self_o"].reshape(-1, ch).T)
            np.testing.assert_array_equal(got["conv_in.w"].numpy(), pn["conv_in"]["w"].transpose(3, 2, 0, 1))
    else:
        sd = meta_state_dict(spec, monkeypatch)
        model = cls(tcfg, device="meta")
        model.load_state_dict(sd, strict=True)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("jcfg,tcfg,exact,smoke", [
    (JAX_DIT_B2, DIT_B2, 130_232_864, 181_024), (JAX_UNET_SDXL, UNET_SDXL, 2_578_875_844, 1_076_868)],
    ids=["dit-b2", "unet-sdxl"])
def test_full_n_params_equal_reference(jcfg, tcfg, exact, smoke):
    spec_fn = jdit.dit_param_spec if isinstance(jcfg, jbase.DiTConfig) else junet.unet_param_spec
    assert tapi.build(tcfg).n_params() == tree_count(spec_fn(jcfg)) == exact
    assert tapi.build(dataclasses.replace(tcfg)).family == "diffusion"
    assert tcfg.param_count == jcfg.param_count
    small = DIT_SMOKE if isinstance(tcfg, tbase.DiTConfig) else UNET_SMOKE
    assert tapi.build(small).n_params() == smoke


def test_unet_dtypes_and_estimate():
    """bf16 weights with float32 GroupNorm and LayerNorm leaves, as the
    reference's specs; the analytic estimate equals the reference's."""
    assert tbase.unet_param_estimate(UNET_SDXL) == jbase.unet_param_estimate(JAX_UNET_SDXL) == 2_562_890_240
    with torch.device("meta"):
        m = tunet.UNet(UNET_SDXL, device="meta")
    f32 = {k for k, v in m.state_dict().items() if v.dtype == torch.float32}
    assert f32 and all(k.rsplit(".", 2)[-2].startswith(("gn", "ln")) for k in f32)
    n_f32 = sum(m.state_dict()[k].numel() for k in f32)
    assert n_f32 == 600_960 and sum(p.numel() for p in m.parameters()) - n_f32 == 2_578_274_884


def test_zero_initialised_leaves_as_reference_and_redrawn():
    """The port's init leaves adaLN-Zero and proj_out at 0, as the
    reference's does, which makes DiT's output exactly 0;
    ``reset_parameters(g, zero_std=0.02)`` draws them."""
    g = torch.Generator().manual_seed(0)
    dit = tdit.DiT(DIT_SMOKE, generator=g, device="cpu", dtype=torch.float32)
    latents, t, y = _torch(*_dit_inputs(DIT_SMOKE, 2, 0))
    with torch.no_grad():
        assert not dit(latents, t, y).any()
        assert not dit.state_dict()["layers.0.adaln.w"].any()
        dit.reset_parameters(g, zero_std=0.02)
        assert abs(float(dit.state_dict()["layers.0.adaln.w"].std()) / 0.02 - 1) < 0.1
        assert dit(latents, t, y).abs().max() > 0.1
        assert torch.equal(dit.state_dict()["layers.0.mlp.wi"].std() > 0, torch.tensor(True))
    unet = tunet.UNet(UNET_SMOKE, generator=g, device="cpu")
    sd = unet.state_dict()
    assert not sd["mid.tf.proj_out.w"].any() and sd["mid.tf.proj_out.w"].dtype == torch.bfloat16
    assert torch.equal(sd["mid.tf.gn.scale"], torch.ones(64)) and sd["mid.tf.gn.scale"].dtype == torch.float32
    unet.reset_parameters(g, zero_std=0.02)
    assert unet.state_dict()["mid.tf.proj_out.w"].any()
    assert torch.equal(unet.state_dict()["mid.tf.gn.scale"], torch.ones(64))


def test_registry_and_build_equal_reference():
    assert tbase.list_archs() == jbase.list_archs()
    assert len(tbase.list_archs()) == 10
    for arch in ("dit-b2", "unet-sdxl"):
        t, j = tbase.get_arch(arch), jbase.get_arch(arch)
        assert t.family == j.family == "diffusion" and t.source == j.source
        for which in ("full", "smoke"):
            assert dataclasses.asdict(getattr(t, which)) == dataclasses.asdict(getattr(j, which))
    with pytest.raises(TypeError, match="unknown config type"):
        tapi.build(object())
    with pytest.raises(TypeError, match="unknown config type"):
        japi.build(object())
    assert tapi.CTX_TOKENS == japi.CTX_TOKENS == 77


def test_build_forward_runs_each_diffusion_model():
    g = torch.Generator().manual_seed(1)
    h = tapi.build(DIT_SMOKE)
    m = h.init(g, device="cpu", dtype=torch.float32)
    latents, t, y = _torch(*_dit_inputs(DIT_SMOKE, 2, 1))
    with torch.no_grad():
        assert torch.equal(h.forward(m, latents, t, y), tdit.dit_forward(m, latents, t, y, DIT_SMOKE))
    h = tapi.build(UNET_SMOKE)
    m = h.init(g, device="cpu", dtype=torch.float32)
    latents, t, ctx = _torch(*_unet_inputs(UNET_SMOKE, 1, 1))
    with torch.no_grad():
        out = h.forward(m, latents, t, ctx)
    assert out.shape == (1, 8, 8, 4) and torch.isfinite(out).all()
