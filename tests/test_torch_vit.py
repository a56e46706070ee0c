"""The port's ViT/DeiT and its converter against the JAX reference.

The JAX parameters (drawn with the JAX PRNG, float32) go through
``params_from_jax`` into the port's ``ViT``; the same numpy images go
through both forwards.  Logits agree within ``LOGIT_ATOL`` = 1e-4: float32
matrix products summed in another order, through at most 12 layers, on
logits of magnitude about 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deit_b import FULL as JAX_DEIT_B, SMOKE as JAX_DEIT_SMOKE
from repro.configs.vit_s16 import FULL as JAX_VIT_S16, SMOKE as JAX_VIT_SMOKE
from repro.models import api
from repro.models.ptree import tree_count
from repro.models.vit import vit_forward, vit_param_spec
from repro_torch.configs import deit_b, vit_s16
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import apply_mlp, apply_norm
from repro_torch.models.vit import ViT, patchify

LOGIT_ATOL = 1e-4

SMOKES = [(JAX_VIT_SMOKE, vit_s16.SMOKE), (JAX_DEIT_SMOKE, deit_b.SMOKE)]


def _jax_params(cfg, seed):
    p = api.build(cfg).init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    return p, jax.tree.map(np.asarray, p)


def _images(n, res, seed=0):
    return np.random.default_rng(seed).standard_normal((n, res, res, 3)).astype(np.float32)


def _port(tcfg, pn):
    model = ViT(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(pn), strict=True)
    return model


def _converted_shape(path: tuple, shape: tuple) -> tuple:
    """The port's shape for a reference leaf: ``convert.py``'s layout rules."""
    key = path[-1]
    if key in ("w", "wi", "wo") and len(shape) == 2:
        return shape[::-1]
    if key == "wqkv":
        return (shape[0] * shape[2] * shape[3], shape[1])
    if key == "bqkv":
        return (int(np.prod(shape)),)
    if key == "wo" and len(shape) == 3:
        return (shape[2], shape[0] * shape[1])
    return shape


@pytest.mark.parametrize("jcfg,tcfg", SMOKES, ids=["vit-smoke", "deit-smoke"])
def test_vit_smoke_forward_matches_reference(jcfg, tcfg):
    p, pn = _jax_params(jcfg, seed=3)
    model = _port(tcfg, pn)
    x = _images(3, tcfg.img_res)
    ref = np.asarray(vit_forward(p, jnp.asarray(x), jcfg))
    with torch.no_grad():
        out = model(torch.as_tensor(x))
    assert out.shape == (3, tcfg.n_classes) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("res", [48, 16], ids=["upsample-6x6", "downsample-2x2"])
@pytest.mark.parametrize("jcfg,tcfg", SMOKES, ids=["vit-smoke", "deit-smoke"])
def test_vit_interpolated_pos_embed_matches_reference(jcfg, tcfg, res):
    """At a second resolution the grid part of ``pos_embed`` is resized
    (``_interp_pos``): up to 6x6 and, antialiased, down to 2x2."""
    p, pn = _jax_params(jcfg, seed=5)
    model = _port(tcfg, pn)
    x = _images(2, res, seed=1)
    ref = np.asarray(vit_forward(p, jnp.asarray(x), jcfg))
    with torch.no_grad():
        out = model(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


def test_deit_b_full_forward_matches_reference():
    """DeiT-B at full width and depth (87.3 M parameters), one frame."""
    p, pn = _jax_params(JAX_DEIT_B, seed=0)
    model = _port(deit_b.FULL, pn)
    x = _images(1, 224, seed=2)
    ref = np.asarray(vit_forward(p, jnp.asarray(x), JAX_DEIT_B))
    with torch.no_grad():
        out = model(torch.as_tensor(x))
    assert out.shape == (1, 1000)
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("jcfg,tcfg", [(JAX_DEIT_B, deit_b.FULL), (JAX_VIT_S16, vit_s16.FULL),
                                       *SMOKES], ids=["deit-b", "vit-s16", "vit-smoke", "deit-smoke"])
def test_param_names_shapes_and_counts(jcfg, tcfg):
    """Every leaf of ``vit_param_spec``, unstacked and in the port's layout,
    is a parameter of the port's ``ViT`` and nothing else is."""
    spec = vit_param_spec(jcfg)
    expected = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            spec, is_leaf=lambda x: hasattr(x, "axes"))[0]:
        keys = tuple(k.key for k in path)
        if keys[:2] == ("layers", "all"):
            for i in range(leaf.shape[0]):
                expected[".".join(("layers", str(i)) + keys[2:])] = _converted_shape(keys, leaf.shape[1:])
        else:
            expected[".".join(keys)] = _converted_shape(keys, leaf.shape)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in ViT(tcfg, device="meta").state_dict().items()}
    assert shapes == expected
    assert sum(int(np.prod(s)) for s in shapes.values()) == tree_count(spec)
    assert tcfg.param_count == jcfg.param_count
    for f in ("img_res", "patch", "n_layers", "d_model", "n_heads", "d_ff", "n_classes", "distill_token"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_deit_b_counts():
    assert tree_count(vit_param_spec(JAX_DEIT_B)) == 87_292_112
    assert deit_b.FULL.param_count == 87_250_944  # the reference formula leaves out some biases


def test_params_from_jax_unstacks_and_relayouts():
    p, pn = _jax_params(JAX_DEIT_SMOKE, seed=1)
    sd = params_from_jax(pn)
    L, d = JAX_DEIT_SMOKE.n_layers, JAX_DEIT_SMOKE.d_model
    stacked = pn["layers"]["all"]
    assert not any(k.startswith("layers.all") for k in sd)
    for i in range(L):
        wqkv = stacked["attn"]["wqkv"][i]  # (3, d, H, Dh)
        np.testing.assert_array_equal(sd[f"layers.{i}.attn.wqkv"].numpy(),
                                      wqkv.transpose(0, 2, 3, 1).reshape(-1, d))
        np.testing.assert_array_equal(sd[f"layers.{i}.attn.bqkv"].numpy(),
                                      stacked["attn"]["bqkv"][i].reshape(-1))
        np.testing.assert_array_equal(sd[f"layers.{i}.attn.wo"].numpy(),
                                      stacked["attn"]["wo"][i].reshape(-1, d).T)
        np.testing.assert_array_equal(sd[f"layers.{i}.mlp.wi"].numpy(), stacked["mlp"]["wi"][i].T)
        np.testing.assert_array_equal(sd[f"layers.{i}.mlp.wo"].numpy(), stacked["mlp"]["wo"][i].T)
        np.testing.assert_array_equal(sd[f"layers.{i}.ln2.scale"].numpy(), stacked["ln2"]["scale"][i])
    np.testing.assert_array_equal(sd["head_dist.w"].numpy(), pn["head_dist"]["w"].T)
    np.testing.assert_array_equal(sd["pos_embed"].numpy(), pn["pos_embed"])
    assert sd[f"layers.{L - 1}.attn.wqkv"].shape == (3 * d, d)


def test_params_from_jax_keeps_bf16_stacked():
    p = api.build(JAX_VIT_SMOKE).init(jax.random.PRNGKey(0))  # the spec's own dtypes: bf16 weights
    sd = params_from_jax(jax.tree.map(np.asarray, p))
    assert sd["layers.1.attn.wqkv"].dtype == torch.bfloat16
    assert sd["layers.1.ln1.scale"].dtype == torch.float32


def test_patchify_feature_order():
    """(row, col, channel) inside each patch, patches in raster order."""
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    got = patchify(torch.as_tensor(x), 4).numpy()
    assert got.shape == (2, 4, 48)
    np.testing.assert_array_equal(got[1, 2], x[1, 4:8, 0:4].reshape(-1))
    from repro.models.vit import patchify as jax_patchify
    np.testing.assert_array_equal(got, np.asarray(jax_patchify(jnp.asarray(x), 4)))


def test_norm_and_mlp_match_reference():
    from repro.models import layers as jl

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    scale, bias = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    wi, wo = (rng.standard_normal((16, 32)).astype(np.float32) / 4,
              rng.standard_normal((32, 16)).astype(np.float32) / 6)
    ref = np.asarray(jl.apply_norm({"scale": scale, "bias": bias}, jnp.asarray(x), "layernorm"))
    got = apply_norm({"scale": torch.as_tensor(scale), "bias": torch.as_tensor(bias)}, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    ref = np.asarray(jl.apply_mlp({"wi": wi, "wo": wo}, jnp.asarray(x), "gelu"))
    got = apply_mlp({"wi": torch.as_tensor(wi.T), "wo": torch.as_tensor(wo.T)}, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_vit_init_distribution():
    """Fan-in-scaled normal weights (ptree.py) with the reference layout's
    fan-in, pos_embed at 0.02, tokens and biases 0, norm scales 1."""
    cfg = deit_b.SMOKE
    m1 = ViT(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    m2 = ViT(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    sd = m1.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, m2.state_dict()[k]), k
    d, H = cfg.d_model, cfg.n_heads
    wqkv = torch.cat([m1.state_dict()[f"layers.{i}.attn.wqkv"].flatten() for i in range(cfg.n_layers)])
    assert abs(float(wqkv.std()) * np.sqrt(3 * d * H) - 1.0) < 0.05
    wi = sd["layers.0.mlp.wi"]
    assert abs(float(wi.std()) * np.sqrt(d) - 1.0) < 0.05
    assert abs(float(sd["pos_embed"].std()) / 0.02 - 1.0) < 0.1
    assert not sd["cls_token"].any() and not sd["dist_token"].any()
    assert not sd["layers.1.attn.bqkv"].any() and not sd["head.b"].any()
    assert torch.equal(sd["final_norm.scale"], torch.ones(d)) and not sd["final_norm.bias"].any()
