"""The port's dense GQA language model against the JAX reference.

The JAX parameters (drawn with the JAX PRNG, float32) go through
``params_from_jax`` into the port's ``TransformerLM``; the same numpy
tokens go through both.  Tolerances, on logits of magnitude about 3:

- ``FWD_ATOL`` 2e-5 for ``lm_forward`` and ``lm_prefill``: float32
  products summed in another order through 2 layers (2e-6 seen);
- ``DECODE_ATOL`` 2e-3 for ``lm_decode``: each step writes K/V into the
  cache, int8-quantized or rounded to bf16 by ``_cache_read``, and where
  the two frameworks' float32 K/V straddle a rounding boundary one entry
  differs by one int8 step or one bf16 ulp, which moves the logits by up
  to about 1e-3 (7.5e-4 seen over 20 steps);
- the greedy tokens equal, the int8 caches bit-equal on identical inputs.

On the CPU the fold branch runs the kernel's plain version; the CUDA
kernel runs in ``test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.arctic_480b import SMOKE as JAX_ARCTIC_SMOKE
from repro.configs.deepseek_v2_lite_16b import SMOKE as JAX_DSV2_SMOKE
from repro.configs.deit_b import SMOKE as JAX_DEIT_SMOKE
from repro.configs.qwen15_32b import FULL as JAX_QWEN, SMOKE as JAX_QWEN_SMOKE
from repro.configs.resnet_50 import SMOKE as JAX_RESNET_SMOKE
from repro.configs.stablelm_12b import FULL as JAX_STABLELM, SMOKE as JAX_STABLELM_SMOKE
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import deit_b, qwen15_32b, resnet_50, stablelm_12b
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.models import api as tapi
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax

FWD_ATOL = 2e-5
DECODE_ATOL = 2e-3

SMOKES = [(JAX_STABLELM_SMOKE, stablelm_12b.SMOKE), (JAX_QWEN_SMOKE, qwen15_32b.SMOKE)]
SMOKE_IDS = ["stablelm-smoke", "qwen-smoke"]
PLANS = [("bf16", False), ("int8", False), ("int8", True)]
PLAN_IDS = ["bf16", "int8", "int8-fold"]
# StableLM-12B's head geometry (32 heads over 8 KV heads of 160, RoPE on
# 40 dims) at d 256, 2 layers, vocab 512
GEOMETRY = dict(name="stablelm-geometry", d_model=256, n_heads=32, n_kv_heads=8, d_head=160,
                d_ff=512, vocab_size=512)


def _plans(kv, fold, **kw):
    return (jt.ParallelPlan(kv_cache_dtype=kv, kv_scale_fold=fold, **kw),
            tt.ParallelPlan(kv_cache_dtype=kv, kv_scale_fold=fold, **kw))


def _models(jcfg, tcfg, jplan, tplan, seed=0):
    p = japi.build(jcfg, jplan).init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    model = tt.TransformerLM(tcfg, tplan, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p)), strict=True)
    return p, model


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port_cfg(jcfg) -> LMConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if jcfg.moe is not None:
        fields["moe"] = MoEConfig(**dataclasses.asdict(jcfg.moe))
    return LMConfig(**fields)


# --------------------------------------------------------------------------- #
# configs, parameters, conversion
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("jcfg,tcfg", [(JAX_STABLELM, stablelm_12b.FULL), (JAX_QWEN, qwen15_32b.FULL),
                                       *SMOKES], ids=["stablelm-12b", "qwen1.5-32b", *SMOKE_IDS])
def test_config_fields_and_param_count_match(jcfg, tcfg):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count == jcfg.param_count
    assert tcfg.active_param_count == jcfg.active_param_count


def test_param_count_of_moe_and_mla_configs_match():
    for jcfg in (JAX_ARCTIC_SMOKE, JAX_DSV2_SMOKE):
        tcfg = _port_cfg(jcfg)
        assert (tcfg.param_count, tcfg.active_param_count) == (jcfg.param_count, jcfg.active_param_count)


@pytest.mark.parametrize("jcfg,tcfg", [(JAX_STABLELM, stablelm_12b.FULL), (JAX_QWEN, qwen15_32b.FULL),
                                       *SMOKES, (JAX_DEIT_SMOKE, deit_b.SMOKE),
                                       (JAX_RESNET_SMOKE, resnet_50.SMOKE)],
                         ids=["stablelm-12b", "qwen1.5-32b", *SMOKE_IDS, "deit-smoke", "resnet-smoke"])
def test_build_n_params_matches_reference_tree(jcfg, tcfg):
    """``n_params`` counts the module on the meta device, without allocating."""
    h = tapi.build(tcfg)
    assert h.n_params() == japi.build(jcfg).n_params()
    assert h.family == ("lm" if isinstance(tcfg, LMConfig) else "vision")


@pytest.mark.parametrize("jcfg,tcfg", SMOKES, ids=SMOKE_IDS)
def test_params_from_jax_lm_layouts(jcfg, tcfg):
    p = japi.build(jcfg).init(jax.random.PRNGKey(1), dtype=jnp.float32)
    pn = jax.tree.map(np.asarray, p)
    sd = params_from_jax(pn)
    model = tt.TransformerLM(tcfg, device="cpu", dtype=torch.float32)
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    a = pn["layers"]["all"]["attn"]
    d, H, Dh = a["wq"].shape[1:]
    wq = sd["layers.1.attn.wq"].numpy()  # (H·Dh, d): row h·Dh + k is column (h, k)
    np.testing.assert_array_equal(wq.reshape(H, Dh, d), np.transpose(a["wq"][1], (1, 2, 0)))
    np.testing.assert_array_equal(sd["layers.0.attn.wo"].numpy(), a["wo"][0].reshape(H * Dh, d).T)
    m = pn["layers"]["all"]["mlp"]
    np.testing.assert_array_equal(sd["layers.0.mlp.wg"].numpy(), m["wg"][0].T)
    np.testing.assert_array_equal(sd["layers.1.mlp.wd"].numpy(), m["wd"][1].T)
    np.testing.assert_array_equal(sd["unembed"].numpy(), pn["unembed"].T)
    np.testing.assert_array_equal(sd["embed"].numpy(), pn["embed"])
    if jcfg.qkv_bias:
        np.testing.assert_array_equal(sd["layers.0.attn.bk"].numpy(), a["bk"][0].reshape(-1))


def test_random_init_follows_tree_init():
    """Fan-in-scaled normal draws (std 1/sqrt(d·H) for wq, 1/sqrt(H·Dh)
    for wo), norm scales 1 and biases 0 in f32, weights in the dtype asked."""
    cfg = dataclasses.replace(qwen15_32b.SMOKE, d_model=256, d_ff=512, vocab_size=2048)
    m = tt.TransformerLM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    sd = m.state_dict()
    assert sd["layers.0.attn.wq"].dtype == torch.bfloat16 and sd["layers.0.ln1.scale"].dtype == torch.float32
    assert torch.equal(sd["layers.0.ln1.scale"], torch.ones(256)) and not sd["layers.0.attn.bq"].any()
    for name, fan_in in (("layers.0.attn.wq", 256 * 4), ("layers.1.attn.wo", 4 * 16), ("embed", 256),
                         ("layers.0.mlp.wd", 512)):
        std = float(sd[name].float().std())
        assert abs(std * np.sqrt(fan_in) - 1) < 0.05, (name, std)
    assert not any(p.requires_grad for p in m.parameters())


def test_transformer_lm_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.TransformerLM(stablelm_12b.SMOKE)


def test_plan_needs_one_card():
    """The plan runs on one card at any model axis: one above 1 pads the
    heads (``effective_heads``), one below 1 is refused."""
    with pytest.raises(ValueError, match="model_axis"):
        tt.check_supported(qwen15_32b.SMOKE, tt.ParallelPlan(model_axis=0))
    tt.check_supported(qwen15_32b.SMOKE, tt.ParallelPlan(model_axis=2))
    assert tt.effective_heads(qwen15_32b.SMOKE, tt.ParallelPlan(model_axis=3)) == (6, 6)


@pytest.mark.parametrize("jcfg,tcfg", SMOKES, ids=SMOKE_IDS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cache_spec_matches_reference(jcfg, tcfg, kv):
    jplan, tplan = _plans(kv, False)
    ref = jt.cache_spec(jcfg, jplan, 3, 40)
    out = tt.cache_spec(tcfg, tplan, 3, 40)
    assert set(out) == set(ref)
    for name, (shape, dtype) in out.items():
        assert shape == ref[name].shape and str(dtype).removeprefix("torch.") == str(ref[name].dtype)


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32), "bias": rng.standard_normal(64).astype(np.float32)}
    ref = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    got = tl.apply_norm({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rot,D", [(40, 160), (4, 16), (16, 16)])
def test_apply_rope_matches_reference_at_large_positions(rot, D):
    """Partial NeoX rotation with f32 angles, at path 4's positions 2048-2079."""
    x = np.random.default_rng(rot).standard_normal((2, 32, 3, D)).astype(np.float32)
    pos = np.arange(2048, 2080)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, rot)
    got = tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0, rot)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


def test_apply_mlp_swiglu_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in (("wg", (64, 96)), ("wu", (64, 96)), ("wd", (96, 64)))}
    ref = jl.apply_mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), "swiglu")
    got = tl.apply_mlp({k: torch.as_tensor(v.T) for k, v in w.items()}, torch.as_tensor(x), "swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _qkv_gqa(B, S, H, KH, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KH, D)).astype(np.float32),
            rng.standard_normal((B, S, KH, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_core_matches_reference_with_gqa(causal):
    q, k, v = _qkv_gqa(2, 24, 8, 2, 32, seed=3)
    ref = jl.attention_core(jnp.asarray(q), jl._expand_kv(jnp.asarray(k), 8), jl._expand_kv(jnp.asarray(v), 8),
                            causal=causal)
    got = tl.attention_core(torch.as_tensor(q), tl._expand_kv(torch.as_tensor(k), 8),
                            tl._expand_kv(torch.as_tensor(v), 8), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=FWD_ATOL, atol=FWD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 20)])
def test_attention_blockwise_matches_reference(S, chunk, causal):
    q, k, v = _qkv_gqa(2, S, 4, 4, 32, seed=S)
    ref = jl.attention_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, chunk=chunk)
    got = tl.attention_blockwise(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                 causal=causal, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=FWD_ATOL, atol=FWD_ATOL)


def test_quantization_bit_equal_on_identical_inputs():
    """``_quantize_slot`` and ``_quantize_cache`` on the same f32 K/V: the
    int8 values and the bf16 scales bit-equal (values from the unrounded
    f32 scale, rounded half to even)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 3, 16, 4, 32)) * rng.uniform(0.01, 10, (2, 3, 16, 1, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero token: the 1e-6 floor
    x[0, 0, 1, 0, :4] = [127.0, -63.5, 0.5, -1.5]  # halves round to even
    ref = jt._quantize_cache({"k": jnp.asarray(x)}, jt.ParallelPlan(kv_cache_dtype="int8"))
    got = tt._quantize_cache({"k": torch.as_tensor(x)}, tt.ParallelPlan(kv_cache_dtype="int8"))
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))
    np.testing.assert_array_equal(got["k_scale"].float().numpy(), _np(ref["k_scale"]))
    assert got["k_scale"].dtype == torch.bfloat16
    slot = x[1][:, 5:6]  # (B, 1, KH, D)
    qj, sj = jt._quantize_slot(jnp.asarray(slot))
    qt, st = tt._quantize_slot(torch.as_tensor(slot))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.float().numpy(), _np(sj))


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("jcfg,tcfg", SMOKES, ids=SMOKE_IDS)
@pytest.mark.parametrize("kv,fold", PLANS, ids=PLAN_IDS)
def test_lm_prefill_and_forward_match_reference(jcfg, tcfg, kv, fold):
    jplan, tplan = _plans(kv, fold)
    p, model = _models(jcfg, tcfg, jplan, tplan)
    toks = _tokens(2, 12, jcfg.vocab_size)
    jlog, jcache = jt.lm_prefill(p, jnp.asarray(toks), jcfg, jplan)
    tlog, tcache = tt.lm_prefill(model, torch.as_tensor(toks), tcfg, tplan)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=FWD_ATOL)
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
        assert str(tcache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype)
        if kv == "int8":  # saw no differing int8 value or scale at either smoke size
            np.testing.assert_array_equal(tcache[name].float().numpy(), _np(jcache[name]))
        else:
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), rtol=0, atol=FWD_ATOL)
    jf, _ = jt.lm_forward(p, jnp.asarray(toks), jcfg, jplan)
    tf, aux = tt.lm_forward(model, torch.as_tensor(toks), tcfg, tplan)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)
    assert float(aux) == 0.0
    np.testing.assert_allclose(tf[:, -1].numpy(), tlog.numpy(), rtol=0, atol=FWD_ATOL)


def test_blockwise_prefill_matches_reference():
    """``attn_chunk`` sends prefill through ``attention_blockwise`` (S > 2·chunk)."""
    jplan, tplan = _plans("int8", True, attn_chunk=4)
    p, model = _models(JAX_STABLELM_SMOKE, stablelm_12b.SMOKE, jplan, tplan)
    toks = _tokens(2, 16, 256, seed=5)
    jlog, _ = jt.lm_prefill(p, jnp.asarray(toks), JAX_STABLELM_SMOKE, jplan)
    tlog, _ = tt.lm_prefill(model, torch.as_tensor(toks), stablelm_12b.SMOKE, tplan)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=FWD_ATOL)


def _decode_both(jcfg, tcfg, jplan, tplan, S, steps, seed=0):
    """Prefill S tokens, then ``steps`` greedy steps (past the ring's wrap
    at pos S) in both frameworks; the port's tokens are the reference's."""
    p, model = _models(jcfg, tcfg, jplan, tplan, seed=seed)
    toks = _tokens(2, S, jcfg.vocab_size, seed=seed)
    jlog, jcache = jt.lm_prefill(p, jnp.asarray(toks), jcfg, jplan)
    tlog, tcache = tt.lm_prefill(model, torch.as_tensor(toks), tcfg, tplan)
    out = []
    for pos in range(S, S + steps):
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
        assert np.array_equal(tlog.numpy().argmax(-1), tok), f"greedy token differs at pos {pos}"
        jlog, jcache = jt.lm_decode(p, jcache, jnp.asarray(tok), pos, jcfg, jplan)
        tlog, tcache2 = tt.lm_decode(model, tcache, torch.as_tensor(tok), pos, tcfg, tplan)
        assert tcache2 is tcache  # written in place
        out.append((np.asarray(jlog), tlog.numpy()))
    return out, jcache, tcache


@pytest.mark.parametrize("jcfg,tcfg", SMOKES, ids=SMOKE_IDS)
@pytest.mark.parametrize("kv,fold", PLANS, ids=PLAN_IDS)
def test_lm_decode_matches_reference(jcfg, tcfg, kv, fold):
    """8 steps after a 6-token prefill: slots 0-5 of the ring are
    overwritten from pos 6 on."""
    jplan, tplan = _plans(kv, fold)
    steps, jcache, tcache = _decode_both(jcfg, tcfg, jplan, tplan, S=6, steps=8)
    for j, t in steps:
        np.testing.assert_allclose(t, j, rtol=0, atol=DECODE_ATOL)
    assert np.array_equal(steps[-1][1].argmax(-1), steps[-1][0].argmax(-1))
    for name in jcache:
        assert str(tcache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype)


def test_stablelm_geometry_fold_decode_matches_reference():
    """StableLM-12B's head geometry (H 32, KH 8, D 160, RoPE on 40 dims) at
    d 256 through the fold branch.  Through the prefill the two frameworks'
    int8 caches differ by one step where their f32 K/V straddle a rounding
    boundary: 2 of the 163,840 values were seen to differ at this seed."""
    jcfg = dataclasses.replace(JAX_STABLELM_SMOKE, **GEOMETRY)
    tcfg = dataclasses.replace(stablelm_12b.SMOKE, **GEOMETRY)
    jplan, tplan = _plans("int8", True)
    p, model = _models(jcfg, tcfg, jplan, tplan)
    toks = _tokens(2, 16, 512)
    _, jcache = jt.lm_prefill(p, jnp.asarray(toks), jcfg, jplan)
    _, tcache = tt.lm_prefill(model, torch.as_tensor(toks), tcfg, tplan)
    for name in ("k", "v"):
        diff = np.abs(tcache[name].numpy().astype(np.int32) - np.asarray(jcache[name]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 8, (name, int((diff > 0).sum()))
    steps, _, _ = _decode_both(jcfg, tcfg, jplan, tplan, S=16, steps=4)
    for j, t in steps:
        np.testing.assert_allclose(t, j, rtol=0, atol=DECODE_ATOL)


def test_nonfold_int8_rounds_the_cache_to_bf16_as_the_reference():
    """The non-fold int8 branch reads a bf16 dequantized cache even in f32,
    the fold branch does not: the two differ by ~1e-2 in the logits of
    stablelm-smoke, in the port as in the reference."""
    toks = _tokens(2, 12, 256, seed=6)
    logits = {}
    for fold in (False, True):
        jplan, tplan = _plans("int8", fold)
        p, model = _models(JAX_STABLELM_SMOKE, stablelm_12b.SMOKE, jplan, tplan)
        _, jcache = jt.lm_prefill(p, jnp.asarray(toks), JAX_STABLELM_SMOKE, jplan)
        _, tcache = tt.lm_prefill(model, torch.as_tensor(toks), stablelm_12b.SMOKE, tplan)
        tok = np.array([3, 7], np.int32)
        jlog, _ = jt.lm_decode(p, jcache, jnp.asarray(tok), 12, JAX_STABLELM_SMOKE, jplan)
        tlog, _ = tt.lm_decode(model, tcache, torch.as_tensor(tok), 12, stablelm_12b.SMOKE, tplan)
        logits[fold] = (np.asarray(jlog), tlog.numpy())
    jdiff = logits[False][0] - logits[True][0]
    tdiff = logits[False][1] - logits[True][1]
    assert np.abs(jdiff).max() > 1e-3
    np.testing.assert_allclose(tdiff, jdiff, rtol=0, atol=DECODE_ATOL / 4)


def test_api_forward_of_each_family_runs_its_model():
    tokens = torch.as_tensor(_tokens(1, 5, 256))
    h = tapi.build(stablelm_12b.SMOKE)
    model = h.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    assert torch.equal(h.forward(model, tokens), tt.lm_forward(model, tokens, h.cfg, h.plan)[0])
    images = torch.zeros(2, 32, 32, 3)
    for cfg in (deit_b.SMOKE, resnet_50.SMOKE):
        h = tapi.build(cfg)
        model = h.init(torch.Generator().manual_seed(0), device="cpu")
        assert torch.equal(h.forward(model, images), model(images))
    with pytest.raises(TypeError, match="unknown config type"):
        tapi.build(object())
