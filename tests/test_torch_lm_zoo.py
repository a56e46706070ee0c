"""The rest of the language-model zoo against the JAX reference: MLA
(deepseek-v2-lite-smoke, naive and absorbed decode), MoE (both smoke
configs, grouped dispatch), the fused QKV projection (qwen-smoke, MHA) and
``attn_mode="sp"`` (stablelm-smoke).

As in ``tests/test_torch_lm.py``, whose limits these are: the JAX
parameters (float32) go through ``params_from_jax`` into the port's
``TransformerLM`` and the same numpy tokens through both; ``lm_forward``
and ``lm_prefill`` within ``FWD_ATOL``, ``lm_decode`` within
``DECODE_ATOL``, greedy tokens equal.  Besides: every MoE call's route
(``top_i``) bit-equal, each token's k-th and (k+1)-th gates apart by more
than ``GATE_GAP`` (so no flip is noise), and the aux loss within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.arctic_480b import FULL as JAX_ARCTIC, SMOKE as JAX_ARCTIC_SMOKE
from repro.configs.deepseek_v2_lite_16b import FULL as JAX_DSV2, SMOKE as JAX_DSV2_SMOKE
from repro.configs.qwen15_32b import SMOKE as JAX_QWEN_SMOKE
from repro.configs.stablelm_12b import SMOKE as JAX_STABLELM_SMOKE
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.configs import arctic_480b, deepseek_v2_lite_16b, qwen15_32b, stablelm_12b
from repro_torch.configs.base import get_arch
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax
from test_torch_lm import DECODE_ATOL, FWD_ATOL, _decode_both, _models, _np, _tokens

AUX_ATOL = 1e-6
GATE_GAP = 1e-5
ZOO = [(JAX_DSV2_SMOKE, deepseek_v2_lite_16b.SMOKE), (JAX_ARCTIC_SMOKE, arctic_480b.SMOKE)]
ZOO_IDS = ["deepseek-smoke", "arctic-smoke"]


class Routes:
    """Records the top-k experts of every MoE call in both frameworks: the
    port's through ``moe.route``, the reference's from the same lines of its
    ``_moe_tokens`` (``moe.py:77-80``) on the tokens it was given, through a
    host callback so that it records under ``lax.scan`` too."""

    def __init__(self, monkeypatch):
        self.jax, self.port, self.gaps = [], [], []
        route, tokens = tmoe.route, jmoe._moe_tokens

        def port_route(router, xf, cfg):
            gates, top_v, top_i = route(router, xf, cfg)
            srt = torch.sort(gates, dim=-1, descending=True).values
            self.gaps.append(float((srt[..., cfg.top_k - 1] - srt[..., cfg.top_k]).min()))
            self.port.append(top_i.numpy())
            return gates, top_v, top_i

        def jax_tokens(p, xf, cfg, act):
            gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", xf.astype(jnp.float32), p["router"]), axis=-1)
            jax.debug.callback(lambda t: self.jax.append(np.asarray(t)), jax.lax.top_k(gates, cfg.top_k)[1],
                               ordered=True)
            return tokens(p, xf, cfg, act)

        monkeypatch.setattr(tmoe, "route", port_route)
        monkeypatch.setattr(jmoe, "_moe_tokens", jax_tokens)

    def check(self, n_calls):
        assert len(self.port) == len(self.jax) == n_calls
        assert min(self.gaps) > GATE_GAP, f"a near-tie of gates ({min(self.gaps):.2e}): pick inputs without one"
        for t, j in zip(self.port, self.jax):
            np.testing.assert_array_equal(t, j)


def _n_moe(cfg) -> int:
    return 0 if cfg.moe is None else cfg.n_layers - cfg.moe.first_k_dense


# --------------------------------------------------------------------------- #
# configs, parameters, conversion
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("jcfg,tcfg", [(JAX_DSV2, deepseek_v2_lite_16b.FULL), (JAX_ARCTIC, arctic_480b.FULL),
                                       *ZOO], ids=["deepseek-v2-lite-16b", "arctic-480b", *ZOO_IDS])
def test_zoo_config_fields_and_param_count_match(jcfg, tcfg):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.param_count, tcfg.active_param_count) == (jcfg.param_count, jcfg.active_param_count)


@pytest.mark.parametrize("arch,n", [("deepseek-v2-lite-16b", 15_706_484_224), ("arctic-480b", 476_850_275_328)])
def test_build_n_params_of_full_configs_on_meta(arch, n):
    """Counted on the meta device: nothing is allocated."""
    spec = get_arch(arch)
    assert spec.family == "moe-lm"
    h = tapi.build(spec.full)
    jcfg = {"deepseek-v2-lite-16b": JAX_DSV2, "arctic-480b": JAX_ARCTIC}[arch]
    assert h.n_params() == n == japi.build(jcfg).n_params()
    assert h.family == "lm"


@pytest.mark.parametrize("jcfg,tcfg", ZOO, ids=ZOO_IDS)
def test_params_from_jax_zoo_layouts(jcfg, tcfg):
    """MLA leaves to ``F.linear``'s layout, the expert leaves and the router
    as they are, the ``dense``/``moe`` groups unstacked in layer order."""
    p = japi.build(jcfg).init(jax.random.PRNGKey(1), dtype=jnp.float32)
    pn = jax.tree.map(np.asarray, p)
    sd = params_from_jax(pn)
    model = tt.TransformerLM(tcfg, device="cpu", dtype=torch.float32)
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    kd = tcfg.moe.first_k_dense
    groups = pn["layers"]
    moe_group, j = (groups["moe"], 0) if kd else (groups["all"], 1)
    m = moe_group["moe"]
    np.testing.assert_array_equal(sd[f"layers.{kd + j}.moe.router"].numpy(), m["router"][j])
    np.testing.assert_array_equal(sd[f"layers.{kd + j}.moe.wg"].numpy(), m["wg"][j])  # (E, d, f)
    np.testing.assert_array_equal(sd[f"layers.{kd + j}.moe.wd"].numpy(), m["wd"][j])  # (E, f, d)
    extra = "shared" if tcfg.moe.n_shared else "dense"
    np.testing.assert_array_equal(sd[f"layers.{kd + j}.moe.{extra}.wu"].numpy(), m[extra]["wu"][j].T)
    np.testing.assert_array_equal(sd[f"layers.{kd + j}.moe.{extra}.wd"].numpy(), m[extra]["wd"][j].T)
    if kd:
        np.testing.assert_array_equal(sd["layers.0.mlp.wg"].numpy(), groups["dense"]["mlp"]["wg"][0].T)
        a = moe_group["attn"]
        r, H, nope = a["w_uk"].shape[1:]
        np.testing.assert_array_equal(sd["layers.1.attn.w_uk"].numpy().reshape(H, nope, r),
                                      np.transpose(a["w_uk"][0], (1, 2, 0)))
        np.testing.assert_array_equal(sd["layers.1.attn.w_dkv"].numpy(), a["w_dkv"][0].T)
        np.testing.assert_array_equal(sd["layers.1.attn.wo"].numpy(), a["wo"][0].reshape(-1, a["wo"].shape[-1]).T)
        np.testing.assert_array_equal(sd["layers.1.attn.kv_norm.scale"].numpy(), a["kv_norm"]["scale"][0])


def test_params_from_jax_q_lora_leaves():
    """The ``q_lora_rank`` branch (no config of the zoo uses it): ``w_dq``,
    ``w_uq`` and ``q_norm`` carried, and the model matches the reference."""
    jcfg = dataclasses.replace(JAX_DSV2_SMOKE, q_lora_rank=24)
    tcfg = dataclasses.replace(deepseek_v2_lite_16b.SMOKE, q_lora_rank=24)
    jplan, tplan = jt.ParallelPlan(), tt.ParallelPlan()
    p, model = _models(jcfg, tcfg, jplan, tplan)
    assert {"layers.0.attn.w_dq", "layers.0.attn.w_uq", "layers.0.attn.q_norm.scale"} <= set(model.state_dict())
    assert "layers.0.attn.wq" not in model.state_dict()
    toks = _tokens(2, 10, jcfg.vocab_size, seed=2)
    jf, _ = jt.lm_forward(p, jnp.asarray(toks), jcfg, jplan)
    tf, _ = tt.lm_forward(model, torch.as_tensor(toks), tcfg, tplan)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)


def test_random_init_of_the_zoo_follows_tree_init():
    """Fan-ins of the per-layer reference shapes (E·d for an expert's
    ``wg``, E·f for ``wd``, d for the router, r·H for ``w_uk``); the router
    and MLA's ``kv_norm`` in float32 in a bf16 model."""
    cfg = dataclasses.replace(deepseek_v2_lite_16b.SMOKE, d_model=256, kv_lora_rank=128,
                              moe=dataclasses.replace(deepseek_v2_lite_16b.SMOKE.moe, d_ff_expert=128))
    sd = tt.TransformerLM(cfg, generator=torch.Generator().manual_seed(0), device="cpu").state_dict()
    assert sd["layers.1.moe.router"].dtype == torch.float32 and sd["layers.1.moe.wg"].dtype == torch.bfloat16
    assert sd["layers.0.attn.kv_norm.scale"].dtype == torch.float32
    assert torch.equal(sd["layers.0.attn.kv_norm.scale"], torch.ones(128))
    E, H = cfg.moe.n_routed, cfg.n_heads
    for name, fan_in in (("layers.1.moe.wg", E * 256), ("layers.1.moe.wd", E * 128), ("layers.1.moe.router", 256),
                         ("layers.0.attn.w_uk", 128 * H), ("layers.0.attn.w_dkv", 256),
                         ("layers.1.moe.shared.wd", 128)):
        std = float(sd[name].float().std())
        assert abs(std * np.sqrt(fan_in) - 1) < 0.05, (name, std)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_cache_spec_matches_reference(kv):
    jplan, tplan = jt.ParallelPlan(kv_cache_dtype=kv), tt.ParallelPlan(kv_cache_dtype=kv)
    ref = jt.cache_spec(JAX_DSV2, jplan, 8, 2048)
    out = tt.cache_spec(deepseek_v2_lite_16b.FULL, tplan, 8, 2048)
    assert set(out) == set(ref) == ({"ckv", "k_rope"} | ({"ckv_scale", "k_rope_scale"} if kv == "int8" else set()))
    for name, (shape, dtype) in out.items():
        assert shape == ref[name].shape and str(dtype).removeprefix("torch.") == str(ref[name].dtype)


# --------------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("jcfg,tcfg", ZOO, ids=ZOO_IDS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_zoo_prefill_and_forward_match_reference(jcfg, tcfg, kv, monkeypatch):
    jplan, tplan = jt.ParallelPlan(kv_cache_dtype=kv), tt.ParallelPlan(kv_cache_dtype=kv)
    p, model = _models(jcfg, tcfg, jplan, tplan)
    toks = _tokens(2, 12, jcfg.vocab_size)
    routes = Routes(monkeypatch)
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
    jf, jaux = jt.lm_forward(p, jnp.asarray(toks), jcfg, jplan)
    tf, taux = tt.lm_forward(model, torch.as_tensor(toks), tcfg, tplan)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(tf[:, -1].numpy(), tlog.numpy(), rtol=0, atol=FWD_ATOL)
    assert taux.dtype == torch.float32 and float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL
    routes.check(2 * _n_moe(tcfg))


@pytest.mark.parametrize("jcfg,tcfg", ZOO, ids=ZOO_IDS)
def test_grouped_dispatch_matches_reference(jcfg, tcfg, monkeypatch):
    """``moe_grouped_dispatch`` at ``data_axis=2``: each half of the batch
    routes and fills its experts' capacity on its own, in both frameworks;
    at B = 3, which 2 does not divide, one group.  Decode dispatches in one
    group whatever the plan."""
    kw = dict(moe_grouped_dispatch=True, data_axis=2)
    jplan, tplan = jt.ParallelPlan(**kw), tt.ParallelPlan(**kw)
    p, model = _models(jcfg, tcfg, jplan, tplan, seed=3)
    routes = Routes(monkeypatch)
    for B in (4, 3):
        toks = _tokens(B, 10, jcfg.vocab_size, seed=B)
        jf, jaux = jt.lm_forward(p, jnp.asarray(toks), jcfg, jplan)
        tf, taux = tt.lm_forward(model, torch.as_tensor(toks), tcfg, tplan)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)
        assert abs(float(taux) - float(jaux)) <= AUX_ATOL
    assert [r.shape[0] for r in routes.port] == [2] * _n_moe(tcfg) + [1] * _n_moe(tcfg)
    jlog, jcache = jt.lm_prefill(p, jnp.asarray(toks), jcfg, jplan)
    tlog, tcache = tt.lm_prefill(model, torch.as_tensor(toks), tcfg, tplan)
    tok = np.asarray(jlog).argmax(-1).astype(np.int32)
    jlog, _ = jt.lm_decode(p, jcache, jnp.asarray(tok), 10, jcfg, jplan)
    tlog, _ = tt.lm_decode(model, tcache, torch.as_tensor(tok), 10, tcfg, tplan)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=DECODE_ATOL)
    routes.check(4 * _n_moe(tcfg))
    # a one-token-a-row decode step's MoE call takes all B rows in one group
    assert routes.port[-1].shape[:2] == (1, 3)


def _decode_matches(jcfg, tcfg, jplan, tplan, S, steps):
    """``test_torch_lm._decode_both`` (prefill, then greedy steps past the
    ring's wrap, the port fed the reference's tokens), held to
    ``DECODE_ATOL`` with the last greedy tokens and the cache dtypes equal."""
    out, jcache, tcache = _decode_both(jcfg, tcfg, jplan, tplan, S=S, steps=steps)
    for j, t in out:
        np.testing.assert_allclose(t, j, rtol=0, atol=DECODE_ATOL)
    assert np.array_equal(out[-1][1].argmax(-1), out[-1][0].argmax(-1))
    for name in jcache:
        assert str(tcache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_decode_matches_reference(kv, absorb, monkeypatch):
    """8 steps after a 6-token prefill, past the ring's wrap; the MoE layer
    routes each step's 2 tokens as the reference does."""
    kw = dict(kv_cache_dtype=kv, mla_absorb=absorb, pad_attention_heads=False)
    routes = Routes(monkeypatch)
    _decode_matches(JAX_DSV2_SMOKE, deepseek_v2_lite_16b.SMOKE, jt.ParallelPlan(**kw), tt.ParallelPlan(**kw),
                    S=6, steps=8)
    routes.check(9)


@pytest.mark.parametrize("kv,fold", [("bf16", False), ("int8", False), ("int8", True)],
                         ids=["bf16", "int8", "int8-fold"])
def test_arctic_decode_matches_reference(kv, fold, monkeypatch):
    """Arctic's GQA (8 heads over 2) with its MoE and dense residual; the
    fold branch goes through the decode kernel's plain version here."""
    kw = dict(kv_cache_dtype=kv, kv_scale_fold=fold)
    routes = Routes(monkeypatch)
    _decode_matches(JAX_ARCTIC_SMOKE, arctic_480b.SMOKE, jt.ParallelPlan(**kw), tt.ParallelPlan(**kw), S=6, steps=8)
    routes.check(2 * 9)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_absorbed_mla_decode_matches_naive(kv):
    """The absorbed decode against the naive one from clones of one prefill
    cache (``lm_decode`` writes the cache in place), within 2e-4 as
    ``tests/test_models_smoke.py`` holds the reference, and their difference
    within ``DECODE_ATOL`` / 4 of the reference's."""
    cfg, jcfg = deepseek_v2_lite_16b.SMOKE, JAX_DSV2_SMOKE
    plans = {a: (jt.ParallelPlan(kv_cache_dtype=kv, mla_absorb=a), tt.ParallelPlan(kv_cache_dtype=kv, mla_absorb=a))
             for a in (False, True)}
    p, model = _models(jcfg, cfg, *plans[False])
    toks = _tokens(2, 16, cfg.vocab_size, seed=4)
    _, jcache = jt.lm_prefill(p, jnp.asarray(toks), jcfg, plans[False][0])
    _, tcache = tt.lm_prefill(model, torch.as_tensor(toks), cfg, plans[False][1])
    tok = toks[:, -1]
    out = {}
    for a, (jplan, tplan) in plans.items():
        jl, _ = jt.lm_decode(p, jcache, jnp.asarray(tok), 16, jcfg, jplan)
        tl, _ = tt.lm_decode(model, {k: v.clone() for k, v in tcache.items()}, torch.as_tensor(tok), 16, cfg, tplan)
        out[a] = (np.asarray(jl), tl.numpy())
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out[True][1] - out[False][1], out[True][0] - out[False][0], rtol=0,
                               atol=DECODE_ATOL / 4)


def test_fuse_qkv_matches_reference():
    """qwen-smoke (MHA, QKV bias) with one stacked projection ``wqkv``: the
    layout ``(3·H·Dh, d)``, forward, prefill and decode against the
    reference's fused plan, and the same numbers as three projections."""
    jcfg, tcfg = JAX_QWEN_SMOKE, qwen15_32b.SMOKE
    jplan, tplan = jt.ParallelPlan(fuse_qkv=True), tt.ParallelPlan(fuse_qkv=True)
    p, model = _models(jcfg, tcfg, jplan, tplan)
    sd = model.state_dict()
    assert {"layers.0.attn.wqkv", "layers.0.attn.bqkv"} <= set(sd) and "layers.0.attn.wq" not in sd
    a = jax.tree.map(np.asarray, p)["layers"]["all"]["attn"]
    _, d, H, Dh = a["wqkv"].shape[1:]
    np.testing.assert_array_equal(sd["layers.1.attn.wqkv"].numpy().reshape(3, H, Dh, d),
                                  np.transpose(a["wqkv"][1], (0, 2, 3, 1)))
    toks = _tokens(2, 12, jcfg.vocab_size, seed=5)
    jf, _ = jt.lm_forward(p, jnp.asarray(toks), jcfg, jplan)
    tf, _ = tt.lm_forward(model, torch.as_tensor(toks), tcfg, tplan)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)
    three = {}
    for k, v in sd.items():
        if k.endswith((".wqkv", ".bqkv")):
            for n, part in zip("qkv", v.chunk(3)):
                three[k.replace("qkv", n)] = part
        else:
            three[k] = v
    split = tt.TransformerLM(tcfg, device="cpu", dtype=torch.float32)
    split.load_state_dict(three, strict=True)
    np.testing.assert_allclose(tt.lm_forward(split, torch.as_tensor(toks), tcfg, tt.ParallelPlan())[0].numpy(),
                               tf.numpy(), rtol=0, atol=FWD_ATOL)
    _decode_matches(jcfg, tcfg, jplan, tplan, S=6, steps=4)


def test_fuse_qkv_is_for_mha_only():
    """GQA (KH < H) keeps three projections under ``fuse_qkv``, as in the
    reference."""
    model = tt.TransformerLM(stablelm_12b.SMOKE, tt.ParallelPlan(fuse_qkv=True), device="cpu")
    assert "layers.0.attn.wq" in model.state_dict() and "layers.0.attn.wqkv" not in model.state_dict()


def test_sp_attention_matches_reference_and_tp():
    """``attn_mode="sp"`` on stablelm-smoke: the reference's sharding of
    attention over the sequence changes nothing on one card, so forward,
    prefill and decode match the reference's sp plan and the port's tp."""
    jcfg, tcfg = JAX_STABLELM_SMOKE, stablelm_12b.SMOKE
    jplan, tplan = jt.ParallelPlan(attn_mode="sp"), tt.ParallelPlan(attn_mode="sp")
    assert tt.effective_heads(tcfg, tplan) == (tcfg.n_heads, tcfg.n_kv_heads)
    p, model = _models(jcfg, tcfg, jplan, tplan)
    toks = _tokens(2, 12, jcfg.vocab_size, seed=6)
    jf, _ = jt.lm_forward(p, jnp.asarray(toks), jcfg, jplan)
    tf, _ = tt.lm_forward(model, torch.as_tensor(toks), tcfg, tplan)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)
    assert torch.equal(tf, tt.lm_forward(model, torch.as_tensor(toks), tcfg, tt.ParallelPlan())[0])
    _decode_matches(jcfg, tcfg, jplan, tplan, S=6, steps=4)


def test_zoo_models_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (deepseek_v2_lite_16b.SMOKE, arctic_480b.SMOKE):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.TransformerLM(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.build(cfg).init(torch.Generator().manual_seed(0))
