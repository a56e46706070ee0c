"""The port's MoE layer (``models/moe.py``) against ``repro.models.moe``.

The same seeded numpy weights and tokens go through both, in float32.
Limits:

- routes (``top_i``) bit-equal.  The two frameworks' f32 router products
  differ in the last bits, so each case first asserts that the smallest
  gap between a token's k-th and (k+1)-th gate is above ``GATE_GAP``
  (1e-5, far above that noise): a flipped expert is then a fault;
- the capacity drops equal: the tokens a drop changes are the same in both,
  and they are the slots that the reference's rule (rank within the
  expert, in token order, at or past C) drops;
- outputs within 1e-5 (f32 products summed in another order);
- the aux loss within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.arctic_480b import FULL as JAX_ARCTIC
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.deepseek_v2_lite_16b import FULL as JAX_DSV2
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as tmoe

OUT_ATOL = 1e-5
AUX_ATOL = 1e-6
GATE_GAP = 1e-5
D = 32


def _cfgs(**kw):
    base = dict(n_routed=8, top_k=2, d_ff_expert=24)
    base.update(kw)
    return JaxMoEConfig(**base), MoEConfig(**base)


def _weights(cfg, act, seed, router_bias=None):
    """Reference-layout numpy weights; the MLPs' are transposed for the port."""
    rng = np.random.default_rng(seed)
    E, f = cfg.n_routed, cfg.d_ff_expert

    def w(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    p = {"router": w(D, E)}
    if router_bias is not None:
        p["router"][:, router_bias] += 0.2
    names = (("wg", (E, D, f)), ("wu", (E, D, f)), ("wd", (E, f, D))) if act == "swiglu" else \
        (("wi", (E, D, f)), ("wo", (E, f, D)))
    p.update({k: w(*s, scale=np.sqrt(E)) for k, s in names})
    mlp = (("wg", (D, 40)), ("wu", (D, 40)), ("wd", (40, D))) if act == "swiglu" else (("wi", (D, 40)), ("wo", (40, D)))
    if cfg.n_shared:
        p["shared"] = {k: w(*s) for k, s in mlp}
    if cfg.dense_residual_ff:
        p["dense"] = {k: w(*s) for k, s in mlp}
    return p


def _to_jax(p):
    return jax.tree.map(jnp.asarray, p)


def _to_port(p):
    return {k: ({n: torch.as_tensor(v.T.copy()) for n, v in val.items()} if isinstance(val, dict)
                else torch.as_tensor(val)) for k, val in p.items()}


def _x(B, S, seed, shift=0.0):
    return (np.random.default_rng(seed + 100).standard_normal((B, S, D)) + shift).astype(np.float32)


def _jax_top_i(p, x, cfg, groups):
    """The reference's routing lines (``moe.py:77-80``) on its grouping."""
    B, S, _ = x.shape
    G = groups if (groups > 1 and B % groups == 0) else 1
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(G, B * S // G, D), jnp.asarray(p["router"]))
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1])


def _port_route(p, x, cfg, groups):
    G = groups if (groups > 1 and x.shape[0] % groups == 0) else 1
    gates, top_v, top_i = tmoe.route(torch.as_tensor(p["router"]), torch.as_tensor(x).reshape(G, -1, D), cfg)
    srt = torch.sort(gates, dim=-1, descending=True).values
    gap = float((srt[..., cfg.top_k - 1] - srt[..., cfg.top_k]).min())
    return top_i.numpy(), top_v, gap


def _both(p, x, jcfg, tcfg, act, groups):
    jout, jaux = jmoe.apply_moe(_to_jax(p), jnp.asarray(x), jcfg, act, groups=groups)
    tout, taux = tmoe.apply_moe(_to_port(p), torch.as_tensor(x), tcfg, act, groups=groups)
    return np.asarray(jout), float(jaux), tout.numpy(), float(taux)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("extra", ["shared", "dense", "neither"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_moe_matches_reference(act, extra, groups):
    kw = {"shared": dict(n_shared=2), "dense": dict(dense_residual_ff=40), "neither": {}}[extra]
    jcfg, tcfg = _cfgs(**kw)
    seed = 7 * groups + len(extra)
    p, x = _weights(jcfg, act, seed), _x(4, 16, seed)
    top_i, top_v, gap = _port_route(p, x, tcfg, groups)
    assert gap > GATE_GAP, f"a near-tie of gates ({gap:.2e}): pick inputs without one"
    np.testing.assert_array_equal(top_i, _jax_top_i(p, x, jcfg, groups))
    np.testing.assert_allclose(top_v.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)
    jout, jaux, tout, taux = _both(p, x, jcfg, tcfg, act, groups)
    assert tout.shape == (4, 16, D) and tout.dtype == np.float32
    np.testing.assert_allclose(tout, jout, rtol=0, atol=OUT_ATOL)
    assert abs(taux - jaux) <= AUX_ATOL


def _dropped_slots(top_i: np.ndarray, C: int) -> np.ndarray:
    """(G, T, K) bool: the reference's rule, written out — a slot is dropped
    when at least C slots of its expert come before it in (token, k) order."""
    G, T, K = top_i.shape
    flat = top_i.reshape(G, T * K)
    out = np.zeros_like(flat, dtype=bool)
    for g in range(G):
        for e in np.unique(flat[g]):
            idx = np.flatnonzero(flat[g] == e)
            out[g, idx[C:]] = True
    return out.reshape(G, T, K)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_capacity_drops_match_reference(act, groups):
    """Tokens with a positive mean, and a router column that rewards it,
    pull most tokens to expert 3 and overflow it.  Raising the capacity
    factor so nothing drops changes exactly the tokens with a dropped slot,
    the same ones in both frameworks; nothing is renormalised."""
    jcfg, tcfg = _cfgs(n_shared=1)
    p, x = _weights(jcfg, act, 11 + groups, router_bias=3), _x(4, 16, 11 + groups, shift=0.5)
    top_i, _, gap = _port_route(p, x, tcfg, groups)
    assert gap > GATE_GAP
    np.testing.assert_array_equal(top_i, _jax_top_i(p, x, jcfg, groups))
    G = groups
    C = tmoe.capacity_for(x.shape[0] * x.shape[1] // G, tcfg)
    dropped = _dropped_slots(top_i, C)
    assert dropped.sum() >= 8, f"the biased router dropped only {dropped.sum()} slots"
    jout, jaux, tout, taux = _both(p, x, jcfg, tcfg, act, groups)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=OUT_ATOL)
    assert abs(taux - jaux) <= AUX_ATOL
    jcfg_all = dataclasses.replace(jcfg, capacity_factor=100.0)
    tcfg_all = dataclasses.replace(tcfg, capacity_factor=100.0)
    jall, _, tall, _ = _both(p, x, jcfg_all, tcfg_all, act, groups)
    hit = dropped.any(-1).reshape(x.shape[:2])
    j_changed = np.abs(jall - jout).max(-1) > 1e-4
    t_changed = np.abs(tall - tout).max(-1) > 1e-4
    np.testing.assert_array_equal(t_changed, j_changed)
    np.testing.assert_array_equal(t_changed, hit)


def test_capacity_for_matches_reference():
    """Over T = 1..5000 and both FULL configs (E 64 top 6; E 128 top 2),
    and at the chip paths' shapes: DeepSeek's 8 x 2048 prefill, Arctic's
    8 x 1024, and an 8-token decode step."""
    for jm in (JAX_DSV2.moe, JAX_ARCTIC.moe, _cfgs()[0]):
        tm = MoEConfig(**dataclasses.asdict(jm))
        for T in range(1, 5000, 7):
            assert tmoe.capacity_for(T, tm) == jmoe.capacity_for(T, jm), (jm, T)
    dsv2, arctic = MoEConfig(**dataclasses.asdict(JAX_DSV2.moe)), MoEConfig(**dataclasses.asdict(JAX_ARCTIC.moe))
    assert (tmoe.capacity_for(8 * 2048, dsv2), tmoe.capacity_for(8 * 1024, arctic)) == (1920, 160)
    assert tmoe.capacity_for(8, dsv2) == tmoe.capacity_for(8, arctic) == 8


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_shapes_match_reference_spec(act):
    """``moe_shapes`` against ``moe_spec``: the expert leaves and the router
    in the reference's layout, the MLPs transposed, the fan-ins those
    ``tree_init`` gives the per-layer shapes."""
    jcfg, tcfg = _cfgs(n_shared=2, dense_residual_ff=40)
    spec = jmoe.moe_spec(D, jcfg, act)
    flat = {}
    for k, v in spec.items():
        for n, leaf in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat[k if n is None else f"{k}.{n}"] = leaf
    shapes = tmoe.moe_shapes(D, tcfg, act)
    assert set(shapes) == set(flat)
    for name, leaf in shapes.items():
        ref = flat[name]
        want = ref.shape if "." not in name else ref.shape[::-1]
        assert leaf.shape == want, name
        assert leaf.fan_in == int(np.prod(ref.shape[:-1])), name
        assert leaf.f32 == (ref.dtype == jnp.float32), name
