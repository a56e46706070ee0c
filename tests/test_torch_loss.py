"""The training objectives of the port (``models/api.py``'s ``loss``,
``models/transformer.py::lm_loss``) against the JAX reference: the loss and
every parameter's gradient, from the same weights (every reference leaf
drawn in numpy, ``_ref_tree.draw_tree``, converted by ``params_from_jax``;
the reference's gradient tree goes through the same conversion).

Tolerances, float32 on the CPU: the loss within 1e-5 relative; each
gradient leaf within 1e-4 of its scale, the larger of the leaf's largest
reference magnitude and 1e-3 of the model's (both frameworks sum the same
terms in another order through a few layers).  The floor is for leaves
whose gradient is 0 in exact arithmetic, as a UNet bias right before a
GroupNorm is: there both frameworks give rounding noise of ~1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ref_tree import draw_tree
from repro.configs.arctic_480b import SMOKE as J_ARCTIC
from repro.configs.dit_b2 import SMOKE as J_DIT
from repro.configs.resnet_50 import SMOKE as J_RESNET
from repro.configs.stablelm_12b import SMOKE as J_STABLELM
from repro.configs.unet_sdxl import SMOKE as J_UNET
from repro.configs.vit_s16 import SMOKE as J_VIT
from repro.models import api as japi
from repro.models.transformer import ParallelPlan as JPlan
from repro_torch.configs.arctic_480b import SMOKE as ARCTIC
from repro_torch.configs.dit_b2 import SMOKE as DIT
from repro_torch.configs.resnet_50 import SMOKE as RESNET
from repro_torch.configs.stablelm_12b import SMOKE as STABLELM
from repro_torch.configs.unet_sdxl import SMOKE as UNET
from repro_torch.configs.vit_s16 import SMOKE as VIT
from repro_torch.data.pipeline import token_batch_fn
from repro_torch.models import api as tapi
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import ParallelPlan

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest |grad|


def _image_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((B, cfg.img_res, cfg.img_res, 3)).astype(np.float32),
            "labels": rng.integers(0, cfg.n_classes, B).astype(np.int32)}


def _diffusion_batch(cfg, B, seed, unet: bool):
    rng = np.random.default_rng(seed)
    lat = cfg.latent_res if unet else cfg.img_res // cfg.latent_factor
    shape = (B, lat, lat, cfg.in_channels)
    cond = (rng.standard_normal((B, japi.CTX_TOKENS, cfg.ctx_dim)).astype(np.float32) if unet
            else rng.integers(0, cfg.n_classes + 1, B).astype(np.int32))
    return {"latents": rng.standard_normal(shape).astype(np.float32), "t": rng.integers(0, 1000, B).astype(np.int32),
            "noise": rng.standard_normal(shape).astype(np.float32), "cond": cond}


def _token_batch(cfg, B, S, seed):
    return token_batch_fn(cfg.vocab_size, S)(None, np.arange(seed, seed + B))


def _compare(jcfg, tcfg, batch, seed, jplan=None, tplan=None, family_dtype=True):
    """Loss and grads of the reference and the port from one drawn tree;
    returns (|loss gap|, the largest relative grad gap and its leaf)."""
    jh = japi.build(jcfg, jplan)
    th = tapi.build(tcfg, tplan)
    pn = draw_tree(jh.param_spec, seed)
    lref, gref = jax.jit(jax.value_and_grad(jh.loss))(jax.tree.map(jnp.asarray, pn), {k: jnp.asarray(v) for k, v in batch.items()})
    model = th.init(None, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(pn), strict=True)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    tb = {k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v) for k, v in batch.items()}
    loss = th.loss(model, tb)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    gconv = params_from_jax(jax.tree.map(np.asarray, gref))
    assert sorted(gconv) == sorted(params)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    lref = float(lref)
    assert abs(float(loss.detach()) - lref) <= LOSS_RTOL * abs(lref), (float(loss), lref)
    worst = (0.0, None)
    floor = 1e-3 * max(float(v.abs().max()) for v in gconv.values())
    for (name, p), g in zip(params.items(), grads):
        ref = gconv[name].numpy()
        got = np.zeros_like(ref) if g is None else g.numpy()
        scale = max(float(np.abs(ref).max()), floor)
        gap = float(np.abs(got - ref).max()) / scale
        assert gap <= GRAD_TOL, (name, gap)
        worst = max(worst, (gap, name))
    return abs(float(loss.detach()) - lref), worst


def test_resnet_cls_loss_and_grads():
    _compare(J_RESNET, RESNET, _image_batch(RESNET, 4, 0), seed=0)


def test_vit_cls_loss_and_grads():
    """vit-smoke on the CPU: attention is the plain, differentiable version."""
    _compare(J_VIT, VIT, _image_batch(VIT, 3, 1), seed=1)


def test_dit_learn_sigma_diffusion_loss_and_grads():
    assert DIT.learn_sigma
    _compare(J_DIT, DIT, _diffusion_batch(DIT, 3, 2, unet=False), seed=2)


def test_unet_diffusion_loss_and_grads():
    _compare(J_UNET, UNET, _diffusion_batch(UNET, 2, 3, unet=True), seed=3)


def test_dense_lm_loss_two_chunks_and_grads():
    """S = 4096: the cross-entropy runs in two 2,048-token chunks, each
    under a checkpoint, and every layer under ``plan.remat``."""
    batch = _token_batch(STABLELM, 1, 4096, seed=4)
    _compare(J_STABLELM, STABLELM, batch, seed=4, jplan=JPlan(attn_chunk=1024), tplan=ParallelPlan(attn_chunk=1024))


def test_moe_lm_loss_with_aux_and_grads():
    """arctic-smoke: routed experts, a dense residual MLP, and the router's
    aux loss added to the cross-entropy."""
    batch = _token_batch(ARCTIC, 2, 64, seed=5)
    _compare(J_ARCTIC, ARCTIC, batch, seed=5)


def test_lm_hidden_final_norm_switch():
    """``final_norm=False`` leaves the last layer's output as it is; the
    default applies the final norm, as ``lm_forward`` reads it."""
    from repro_torch.models import transformer as tr

    model = tapi.build(STABLELM).init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    toks = torch.as_tensor(_token_batch(STABLELM, 2, 32, seed=6)["tokens"]).long()
    plan = ParallelPlan()
    with torch.no_grad():
        raw, _ = tr.lm_hidden(model, toks, STABLELM, plan, final_norm=False)
        normed, _ = tr.lm_hidden(model, toks, STABLELM, plan)
    assert not torch.equal(raw, normed)
    torch.testing.assert_close(tr.apply_norm(model.final_norm, raw, STABLELM.norm), normed, rtol=0, atol=0)
