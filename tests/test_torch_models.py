"""The port's ResNet, converter and quantizer against the JAX reference.

The JAX parameters (drawn with the JAX PRNG) go through ``params_from_jax``
into the port's model; the same numpy images go through both forwards.
Logits agree to 1e-4 (float32 convolutions summed in another order);
quantization is compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ResNetConfig as JaxResNetConfig
from repro.configs.resnet_50 import FULL as JAX_FULL, SMOKE as JAX_SMOKE
from repro.models import api
from repro.models.resnet import resnet_forward
from repro.quant import quantize as jq
from repro_torch.configs.base import ResNetConfig
from repro_torch.configs.resnet_50 import FULL, SMOKE
from repro_torch.device import resolve_device
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import _same_pad
from repro_torch.models.resnet import ResNet
from repro_torch.quant import quantize as tq

LOGIT_ATOL = 1e-4

# SMOKE at its own size, and a 3-stage net fed an odd size so every
# stride-2 conv and the max-pool see odd inputs (the asymmetric SAME split)
CASES = [
    (JAX_SMOKE, SMOKE, 32),
    (JaxResNetConfig(name="odd", img_res=37, depths=(1, 1, 1), width=8, n_classes=7),
     ResNetConfig(name="odd", img_res=37, depths=(1, 1, 1), width=8, n_classes=7), 37),
]


def _jax_params(cfg, seed, dtype=jnp.float32):
    p = api.build(cfg).init(jax.random.PRNGKey(seed), dtype=dtype)
    return p, jax.tree.map(np.asarray, p)


def _images(n, res, seed=0):
    return np.random.default_rng(seed).standard_normal((n, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("jcfg,tcfg,res", CASES, ids=["smoke", "odd"])
def test_resnet_forward_matches_reference(jcfg, tcfg, res):
    p, pn = _jax_params(jcfg, seed=3)
    model = ResNet(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(pn), strict=True)
    x = _images(3, res)
    ref = np.asarray(resnet_forward(p, jnp.asarray(x), jcfg))
    with torch.no_grad():
        out = model(torch.as_tensor(x))
    assert out.shape == (3, tcfg.n_classes) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("n,k,s,split", [(224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)),
                                         (56, 3, 2, (0, 1)), (37, 3, 2, (1, 1)),
                                         (19, 1, 2, (0, 0)), (28, 3, 1, (1, 1))])
def test_same_pad_split(n, k, s, split):
    assert _same_pad(n, k, s) == split


def test_params_from_jax_layouts_and_names():
    _, pn = _jax_params(JAX_SMOKE, seed=0)
    sd = params_from_jax(pn)
    assert set(sd) == set(ResNet(SMOKE, device="cpu").state_dict())
    np.testing.assert_array_equal(sd["stem.w"].numpy(), pn["stem"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.w"].numpy(), pn["head"]["w"].T)
    np.testing.assert_array_equal(sd["stage1.b0.proj.scale"].numpy(), pn["stage1"]["b0"]["proj"]["scale"])


def test_params_from_jax_keeps_bf16():
    _, pn = _jax_params(JAX_SMOKE, seed=0, dtype=None)  # the spec's own dtypes: bf16 weights
    sd = params_from_jax(pn)
    assert sd["stem.w"].dtype == torch.bfloat16 and sd["stem.scale"].dtype == torch.float32
    np.testing.assert_array_equal(sd["stem.w"].float().numpy(),
                                  pn["stem"]["w"].astype(np.float32).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("bits,axis", [(8, -1), (4, None)], ids=["int8-channel", "int4-tensor"])
def test_qdq_tree_bit_exact(bits, axis):
    """The reference reduces over its last axis (the output channel of
    HWIO and (in, out)); that is axis 0 of the port's layouts."""
    p, pn = _jax_params(JAX_SMOKE, seed=1)
    port_axis = None if axis is None else 0
    ref = params_from_jax(jax.tree.map(np.asarray, jq.qdq_tree(p, bits=bits, axis=axis)))
    out = tq.qdq_tree(params_from_jax(pn), bits=bits, axis=port_axis)
    assert set(ref) == set(out)
    for k in ref:
        assert torch.equal(ref[k], out[k]), k
    assert not torch.equal(out["stem.w"], params_from_jax(pn)["stem.w"])  # weights were quantized
    assert torch.equal(out["stem.scale"], params_from_jax(pn)["stem.scale"])  # affine kept


def test_quantize_tree_values_and_scales():
    p, pn = _jax_params(JAX_SMOKE, seed=2)
    ref = jq.quantize_tree(p)
    out = tq.quantize_tree(params_from_jax(pn))
    qt = out["stage0.b0.c2.w"]
    qr = ref["stage0"]["b0"]["c2"]["w"]
    assert qt.values.dtype == torch.int8
    np.testing.assert_array_equal(qt.values.numpy(), np.asarray(qr.values).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qr.scale).transpose(3, 2, 0, 1))
    deq = tq.dequantize_tree(out, dtype=torch.float32)["head.w"]
    np.testing.assert_array_equal(deq.numpy(), np.asarray(ref["head"]["w"].dequantize(jnp.float32)).T)


def test_fp16_tree_matches_reference():
    p, pn = _jax_params(JAX_SMOKE, seed=4)
    ref = params_from_jax(jax.tree.map(np.asarray, jq.fp16_tree(p)))
    out = tq.fp16_tree(params_from_jax(pn))
    for k in ref:
        assert torch.equal(ref[k], out[k]), k


def test_resnet_init_distribution():
    """Fan-in-scaled normal weights (ptree.py), scale 1, bias 0, from the generator."""
    m1 = ResNet(SMOKE, generator=torch.Generator().manual_seed(0), device="cpu")
    m2 = ResNet(SMOKE, generator=torch.Generator().manual_seed(0), device="cpu")
    sd = m1.state_dict()
    for k, v in sd.items():
        assert torch.equal(v, m2.state_dict()[k]), k
    w = sd["stage1.b0.c2.w"]  # 3x3, cin=32: fan-in 288
    assert abs(float(w.std()) * np.sqrt(9 * 32) - 1.0) < 0.05
    head = sd["head.w"]  # fan-in = features (128)
    assert abs(float(head.std()) * np.sqrt(head.shape[1]) - 1.0) < 0.1
    assert torch.equal(sd["stem.scale"], torch.ones(SMOKE.width))
    assert not sd["stem.bias"].any() and not sd["head.b"].any()


def test_full_config_matches_reference():
    for f in ("img_res", "depths", "width", "n_classes"):
        assert getattr(FULL, f) == getattr(JAX_FULL, f)
    assert FULL.param_count == JAX_FULL.param_count == 25_502_912
    assert sum(v.numel() for k, v in ResNet(SMOKE, device="cpu").state_dict().items()
               if k.endswith(".w")) == SMOKE.param_count


def test_entry_points_default_to_cuda():
    """No device means cuda; without a GPU that raises rather than falling back."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ResNet(SMOKE)
    assert resolve_device("cpu").type == "cpu"
