"""The port's Swin against the JAX reference (``repro.models.swin``).

Every leaf of the reference tree is drawn with numpy from a seed
(``_ref_tree.draw_tree``: the zero-initialised biases too), converted by
``params_from_jax`` into the port's ``Swin`` and held to ``swin_forward``
on the same numpy images, float32.  Logits agree within ``LOGIT_ATOL`` =
1e-4, ``test_torch_vit.py``'s limit: float32 products summed in another
order through the smoke config's two stages, on logits of magnitude
about 1 (the largest difference measured over three seeds, at 32 and
64 px, was 2.1e-7).  The
shift mask and the relative-position index are bit-equal.  The cascade
test serves a stream with a swin-smoke slow tier as
``test_torch_serving.py`` does with deit-smoke.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as jeng
import repro_torch.serving.engine as teng
from _diff import LAT_ATOL
from _ref_tree import draw_tree, meta_state_dict
from repro.configs.base import ShapeSpec
from repro.configs.resnet_50 import SMOKE as JAX_RESNET_SMOKE
from repro.configs.swin_b import FULL as JAX_SWIN_B, SMOKE as JAX_SWIN_SMOKE
from repro.core.calibration import PlattCalibrator as JaxPlatt
from repro.core.netsim import Uplink as JaxUplink
from repro.core.netsim import png_size_model as jax_png_size_model
from repro.models import api
from repro.models import swin as jswin
from repro.models.ptree import tree_count
from repro.models.resnet import resnet_forward
from repro.quant.quantize import qdq_tree as jax_qdq_tree
from repro_torch.configs.base import ShapeSpec as TShapeSpec
from repro_torch.configs.resnet_50 import SMOKE as RESNET_SMOKE
from repro_torch.configs.swin_b import FULL as SWIN_B, SMOKE as SWIN_SMOKE
from repro_torch.core.calibration import PlattCalibrator
from repro_torch.core.netsim import Uplink, mbps, png_size_model
from repro_torch.data.video import VideoDataConfig, make_dataset
from repro_torch.models import api as tapi
from repro_torch.models import swin as tswin
from repro_torch.models.convert import params_from_jax
from repro_torch.models.resnet import ResNet
from repro_torch.quant.quantize import qdq_tree
from repro_torch.serving.engine import CascadeServer, ServeConfig

LOGIT_ATOL = 1e-4
PLATT = (-20.0, 5.0)
ACC_SERVER = (0.5, 0.62, 0.74, 0.82, 0.88)
RESOLUTIONS = (8, 12, 18, 24, 32)  # the paper's 45..224 ladder at 32 px


def _pair(jcfg, tcfg, seed):
    pn = draw_tree(jswin.swin_param_spec(jcfg), seed)
    model = tswin.Swin(tcfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(pn), strict=True)
    return jax.tree.map(jnp.asarray, pn), model


def _images(n, res, seed=0):
    return np.random.default_rng(seed).standard_normal((n, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_swin_smoke_logits_match_reference(seed):
    p, model = _pair(JAX_SWIN_SMOKE, SWIN_SMOKE, seed)
    x = _images(3, SWIN_SMOKE.img_res, seed=seed)
    ref = np.asarray(jswin.swin_forward(p, jnp.asarray(x), JAX_SWIN_SMOKE))
    with torch.no_grad():
        out = model(torch.as_tensor(x))
    assert out.shape == (3, SWIN_SMOKE.n_classes) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


def test_swin_at_config_for_shape_doubles_the_window():
    """At 2x the smoke resolution the window scales 4 -> 8 (the Swin-384
    rule), the relative-position bias with it."""
    res = 2 * JAX_SWIN_SMOKE.img_res
    jcfg = api.config_for_shape(JAX_SWIN_SMOKE, ShapeSpec("serve", "serve", img_res=res, batch=2))
    tcfg = tapi.config_for_shape(SWIN_SMOKE, TShapeSpec("serve", "serve", img_res=res, batch=2))
    assert (tcfg.window, tcfg.img_res) == (jcfg.window, jcfg.img_res) == (8, res)
    assert tapi.config_for_shape(SWIN_SMOKE, TShapeSpec("lm", "prefill")) is SWIN_SMOKE
    assert tapi.config_for_shape(SWIN_B, TShapeSpec("cls_384", "train", img_res=384)).window == 12
    p, model = _pair(jcfg, tcfg, seed=4)
    assert model.state_dict()["stage0.l0.attn.rel_bias"].shape == (15**2, SWIN_SMOKE.heads[0])
    x = _images(2, res, seed=3)
    ref = np.asarray(jswin.swin_forward(p, jnp.asarray(x), jcfg))
    with torch.no_grad():
        out = model(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("window", [2, 4, 7, 8, 12])
def test_rel_index_bit_equal(window):
    got = tswin._rel_index(window)
    np.testing.assert_array_equal(got, jswin._rel_index(window))
    assert got.dtype == np.int32 and got.min() == 0 and got.max() == (2 * window - 1) ** 2 - 1


@pytest.mark.parametrize("H,W,window,shift", [(16, 16, 4, 2), (8, 8, 4, 2), (56, 56, 7, 3), (7, 7, 7, 3),
                                              (14, 28, 7, 3), (24, 24, 12, 6)])
def test_shift_mask_bit_equal(H, W, window, shift):
    """Swin-B's stages at 224 px (56 to 7, window 7, the last one window),
    Swin-384's window 12, and the smoke sizes."""
    got = tswin._shift_mask(H, W, window, shift)
    np.testing.assert_array_equal(got, np.asarray(jswin._shift_mask(H, W, window, shift)))
    assert got.shape == ((H // window) * (W // window), window**2, window**2)


def test_window_attention_shifted_and_not_matches_reference():
    """One layer's attention at a 2 x 2-window map, shift 0 and 2."""
    rng = np.random.default_rng(7)
    C, H_heads, w = 32, 2, 4
    spec = jswin._win_layer_spec(C, H_heads, w)["attn"]
    pn = draw_tree(spec, seed=7)
    tp = params_from_jax(pn)
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    idx = torch.as_tensor(tswin._rel_index(w).astype(np.int64))
    for shift in (0, 2):
        mask = torch.as_tensor(tswin._shift_mask(8, 8, w, shift or 2))
        ref = np.asarray(jswin._window_attention(jax.tree.map(jnp.asarray, pn), jnp.asarray(x), w, shift, 8, 8))
        got = tswin._window_attention(tp, torch.as_tensor(x), w, shift, idx, mask)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("jcfg,tcfg", [(JAX_SWIN_B, SWIN_B), (JAX_SWIN_SMOKE, SWIN_SMOKE)],
                         ids=["swin-b", "swin-smoke"])
def test_params_from_jax_loads_strict(jcfg, tcfg, monkeypatch):
    """Every converted leaf has a parameter of the port's shape, and every
    parameter a leaf; FULL on the meta device, SMOKE with real values."""
    spec = jswin.swin_param_spec(jcfg)
    if tcfg is SWIN_SMOKE:
        pn = draw_tree(spec, seed=2)
        sd = params_from_jax(pn)
        model = tswin.Swin(tcfg, device="cpu", dtype=torch.float32)
        model.load_state_dict(sd, strict=True)
        np.testing.assert_array_equal(model.state_dict()["stage0.merge.w"].numpy(), pn["stage0"]["merge"]["w"].T)
        np.testing.assert_array_equal(model.state_dict()["stage1.l0.attn.rel_bias"].numpy(),
                                      pn["stage1"]["l0"]["attn"]["rel_bias"])
    else:
        sd = meta_state_dict(spec, monkeypatch)
        model = tswin.Swin(tcfg, device="meta")
        model.load_state_dict(sd, strict=True)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}


def test_swin_b_n_params_equal_reference():
    assert tapi.build(SWIN_B).n_params() == tree_count(jswin.swin_param_spec(JAX_SWIN_B)) == 87_696_032
    assert SWIN_B.param_count == JAX_SWIN_B.param_count == 87_649_336
    assert tapi.build(SWIN_SMOKE).n_params() == 71_965
    assert tapi.build(SWIN_B).family == "vision"


def test_swin_init_reference_layout():
    """Fan-in-scaled weights with the reference layout's fan-in, rel_bias
    at std 0.02, float32 norms in a bf16 model, biases 0."""
    m = tswin.Swin(SWIN_B, generator=torch.Generator().manual_seed(0), device="cpu")
    sd = m.state_dict()
    wqkv = sd["stage2.l0.attn.wqkv"].float()
    assert sd["stage2.l0.attn.wqkv"].dtype == torch.bfloat16 and sd["stage2.l0.ln1.scale"].dtype == torch.float32
    assert abs(float(wqkv.std()) * np.sqrt(3 * 512 * 16) - 1.0) < 0.05
    assert abs(float(sd["stage0.l1.attn.rel_bias"].float().std()) / 0.02 - 1.0) < 0.1
    assert not sd["stage3.l1.attn.bqkv"].any() and not sd["head.b"].any()
    assert torch.equal(sd["final_norm.scale"], torch.ones(1024))


@pytest.fixture(scope="module")
def resnet_fast():
    return jax_qdq_tree(api.build(JAX_RESNET_SMOKE).init(jax.random.PRNGKey(0), dtype=jnp.float32))


@pytest.fixture(scope="module")
def stream():
    data = make_dataset(VideoDataConfig(n_classes=10, img_res=32, frames_per_video=12,
                                        noise_floor=0.3), 6, seed=2)
    return data["frames"][:72], data["labels"][:72]  # 4 full batches + a partial one


def _logging(fn, log):
    def wrapped(x):
        out = fn(x)
        log.append(np.asarray(out))
        return out
    return wrapped


def _recording_gather(fn, log):
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        log.append((np.asarray(out.escalated), np.asarray(out.esc_idx)))
        return out
    return wrapped


@pytest.mark.parametrize("bw_mbps,server_time", [(1.0, 0.037), (4.0, 0.1)], ids=["1mbps", "4mbps-straggler"])
def test_cascade_server_swin_slow_tier_matches_reference(resnet_fast, stream, monkeypatch, bw_mbps, server_time):
    """ResNet SMOKE fast tier, swin-smoke slow tier: per batch the same
    gathered frames, slow-tier logits within ``LOGIT_ATOL`` and equal slow
    predictions on every escalated frame, then every metric as the
    reference's."""
    frames, labels = stream
    swin_p, swin_m = _pair(JAX_SWIN_SMOKE, SWIN_SMOKE, seed=1)
    common = dict(resolutions=RESOLUTIONS, acc_server=ACC_SERVER, batch_size=16, use_fused=True, platt_ab=PLATT)

    jlog, tlog, jslow, tslow = [], [], [], []
    monkeypatch.setattr(jeng, "cascade_classify", _recording_gather(jeng.cascade_classify, jlog))
    monkeypatch.setattr(teng, "cascade_classify", _recording_gather(teng.cascade_classify, tlog))

    jcfg = jeng.ServeConfig(size_of=functools.partial(jax_png_size_model, base_res=32), **common)
    jsrv = jeng.CascadeServer(
        jcfg,
        fast_forward=lambda x: resnet_forward(resnet_fast, x, JAX_RESNET_SMOKE),
        slow_forward=_logging(lambda x: jswin.swin_forward(swin_p, x, JAX_SWIN_SMOKE), jslow),
        calibrate=JaxPlatt(*PLATT),
        uplink=JaxUplink(bandwidth_bps=mbps(bw_mbps), latency=0.05, server_time=server_time))
    jm = jsrv.process_stream(frames, labels)

    fast_m = ResNet(RESNET_SMOKE, device="cpu")
    fast_m.load_state_dict(qdq_tree(params_from_jax(jax.tree.map(np.asarray, resnet_fast))))
    tcfg = ServeConfig(size_of=functools.partial(png_size_model, base_res=32), **common)
    tsrv = CascadeServer(tcfg, fast_forward=fast_m, slow_forward=_logging(swin_m, tslow),
                         calibrate=PlattCalibrator(*PLATT),
                         uplink=Uplink(bandwidth_bps=mbps(bw_mbps), latency=0.05, server_time=server_time),
                         device="cpu")
    with torch.no_grad():
        tm = tsrv.process_stream(frames, labels)

    assert len(jlog) == len(tlog) == len(jslow) == len(tslow) == 5  # one slow-tier call a batch
    n_escalated = 0
    for (jesc, jidx), (tesc, tidx), jl, tl in zip(jlog, tlog, jslow, tslow):
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(tesc, jesc)
        assert tl.shape == jl.shape == (len(jidx), SWIN_SMOKE.n_classes)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        valid = jesc[jidx]
        top2 = np.sort(jl[valid], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > LOGIT_ATOL).all(), "an escalated frame's top-2 logits tie"
        np.testing.assert_array_equal(tl[valid].argmax(-1), jl[valid].argmax(-1))
        n_escalated += int(valid.sum())
    assert n_escalated > 0
    for f in ("n_frames", "n_offloaded", "n_deadline_miss", "n_correct"):
        assert getattr(tm, f) == getattr(jm, f), f
    np.testing.assert_allclose(tm.latencies, jm.latencies, atol=LAT_ATOL, rtol=0)
    assert tm.summary() == jm.summary()


def test_swin_config_fields_equal_reference():
    for jcfg, tcfg in ((JAX_SWIN_B, SWIN_B), (JAX_SWIN_SMOKE, SWIN_SMOKE)):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.heads == jcfg.heads
