"""The whole slice: the port's ``CascadeServer(use_fused=True)`` against the
JAX reference's, with the same converted weights and the same
``make_dataset`` frames: a SMOKE ResNet fast tier, and a SMOKE ResNet or a
``deit-smoke`` ViT slow tier.

Each batch's fast-tier predictions must be equal and its calibrated
confidences within 1e-5 (float32 convolutions summed in another order);
every integer metric is exact and latencies agree within ``LAT_ATOL``.
A decision can flip only if a confidence sits within rounding of the
round's threshold, so the test first asserts that none comes within 1e-4:
a mismatch then has a cause in the port.  With the DeiT slow tier, the
slow tier's logits agree within ``LOGIT_ATOL`` and every escalated frame's
top-1/top-2 margin exceeds it, so its prediction is decided, not rounded.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.serving.engine as jeng
import repro_torch.serving.engine as teng
from _diff import LAT_ATOL
from repro.configs.deit_b import SMOKE as JAX_DEIT_SMOKE
from repro.configs.resnet_50 import SMOKE as JAX_SMOKE
from repro.core.calibration import PlattCalibrator as JaxPlatt
from repro.core.netsim import Uplink as JaxUplink
from repro.core.netsim import png_size_model as jax_png_size_model
from repro.models import api
from repro.models.resnet import resnet_forward
from repro.models.vit import vit_forward
from repro.quant.quantize import qdq_tree as jax_qdq_tree
from repro_torch.configs.deit_b import SMOKE as DEIT_SMOKE
from repro_torch.configs.resnet_50 import SMOKE
from repro_torch.core.calibration import PlattCalibrator
from repro_torch.core.netsim import Uplink, mbps, png_size_model
from repro_torch.data.video import VideoDataConfig, make_dataset
from repro_torch.models.convert import params_from_jax
from repro_torch.models.resnet import ResNet
from repro_torch.models.vit import ViT
from repro_torch.quant.quantize import qdq_tree
from repro_torch.serving.engine import CascadeServer, ServeConfig

CONF_ATOL = 1e-5
LOGIT_ATOL = 1e-4  # as tests/test_torch_vit.py
THETA_MARGIN = 1e-4
PLATT = (-20.0, 5.0)
ACC_SERVER = (0.5, 0.62, 0.74, 0.82, 0.88)
RESOLUTIONS = (8, 12, 18, 24, 32)  # the paper's 45..224 ladder at 32 px


def _recording(fn, log):
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        log.append((kw["threshold"], np.asarray(out.fast_preds), np.asarray(out.conf),
                    np.asarray(out.escalated)))
        return out
    return wrapped


@pytest.fixture(scope="module")
def tiers():
    h = api.build(JAX_SMOKE)
    fast = jax_qdq_tree(h.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    slow = h.init(jax.random.PRNGKey(1), dtype=jnp.float32)
    return fast, slow


@pytest.fixture(scope="module")
def stream():
    data = make_dataset(VideoDataConfig(n_classes=10, img_res=32, frames_per_video=12,
                                        noise_floor=0.3), 6, seed=2)
    return data["frames"][:72], data["labels"][:72]  # 4 full batches + a partial one


# the uplink's true server time: the planner's 0.037 s, or a straggling
# 0.1 s server whose late replies fall back to the fast answer
@pytest.mark.parametrize("bw_mbps,server_time", [(1.0, 0.037), (4.0, 0.037), (4.0, 0.1)],
                         ids=["1mbps", "4mbps", "4mbps-straggler"])
def test_cascade_server_fused_matches_reference(tiers, stream, monkeypatch, bw_mbps, server_time):
    frames, labels = stream
    fast_p, slow_p = tiers
    common = dict(resolutions=RESOLUTIONS, acc_server=ACC_SERVER, batch_size=16,
                  use_fused=True, platt_ab=PLATT)

    jlog, tlog = [], []
    monkeypatch.setattr(jeng, "cascade_classify", _recording(jeng.cascade_classify, jlog))
    monkeypatch.setattr(teng, "cascade_classify", _recording(teng.cascade_classify, tlog))

    jcfg = jeng.ServeConfig(size_of=functools.partial(jax_png_size_model, base_res=32), **common)
    jsrv = jeng.CascadeServer(
        jcfg,
        fast_forward=lambda x: resnet_forward(fast_p, x, JAX_SMOKE),
        slow_forward=lambda x: resnet_forward(slow_p, x, JAX_SMOKE),
        calibrate=JaxPlatt(*PLATT),
        uplink=JaxUplink(bandwidth_bps=mbps(bw_mbps), latency=0.05, server_time=server_time))
    jm = jsrv.process_stream(frames, labels)

    fast_m = ResNet(SMOKE, device="cpu")
    fast_m.load_state_dict(qdq_tree(params_from_jax(jax.tree.map(np.asarray, tiers[0]))))
    slow_m = ResNet(SMOKE, device="cpu")
    slow_m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, slow_p)))
    tcfg = ServeConfig(size_of=functools.partial(png_size_model, base_res=32), **common)
    tsrv = CascadeServer(tcfg, fast_forward=fast_m, slow_forward=slow_m,
                         calibrate=PlattCalibrator(*PLATT),
                         uplink=Uplink(bandwidth_bps=mbps(bw_mbps), latency=0.05,
                                       server_time=server_time),
                         device="cpu")
    tm = tsrv.process_stream(frames, labels)

    assert len(jlog) == len(tlog) == 5
    for (jth, jpred, jconf, jesc), (tth, tpred, tconf, tesc) in zip(jlog, tlog):
        assert np.abs(jconf - jth).min() > THETA_MARGIN, "a confidence sits on the threshold"
        assert abs(tth - jth) <= CONF_ATOL  # theta is a copied confidence
        np.testing.assert_array_equal(tpred, jpred)
        np.testing.assert_allclose(tconf, jconf, atol=CONF_ATOL, rtol=0)
        np.testing.assert_array_equal(tesc, jesc)

    for f in ("n_frames", "n_offloaded", "n_deadline_miss", "n_correct"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.n_frames == 72 and tm.n_offloaded + tm.n_deadline_miss > 0
    assert (tm.n_deadline_miss > 0) == (server_time > tcfg.server_time)
    np.testing.assert_allclose(tm.latencies, jm.latencies, atol=LAT_ATOL, rtol=0)
    assert abs(tsrv.uplink._busy_until - jsrv.uplink._busy_until) <= LAT_ATOL
    assert tm.summary() == jm.summary()


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


@pytest.fixture(scope="module")
def deit_slow():
    return api.build(JAX_DEIT_SMOKE).init(jax.random.PRNGKey(1), dtype=jnp.float32)


@pytest.mark.parametrize("bw_mbps,server_time", [(1.0, 0.037), (4.0, 0.037), (4.0, 0.1)],
                         ids=["1mbps", "4mbps", "4mbps-straggler"])
def test_cascade_server_deit_slow_tier_matches_reference(tiers, deit_slow, stream, monkeypatch,
                                                         bw_mbps, server_time):
    """ResNet SMOKE fast tier, DeiT SMOKE slow tier (its attention through
    ``kernels.flash_attention.ops``): per batch the same gathered frames,
    slow-tier logits within ``LOGIT_ATOL`` and equal slow predictions on
    every escalated frame, then every metric as the reference's."""
    frames, labels = stream
    fast_p = tiers[0]
    common = dict(resolutions=RESOLUTIONS, acc_server=ACC_SERVER, batch_size=16,
                  use_fused=True, platt_ab=PLATT)

    jlog, tlog, jslow, tslow = [], [], [], []
    monkeypatch.setattr(jeng, "cascade_classify", _recording_gather(jeng.cascade_classify, jlog))
    monkeypatch.setattr(teng, "cascade_classify", _recording_gather(teng.cascade_classify, tlog))

    jcfg = jeng.ServeConfig(size_of=functools.partial(jax_png_size_model, base_res=32), **common)
    jsrv = jeng.CascadeServer(
        jcfg,
        fast_forward=lambda x: resnet_forward(fast_p, x, JAX_SMOKE),
        slow_forward=_logging(lambda x: vit_forward(deit_slow, x, JAX_DEIT_SMOKE), jslow),
        calibrate=JaxPlatt(*PLATT),
        uplink=JaxUplink(bandwidth_bps=mbps(bw_mbps), latency=0.05, server_time=server_time))
    jm = jsrv.process_stream(frames, labels)

    fast_m = ResNet(SMOKE, device="cpu")
    fast_m.load_state_dict(qdq_tree(params_from_jax(jax.tree.map(np.asarray, fast_p))))
    slow_m = ViT(DEIT_SMOKE, device="cpu")
    slow_m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, deit_slow)))
    tcfg = ServeConfig(size_of=functools.partial(png_size_model, base_res=32), **common)
    tsrv = CascadeServer(tcfg, fast_forward=fast_m, slow_forward=_logging(slow_m, tslow),
                         calibrate=PlattCalibrator(*PLATT),
                         uplink=Uplink(bandwidth_bps=mbps(bw_mbps), latency=0.05,
                                       server_time=server_time),
                         device="cpu")
    tm = tsrv.process_stream(frames, labels)

    assert len(jlog) == len(tlog) == len(jslow) == len(tslow) == 5  # one slow-tier call a batch
    n_escalated = 0
    for (jesc, jidx), (tesc, tidx), jl, tl in zip(jlog, tlog, jslow, tslow):
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_array_equal(tesc, jesc)
        assert tl.shape == jl.shape == (len(jidx), DEIT_SMOKE.n_classes)
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        valid = jesc[jidx]  # the gathered frames that were gated, not padding
        top2 = np.sort(jl[valid], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > LOGIT_ATOL).all(), "an escalated frame's top-2 logits tie"
        np.testing.assert_array_equal(tl[valid].argmax(-1), jl[valid].argmax(-1))
        n_escalated += int(valid.sum())
    assert n_escalated > 0

    for f in ("n_frames", "n_offloaded", "n_deadline_miss", "n_correct"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.n_frames == 72 and tm.n_offloaded + tm.n_deadline_miss > 0
    np.testing.assert_allclose(tm.latencies, jm.latencies, atol=LAT_ATOL, rtol=0)
    assert tm.summary() == jm.summary()
