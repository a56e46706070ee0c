"""The port's core and policy modules against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float32 scores 1e-6; Platt coefficients 1e-4 (two Newton
solvers in float32); resizes 1e-4.  Integer outcomes (gathered indices,
planner schedules) are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import cascade as jcas
from repro.core import confidence as jconf
from repro.core import netsim as jnet
from repro.data import video as jvideo
from repro.policy import frontier as jfront
from repro.policy import make_policy as j_make_policy
from repro.policy import runner as jrunner
from repro.policy import types as jtypes
from repro_torch.core import calibration as tcal
from repro_torch.core import cascade as tcas
from repro_torch.core import confidence as tconf
from repro_torch.core import netsim as tnet
from repro_torch.data import video as tvideo
from repro_torch.policy import frontier as tfront
from repro_torch.policy import make_policy as t_make_policy
from repro_torch.policy import runner as trunner
from repro_torch.policy import types as ttypes

RESOLUTIONS_32 = (8, 12, 18, 24, 32)  # the benchmarks' ladder at 32 px


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------- data --------------------------------------- #


def test_make_dataset_bit_equal():
    cfg_args = dict(n_classes=5, img_res=24, frames_per_video=4, noise_floor=0.3)
    ref = jvideo.make_dataset(jvideo.VideoDataConfig(**cfg_args), 3, seed=7)
    out = tvideo.make_dataset(tvideo.VideoDataConfig(**cfg_args), 3, seed=7)
    for k in ref:
        assert ref[k].dtype == out[k].dtype
        np.testing.assert_array_equal(out[k], ref[k])


# --------------------------- confidence scores ------------------------------ #


@pytest.mark.parametrize("name", ["max_softmax", "margin", "neg_entropy"])
def test_scores_match_reference(name):
    x = (np.random.default_rng(0).standard_normal((6, 5, 11)) * 2).astype(np.float32)
    ref = jconf.SCORES[name](jnp.asarray(x))
    out = tconf.SCORES[name](torch.as_tensor(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6)


def test_sequence_confidence_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 9)).astype(np.float32)
    mask = rng.random((3, 7)) > 0.4
    mask[2] = False  # an all-masked sequence divides by max(0, 1)
    for m in (None, mask):
        ref = jconf.sequence_confidence(jnp.asarray(x), None if m is None else jnp.asarray(m))
        out = tconf.sequence_confidence(torch.as_tensor(x), None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6)


# ------------------------------ calibration --------------------------------- #


def _calib_data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    conf = rng.beta(5, 2, n).astype(np.float32)
    correct = (rng.random(n) < conf ** 1.5).astype(np.float32)
    return conf, correct


@pytest.mark.parametrize("n_bins", [10, 15])
def test_ece_mce_bins_match_reference(n_bins):
    conf, correct = _calib_data()
    for a, b in zip(jcal.reliability_bins(conf, correct, n_bins),
                    tcal.reliability_bins(conf, correct, n_bins)):
        np.testing.assert_array_equal(a, b)
    assert tcal.ece(conf, correct, n_bins) == jcal.ece(conf, correct, n_bins)
    assert tcal.mce(conf, correct, n_bins) == jcal.mce(conf, correct, n_bins)


@pytest.mark.parametrize("seed", [0, 1])
def test_platt_fit_matches_reference(seed):
    conf, correct = _calib_data(seed=seed)
    ref = jcal.PlattCalibrator.fit(conf, correct)
    out = tcal.PlattCalibrator.fit(conf, correct)
    assert abs(out.a - ref.a) < 1e-4 and abs(out.b - ref.b) < 1e-4
    s = np.linspace(0, 1, 11, dtype=np.float32)
    np.testing.assert_allclose(_np(tcal.PlattCalibrator(ref.a, ref.b)(s)),
                               np.asarray(ref(s)), atol=1e-6)


# -------------------------------- cascade ----------------------------------- #


def test_degrade_resolution_ladders():
    """Every rung of the 32 px ladder and 224 -> {45, 90, 134, 179}."""
    rng = np.random.default_rng(2)
    for H, rungs in ((32, RESOLUTIONS_32), (224, (45, 90, 134, 179, 224))):
        x = rng.standard_normal((2, H, H, 3)).astype(np.float32)
        for r in rungs:
            ref = np.asarray(jcas.degrade_resolution(jnp.asarray(x), r))
            out = tcas.degrade_resolution(torch.as_tensor(x), r)
            assert out.shape == x.shape and out.dtype == torch.float32
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def _fast(x, V=6):
    """A linear fast tier over two pixels; the same code runs on jnp and torch."""
    return x[:, 0, 0, :V] * 1.5 + x[:, 1, 1, :V]


def _slow(x, V=6):
    return x[:, 0, 0, :V] * 10.0


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("threshold,capacity", [(0.45, 3), (0.45, 16), (0.0, 5), (1.0, 16)])
def test_cascade_classify_matches_reference(use_fused, threshold, capacity):
    """capacity above the gated count makes the gather pick among -inf
    ties, which must resolve toward the lower index as ``top_k`` does."""
    x = np.random.default_rng(3).standard_normal((16, 8, 8, 6)).astype(np.float32)
    platt = (-6.0, 2.0)
    jcal_fn = jcal.PlattCalibrator(*platt)
    tcal_fn = tcal.PlattCalibrator(*platt)
    kw = dict(threshold=threshold, capacity=capacity, resolution=4,
              use_fused=use_fused, platt_ab=platt)
    ref = jcas.cascade_classify(_fast, _slow, jcal_fn, jnp.asarray(x), **kw)
    out = tcas.cascade_classify(_fast, _slow, tcal_fn, torch.as_tensor(x), **kw)
    np.testing.assert_array_equal(out.esc_idx.numpy(), np.asarray(ref.esc_idx))
    np.testing.assert_array_equal(out.escalated.numpy(), np.asarray(ref.escalated))
    np.testing.assert_array_equal(out.preds.numpy(), np.asarray(ref.preds))
    np.testing.assert_array_equal(out.fast_preds.numpy(), np.asarray(ref.fast_preds))
    np.testing.assert_allclose(out.conf.numpy(), np.asarray(ref.conf), atol=1e-6)


def test_fast_pass_fused_needs_platt():
    with pytest.raises(ValueError, match="platt_ab"):
        tcas.fast_pass(_fast, None, torch.zeros(2, 4, 4, 6), use_fused=True)


def test_argmax_takes_first_maximum():
    x = np.zeros((3, 2, 2, 6), np.float32)
    x[:, 0, 0, [1, 4]] = 1.0  # tied maxima at classes 1 and 4
    ref, _ = jcas.fast_pass(_fast, lambda s: s, jnp.asarray(x))
    out, _ = tcas.fast_pass(_fast, lambda s: s, torch.as_tensor(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.tolist() == [1, 1, 1]


def test_slow_pass_multires_matches_reference():
    x = np.random.default_rng(4).standard_normal((6, 32, 32, 6)).astype(np.float32)
    res = [8, 32, 12, 8, 24, 18]
    ref = jcas.slow_pass_multires(_slow, jnp.asarray(x), res)
    out = tcas.slow_pass_multires(_slow, torch.as_tensor(x), res)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -------------------------------- netsim ------------------------------------ #


@pytest.mark.parametrize("kind", ["constant", "jitter", "jitter_high"])
def test_uplink_matches_reference(kind):
    extra = {"constant": {}, "jitter": dict(jitter=0.3, seed=5),
             "jitter_high": dict(jitter=0.9, seed=11)}[kind]
    ju = jnet.Uplink(bandwidth_bps=jnet.mbps(4.0), latency=0.05, server_time=0.037, **extra)
    tu = tnet.Uplink(bandwidth_bps=tnet.mbps(4.0), latency=0.05, server_time=0.037, **extra)
    rng = np.random.default_rng(6)
    t0 = 0.0
    for _ in range(5):
        n = int(rng.integers(0, 6))
        subs = t0 + np.sort(rng.random(n)) * 0.5
        pay = tnet.png_size_model(rng.choice([45, 90, 224], n))
        np.testing.assert_array_equal(tu.transmit_batch(pay, subs), ju.transmit_batch(pay, subs))
        np.testing.assert_array_equal(tu.bandwidth_at(subs), ju.bandwidth_at(subs))
        assert tu._busy_until == ju._busy_until
        t0 += 0.8


def test_uplink_counter_jitter_not_ported():
    with pytest.raises(NotImplementedError, match="A.7"):
        tnet.Uplink(bandwidth_bps=1e5, latency=0.0, server_time=0.0, jitter=0.1,
                    jitter_mode="counter")
    with pytest.raises(ValueError, match="jitter_mode"):
        tnet.Uplink(bandwidth_bps=1e5, latency=0.0, server_time=0.0, jitter_mode="x")


def test_netsim_helpers_match_reference():
    res = np.array([45, 90, 134, 179, 224])
    assert tnet.png_size_model(90) == jnet.png_size_model(90)
    np.testing.assert_array_equal(tnet.png_size_model(res), jnet.png_size_model(res))

    def scalar_only(r):
        return float(int(r) * 10)

    np.testing.assert_array_equal(tnet.payload_sizes(scalar_only, res),
                                  jnet.payload_sizes(scalar_only, res))
    lands, subs = np.array([0.3, 0.5]), np.array([0.1, 0.2])
    np.testing.assert_array_equal(
        tnet.transfer_seconds(lands, subs, latency=0.05, server_time=0.037),
        jnet.transfer_seconds(lands, subs, latency=0.05, server_time=0.037))


# ------------------------------- planners ----------------------------------- #


def _backlog(types, n, seed, sizes):
    rng = np.random.default_rng(seed)
    arr = np.sort(rng.random(n)) * 0.4
    conf = rng.random(n).astype(np.float32).astype(np.float64)
    if n > 3:
        conf[1] = conf[3]  # a confidence tie
    return [types.Frame(float(a), float(c), sizes) for a, c in zip(arr, conf)]


def _env(types, bw):
    return types.Env(bandwidth=bw, latency=0.05, server_time=0.037, deadline=0.2,
                     acc_server=(0.55, 0.7, 0.8, 0.86, 0.9))


def _assert_plan_equal(a, b):
    assert a.offloads == b.offloads
    assert a.theta == b.theta and a.resolution == b.resolution and a.n_frames == b.n_frames
    assert a.total_gain == b.total_gain and a.base_acc == b.base_acc


SIZES = tuple(float(s) for s in jnet.png_size_model(np.array([45, 90, 134, 179, 224])))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("bw_mbps", [0.5, 5.0, 40.0])
def test_cbo_plan_matches_reference(seed, bw_mbps):
    n = [0, 1, 7, 20, 40, 64][seed]
    bw = jnet.mbps(bw_mbps)
    ref = jfront.cbo_plan(_backlog(jtypes, n, seed, SIZES), _env(jtypes, bw), now=0.05)
    out = tfront.cbo_plan(_backlog(ttypes, n, seed, SIZES), _env(ttypes, bw), now=0.05)
    _assert_plan_equal(out, ref)


@pytest.mark.parametrize("seed", range(3))
def test_optimal_schedule_matches_reference(seed):
    bw = jnet.mbps(3.0)
    ref = jfront.optimal_schedule(_backlog(jtypes, 12 + 4 * seed, seed, SIZES), _env(jtypes, bw))
    out = tfront.optimal_schedule(_backlog(ttypes, 12 + 4 * seed, seed, SIZES), _env(ttypes, bw))
    _assert_plan_equal(out, ref)


@pytest.mark.parametrize("name,cfg", [("cbo", {}), ("optimal", {}), ("local", {}),
                                      ("threshold", dict(theta=0.6, resolution=2)),
                                      ("server", {}), ("greedy-rate", dict(local_acc=0.6))])
def test_policies_match_reference(name, cfg):
    """Each registered policy through observe / plan / consume rounds."""
    jp, tp = j_make_policy(name, **cfg), t_make_policy(name, **cfg)
    for rnd in range(4):
        frames = _backlog(jtypes, 10, 20 + rnd, SIZES)
        jp.observe([jtypes.Frame(f.arrival + 0.3 * rnd, f.conf, f.sizes) for f in frames])
        tp.observe([ttypes.Frame(f.arrival + 0.3 * rnd, f.conf, f.sizes) for f in frames])
        now = 0.3 * rnd + 0.1
        jplan = jp.plan(now, _env(jtypes, jnet.mbps(6.0)))
        tplan = tp.plan(now, _env(ttypes, jnet.mbps(6.0)))
        _assert_plan_equal(tplan, jplan)
        assert jp.consume(i for i, _ in jplan.offloads) == tp.consume(i for i, _ in tplan.offloads)
        assert [(f.arrival, f.conf) for f in tp.backlog] == [(f.arrival, f.conf) for f in jp.backlog]


def test_policy_runner_matches_reference():
    kw = dict(resolutions=(45, 90, 134, 179, 224), acc_server=(0.55, 0.7, 0.8, 0.86, 0.9),
              deadline=0.2, latency=0.05, server_time=0.037, size_of=jnet.png_size_model)
    jr = jrunner.PolicyRunner("cbo", bw=jrunner.BandwidthEstimator(estimate_bps=jnet.mbps(2.0)), **kw)
    tr = trunner.PolicyRunner("cbo", bw=trunner.BandwidthEstimator(estimate_bps=tnet.mbps(2.0)), **kw)
    rng = np.random.default_rng(9)
    for step in range(5):
        for i in range(8):
            t, c = step * 0.2 + i * 0.02, float(rng.random())
            jr.add_frame(t, c)
            tr.add_frame(t, c)
        jplan, tplan = jr.plan(now=step * 0.2 + 0.15), tr.plan(now=step * 0.2 + 0.15)
        _assert_plan_equal(tplan, jplan)
        jr.consume(i for i, _ in jplan.offloads)
        tr.consume(i for i, _ in tplan.offloads)
        pay, secs = 1500.0 * (step + 1), 0.01 * (step + 1)
        jr.bw.observe(pay, secs)
        tr.bw.observe(pay, secs)
        assert tr.bw.estimate_bps == jr.bw.estimate_bps
        assert tr.env() == ttypes.Env(**{k: getattr(jr.env(), k) for k in
                                          ("bandwidth", "latency", "server_time", "deadline",
                                           "acc_server")})
