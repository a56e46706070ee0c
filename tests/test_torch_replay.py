"""The port's §V trace replay and planner oracles against the JAX package.

``replay_trace``, the tuple-chain reference planners, the brute-force
oracle and ``AdaptiveController`` are host numpy in both packages, so on
the same inputs every answer is bit-equal: each replayed frame's result,
its offloaded flag and the count of late transmissions, and every plan's
offload schedule, theta, resolution and gains.  The replay runs each
approach of ``benchmarks/approaches.py`` (six registered policies, the
``cbo`` one twice, with calibrated and raw confidences, and ``threshold``
beside them) on ``tests/_replay_fixture.py``'s synthetic trace under every
``FIXTURE_NETS`` regime, and must also give the accuracy recorded in
``tests/data/replay_fixture.json``.
"""
import json
import os
import sys

import numpy as np
import pytest

import repro.core.cbo as jcbo
import repro.core.policy as jcpol
import repro.policy as jpol
import repro.policy.reference as jref
import repro_torch.core.cbo as tcbo
import repro_torch.core.policy as tcpol
import repro_torch.policy as tpol
import repro_torch.policy.reference as tref
from repro.core.netsim import mbps, png_size_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(os.path.dirname(__file__), "data")
for _p in (ROOT, os.path.dirname(__file__)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from _replay_fixture import FIXTURE_NETS, make_synthetic_trace  # noqa: E402

SERVER_TIME = 0.037  # benchmarks/approaches.py's Table III constants
FAST_TIME = 0.020
COMPRESS_TIME = 0.080


@pytest.fixture(scope="module")
def trace():
    return make_synthetic_trace()


@pytest.fixture(scope="module")
def fixture_rows():
    with open(os.path.join(DATA, "replay_fixture.json")) as f:
        return json.load(f)


def _net(kw):
    net = dict(latency=0.1, frame_rate=30.0, deadline=0.2)
    net.update(kw)
    return net


def _pop_acc(tr):
    return tuple(float((tr.slow_pred_by_res[r] == tr.labels).mean()) for r in sorted(tr.slow_pred_by_res))


def _approach(name, tr, net):
    """(policy name, policy kwargs, replay kwargs) of ``benchmarks/approaches.py``'s
    approach ``name`` (``Threshold`` added: the sixth registered policy)."""
    gamma = 1.0 / net["frame_rate"]
    fp_acc = float((tr.fast_fp_pred == tr.labels).mean())
    return {
        "Local": ("local", {}, dict(local_pred=tr.fast_pred)),
        "Server": ("server", dict(frame_interval=gamma), dict(local_pred=None)),
        "FastVA": ("greedy-rate", dict(local_acc=tr.local_acc_mean),
                   dict(acc_server=_pop_acc(tr), local_pred=tr.fast_pred, local_time=FAST_TIME)),
        "Compress": ("greedy-rate", dict(local_acc=fp_acc),
                     dict(acc_server=_pop_acc(tr), local_pred=tr.fast_fp_pred, local_time=COMPRESS_TIME)),
        "CBO-w/o": ("cbo", dict(max_backlog=None), dict(conf=tr.conf_raw, local_pred=tr.fast_pred)),
        "CBO": ("cbo", dict(max_backlog=None), dict(conf=tr.conf_cal, local_pred=tr.fast_pred)),
        "Optimal": ("optimal", {}, dict(conf=tr.conf_cal, local_pred=tr.fast_pred, window=60)),
        "Threshold": ("threshold", dict(theta=0.6), dict(local_pred=tr.fast_pred, replan_every=2)),
    }[name]


def _replay(pkg, name, tr, net):
    policy, pkw, rkw = _approach(name, tr, net)
    rkw = dict(rkw)
    env = pkg.Env(bandwidth=mbps(net["bandwidth_mbps"]), latency=net["latency"], server_time=SERVER_TIME,
                  deadline=net["deadline"], acc_server=rkw.pop("acc_server", tr.plan_acc_by_res))
    res = sorted(tr.slow_pred_by_res)
    return pkg.replay_trace(pkg.make_policy(policy, **pkw), conf=rkw.pop("conf", tr.conf_cal),
                            slow_pred=np.stack([tr.slow_pred_by_res[r] for r in res]),
                            sizes=[tr.sizes[r] for r in res], env=env,
                            frame_interval=1.0 / net["frame_rate"], **rkw)


APPROACHES = ["Local", "Server", "FastVA", "Compress", "CBO-w/o", "CBO", "Optimal", "Threshold"]


@pytest.mark.parametrize("net_idx", range(len(FIXTURE_NETS)))
@pytest.mark.parametrize("name", APPROACHES)
def test_replay_trace_bit_equal_to_reference(trace, fixture_rows, name, net_idx):
    net = _net(FIXTURE_NETS[net_idx])
    got, ref = _replay(tpol, name, trace, net), _replay(jpol, name, trace, net)
    assert isinstance(got, tpol.ReplayResult)
    np.testing.assert_array_equal(got.results, ref.results)
    np.testing.assert_array_equal(got.offloaded, ref.offloaded)
    assert got.results.dtype == ref.results.dtype and got.offloaded.dtype == ref.offloaded.dtype
    assert got.n_late == ref.n_late and got.n_offloaded == ref.n_offloaded
    acc = got.accuracy(trace.labels)
    assert acc == ref.accuracy(trace.labels)
    row = fixture_rows[net_idx]
    assert row["net"] == FIXTURE_NETS[net_idx]
    if name in row:
        assert acc == pytest.approx(row[name], abs=1e-12)


@pytest.mark.parametrize("name", tpol.available_policies())
def test_registered_policies_declare_transmit_late_as_reference(name):
    assert tpol.available_policies() == jpol.available_policies()
    got = getattr(tpol.make_policy(name), "transmit_late", False)
    assert got == getattr(jpol.make_policy(name), "transmit_late", False)


def test_replay_transmit_late_override_and_unobserved_plan():
    n = 40
    # frames come twice as fast as the uplink drains them: the queue grows
    # and transmissions land late, more of them when late ones still go out
    env_kw = dict(bandwidth=1e6, latency=0.05, server_time=0.037, deadline=0.2, acc_server=(0.9,))
    kw = dict(conf=np.full(n, 0.3), slow_pred=np.ones((1, n), dtype=np.int64), sizes=[25_000.0],
              frame_interval=1 / 60, local_pred=np.zeros(n, dtype=np.int64))
    for late in (None, False, True):
        got = tpol.replay_trace("server", env=tpol.Env(**env_kw), transmit_late=late, **kw)
        ref = jpol.replay_trace("server", env=jpol.Env(**env_kw), transmit_late=late, **kw)
        np.testing.assert_array_equal(got.results, ref.results)
        assert got.n_late == ref.n_late > 0
    pol = tpol.make_policy("cbo")
    pol.observe([tpol.Frame(0.0, 0.1, (1.0,))])  # a frame with no trace id
    with pytest.raises(ValueError, match="never observed"):
        tpol.replay_trace(pol, env=tpol.Env(**env_kw), **kw)


def _instance(rng, n=None, m=None):
    """One random planning instance: a function making its (frames, env) in either package."""
    n = n or int(rng.integers(1, 10))
    m = m or int(rng.integers(1, 5))
    conf = rng.uniform(0.2, 0.99, n)
    if n > 3:
        conf[2] = conf[0]  # a confidence tie
    sizes = [tuple(sorted(rng.uniform(1e3, 2e5, size=m))) for _ in range(n)]
    env = dict(bandwidth=float(rng.uniform(1e5, 5e6)), latency=0.05, server_time=0.037,
               deadline=float(rng.choice([0.15, 0.2, 0.3, 0.5])),
               acc_server=tuple(sorted(rng.uniform(0.5, 0.99, size=m))))
    return lambda pkg: ([pkg.Frame(arrival=i / 30, conf=float(conf[i]), sizes=sizes[i]) for i in range(n)],
                        pkg.Env(**env))


def _plan_tuple(p):
    return (p.theta, p.resolution, list(p.offloads), p.total_gain, p.base_acc, p.n_frames)


@pytest.mark.parametrize("seed", range(6))
def test_reference_planners_bit_equal(seed):
    rng = np.random.default_rng(seed)
    for trial in range(40):
        make = _instance(rng)
        (ft, et), (fj, ej) = make(tpol), make(jpol)
        now = float(rng.uniform(0, 0.3)) if trial % 2 else 0.0
        a, b = tref.cbo_plan_reference(ft, et, now=now), jref.cbo_plan_reference(fj, ej, now=now)
        assert _plan_tuple(a) == _plan_tuple(b), trial
        # the port's vectorized planner against the port's oracle
        assert _plan_tuple(tpol.cbo_plan(ft, et, now=now)) == _plan_tuple(a), trial
        c, d = tref.optimal_schedule_reference(ft, et), jref.optimal_schedule_reference(fj, ej)
        assert _plan_tuple(c) == _plan_tuple(d), trial
        assert _plan_tuple(tcbo.optimal_schedule(ft, et)) == _plan_tuple(c), trial


@pytest.mark.parametrize("seed", range(4))
def test_brute_force_oracle_bit_equal(seed):
    rng = np.random.default_rng(100 + seed)
    for trial in range(15):
        make = _instance(rng, n=int(rng.integers(1, 6)), m=int(rng.integers(1, 3)))
        (ft, et), (fj, ej) = make(tpol), make(jpol)
        bt = tcbo.brute_force(ft, et)
        assert bt == jcbo.brute_force(fj, ej), trial
        opt = tcbo.optimal_schedule(ft, et)
        assert opt.base_acc + opt.total_gain == pytest.approx(bt, abs=1e-9), trial


def test_cbo_facade_reexports():
    assert tcbo.cbo_plan is tpol.cbo_plan and tcbo.optimal_schedule is tpol.optimal_schedule
    assert set(tcbo.__all__) == set(jcbo.__all__)


@pytest.mark.parametrize("max_backlog", [4, 64])
def test_adaptive_controller_plans_bit_equal(max_backlog):
    def make(pkg_cbo, pkg_pol):
        return pkg_cbo.AdaptiveController(
            resolutions=(45, 90, 134, 179, 224), acc_server=(0.55, 0.7, 0.8, 0.86, 0.9),
            deadline=0.2, latency=0.05, server_time=0.037, size_of=png_size_model,
            bw=pkg_cbo.BandwidthEstimator(estimate_bps=mbps(5.0)), max_backlog=max_backlog,
            backlog=[pkg_pol.Frame(0.0, 0.4, tuple(png_size_model(np.array([45, 90, 134, 179, 224]))))])

    tc, jc = make(tcpol, tpol), make(jcpol, jpol)
    rng = np.random.default_rng(3)
    for i in range(60):
        t, c = i / 30, float(rng.uniform(0.2, 0.99))
        tc.add_frame(t, c)
        jc.add_frame(t, c)
        if i % 3 == 0:
            b = float(rng.uniform(1e3, 4e4))
            tc.bw.observe(b, 0.05)
            jc.bw.observe(b, 0.05)
        a, b = tc.plan(t), jc.plan(t)
        assert _plan_tuple(a) == _plan_tuple(b), i
        assert tc.env() == tpol.Env(**vars(jc.env())), i
        assert tc.consume(k for k, _ in a.offloads) == jc.consume(k for k, _ in b.offloads)
        assert [(f.arrival, f.conf) for f in tc.backlog] == [(f.arrival, f.conf) for f in jc.backlog]
    assert tc.max_backlog == jc.max_backlog == max_backlog
