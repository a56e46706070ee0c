"""The port's multi-stream slice against the JAX package's numpy engine.

Host-side pieces (``Uplink``'s per-transfer methods, ``ReplicaPool``,
``Placement``, ``EdgeFabric``, ``select_escalations``, ``FairScheduler``,
``FleetState`` and ``cbo_plan_many``) are numpy copies: on the same seeded
inputs they must agree bit for bit.  The port's ``MultiStreamServer`` with
the synthetic tiers must reproduce ``tests/data/multistream_snapshot.json``
and ``fabric_snapshot.json`` in every integer field (accuracies within
1e-12), also under degenerate batching; under live continuous batching it
must match the JAX numpy engine round for round (``_diff.assert_round_equal``:
integer fields exact, theta within 1e-6, bandwidth estimates within 1e-2
relative, latencies within ``LAT_ATOL``).

The whole slice at a small size: a SMOKE ResNet fast tier (int8 QDQ
weights) and a ``deit-smoke`` slow tier, converted from the same JAX
params, over a 2-cell, 2-replica fabric with live batching, S = 3 streams.
Per round the decisions are exact and the confidences within 1e-5
(float32 convolutions summed in another order); a decision could flip only
if a confidence sat within rounding of its stream's theta, so the test
first asserts none comes within 1e-4.  The slow tier's logits agree within
1e-4 and every escalated frame's top-1/top-2 margin exceeds that.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.netsim as jnet
import repro.net as jfab
import repro.policy as jpol
import repro.serving as jsrv
import repro.serving.engine as jeng
import repro.slowtier as jst
import repro_torch.core.netsim as tnet
import repro_torch.net as tfab
import repro_torch.policy as tpol
import repro_torch.serving as tsrv
import repro_torch.serving.engine as teng
import repro_torch.slowtier as tst
from _diff import assert_round_equal
from repro.configs.deit_b import SMOKE as JAX_DEIT_SMOKE
from repro.configs.resnet_50 import SMOKE as JAX_SMOKE
from repro.core.cascade import degrade_resolution as jax_degrade
from repro.models import api
from repro.models.resnet import resnet_forward
from repro.models.vit import vit_forward
from repro.quant.quantize import qdq_tree as jax_qdq_tree
from repro.serving.scheduler import sfq_tags as jax_sfq_tags
from repro.serving.synthetic import synthetic_streams as jax_synthetic_streams
from repro.serving.synthetic import synthetic_tiers as jax_synthetic_tiers
from repro_torch.configs.deit_b import SMOKE as DEIT_SMOKE
from repro_torch.configs.resnet_50 import SMOKE
from repro_torch.core.cascade import degrade_resolution
from repro_torch.data.video import VideoDataConfig, make_dataset
from repro_torch.models.convert import params_from_jax
from repro_torch.models.resnet import ResNet
from repro_torch.models.vit import ViT
from repro_torch.quant.quantize import qdq_tree
from repro_torch.serving.scheduler import sfq_tags
from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers

DATA = os.path.join(os.path.dirname(__file__), "data")
CONF_ATOL = 1e-5
LOGIT_ATOL = 1e-4
THETA_MARGIN = 1e-4
LIVE = (0.03125, 0.0078125)  # LinearBatch(base, per_item), float32-exact, as test_slowtier.py


# ------------------------------ uplink ------------------------------------ #


@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_uplink_transfers_and_counters_bit_equal(jitter):
    rng = np.random.default_rng(1)
    kw = dict(bandwidth_bps=jnet.mbps(3.0), latency=0.05, server_time=0.037, jitter=jitter, seed=4)
    ju, tu = jnet.Uplink(**kw), tnet.Uplink(**kw)
    for _ in range(4):
        payloads, subs = rng.uniform(100, 50_000, 25), np.sort(rng.uniform(0, 3, 25))
        assert np.array_equal(tu.upload_batch(payloads, subs), ju.upload_batch(payloads, subs))
        assert np.array_equal(tu.last_starts, ju.last_starts)
        p, t = float(rng.uniform(1e3, 1e4)), float(rng.uniform(0, 4))
        assert tu.would_land_at(p, t) == ju.would_land_at(p, t)
        assert tu.transmit(p, t) == ju.transmit(p, t)
        assert np.array_equal(tu.transmit_batch(payloads[:5], subs[:5] + 3),
                              ju.transmit_batch(payloads[:5], subs[:5] + 3))
    for f in ("_busy_until", "n_transfers", "busy_seconds", "queued_seconds"):
        assert getattr(tu, f) == getattr(ju, f), f
    assert tu.utilization(10.0) == ju.utilization(10.0)
    tu.reset()
    assert (tu._busy_until, tu.n_transfers, tu.busy_seconds, tu.queued_seconds) == (0.0, 0, 0.0, 0.0)


def test_uplink_unported_modes_raise():
    with pytest.raises(ValueError, match="jitter_mode"):
        tnet.Uplink(1e6, 0.05, 0.037, jitter=0.1, jitter_mode="philox")
    # counter-mode jitter is ported (core/threefry.py): the reference's factors
    up = tnet.Uplink(1e6, 0.05, 0.037, jitter=0.1, jitter_mode="counter")
    ref = jnet.Uplink(1e6, 0.05, 0.037, jitter=0.1, jitter_mode="counter")
    assert up.bandwidth_at(np.array([0.5, 7.0])).tolist() == ref.bandwidth_at(np.array([0.5, 7.0])).tolist()
    # bandwidth traces are ported: a trace-driven uplink constructs and runs
    up = tnet.Uplink(1e6, 0.05, 0.037, trace=tfab.regime_shift_trace())
    assert up.bandwidth_at(np.array([0.0, 10.0])).tolist() == [2.5e6, 2.5e5]


# ------------------------------ replica pool ------------------------------ #


def _pools(n, st, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if "batching" in kw:
        jkw["batching"] = kw["batching"](jst)
        tkw["batching"] = kw["batching"](tst)
    return jfab.ReplicaPool(n, st, **jkw), tfab.ReplicaPool(n, st, **tkw)


POOLS = {
    "serial": lambda: _pools(3, np.array([0.02, 0.03, 0.025])),
    "infinite": lambda: _pools(2, 0.037, serial=False),
    "degenerate-batching": lambda: _pools(
        3, np.array([0.02, 0.03, 0.025]),
        batching=lambda m: m.ContinuousBatching(m.FlatService(0.02), window_s=0.0, max_batch=1)),
    "live-batching": lambda: _pools(
        2, 0.02, batching=lambda m: m.ContinuousBatching(m.LinearBatch(0.015, 0.004), window_s=0.01)),
    "step-batching": lambda: _pools(
        2, 0.02, batch_beta=0.5,
        batching=lambda m: m.ContinuousBatching(m.StepBatch(0.01, 0.008, page_size=4, max_pages=2),
                                                window_s=0.05, max_batch=6)),
}


@pytest.mark.parametrize("kind", list(POOLS))
def test_replica_pool_bit_equal_to_reference(kind):
    jp, tp = POOLS[kind]()
    rng = np.random.default_rng(3)
    t = 0.0
    for _ in range(8):
        n = int(rng.integers(0, 30))
        arr = np.sort(t + rng.uniform(0.0, 0.3, size=n))
        rep = rng.integers(0, jp.n_replicas, size=n)
        assert np.array_equal(tp.process(arr, rep), jp.process(arr, rep))
        for f in ("last_service", "last_batch_id", "busy_until", "n_jobs", "busy_seconds",
                  "queued_seconds"):
            assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
        assert tp.avg_batch == jp.avg_batch
        assert tp.expected_server_time() == jp.expected_server_time()
        assert tp.queue_depth(t) == jp.queue_depth(t)
        t += 0.3
    assert np.array_equal(tp.utilization(t), jp.utilization(t))
    if kind == "live-batching":
        assert tp.avg_batch > 1.0  # batches really formed
    tp.reset()
    assert tp.avg_batch == 1.0 and not tp.busy_until.any()


def test_replica_pool_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        tfab.ReplicaPool(0, 0.1)
    with pytest.raises(ValueError):
        tfab.ReplicaPool(1, 0.02, serial=False,
                         batching=tst.ContinuousBatching(tst.FlatService(0.02)))
    live = tfab.ReplicaPool(1, 0.02, batching=tst.ContinuousBatching(tst.LinearBatch(0.01, 0.001)))
    with pytest.raises(ValueError, match="service_scale"):
        live.process(np.zeros(2), np.zeros(2, dtype=np.int64), service_scale=np.array([1.0, 0.5]))


# ------------------------------ placement --------------------------------- #


@pytest.mark.parametrize("policy", tfab.PLACEMENT_POLICIES)
def test_placement_bit_equal_to_reference(policy):
    rng = np.random.default_rng(2)
    jpl, tpl = jfab.Placement(policy), tfab.Placement(policy)
    for _ in range(15):
        K = int(rng.integers(1, 6))
        st = rng.uniform(0.01, 0.2, K)
        jp, tp = jfab.ReplicaPool(K, st), tfab.ReplicaPool(K, st)
        busy = rng.uniform(0, 0.5, K)
        jp.busy_until[:] = busy
        tp.busy_until[:] = busy
        arrive = rng.uniform(0, 2, int(rng.integers(0, 30)))
        got = tpl.assign(tp, arrive)
        assert np.array_equal(got, jpl.assign(jp, arrive))
        assert np.array_equal(tfab.assign_looped(policy, tp, arrive),
                              jfab.assign_looped(policy, jp, arrive))
        assert tpl._next == jpl._next  # the round-robin cursor carries across rounds


# ------------------------------ fabric ------------------------------------ #


def _fabrics(jitter, batching=None):
    def build(net, fab, slow):
        ups = [net.Uplink(bandwidth_bps=net.mbps(4.0), latency=0.05, server_time=0.037,
                          jitter=jitter, seed=c) for c in range(3)]
        b = None if batching is None else batching(slow)
        pool = fab.ReplicaPool(2, np.array([0.037, 0.05]), batching=b)
        return fab.EdgeFabric(ups, pool, cell_of=np.array([0, 0, 1, 2, 2, 2, 1]), placement="jsq")
    return build(jnet, jfab, jst), build(tnet, tfab, tst)


@pytest.mark.parametrize("jitter", [0.0, 0.25])
@pytest.mark.parametrize("batched", [False, True])
def test_edge_fabric_transmit_bit_equal(jitter, batched):
    batching = (lambda m: m.ContinuousBatching(m.LinearBatch(*LIVE), window_s=LIVE[0])) if batched else None
    jf, tf = _fabrics(jitter, batching)
    assert np.array_equal(tf.stream_bandwidth(), jf.stream_bandwidth())
    rng = np.random.default_rng(9)
    t = 0.0
    for _ in range(6):
        n = int(rng.integers(0, 25))
        stream = rng.integers(0, 7, n)
        payload = rng.uniform(500, 30_000, n)
        subs = t + np.sort(rng.uniform(0, 0.5, n))
        assert np.array_equal(tf.transmit(stream, payload, subs), jf.transmit(stream, payload, subs))
        assert np.array_equal(tf.last_service_time, jf.last_service_time)
        assert np.array_equal(tf.true_bandwidth(t), jf.true_bandwidth(t))
        assert tf.expected_server_time() == jf.expected_server_time()
        t += 0.5
    assert tf.summary() == jf.summary()
    assert tf.n_transfers == jf.n_transfers and tf.occupancy == jf.occupancy
    tf.reset()
    assert tf.n_transfers == 0 and tf.occupancy == 1.0


def test_degenerate_fabric_equals_transmit_batch():
    rng = np.random.default_rng(6)
    legacy = tnet.Uplink(bandwidth_bps=tnet.mbps(2.0), latency=0.05, server_time=0.037)
    mirror = tnet.Uplink(bandwidth_bps=tnet.mbps(2.0), latency=0.05, server_time=0.037)
    fab = tfab.EdgeFabric.degenerate(mirror, n_streams=8)
    payloads, subs = rng.uniform(100, 50_000, 60), np.sort(rng.uniform(0, 5, 60))
    assert np.array_equal(legacy.transmit_batch(payloads, subs),
                          fab.transmit(rng.integers(0, 8, 60), payloads, subs))
    built = tfab.EdgeFabric.build(n_streams=4, n_cells=2, n_replicas=3, bandwidth_bps=1e5)
    assert built.n_cells == 2 and built.n_replicas == 3 and list(built.cell_of) == [0, 1, 0, 1]
    with pytest.raises(ValueError):
        tfab.EdgeFabric([], fab.pool, n_streams=2)


# ------------------------------ gate and scheduler ------------------------ #


def test_select_escalations_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(30):
        S, B = int(rng.integers(1, 7)), int(rng.integers(1, 20))
        conf = rng.choice([0.2, 0.4, 0.6, np.inf], size=(S, B)) if rng.random() < 0.5 \
            else rng.uniform(size=(S, B))
        theta, cap = rng.uniform(0, 1, S), rng.integers(0, 6, S)
        for g, w in zip(tsrv.select_escalations(conf, theta, cap),
                        jsrv.select_escalations(conf, theta, cap)):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("policy,weighted", [("fifo", False), ("round_robin", False),
                                             ("round_robin", True)])
def test_fair_scheduler_order_bit_equal(policy, weighted):
    rng = np.random.default_rng(5)
    weights = rng.uniform(0.5, 3.0, 6) if weighted else None
    js, ts = jsrv.FairScheduler(policy, weights=weights), tsrv.FairScheduler(policy, weights=weights)
    for _ in range(30):
        n = int(rng.integers(0, 40))
        stream = rng.integers(0, 6, n)
        t_ready = np.round(rng.uniform(0, 0.5, n), 2)  # ties on purpose
        cost = rng.uniform(1e-3, 5e-2, n)
        assert np.array_equal(ts.order(stream, t_ready, cost), js.order(stream, t_ready, cost))
        assert np.array_equal(sfq_tags(stream, t_ready, cost), jax_sfq_tags(stream, t_ready, cost))
    with pytest.raises(ValueError):
        tsrv.FairScheduler("lifo")


def test_arrival_schedules_equal_reference():
    for kw in (dict(), dict(stagger=False)):
        a = tsrv.ArrivalSchedule.interleaved(4, 37, 30.0, 0.2, **kw)
        b = jsrv.ArrivalSchedule.interleaved(4, 37, 30.0, 0.2, **kw)
        assert np.array_equal(a.arrival, b.arrival) and a.horizon == b.horizon
    a = tsrv.ArrivalSchedule.churn(3, 40, 32.0, 0.2, join=[0, 5, 9], length=[40, 20, 31])
    b = jsrv.ArrivalSchedule.churn(3, 40, 32.0, 0.2, join=[0, 5, 9], length=[40, 20, 31])
    assert np.array_equal(a.arrival, b.arrival) and np.array_equal(a.valid, b.valid)
    assert [s for s, _, _ in a.rounds(16)] == [0, 16, 32]
    assert tsrv.jain_index([10, 0, 0, 0]) == jsrv.jain_index([10, 0, 0, 0]) == 0.25


# ------------------------------ fleet planner ----------------------------- #


def _runners(policy, S, rng, m=3):
    resolutions = tuple(4 * (i + 1) for i in range(m))
    acc = tuple(sorted(rng.uniform(0.5, 0.99, size=m)))
    deadline = float(rng.choice([0.15, 0.2, 0.3, 0.5]))
    kw = dict(resolutions=resolutions, acc_server=acc, deadline=deadline, latency=0.05,
              server_time=0.037, size_of=lambda r: jnet.png_size_model(r, base_res=16), bw_init=1.0)
    jr = jpol.FleetRunner([jpol.make_policy(policy) for _ in range(S)], **kw)
    tr = tpol.FleetRunner([tpol.make_policy(policy) for _ in range(S)], **kw)
    bw = rng.uniform(1e5, 5e6, size=S)
    n = rng.integers(0, 12, size=S)
    stream = np.repeat(np.arange(S), n)
    arrival = np.concatenate([np.arange(k) / 30.0 for k in n]) if n.sum() else np.zeros(0)
    conf = rng.choice([0.4, 0.6, 0.8], size=n.sum()) if rng.random() < 0.3 \
        else rng.uniform(0.2, 0.99, size=n.sum())
    for r in (jr, tr):
        r.bw_est[:] = bw
        r.observe_frames(stream, arrival, conf)
    return jr, tr


def _assert_batch_equal(got, want):
    for f in ("theta", "resolution", "n_offloads", "total_gain", "base_acc", "n_frames",
              "off_stream", "off_pos", "off_res", "planned", "off_kind", "off_cut"):
        g, w = getattr(got, f), getattr(want, f)
        assert np.array_equal(g, w), (f, g, w)


@pytest.mark.parametrize("policy", ["cbo", "threshold", "local", "server", "greedy-rate", "optimal"])
def test_fleet_plan_all_bit_equal(policy):
    """Every policy's batched plan over seeded ragged backlogs, then a
    consume and a bandwidth fold, as the reference's numpy fleet."""
    rng = np.random.default_rng(11)
    for _ in range(20):
        S = int(rng.integers(1, 9))
        jr, tr = _runners(policy, S, rng)
        now = np.full(S, float(rng.choice([0.0, 0.05, 0.2])))
        active = rng.random(S) < 0.85
        pj, pt = jr.plan_all(now, active), tr.plan_all(now, active)
        _assert_batch_equal(pt, pj)
        for s in range(S):
            assert vars(pt.plan(s)) == vars(pj.plan(s))
        assert jr.consume(pj) == tr.consume(pt)
        stream = rng.integers(0, S, 10)
        payload, secs = rng.uniform(1e3, 1e5, 10), rng.uniform(-0.01, 0.3, 10)
        jr.observe_bandwidth(stream, payload, secs)
        tr.observe_bandwidth(stream, payload, secs)
        for f in ("arrival", "conf", "stream_id", "offsets"):
            assert np.array_equal(getattr(tr.state, f), getattr(jr.state, f)), f
        assert np.array_equal(tr.bw_est, jr.bw_est)


def test_cbo_plan_many_bit_equal_on_tie_heavy_backlogs():
    rng = np.random.default_rng(12)
    for _ in range(40):
        S = int(rng.integers(1, 10))
        m = int(rng.integers(1, 3))
        sizes = np.asarray([float(rng.choice([1e4, 5e4])) for _ in range(m)])
        acc = tuple(float(rng.choice([0.8, 0.9])) for _ in range(m))
        kw = dict(n_streams=S, max_backlog=64)
        js, ts = jpol.FleetState(**kw), tpol.FleetState(**kw)
        n = rng.integers(2, 12, size=S)
        stream = np.repeat(np.arange(S), n)
        arrival = np.concatenate([(np.arange(k) // 2) / 30.0 for k in n])
        conf = rng.choice([0.4, 0.6], size=n.sum())
        for st in (js, ts):
            st.extend(stream, arrival, conf)
        env = dict(bandwidth=np.full(S, 1e6), latency=0.05, server_time=0.037, deadline=0.3,
                   acc_server=acc, sizes=sizes)
        now = np.zeros(S)
        _assert_batch_equal(tpol.cbo_plan_many(ts, tpol.EnvBatch(**env), now),
                            jpol.cbo_plan_many(js, jpol.EnvBatch(**env), now))


def test_fleet_runner_refuses_the_compiled_backend():
    with pytest.raises(NotImplementedError, match="A.9"):
        tpol.FleetRunner([tpol.make_policy("cbo")], resolutions=(4,), acc_server=(0.9,),
                         deadline=0.2, latency=0.05, server_time=0.037, size_of=lambda r: 1e3,
                         backend="jax")


# ------------------------------ the engine: synthetic tiers --------------- #


def _cfg(mod, frame_rate=30.0):
    return mod.ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), batch_size=16,
                           frame_rate=frame_rate, deadline=0.2)


def test_synthetic_workload_and_degraded_frames_equal_reference():
    """The synthetic slow tier reads pixel (0, 0) after the 8 -> 4 px
    degrade; the port's antialiased resize must give the same argmax."""
    imgs, labels = synthetic_streams(3, 20, seed=1)
    jimgs, jlabels = jax_synthetic_streams(3, 20, seed=1)
    assert np.array_equal(imgs, jimgs) and np.array_equal(labels, jlabels)
    flat = imgs.reshape(60, 8, 8, 4)
    for res in (4, 8):
        got = degrade_resolution(torch.as_tensor(flat), res).numpy()
        want = np.asarray(jax_degrade(jnp.asarray(flat), res))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        slow, jslow = synthetic_tiers()[1], jax_synthetic_tiers()[1]
        assert np.array_equal(slow(torch.as_tensor(got)).argmax(-1).numpy(),
                              np.asarray(jslow(jnp.asarray(want))).argmax(-1))


def test_multistream_reproduces_multistream_snapshot():
    with open(os.path.join(DATA, "multistream_snapshot.json")) as f:
        snap = json.load(f)
    fast, slow, cal = synthetic_tiers()
    cfg = _cfg(teng)
    imgs, labels = synthetic_streams(4, 64)
    up = tnet.Uplink(bandwidth_bps=tnet.mbps(50.0), latency=0.05, server_time=cfg.server_time)
    agg = tsrv.MultiStreamServer(cfg, fast, slow, cal, up, n_streams=4,
                                 device="cpu").process_streams(imgs, labels)
    for m, ref in zip(agg.per_stream, snap["per_stream"]):
        assert m.n_frames == ref["n_frames"]
        assert m.accuracy == pytest.approx(ref["accuracy"], abs=1e-12)
        assert m.offload_frac == pytest.approx(ref["offload_frac"], abs=1e-12)
        assert m.deadline_miss_frac == pytest.approx(ref["deadline_miss_frac"], abs=1e-12)
    assert agg.n_offloaded == snap["n_offloaded"]
    assert agg.accuracy == pytest.approx(snap["accuracy"], abs=1e-12)
    assert up.n_transfers == agg.n_offloaded + agg.n_deadline_miss


def _fabric_server(mod, net, fab, slow_mod, S, *, batching=None, device=None):
    """``_diff.make_server``'s "fabric" topology (2 cells at 30 Mbps, 2
    serial replicas at T and 1.5 T, jsq) in module set ``mod``."""
    fast, slow, cal = (synthetic_tiers if mod is teng else jax_synthetic_tiers)()
    cfg = _cfg(mod, frame_rate=32.0)
    ups = [net.Uplink(bandwidth_bps=net.mbps(30.0), latency=0.05,
                      server_time=cfg.server_time, seed=c) for c in range(2)]
    b = None if batching is None else batching(slow_mod)
    pool = fab.ReplicaPool(2, np.array([cfg.server_time, cfg.server_time * 1.5]),
                           serial=True, batching=b)
    kw = dict(device=device) if mod is teng else {}
    return mod.MultiStreamServer(cfg, fast, slow, cal, None, n_streams=S,
                                 scheduler=mod.FairScheduler("round_robin"),
                                 fabric=fab.EdgeFabric(ups, pool, n_streams=S, placement="jsq"),
                                 policy="cbo", **kw)


@pytest.mark.parametrize("case,batching", [
    ("degenerate", None), ("fabric", None),
    ("fabric", lambda m: m.ContinuousBatching(m.FlatService(0.037), window_s=0.0, max_batch=1)),
], ids=["degenerate", "fabric", "fabric-degenerate-batching"])
def test_multistream_reproduces_fabric_snapshot(case, batching):
    with open(os.path.join(DATA, "fabric_snapshot.json")) as f:
        snap = json.load(f)[case]
    if case == "degenerate":
        S = 4
        fast, slow, cal = synthetic_tiers()
        cfg = _cfg(teng, frame_rate=32.0)
        srv = tsrv.MultiStreamServer(
            cfg, fast, slow, cal,
            tnet.Uplink(bandwidth_bps=tnet.mbps(50.0), latency=0.05, server_time=cfg.server_time),
            n_streams=S, device="cpu")
    else:
        S = 12
        srv = _fabric_server(teng, tnet, tfab, tst, S, batching=batching, device="cpu")
    imgs, labels = synthetic_streams(S, 64)
    agg = srv.process_streams(imgs, labels)
    assert int(agg.n_offloaded) == snap["n_offloaded"]
    assert int(agg.n_deadline_miss) == snap["n_deadline_miss"]
    assert agg.accuracy == pytest.approx(snap["accuracy"], abs=1e-12)
    for m, ref in zip(agg.per_stream, snap["per_stream"]):
        assert m.n_frames == ref["n_frames"]
        assert m.accuracy == pytest.approx(ref["accuracy"], abs=1e-12)
        assert m.offload_frac == pytest.approx(ref["offload_frac"], abs=1e-12)
        assert m.deadline_miss_frac == pytest.approx(ref["deadline_miss_frac"], abs=1e-12)


def _rounds(srv, imgs, labels, schedule=None):
    recs = []
    srv.round_hook = recs.append
    return srv.process_streams(imgs, labels, schedule=schedule), recs


@pytest.mark.parametrize("churn", [False, True])
def test_live_batching_matches_numpy_engine_round_for_round(churn):
    """test_slowtier.py::test_live_batching_differential_numpy_vs_jax's
    workload, the port against the reference's numpy engine."""
    S = 12
    batching = lambda m: m.ContinuousBatching(m.LinearBatch(*LIVE), window_s=LIVE[0])  # noqa: E731
    imgs, labels = synthetic_streams(S, 64, seed=0)
    sched = {}
    if churn:
        rng = np.random.default_rng(1)
        join = rng.integers(0, 32, size=S)
        length = rng.integers(1, 64 - join + 1)
        sched = {m: m.ArrivalSchedule.churn(S, 64, 32.0, 0.2, join=join, length=length)
                 for m in (jsrv, tsrv)}
    jm, jrecs = _rounds(_fabric_server(jeng, jnet, jfab, jst, S, batching=batching),
                        imgs, labels, sched.get(jsrv))
    tsrv_ = _fabric_server(teng, tnet, tfab, tst, S, batching=batching, device="cpu")
    tm, trecs = _rounds(tsrv_, imgs, labels, sched.get(tsrv))
    assert len(trecs) == len(jrecs) == 4
    for i, (a, b) in enumerate(zip(jrecs, trecs)):
        assert set(a) == set(b)
        assert_round_equal(a, b, ctx=f"round {i}")
        np.testing.assert_array_equal(b["theta"], a["theta"])  # both float64 numpy: exact
    assert tm.summary() == jm.summary()
    assert tm.n_offloaded > 0
    assert tsrv_.fabric.pool.avg_batch > 1.0  # real batches formed


def test_multistream_refuses_what_is_not_ported():
    fast, slow, cal = synthetic_tiers()
    cfg = _cfg(teng)
    up = tnet.Uplink(bandwidth_bps=tnet.mbps(50.0), latency=0.05, server_time=cfg.server_time)
    with pytest.raises(NotImplementedError, match="A.9"):
        tsrv.MultiStreamServer(cfg, fast, slow, cal, up, n_streams=2, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tsrv.MultiStreamServer(cfg, fast, slow, cal, up, n_streams=2, backend="tpu", device="cpu")
    # the round engine is ported: backend="torch" constructs on the CPU
    assert tsrv.MultiStreamServer(cfg, fast, slow, cal, up, n_streams=2, backend="torch",
                                  device="cpu").backend == "torch"
    with pytest.raises(ValueError):
        tsrv.MultiStreamServer(cfg, fast, slow, cal, None, n_streams=2, device="cpu")
    with pytest.raises(ValueError):
        tsrv.MultiStreamServer(cfg, fast, slow, cal, up, n_streams=4, device="cpu",
                               fabric=tfab.EdgeFabric.degenerate(up, n_streams=2))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tsrv.MultiStreamServer(cfg, fast, slow, cal, up, n_streams=2)


# ------------------------------ the whole slice --------------------------- #


def _recording_fast(fn, log, unpack):
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        log.append(np.asarray(unpack(out[1])))
        return out
    return wrapped


def _logging(fn, log):
    def wrapped(x):
        out = fn(x)
        log.append(np.asarray(out))
        return out
    return wrapped


@pytest.fixture(scope="module")
def smoke_params():
    fast = jax_qdq_tree(api.build(JAX_SMOKE).init(jax.random.PRNGKey(0), dtype=jnp.float32))
    slow = api.build(JAX_DEIT_SMOKE).init(jax.random.PRNGKey(1), dtype=jnp.float32)
    return fast, slow


def test_whole_slice_resnet_deit_smoke_matches_reference(smoke_params, monkeypatch):
    fast_p, slow_p = smoke_params
    S, N = 3, 40  # rounds of 16, 16 and 8 frames per stream
    data = make_dataset(VideoDataConfig(n_classes=10, img_res=32, frames_per_video=12,
                                        noise_floor=0.3), 10, seed=2)
    frames = data["frames"][:S * N].reshape(S, N, 32, 32, 3)
    labels = data["labels"][:S * N].reshape(S, N)
    batching = lambda m: m.ContinuousBatching(m.LinearBatch(*LIVE), window_s=LIVE[0])  # noqa: E731
    common = dict(resolutions=(8, 12, 18, 24, 32), acc_server=(0.5, 0.62, 0.74, 0.82, 0.88),
                  batch_size=16, frame_rate=32.0, use_fused=True, platt_ab=(-20.0, 5.0))

    def server(mod, net, fab, slow_mod, fast_fn, slow_fn, **kw):
        cfg = mod.ServeConfig(size_of=functools.partial(net.png_size_model, base_res=32), **common)
        ups = [net.Uplink(bandwidth_bps=net.mbps(1.5), latency=0.05,
                          server_time=cfg.server_time, seed=c) for c in range(2)]
        pool = fab.ReplicaPool(2, np.array([cfg.server_time, cfg.server_time * 1.5]),
                               batching=batching(slow_mod))
        return mod.MultiStreamServer(cfg, fast_fn, slow_fn, None, None, n_streams=S,
                                     fabric=fab.EdgeFabric(ups, pool, n_streams=S, placement="jsq"),
                                     **kw)

    jconf, tconf, jslow, tslow = [], [], [], []
    monkeypatch.setattr(jeng, "_fast_pass", _recording_fast(jeng._fast_pass, jconf, np.asarray))
    monkeypatch.setattr(teng, "fast_pass", _recording_fast(teng.fast_pass, tconf, lambda c: c.numpy()))
    jserver = server(jeng, jnet, jfab, jst,
                     lambda x: resnet_forward(fast_p, x, JAX_SMOKE),
                     _logging(lambda x: vit_forward(slow_p, x, JAX_DEIT_SMOKE), jslow))
    fast_m = ResNet(SMOKE, device="cpu")
    fast_m.load_state_dict(qdq_tree(params_from_jax(jax.tree.map(np.asarray, fast_p))))
    slow_m = ViT(DEIT_SMOKE, device="cpu")
    slow_m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, slow_p)))
    tserver = server(teng, tnet, tfab, tst, fast_m, _logging(slow_m, tslow), device="cpu")

    jm, jrecs = _rounds(jserver, frames, labels)
    tm, trecs = _rounds(tserver, frames, labels)
    assert len(jrecs) == len(trecs) == len(jconf) == len(tconf) == 3
    n_escalated = 0
    for i, (a, b, jc, tc) in enumerate(zip(jrecs, trecs, jconf, tconf)):
        jc, tc = jc.reshape(S, -1), tc.reshape(S, -1)
        planned = a["n_off"] > 0
        assert (np.abs(jc - a["theta"][:, None])[planned] > THETA_MARGIN).all(), \
            "a confidence sits on its stream's threshold"
        np.testing.assert_allclose(tc, jc, atol=CONF_ATOL, rtol=0)
        assert_round_equal(a, b, ctx=f"round {i}", theta_atol=CONF_ATOL)
        n_escalated += int(a["esc"].sum())
    assert n_escalated > 0 and len(jslow) == len(tslow) > 0  # one slow-tier call a round with escalations
    for jl, tl in zip(jslow, tslow):
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > LOGIT_ATOL).all(), "an escalated frame's top-2 logits tie"
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    for f in ("n_frames", "n_offloaded", "n_deadline_miss"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.n_frames == S * N
    assert tm.summary() == jm.summary()
