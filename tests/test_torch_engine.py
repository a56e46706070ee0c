"""The port's round engine, ``MultiStreamServer(backend="torch",
device="cpu")``, against the port's numpy engine and the reference's
``MultiStreamServer(backend="jax")``.

Every case replays one seeded workload on the ``frame_rate=32`` grid
(arrival times exact in float32, so the prune and deadline compares are
tie-free) through the port's numpy and torch backends with a
``round_hook`` attached, and holds each round with ``_diff``'s
``assert_round_equal``: ``EXACT_KEYS`` bit-equal, theta within
``THETA_ATOL``, bandwidth estimates within ``BW_RTOL`` relative, latencies
within ``LAT_ATOL``, and no frontier ``overflow``/``inexact`` flag.  A few
cases also run the reference's ``backend="jax"`` on the same workload and
hold the torch rounds to its rounds the same way (its own tests tie its
numpy and jax engines).  The cases mirror ``test_fleet_jax.py``'s round
loop, ``test_slowtier.py``'s live batching, ``test_split.py``'s split
actions and ``test_obs.py``'s recorder; both ``fabric_snapshot.json``
topologies are pinned; and ``simulate`` on synthetic rounds is held to
``engine_jax.simulate`` at S = 64 (integer outputs equal, the floats that
are not sums of a reduction bit-equal).
"""
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.net.traces as jtr
import repro_torch.core.netsim as tnet
import repro_torch.net as tfab
import repro_torch.net.traces as ttr
import repro_torch.obs as tobs
import repro_torch.policy.fleet_torch as ft
import repro_torch.serving as tsrv
import repro_torch.serving.engine_torch as et
import repro_torch.slowtier as tst
from _diff import (BW_RTOL, LAT_ATOL, assert_fleet_equal, assert_round_equal,
                   canonical_actions as jax_canonical_actions, make_server as jax_make_server)
from repro.serving.events import ArrivalSchedule as JaxSchedule
from repro.serving.synthetic import synthetic_streams as jax_synthetic_streams
from repro_torch.policy.types import ActionTable
from repro_torch.serving.events import ArrivalSchedule
from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers

DATA = os.path.join(os.path.dirname(__file__), "data")
LIVE = (0.03125, 0.0078125)  # LinearBatch(base, per_item), float32-exact, as test_slowtier.py


# ------------------------------ port-side servers --------------------------- #


def canonical_actions():
    """``_diff.canonical_actions`` on the port's types: two synthetic cuts
    over the (4, 8) frame grid, every quantity exact in float32."""
    frame_sizes = tnet.payload_sizes(tnet.png_size_model, np.asarray((4, 8)))
    base = ActionTable.frames_only(sizes=frame_sizes, acc=np.asarray((0.7, 0.99)))
    sizes = np.asarray([np.floor(frame_sizes[1] * 0.75), np.floor(frame_sizes[0] * 1.25)])
    return ActionTable(
        kind=np.r_[base.kind, np.ones(2, dtype=np.int8)],
        res=np.r_[base.res, np.full(2, 1, dtype=np.int64)],
        cut=np.r_[base.cut, np.arange(2, dtype=np.int64)],
        sizes=np.r_[base.sizes, sizes],
        acc=np.r_[base.acc, np.asarray([0.984375, 0.99])],
        t_dev=np.r_[base.t_dev, np.asarray([2.0 ** -10, 2.0 ** -8])],
        srv_frac=np.r_[base.srv_frac, np.asarray([0.5, 0.25])],
        names=base.names + ("feat@cut0", "feat@cut1"))


def make_server(backend, *, S, policy="cbo", scheduler="round_robin", topology="degenerate",
                placement="jsq", frame_rate=32.0, bw_mbps=50.0, seed=0, jitter=0.0,
                jitter_mode="counter", traces=None, actions=None, telemetry=None, batching=None):
    """``_diff.make_server`` on the port (``device="cpu"``): the degenerate
    1-cell fabric, or 2 cells x 2 serial replicas (T, 1.5 T); ``batching``
    makes the replicas batch continuously."""
    fast, slow, cal = synthetic_tiers()
    cfg = tsrv.ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), batch_size=16,
                           frame_rate=frame_rate, deadline=0.2, actions=actions)

    def trace_of(c):
        return traces[c % len(traces)] if traces else None

    if topology == "degenerate":
        fab = tfab.EdgeFabric.degenerate(
            tnet.Uplink(bandwidth_bps=tnet.mbps(bw_mbps), latency=0.05, server_time=cfg.server_time,
                        jitter=jitter, seed=seed, jitter_mode=jitter_mode, trace=trace_of(0)),
            n_streams=S)
    else:
        ups = [tnet.Uplink(bandwidth_bps=tnet.mbps(bw_mbps * 0.6), latency=0.05,
                           server_time=cfg.server_time, seed=seed + c, jitter=jitter,
                           jitter_mode=jitter_mode, trace=trace_of(c))
               for c in range(2)]
        pool = tfab.ReplicaPool(2, np.array([cfg.server_time, cfg.server_time * 1.5]), serial=True,
                                batching=batching)
        fab = tfab.EdgeFabric(ups, pool, n_streams=S, placement=placement)
    return tsrv.MultiStreamServer(cfg, fast, slow, cal, None, n_streams=S,
                                  scheduler=tsrv.FairScheduler(scheduler), fabric=fab,
                                  policy=policy, backend=backend, telemetry=telemetry,
                                  device="cpu")


def _churn(side, S, n_frames, seed):
    rng = np.random.default_rng(seed + 1)
    join = rng.integers(0, n_frames // 2, size=S)
    length = rng.integers(1, n_frames - join + 1)
    return side.churn(S, n_frames, 32.0, 0.2, join=join, length=length)


def _replay(srv, imgs, labels, schedule):
    recs = []
    srv.round_hook = recs.append
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # fp_bad would warn
        metrics = srv.process_streams(imgs, labels, schedule=schedule)
    return metrics, recs


def _assert_same_metrics(a, b):
    assert a.n_frames == b.n_frames
    assert a.n_offloaded == b.n_offloaded, (a.n_offloaded, b.n_offloaded)
    assert a.n_deadline_miss == b.n_deadline_miss
    assert a.accuracy == b.accuracy


def run_parity(*, S, churn=False, n_frames=64, seed=0, with_jax=False, traces=None,
               actions=False, **kw):
    """One seeded workload through the port's numpy and torch backends (and
    the reference's jax backend with ``with_jax``): every round held with
    ``assert_round_equal``, the metrics equal.  ``traces`` builds the cells'
    traces from a traces module (each side gets its own objects).  Returns
    the torch run's (metrics, server)."""
    imgs, labels = synthetic_streams(S, n_frames, seed=seed)
    sched = _churn(ArrivalSchedule, S, n_frames, seed) if churn else None
    tk = dict(kw, traces=traces(ttr) if traces else None,
              actions=canonical_actions() if actions else None)
    m_np, r_np = _replay(make_server("numpy", S=S, seed=seed, **tk), imgs, labels, sched)
    srv = make_server("torch", S=S, seed=seed, **tk)
    m_t, r_t = _replay(srv, imgs, labels, sched)
    assert len(r_np) == len(r_t) > 0
    desc = f"S={S} {kw}"
    for i, (a, b) in enumerate(zip(r_np, r_t)):
        assert_round_equal(a, b, ctx=f"numpy vs torch, {desc}, round {i}")
    _assert_same_metrics(m_np, m_t)
    if with_jax:
        jkw = {k: v for k, v in kw.items() if k != "batching"}
        jimgs, jlabels = jax_synthetic_streams(S, n_frames, seed=seed)
        np.testing.assert_array_equal(jimgs, imgs)
        jsrv = jax_make_server("jax", S=S, seed=seed, traces=traces(jtr) if traces else None,
                               actions=jax_canonical_actions() if actions else None, **jkw)
        if "batching" in kw:
            from repro.slowtier import ContinuousBatching, LinearBatch

            jsrv[0].fabric.pool.batching = ContinuousBatching(LinearBatch(*LIVE), window_s=LIVE[0])
        m_j, r_j = _replay(jsrv[0], jimgs, jlabels,
                           _churn(JaxSchedule, S, n_frames, seed) if churn else None)
        assert len(r_j) == len(r_t)
        for i, (a, b) in enumerate(zip(r_j, r_t)):
            assert_round_equal(a, b, ctx=f"jax vs torch, {desc}, round {i}")
        _assert_same_metrics(m_j, m_t)
    return m_t, srv


# ------------------------------ round-loop parity --------------------------- #


@pytest.mark.parametrize("S", [1, 3, 17])
def test_round_loop_parity_degenerate(S):
    run_parity(S=S, topology="degenerate", seed=S, with_jax=S == 3)


@pytest.mark.parametrize("placement", ["jsq", "least_land", "round_robin"])
def test_round_loop_parity_fabric(placement):
    run_parity(S=3, topology="fabric", placement=placement, with_jax=placement == "jsq")


def test_round_loop_parity_threshold_fifo():
    run_parity(S=3, policy="threshold", scheduler="fifo")


@pytest.mark.parametrize("topology", ["degenerate", "fabric"])
def test_round_loop_parity_churn(topology):
    run_parity(S=3, topology=topology, churn=True, seed=5)


def test_round_loop_parity_heterogeneous():
    mix = ("cbo", "threshold", "greedy-rate")
    run_parity(S=6, policy=lambda i: mix[i % len(mix)], seed=11, with_jax=True)


def test_round_loop_parity_heterogeneous_fabric():
    mix = ("cbo", "threshold")
    run_parity(S=4, policy=lambda i: mix[i % len(mix)], topology="fabric", seed=12)


@pytest.mark.parametrize("topology", ["degenerate", "fabric"])
def test_round_loop_parity_jitter(topology):
    # counter-mode jitter drawn inside the step (threefry on tensors) and by
    # the host Uplink: the same per-second channel, so decisions stay exact
    run_parity(S=3, topology=topology, jitter=0.3, seed=7, with_jax=topology == "fabric")


def test_round_loop_parity_trace():
    # a 1.5 s square wave: the ~2 s workload crosses regime boundaries and
    # wraps the loop, the lookup on the step's padded grid
    run_parity(S=3, seed=13, traces=lambda tr: [tr.regime_shift_trace(
        levels_mbps=(20.0, 4.0), period=0.75, loop=True)])


def test_round_loop_parity_trace_fabric():
    # two cells on different traces; then one also jittered: trace lookup
    # and counter jitter compose multiplicatively in the step
    def trs(tr):
        return [tr.regime_shift_trace(levels_mbps=(25.0, 6.0), period=0.75, loop=True),
                tr.regime_shift_trace(levels_mbps=(12.0, 30.0, 8.0), period=0.5, loop=True)]

    run_parity(S=4, topology="fabric", traces=trs, seed=14)
    run_parity(S=3, topology="fabric", traces=trs, jitter=0.2, seed=15, with_jax=True)


def test_post_run_fleet_state_parity():
    # the residual backlog rebuilt from the padded carry equals the numpy one
    imgs, labels = synthetic_streams(3, 48, seed=9)
    states = {}
    for backend in ("numpy", "torch"):
        srv = make_server(backend, S=3)
        srv.process_streams(imgs, labels)
        states[backend] = srv.fleet.state
    assert len(states["numpy"]) > 0
    assert_fleet_equal(states["numpy"], states["torch"])


def test_server_backend_fail_fast():
    # what the round engine cannot express raises at construction, and the
    # shared supports_torch predicate agrees with the raise
    fast, slow, cal = synthetic_tiers()
    cfg = tsrv.ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), frame_rate=32.0, deadline=0.2)

    def server(backend, **up_kw):
        up = tnet.Uplink(bandwidth_bps=tnet.mbps(50.0), latency=0.05, server_time=cfg.server_time,
                         seed=0, **up_kw)
        return tsrv.MultiStreamServer(cfg, fast, slow, cal, None, n_streams=2,
                                      fabric=tfab.EdgeFabric.degenerate(up, n_streams=2),
                                      backend=backend, device="cpu")

    with pytest.raises(ValueError, match="jitter_mode"):
        server("torch", jitter=0.3)
    srv = server("numpy", jitter=0.3)
    assert not et.supports_torch(srv)
    assert any("counter" in r for r in et.torch_unsupported(srv))
    srv = server("torch", jitter=0.3, jitter_mode="counter")
    assert et.supports_torch(srv) and et.torch_unsupported(srv) == []
    with pytest.raises(NotImplementedError, match="torch"):
        server("jax")
    with pytest.raises(ValueError, match="backend"):
        server("tpu")
    # an unbounded backlog has no fixed shape
    with pytest.raises(ValueError, match="max_backlog"):
        tsrv.MultiStreamServer(cfg, fast, slow, cal, None, n_streams=2, policy="optimal",
                               fabric=tfab.EdgeFabric.degenerate(
                                   tnet.Uplink(bandwidth_bps=1e6, latency=0.05,
                                               server_time=0.037), n_streams=2),
                               backend="torch", device="cpu")


@pytest.mark.parametrize("topology,S", [("degenerate", 4), ("fabric", 12)])
def test_fabric_snapshot(topology, S):
    with open(os.path.join(DATA, "fabric_snapshot.json")) as f:
        snap = json.load(f)[topology]
    imgs, labels = synthetic_streams(S, 64)
    agg = make_server("torch", S=S, topology=topology).process_streams(imgs, labels)
    assert agg.accuracy == pytest.approx(snap["accuracy"], abs=1e-12)
    assert int(agg.n_offloaded) == snap["n_offloaded"]
    assert int(agg.n_deadline_miss) == snap["n_deadline_miss"]
    for m, ref in zip(agg.per_stream, snap["per_stream"]):
        assert m.n_frames == ref["n_frames"]
        assert m.accuracy == pytest.approx(ref["accuracy"], abs=1e-12)
        assert m.offload_frac == pytest.approx(ref["offload_frac"], abs=1e-12)
        assert m.deadline_miss_frac == pytest.approx(ref["deadline_miss_frac"], abs=1e-12)


# ------------------------------ continuous batching ------------------------- #


def _live():
    return tst.ContinuousBatching(tst.LinearBatch(*LIVE), window_s=LIVE[0])


def test_degenerate_batching_pins_fabric_snapshot():
    with open(os.path.join(DATA, "fabric_snapshot.json")) as f:
        snap = json.load(f)["fabric"]
    degen = tst.ContinuousBatching(tst.FlatService(0.037), window_s=0.0, max_batch=1)
    imgs, labels = synthetic_streams(12, 64)
    agg = make_server("torch", S=12, topology="fabric", batching=degen).process_streams(imgs, labels)
    assert agg.accuracy == pytest.approx(snap["accuracy"], abs=1e-12)
    assert int(agg.n_offloaded) == snap["n_offloaded"]
    assert int(agg.n_deadline_miss) == snap["n_deadline_miss"]


def test_live_batching_differential_numpy_vs_torch():
    m, _ = run_parity(S=12, topology="fabric", bw_mbps=30.0, batching=_live(), with_jax=True)
    assert m.n_offloaded > 0  # the workload exercises the slow tier


def test_live_batching_occupancy_tracks_across_backends():
    imgs, labels = synthetic_streams(12, 64, seed=0)
    occ = {}
    for backend in ("numpy", "torch"):
        srv = make_server(backend, S=12, topology="fabric", bw_mbps=30.0, batching=_live())
        srv.process_streams(imgs, labels)
        occ[backend] = srv.fabric.pool.avg_batch
    assert occ["numpy"] > 1.0  # real batches formed
    assert occ["torch"] == pytest.approx(occ["numpy"], rel=1e-5)


# ------------------------------ split actions ------------------------------- #


def test_split_differential_degenerate_topology():
    m, _ = run_parity(S=3, n_frames=48, bw_mbps=2.0, actions=True, with_jax=True)
    assert m.n_offloaded > 0  # splits exercised, not planned away


def test_split_differential_churn_two_cells():
    m, _ = run_parity(S=4, n_frames=48, bw_mbps=2.0, churn=True, topology="cells",
                      placement="jsq", actions=True)
    assert m.n_frames > 0


def test_torch_unsupported_flags_splits_with_live_batching():
    srv = make_server("numpy", S=2, actions=canonical_actions(), bw_mbps=2.0)
    assert not et.torch_unsupported(srv)  # split tables alone are supported
    srv.fabric.pool.batching = tst.ContinuousBatching(tst.LinearBatch(0.01, 0.002), window_s=0.01)
    reasons = et.torch_unsupported(srv)
    assert reasons and any("batching" in r for r in reasons)


# ------------------------------ telemetry ---------------------------------- #


def _run_obs(backend, *, topology, telemetry=None):
    imgs, labels = synthetic_streams(6, 48, seed=0)
    srv = make_server(backend, S=6, topology=topology, telemetry=telemetry)
    return srv.process_streams(imgs, labels), srv


@pytest.mark.parametrize("topology", ["degenerate", "fabric"])
def test_recorder_parity_numpy_vs_torch(topology):
    tel_np, tel_t = tobs.Telemetry(record=True), tobs.Telemetry(record=True)
    m_np, _ = _run_obs("numpy", topology=topology, telemetry=tel_np)
    m_t, _ = _run_obs("torch", topology=topology, telemetry=tel_t)
    assert tel_np.recorder.n_rounds == tel_t.recorder.n_rounds > 0
    tel_np.recorder.assert_close(tel_t.recorder, ctx=topology)
    assert m_np.summary() == m_t.summary()


def test_zero_observer_effect():
    """Telemetry on or off changes no reported metric; the profiler holds
    the engine's phases, capture apart from the rounds."""
    m_off, _ = _run_obs("torch", topology="fabric")
    tel = tobs.Telemetry(record=True, profile=True)
    m_on, _ = _run_obs("torch", topology="fabric", telemetry=tel)
    assert m_off.summary() == m_on.summary()
    for k in ("_frames", "_offloaded", "_missed", "_correct"):
        np.testing.assert_array_equal(getattr(m_off, k), getattr(m_on, k))
    assert {"precompute", "compile", "scan", "fold"} <= set(tel.profiler.totals)


# ------------------------------ the engine on synthetic rounds -------------- #


def _synthetic(S, R=6, batch=8, backlog=8, telemetry=True):
    """``bench_fleet_control.py::bench_jax_one``'s inputs (cbo, 1 cell,
    1 replica, 6 Mbps) for both engines."""
    from repro.policy.fleet_jax import spec_for_policy as jspec
    from repro.policy.registry import make_policy as jmake
    from repro.serving import engine_jax as ej
    from repro_torch.policy.fleet_torch import spec_for_policy as tspec
    from repro_torch.policy.registry import make_policy as tmake

    sizes = tnet.payload_sizes(tnet.png_size_model, np.asarray((4, 8)))
    kw = dict(sizes=sizes, acc_server=(0.7, 0.99), deadline=0.2, latency=0.05, server_time=0.037)
    common = dict(n_streams=S, batch=batch, n_cells=1, n_replicas=1, collect="trace",
                  telemetry=telemetry)
    jsp = ej.EngineSpec(planner=jspec(jmake("cbo", max_backlog=backlog), **kw), **common)
    tsp = et.EngineSpec(planner=tspec(tmake("cbo", max_backlog=backlog), **kw), **common)
    bw = tnet.mbps(6.0)
    rng = np.random.default_rng(0)
    base = (np.arange(R * batch, dtype=np.float32) / 32.0).reshape(R, 1, batch)
    cols = (np.broadcast_to(base, (R, S, batch)).copy(), np.ones((R, S, batch), bool),
            rng.uniform(0.0, 1.0, (R, S, batch)).astype(np.float32),
            rng.random((R, S, batch)) < 0.7, rng.random((R, S, batch, 2)) < 0.9)
    per = dict(sizes=sizes, cell_bw=[bw], replica_st=[0.037], stream_bw=np.full(S, bw),
               weights=np.ones(S), bw_init=np.full(S, bw))
    jp = ej.EngineParams(cell_of=jnp.zeros(S, jnp.int32),
                         **{k: jnp.asarray(v, jnp.float32) for k, v in per.items()})
    tp = et.EngineParams(cell_of=torch.zeros(S, dtype=torch.int64),
                         **{k: torch.as_tensor(np.asarray(v, np.float64)).float()
                            for k, v in per.items()})
    return ((jsp, jp, ej.RoundInputs(*map(jnp.asarray, cols))),
            (tsp, tp, et.RoundInputs(*map(torch.as_tensor, cols))))


# float outputs that sum a reduction (the queued/busy seconds, and what an
# observation folds from them) round in another order; the rest are equal
_SUMMED = {"bw_est", "cell_queued_s", "rep_busy_s", "ts_bw_est", "ts_cell_busy_s",
           "ts_cell_queued_s", "ts_rep_busy_s", "lat"}


def test_simulate_synthetic_rounds_against_engine_jax():
    from repro.serving import engine_jax as ej

    (jsp, jp, ji), (tsp, tp, ti) = _synthetic(64)
    jc, jy = ej.simulate(jsp, jp, ji)
    tc, ty = et.simulate(tsp, tp, ti)
    pairs = [("fleet." + k, getattr(jc.fleet, k), getattr(tc.fleet, k)) for k in jc.fleet._fields]
    pairs += [(k, getattr(jc, k), getattr(tc, k)) for k in jc._fields if k != "fleet"]
    pairs += [("ys." + k, getattr(jy, k), getattr(ty, k)) for k in jy._fields]
    checked = 0
    for name, a, b in pairs:
        if a is None:
            assert b is None, name
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind == "f" and name.split(".")[-1] in _SUMMED:
            tol = dict(atol=LAT_ATOL) if name.endswith("lat") else dict(rtol=BW_RTOL, atol=1e-5)
            np.testing.assert_allclose(b, a, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
        checked += 1
    assert checked >= 40
    assert int(tc.offloaded.sum()) > 0


def test_round_loop_state_and_replay():
    """``RoundLoop`` on the CPU: ``aot_split``'s warm-up call leaves the
    state as it was, one step a round, the carry updated in place."""
    _, (tsp, tp, ti) = _synthetic(16, R=3, telemetry=False)
    ref_c, ref_y = et.simulate(tsp, tp, ti)
    carry = et.init_carry(tsp, tp)
    loop = et.RoundLoop(tsp, tp, carry, ti)
    prof = tobs.PhaseProfiler()
    out_c, out_y = loop.run(prof)
    assert out_c is carry and int(loop.r) == 3
    assert set(prof.totals) == {"compile", "scan"}
    for a, b in zip(et._leaves(ref_c) + et._leaves(ref_y), et._leaves(out_c) + et._leaves(out_y)):
        assert torch.equal(a, b)


def test_log_step_scan_is_a_running_sum():
    """The card's fixed-association scan: exact where every partial sum is
    (dyadic rows), within float32 rounding of the sequential sum
    elsewhere, and the same bits on every call."""
    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 64, 1000):
        dyadic = torch.as_tensor(rng.integers(0, 64, n) / 32.0, dtype=torch.float32)
        assert torch.equal(et._log_step_scan(dyadic), torch.cumsum(dyadic, 0))
        x = torch.as_tensor(rng.uniform(0.0, 0.1, n), dtype=torch.float32)
        got = et._log_step_scan(x)
        assert torch.equal(got, et._log_step_scan(x.clone()))
        np.testing.assert_allclose(got.numpy(), np.cumsum(x.numpy().astype(np.float64)),
                                   rtol=1e-5 * np.log2(n + 1), atol=0.0)
    assert torch.equal(et._cumsum(x), torch.cumsum(x, 0))  # the CPU adds in sequence


def test_round_loop_makes_consts_and_warns_on_large_graphs():
    """``RoundLoop`` makes the spec's tables once when the params lack them,
    and warns when the unrolled per-row loops pass ``MAX_UNROLLED_ROWS``."""
    import dataclasses

    _, (tsp, tp, ti) = _synthetic(16, R=1, telemetry=False)
    assert tp.consts is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loop = et.RoundLoop(dataclasses.replace(tsp, placement="jsq"), tp, et.init_carry(tsp, tp), ti)
    (tables,) = loop.params.consts.tables
    for a, b in zip(tables, ft.planner_tables(tsp.planner, "cpu")):
        assert torch.equal(a, b)
    assert et.unrolled_rows(loop.spec) == 16 * 8
    big = dataclasses.replace(tsp, n_streams=1024, n_replicas=2, placement="least_land",
                              batch_kind="flat", batch_coeffs=(0.03,))
    assert et.unrolled_rows(big) == 3 * 1024 * 8 > et.MAX_UNROLLED_ROWS
    _, (_, bp, bi) = _synthetic(1024, R=1, telemetry=False)
    bp = bp._replace(replica_st=torch.full((2,), 0.037))
    with pytest.warns(UserWarning, match="per-row steps"):
        et.RoundLoop(big, bp, et.init_carry(big, bp), bi)


# ------------------------------ helpers ------------------------------------ #


@pytest.mark.parametrize("pad_to", [None, 9])
def test_trace_grid_bit_equal_to_reference(pad_to):
    for jt, tt in ((jtr.lte_trace(30.0, seed=2), ttr.lte_trace(30.0, seed=2)),
                   (jtr.regime_shift_trace(period=0.5), ttr.regime_shift_trace(period=0.5))):
        n = None if pad_to is None else len(jt) + pad_to
        for a, b in zip(jt.grid(pad_to=n), tt.grid(pad_to=n)):
            np.testing.assert_array_equal(b, a)
        # the padded grid's lookup is the ragged trace's
        t_grid, bps = (torch.as_tensor(x) for x in tt.grid(pad_to=n))
        ts = np.random.default_rng(0).uniform(0.0, tt.duration, 257)
        np.testing.assert_array_equal(et.trace_lookup(t_grid, bps, torch.as_tensor(ts)).numpy(),
                                      tt.bandwidth_at(ts))
    with pytest.raises(ValueError, match="pad_to"):
        ttr.regime_shift_trace().grid(pad_to=1)


def test_mod_is_jnp_mod():
    x = torch.tensor([-3.5, -0.75, 0.0, 0.75, 1.5, 7.25, 1e3], dtype=torch.float32)
    for y in (0.75, 1.5, -1.25):
        np.testing.assert_array_equal(et._mod(x, torch.tensor(y)).numpy(),
                                      np.asarray(jnp.mod(jnp.asarray(x.numpy()), jnp.float32(y))))
