"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``, and the port's ``MultiStreamServer(telemetry=...)`` against
the reference's numpy engine.

Unit parity: the same rows fed to both ``FleetRecorder``s give equal
``as_dict``, ``summary``, ``jain_series``, ``bw_error`` and
``relock_lags``, and the same schema errors; both ``FrameTracer``s give
equal records, ``chrome_trace()`` and ``miss_attribution()``; both
``PhaseProfiler``s summarize equal samples alike.

Engine parity, with the synthetic closed-form tiers on the CPU, over three
topologies (a degenerate 1-cell/1-replica fabric; 2 cells x 2 replicas
with continuous batching; the same under churn): every recorder series is
bit-equal, floats included, since both round loops are the same float64
numpy on bit-equal confidences; the tracer's Chrome trace and miss
attribution are equal; the profiler holds plan / serve / transmit / fold;
and telemetry on and off give the same metrics (zero observer effect).
"""
import json

import numpy as np
import pytest
import torch

import repro.core.netsim as jnet
import repro.net as jfab
import repro.obs as jobs
import repro.serving as jsrv
import repro.slowtier as jst
import repro_torch.core.netsim as tnet
import repro_torch.net as tfab
import repro_torch.obs as tobs
import repro_torch.serving as tsrv
import repro_torch.slowtier as tst
from repro.serving.synthetic import synthetic_tiers as jax_synthetic_tiers
from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers

SIDES = {"jax": (jnet, jfab, jobs, jsrv, jst, jax_synthetic_tiers),
         "torch": (tnet, tfab, tobs, tsrv, tst, synthetic_tiers)}
LIVE = (0.03125, 0.0078125)  # LinearBatch(base, per_item), float32-exact


# ------------------------------ recorder ----------------------------------- #


def _rows(n, S=5, C=2, K=3, A=4, seed=0):
    """Random recorder rows (cumulative counters, a bandwidth regime shift)."""
    rng = np.random.default_rng(seed)
    out, cum = [], np.zeros((4, S), dtype=np.int64)
    for r in range(n):
        cum += rng.integers(0, 4, size=(4, S))
        true = np.full(S, 1e6 if r < n // 2 else 2.5e6)
        true[rng.random(S) < 0.1] = np.nan if r % 3 else 0.0
        est = true * rng.uniform(0.5, 1.5, size=S) if r > n // 2 + 2 else np.full(S, 1e6)
        out.append(dict(t=r / 2.0 if r != 3 else np.nan, frames=cum[0].copy(),
                        offloads=cum[1].copy(), misses=cum[2].copy(), correct=cum[3].copy(),
                        bw_est=est, bw_true=true, cell_busy_s=rng.uniform(0, 1, C),
                        cell_queued_s=rng.uniform(0, 1, C), rep_busy_s=rng.uniform(0, 1, K),
                        rep_queued_s=rng.uniform(0, 1, K), avg_batch=rng.uniform(1, 4),
                        server_time=0.037, action_off=rng.integers(0, 5, size=A)))
    return out


def _assert_same(a, b, ctx=""):
    if isinstance(a, dict):
        assert set(a) == set(b), ctx
        for k in a:
            _assert_same(a[k], b[k], f"{ctx}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, ctx
        np.testing.assert_array_equal(a, b, err_msg=ctx)
    else:
        assert a == b or (a != a and b != b), (ctx, a, b)


@pytest.mark.parametrize("capacity", [2, 64])
def test_recorder_views_equal_reference(capacity):
    recs = {side: SIDES[side][2].FleetRecorder(5, 2, 3, 4, capacity=capacity) for side in SIDES}
    for row in _rows(13):
        for rec in recs.values():
            rec.record_round(**row)
    j, t = recs["jax"], recs["torch"]
    assert j.n_rounds == t.n_rounds == 13
    _assert_same(j.as_dict(), t.as_dict(), "as_dict")
    with np.errstate(all="ignore"):
        assert j.summary() == t.summary()
        _assert_same(j.jain_series(), t.jain_series(), "jain")
        _assert_same(j.bw_error(), t.bw_error(), "bw_error")
        for kw in ({}, dict(rtol=0.6, shift_rtol=0.1)):
            lags = tobs.relock_lags(t, **kw)
            assert lags == jobs.relock_lags(j, **kw)
    assert lags, "the rows hold a regime shift"
    for k in ("t", "frames", "action_off"):
        _assert_same(j.series(k), t.series(k), k)
    empty = tobs.FleetRecorder(5)
    assert empty.summary() == jobs.FleetRecorder(5).summary() == {"rounds": 0}
    assert tobs.relock_lags(empty) == []


def test_recorder_schema_errors_and_assert_close_match_reference():
    for side, mod in (("jax", jobs), ("torch", tobs)):
        rec = mod.FleetRecorder(2)
        with pytest.raises(ValueError, match="missing") as e_missing:
            rec.record_round(t=0.0)
        row = _rows(1, S=2, C=1, K=1, A=1)[0]
        with pytest.raises(ValueError, match="unknown") as e_unknown:
            rec.record_round(**row, bogus=1.0)
        if side == "jax":
            want = (str(e_missing.value), str(e_unknown.value))
        else:
            assert (str(e_missing.value), str(e_unknown.value)) == want
    a, b = tobs.FleetRecorder(2), tobs.FleetRecorder(2)
    rows = _rows(2, S=2, C=1, K=1, A=1)
    for rec in (a, b):
        rec.record_round(**rows[0])
    a.assert_close(b)
    a.record_round(**rows[1])
    with pytest.raises(AssertionError, match="round counts"):
        a.assert_close(b)
    b.record_round(**dict(rows[1], offloads=rows[1]["offloads"] + 1))
    with pytest.raises(AssertionError, match="offloads"):
        a.assert_close(b)


def test_profiler_and_bundle_match_reference():
    profs = [mod.PhaseProfiler() for mod in (jobs, tobs)]
    for p in profs:
        assert not p and p.summarize() == {}
        p.add("x", 0.25)
        p.add("x", 0.75)
        p.add("plan", 1e-3)
    assert profs[0].summarize() == profs[1].summarize()
    with profs[1].phase("y"):
        pass
    assert profs[1] and profs[1].counts["y"] == 1
    profs[1].reset()
    assert not profs[1]
    tel = tobs.Telemetry(record=True, trace=True, profile=True)
    tel.bind(n_streams=3, n_cells=2, n_replicas=4, n_actions=5)
    rec, tr, pr = tel.recorder, tel.tracer, tel.profiler
    assert (rec.n_streams, rec.n_cells, rec.n_replicas, rec.n_actions) == (3, 2, 4, 5)
    tel.bind(n_streams=9, n_cells=9, n_replicas=9, n_actions=9)  # pre-built parts are kept
    assert tel.recorder is rec and tel.tracer is tr and tel.profiler is pr
    off = tobs.Telemetry(record=False).bind(n_streams=1, n_cells=1, n_replicas=1, n_actions=1)
    assert off.recorder is None and off.tracer is None and off.profiler is None
    # the compile split: a CPU step runs eagerly, its warm-up call timed and its state restored
    state = torch.zeros(3)
    step = lambda: state.add_(1.0)  # noqa: E731
    prof = tobs.PhaseProfiler()
    replay, seconds = tobs.aot_split(step, state, profiler=prof)
    assert replay is step and seconds >= 0.0 and prof.counts == {"compile": 1}
    assert state.tolist() == [0.0, 0.0, 0.0]


def test_tracer_records_equal_reference(tmp_path):
    rng = np.random.default_rng(3)
    tracers = [jobs.FrameTracer(), tobs.FrameTracer()]
    for r in range(4):
        n = int(rng.integers(0, 6))
        arrival = rng.uniform(0, 2, n)
        t_ready = arrival + 0.028
        up_start = t_ready + rng.uniform(0, 0.02, n)
        up_end = up_start + rng.uniform(0.001, 0.05, n)
        service = rng.uniform(0.01, 0.05, n)
        done = up_end + rng.uniform(0, 0.03, n) + service
        land = done + 0.05
        row = dict(stream=rng.integers(0, 4, n), slot=rng.integers(0, 16, n), arrival=arrival,
                   t_ready=t_ready, cell=rng.integers(0, 2, n), up_start=up_start, up_end=up_end,
                   replica=rng.integers(0, 2, n), service=service, done=done,
                   batch_id=rng.integers(-1, 3, n), land=land, ok=land <= arrival + 0.2,
                   deadline=0.2)
        for tr in tracers:
            tr.record_round(**row)
    j, t = tracers
    assert j.n_frames == t.n_frames > 0
    assert j.frames == t.frames
    assert j.miss_attribution() == t.miss_attribution()
    assert j.chrome_trace() == t.chrome_trace()
    path = tobs.export_chrome_trace(t, str(tmp_path / "trace.json"))
    with open(path) as fh:
        assert json.load(fh) == json.loads(json.dumps(j.chrome_trace()))
    assert tobs.FrameTracer().miss_attribution() == jobs.FrameTracer().miss_attribution()


# ------------------------------ the engine --------------------------------- #


def _server(side, topology, telemetry=None):
    net, fab, _, srv, st, tiers = SIDES[side]
    fast, slow, cal = tiers()
    cfg = srv.ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), batch_size=16,
                          frame_rate=32.0, deadline=0.2)
    kw = dict(device="cpu") if side == "torch" else {}
    if topology == "degenerate":
        up = net.Uplink(bandwidth_bps=net.mbps(50.0), latency=0.05, server_time=cfg.server_time)
        return srv.MultiStreamServer(cfg, fast, slow, cal, up, n_streams=4, telemetry=telemetry, **kw)
    S = 12
    ups = [net.Uplink(bandwidth_bps=net.mbps(30.0), latency=0.05, server_time=cfg.server_time, seed=c)
           for c in range(2)]
    pool = fab.ReplicaPool(2, np.array([cfg.server_time, cfg.server_time * 1.5]), serial=True,
                           batching=st.ContinuousBatching(st.LinearBatch(*LIVE), window_s=LIVE[0]))
    return srv.MultiStreamServer(cfg, fast, slow, cal, None, n_streams=S,
                                 scheduler=srv.FairScheduler("round_robin"),
                                 fabric=fab.EdgeFabric(ups, pool, n_streams=S, placement="jsq"),
                                 policy="cbo", telemetry=telemetry, **kw)


def _run(side, topology, telemetry=None):
    server = _server(side, topology, telemetry)
    S = server.n_streams
    imgs, labels = synthetic_streams(S, 64, seed=0)
    schedule = None
    if topology == "churn":
        rng = np.random.default_rng(1)
        join = rng.integers(0, 32, size=S)
        length = rng.integers(1, 64 - join + 1)
        schedule = SIDES[side][3].ArrivalSchedule.churn(S, 64, 32.0, 0.2, join=join, length=length)
    return server.process_streams(imgs, labels, schedule=schedule), server


@pytest.mark.parametrize("topology", ["degenerate", "fabric", "churn"])
def test_engine_telemetry_bit_equal_to_reference(topology):
    tels = {side: SIDES[side][2].Telemetry(record=True, trace=True, profile=True) for side in SIDES}
    (jm, jserver), (tm, tserver) = (_run(side, topology, tels[side]) for side in SIDES)
    assert tm.summary() == jm.summary()
    jrec, trec = tels["jax"].recorder, tels["torch"].recorder
    assert trec.n_rounds == jrec.n_rounds == 4
    _assert_same(jrec.as_dict(), trec.as_dict(), topology)  # floats too: both are float64 numpy
    jrec.assert_close(trec, ctx=topology)
    with np.errstate(all="ignore"):
        assert trec.summary() == jrec.summary()
        assert tobs.relock_lags(trec) == jobs.relock_lags(jrec)
    jtr, ttr = tels["jax"].tracer, tels["torch"].tracer
    assert ttr.n_frames == jtr.n_frames == tm.n_offloaded + tm.n_deadline_miss > 0
    assert ttr.frames == jtr.frames
    assert ttr.chrome_trace() == jtr.chrome_trace()
    assert ttr.miss_attribution() == jtr.miss_attribution()
    prof = tels["torch"].profiler
    assert {"plan", "serve", "transmit", "fold"} <= set(prof.totals)
    assert prof.counts["plan"] == prof.counts["fold"] == 4
    assert tserver.fleet.profiler is prof
    # the recorder's last cumulative row is the end-of-run counters
    for k, v in (("frames", tm._frames), ("offloads", tm._offloaded), ("misses", tm._missed),
                 ("correct", tm._correct)):
        np.testing.assert_array_equal(trec.series(k)[-1], v)
    if topology != "degenerate":
        assert tserver.fabric.pool.avg_batch > 1.0  # real batches formed
        assert {f["batch"] for f in ttr.frames} != {-1}


@pytest.mark.parametrize("topology", ["degenerate", "fabric", "churn"])
def test_zero_observer_effect(topology):
    m_off, s_off = _run("torch", topology)
    m_on, s_on = _run("torch", topology, tobs.Telemetry(record=True, trace=True, profile=True))
    assert m_off.summary() == m_on.summary()
    for k in ("_frames", "_offloaded", "_missed", "_correct"):
        np.testing.assert_array_equal(getattr(m_off, k), getattr(m_on, k))
    np.testing.assert_array_equal(s_off.fleet.bw_est, s_on.fleet.bw_est)
    assert s_off.fabric.last_detail is None and s_on.fabric.last_detail is not None


def test_fabric_detail_equal_reference():
    """``transmit(collect_detail=True)`` keeps the reference's per-row
    lifecycle detail; without it ``last_detail`` stays None."""
    rng = np.random.default_rng(4)
    out = {}
    for side in SIDES:
        net, fab, *_ = SIDES[side]
        ups = [net.Uplink(bandwidth_bps=net.mbps(20.0), latency=0.05, server_time=0.037, seed=c)
               for c in range(2)]
        pool = fab.ReplicaPool(2, np.array([0.037, 0.05]), serial=True)
        out[side] = fab.EdgeFabric(ups, pool, n_streams=6, placement="jsq")
    stream = rng.integers(0, 6, 20)
    payload = rng.uniform(1e3, 5e4, 20)
    t_sub = np.sort(rng.uniform(0, 0.5, 20))
    lands = {side: f.transmit(stream, payload, t_sub, collect_detail=True) for side, f in out.items()}
    np.testing.assert_array_equal(lands["jax"], lands["torch"])
    _assert_same(out["jax"].last_detail, out["torch"].last_detail, "detail")
    out["torch"].transmit(stream, payload, t_sub + 1.0)
    assert out["torch"].last_detail is None
    out["torch"].transmit(stream[:0], payload[:0], t_sub[:0], collect_detail=True)
    assert out["torch"].last_detail is None
