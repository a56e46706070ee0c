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
attribution are equal; the profiler logs each round's spans once, inside
their round, with ``syncs`` at 4 + k (k distinct planned resolutions)
in a round that escalates and 2 in one that does not, as on the card, and
opens ``serving.*`` ranges under ``torch.profiler``; and telemetry on and
off give the same metrics (zero observer effect).  With telemetry off the
engines call ``NULL_PROFILER``, whose every method does nothing, and no
``PhaseProfiler`` method at all.
"""
import collections
import contextlib
import inspect
import json
import re

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
import repro_torch.policy.fleet as tfleet
import repro_torch.serving as tsrv
import repro_torch.serving.engine as teng
import repro_torch.serving.engine_torch as tet
import repro_torch.slowtier as tst
from repro.serving.synthetic import synthetic_tiers as jax_synthetic_tiers
from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers

SIDES = {"jax": (jnet, jfab, jobs, jsrv, jst, jax_synthetic_tiers),
         "torch": (tnet, tfab, tobs, tsrv, tst, synthetic_tiers)}
LIVE = (0.03125, 0.0078125)  # LinearBatch(base, per_item), float32-exact
# the numpy round loop's spans inside each round, in loop order; SLOW_SPANS
# only in a round that escalates
LOOP_SPANS = ("slice", "h2d", "fast", "fast_wait", "plan", "gate", "transmit", "fold", "hook")
SLOW_SPANS = ("slow", "slow_wait")
# the profiler methods the engines and the planner call
PROFILER_CALLS = ("open_round", "open", "switch", "close", "close_all", "count", "add", "phase")


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


def _server(side, topology, telemetry=None, backend="numpy"):
    net, fab, _, srv, st, tiers = SIDES[side]
    fast, slow, cal = tiers()
    cfg = srv.ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), batch_size=16,
                          frame_rate=32.0, deadline=0.2)
    kw = dict(device="cpu", backend=backend) if side == "torch" else {}
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


def _run(side, topology, telemetry=None, backend="numpy", hooks=None):
    server = _server(side, topology, telemetry, backend)
    if hooks is not None:
        server.round_hook = hooks.append
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
    assert set(prof.totals) == set(LOOP_SPANS) | set(SLOW_SPANS)
    assert all(prof.counts[name] == 4 for name in LOOP_SPANS)
    assert 0 < prof.counts["slow"] == prof.counts["slow_wait"] <= 4
    assert tserver.fleet.profiler is prof
    # the recorder's last cumulative row is the end-of-run counters
    for k, v in (("frames", tm._frames), ("offloads", tm._offloaded), ("misses", tm._missed),
                 ("correct", tm._correct)):
        np.testing.assert_array_equal(trec.series(k)[-1], v)
    if topology != "degenerate":
        assert tserver.fabric.pool.avg_batch > 1.0  # real batches formed
        assert {f["batch"] for f in ttr.frames} != {-1}


@pytest.mark.parametrize("topology", ["degenerate", "fabric", "churn"])
@pytest.mark.parametrize("parts", ["all", "profile", "profile_traced"])
def test_zero_observer_effect(topology, parts):
    """The same metrics with every part on; with the profiler alone (the
    spans and the counter); and with the profiler alone under a
    ``torch.profiler``, whose ``serving.*`` ranges it then opens."""
    m_off, s_off = _run("torch", topology)
    if parts == "all":
        m_on, s_on = _run("torch", topology, tobs.Telemetry(record=True, trace=True, profile=True))
    else:
        tel = tobs.Telemetry(record=False, profile=True)
        with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
              if parts == "profile_traced" else contextlib.nullcontext()):
            m_on, s_on = _run("torch", topology, tel)
        assert tel.profiler.n_rounds == 4
    assert m_off.summary() == m_on.summary()
    for k in ("_frames", "_offloaded", "_missed", "_correct"):
        np.testing.assert_array_equal(getattr(m_off, k), getattr(m_on, k))
    np.testing.assert_array_equal(s_off.fleet.bw_est, s_on.fleet.bw_est)
    assert s_off.fabric.last_detail is None
    assert (s_on.fabric.last_detail is not None) == (parts == "all")


# ------------------------------ spans -------------------------------------- #


def _served_spans(topology, profiled=False):
    """Serve a clip with the profiler alone; returns the profiler, each
    round's hook record and, with ``profiled``, the ``torch.profiler``'s
    events."""
    tel = tobs.Telemetry(record=False, profile=True)
    server = _server("torch", topology, tel)
    hooks = []
    server.round_hook = hooks.append
    imgs, labels = synthetic_streams(server.n_streams, 64, seed=0)
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
            server.process_streams(imgs, labels)
        return tel.profiler, hooks, tp.events()
    server.process_streams(imgs, labels)
    return tel.profiler, hooks, None


@pytest.mark.parametrize("topology", ["degenerate", "fabric", "churn"])
def test_each_round_logs_its_spans_once_inside_it(topology):
    prof, hooks, _ = _served_spans(topology)
    assert prof.n_rounds == len(hooks) == 4 and not prof._open
    spans, self_s = prof.spans, prof.self_times()
    roots = [i for i, sp in enumerate(spans) if sp.name == tobs.profile.ROUND]
    assert [spans[i].round for i in roots] == [0, 1, 2, 3]
    assert all(spans[i].parent == -1 for i in roots)
    n_escalating = 0
    for r, (i, hook) in enumerate(zip(roots, hooks)):
        root = spans[i]
        children = [sp for sp in spans if sp.parent == i]
        escalates = bool(hook["esc"].any())
        n_escalating += escalates
        want = list(LOOP_SPANS[:6]) + list(SLOW_SPANS) * escalates + list(LOOP_SPANS[6:])
        assert [sp.name for sp in children] == want, r  # each once, in loop order
        assert all(sp.round == r for sp in children)
        assert all(root.start <= sp.start <= sp.end <= root.end for sp in children)
        assert all(a.end <= b.start for a, b in zip(children, children[1:]))
        child_s = sum(sp.end - sp.start for sp in children)
        assert self_s[i] == pytest.approx(root.end - root.start - child_s)
        assert self_s[i] >= 0
    assert n_escalating > 0
    assert all(sp.parent == -1 or spans[sp.parent].name == tobs.profile.ROUND for sp in spans)
    # the phases inside the round add to the totals, the round does not
    assert prof.counts["slice"] == 4 and tobs.profile.ROUND not in prof.totals


@pytest.mark.parametrize("topology", ["degenerate", "fabric", "churn"])
def test_syncs_count_each_blocking_transfer(topology):
    prof, hooks, _ = _served_spans(topology)
    syncs = prof.counters["syncs"]
    assert sorted(syncs) == [0, 1, 2, 3]
    saw_k = set()
    for r, hook in enumerate(hooks):
        esc_streams = np.nonzero(hook["esc"])[0]
        if len(esc_streams):
            k = len(np.unique(hook["res_idx"][esc_streams]))  # frame actions: one resolution each
            saw_k.add(k)
            assert syncs[r] == 4 + k, (r, syncs[r], k)
        else:
            assert syncs[r] == 2, (r, syncs[r])
    assert saw_k


@pytest.mark.parametrize("topology", ["degenerate", "fabric"])
def test_profiled_clip_holds_the_serving_ranges(topology, monkeypatch):
    prof, hooks, events = _served_spans(topology, profiled=True)
    got = collections.Counter(e.name for e in events if e.name.startswith(tobs.profile.RANGE_PREFIX))
    assert got == collections.Counter(tobs.profile.RANGE_PREFIX + sp.name for sp in prof.spans)
    assert got["serving.round"] == got["serving.slice"] == got["serving.plan"] == 4
    # no range may read as the benchmark's own or as a kernel's
    assert not any("calib_gate" in name or "flash_attention" in name for name in got)
    # without a recording profiler the spans open no range
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    prof, _, _ = _served_spans(topology)
    assert prof.n_rounds == 4 and opened == []


def test_profiler_spans_unit():
    p = tobs.PhaseProfiler()
    p.count("syncs")  # outside a round: round -1
    p.open_round()
    with p.phase("a"):
        p.count("syncs", 2)
        with p.phase("b"):
            pass
    p.open("c")
    p.switch("d")
    p.close()
    p.close()
    p.open_round()
    p.open("e")
    with pytest.raises(RuntimeError, match="open"):
        p.reset()
    p.close_all()
    assert [(s.name, s.round, s.parent) for s in p.spans] == [
        ("round", 0, -1), ("a", 0, 0), ("b", 0, 1), ("c", 0, 0), ("d", 0, 0), ("round", 1, -1), ("e", 1, 5)]
    assert p.counters == {"syncs": {-1: 1, 0: 2}}
    assert p.n_rounds == 2 and p.counts == {"a": 1, "b": 1, "c": 1, "d": 1, "e": 1}
    st = p.self_times()
    sp = p.spans
    assert st[1] == pytest.approx((sp[1].end - sp[1].start) - (sp[2].end - sp[2].start))
    assert st[0] == pytest.approx(sum(s.end - s.start for s in sp[:1]) - sum(
        s.end - s.start for s in sp if s.parent == 0))
    assert st[2] == sp[2].end - sp[2].start  # a leaf
    assert set(p.summarize()) == {"a", "b", "c", "d", "e", "total_s"}
    p.reset()
    assert not p and p.spans == [] and p.counters == {} and p.n_rounds == 0


def test_engines_call_only_the_null_profilers_methods():
    """Every method the serving loop, the round engine, the planner and
    ``aot_split`` call on their profiler is one of ``PROFILER_CALLS``,
    which both profilers have with the same parameters."""
    src = "\n".join(inspect.getsource(m) for m in (teng, tet, tfleet))
    src += inspect.getsource(tobs.profile.aot_split)
    called = set(re.findall(r"(?<![\w.])(?:self\.)?prof(?:iler)?\.(\w+)\(", src))
    assert called == set(PROFILER_CALLS)
    for name in PROFILER_CALLS:
        full = inspect.signature(getattr(tobs.PhaseProfiler, name)).parameters
        null = inspect.signature(getattr(tobs.NullProfiler, name)).parameters
        assert list(full) == list(null), name


@pytest.mark.parametrize("name", PROFILER_CALLS)
def test_null_profiler_reads_no_clock_and_opens_no_range(name, monkeypatch):
    """Each method of ``NULL_PROFILER`` returns at once: no clock read, no
    ``record_function`` range under a recording ``torch.profiler``, nothing
    kept; ``phase`` hands back one shared context that does nothing."""
    def boom(*args, **kw):
        raise AssertionError("read a clock or opened a range")

    monkeypatch.setattr(tobs.profile, "time", type("Clockless", (), {"perf_counter": staticmethod(boom)}))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    args = {"open": ("x",), "switch": ("x",), "count": ("syncs", 2), "add": ("x", 0.5),
            "phase": ("x",)}.get(name, ())
    null = tobs.NULL_PROFILER
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="clock"):
            tobs.PhaseProfiler().open("x")  # the patches bite the real profiler
        out = getattr(null, name)(*args)
        if name == "phase":
            assert out is null.phase("y")
            with out:
                pass
        else:
            assert out is None
    assert tobs.profile._ranges_open == 0
    assert not hasattr(null, "__dict__")


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("topology", ["degenerate", "fabric", "churn"])
def test_telemetry_off_calls_no_phase_profiler(topology, backend, monkeypatch):
    """A CPU server without telemetry sends its spans to ``NULL_PROFILER``
    and calls no ``PhaseProfiler`` method (each made to raise), and serves
    the same metrics and round hooks as with ``Telemetry(record=False,
    profile=True)``."""
    tel = tobs.Telemetry(record=False, profile=True)
    on_hooks, off_hooks = [], []
    m_on, s_on = _run("torch", topology, tel, backend, on_hooks)
    assert s_on.profiler is tel.profiler and tel.profiler.n_rounds == (4 if backend == "numpy" else 0)

    def refuse(name):
        def call(*args, **kw):
            raise AssertionError(f"PhaseProfiler.{name} called with telemetry off")
        return call

    for name in PROFILER_CALLS:
        monkeypatch.setattr(tobs.PhaseProfiler, name, refuse(name))
    m_off, s_off = _run("torch", topology, None, backend, off_hooks)
    assert s_off.profiler is s_off.fleet.profiler is tobs.NULL_PROFILER
    assert m_off.summary() == m_on.summary()
    for k in ("_frames", "_offloaded", "_missed", "_correct"):
        np.testing.assert_array_equal(getattr(m_off, k), getattr(m_on, k))
    assert len(off_hooks) == len(on_hooks) == 4
    for r, (a, b) in enumerate(zip(on_hooks, off_hooks)):
        assert set(a) == set(b), r
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), (r, k)


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
