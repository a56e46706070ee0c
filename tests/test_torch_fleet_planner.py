"""The port's fixed-shape fleet planner (``repro_torch.policy.fleet_torch``
behind ``FleetRunner(backend="torch")``) against the JAX package's numpy
``FleetRunner`` and its compiled ``FleetRunner(backend="jax")``.

On the same seeded backlogs (``test_fleet_jax.fuzz_backlog``: 1/32 arrival
grid, so the float32 prune and deadline compares are tie-free) every
integer field of the ``PlanBatch`` is bit-equal to both references; theta
within ``THETA_ATOL`` (1e-6: a copied float32 confidence against the
float64 one), total gain and base accuracy within 1e-4 (float32 sums).
Against ``fleet_jax`` directly: ``PlanOut``'s decision rows and its
``overflow`` / ``inexact`` flags bit-equal, the segment ops' padded grids
bit-equal slot for slot (garbage slots included), and ``ewma_fold``
bit-equal (the reference's update compiles to one fused multiply-add,
which the port computes exactly).  Everything runs on the CPU here;
``tests/test_torch_cuda.py`` holds the card against the CPU.

JAX compiles are kept to one jitted planner per spec and fleet size.
"""
import dataclasses
import functools
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.policy.fleet as jfleet
import repro.policy.fleet_jax as fj
import repro_torch.policy.fleet as tfleet
import repro_torch.policy.fleet_torch as ft
from _diff import THETA_ATOL, assert_fleet_equal, canonical_actions
from repro.core.netsim import png_size_model as jax_png
from repro.policy.registry import make_policy as jmake
from repro_torch.core.netsim import png_size_model
from repro_torch.policy.registry import make_policy as tmake
from repro_torch.policy.types import ActionTable
from test_fleet_jax import assert_plan_equal, fuzz_backlog

POLICIES = ["cbo", "threshold", "local", "server", "greedy-rate"]
COMMON = dict(resolutions=(4, 8), acc_server=(0.7, 0.99), deadline=0.2, latency=0.05,
              server_time=0.037, bw_init=50e6 / 8)


def _torch_actions():
    """``_diff.canonical_actions`` as the port's ``ActionTable``."""
    a = canonical_actions()
    return ActionTable(kind=a.kind, res=a.res, cut=a.cut, sizes=a.sizes, acc=a.acc,
                       t_dev=a.t_dev, srv_frac=a.srv_frac, names=a.names)


def _policies(make, names):
    out = []
    for name, mb in names:
        kw = {"max_backlog": mb}
        if name == "server":
            kw["frame_interval"] = 1.0 / 32.0
        out.append(make(name, **kw))
    return out


def make_runner(side, names, backend, actions=False):
    """A ``FleetRunner`` of the port (``side="torch"``) or of the reference
    over policies ``names`` [(registry name, max_backlog)]."""
    if side == "torch":
        kw = dict(device="cpu") if backend == "torch" else {}
        acts = _torch_actions() if actions else None
        return tfleet.FleetRunner(_policies(tmake, names), size_of=png_size_model,
                                  backend=backend, actions=acts, **COMMON, **kw)
    acts = canonical_actions() if actions else None
    return jfleet.FleetRunner(_policies(jmake, names), size_of=jax_png,
                              backend=backend, actions=acts, **COMMON)


@functools.lru_cache(maxsize=None)
def _jax_runner(names, actions=False):
    """One compiled reference runner per fleet (its jitted planners compile
    once per shape); ``_fresh`` empties its state between seeds."""
    return make_runner("jax", list(names), "jax", actions)


def _fresh(runner):
    st = runner.state
    runner.state = type(st)(st.n_streams, max_backlog=[None if b < 0 else int(b) for b in st.max_backlog],
                            cell_id=st.cell_id)
    runner.server_time = COMMON["server_time"]
    return runner


def _plan_three(names, seed, *, S, conf_grid=None, actions=False, server_time=None):
    """Plan one fuzzed backlog with the reference numpy runner, the
    reference JAX runner and the port's torch runner; return the three
    ``PlanBatch``es and the runners."""
    runners = [make_runner("jax", names, "numpy", actions), _fresh(_jax_runner(tuple(names), actions)),
               make_runner("torch", names, "torch", actions)]
    stream, arrival, conf, now, bw, active = fuzz_backlog(S, max(mb for _, mb in names), seed,
                                                          conf_grid=conf_grid)
    plans = []
    for r in runners:
        r.observe_frames(stream, arrival, conf)
        r.bw_est[:] = bw
        if server_time is not None:
            r.server_time = server_time
        plans.append(r.plan_all(now, active))
    return plans, runners


def _assert_three(plans, runners, ctx):
    pn, pj, pt = plans
    assert_plan_equal(pn, pt, ctx=f"{ctx} numpy/torch")
    assert_plan_equal(pj, pt, ctx=f"{ctx} jax/torch")
    for k in ("off_kind", "off_cut"):
        assert np.array_equal(getattr(pn, k), getattr(pt, k)), f"{ctx}: {k}"
    assert_fleet_equal(runners[0].state, runners[2].state)  # post-prune state agrees too


# ------------------------------ FleetRunner parity -------------------------- #


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("S", [1, 3, 17])
def test_planner_parity(policy, S):
    names = [(policy, 12)] * S
    for seed in range(4):
        plans, runners = _plan_three(names, 100 * S + seed, S=S)
        _assert_three(plans, runners, f"{policy} S={S} seed={seed}")


@pytest.mark.parametrize("policy", POLICIES)
def test_planner_parity_tie_heavy(policy):
    # a coarse confidence grid: many exact ties, which the stable sorts and
    # first-maximum picks must break as the references do
    for seed in range(4):
        plans, runners = _plan_three([(policy, 12)] * 9, 7000 + seed, S=9,
                                     conf_grid=(0.3, 0.5, 0.5, 0.7))
        _assert_three(plans, runners, f"tie-heavy {policy} seed={seed}")


@pytest.mark.parametrize("S", [3, 9])
def test_planner_parity_heterogeneous(S):
    # three policy kinds with distinct max_backlogs: one shared pad L,
    # each group planned on its own rows
    mix = (("cbo", 12), ("threshold", 8), ("greedy-rate", 10))
    names = [mix[i % len(mix)] for i in range(S)]
    for seed in range(3):
        plans, runners = _plan_three(names, 4200 + 10 * S + seed, S=S)
        _assert_three(plans, runners, f"het S={S} seed={seed}")
    assert len(runners[2]._torch_planner) == 3
    assert {spec.L for spec, _, _ in runners[2]._torch_planner} == {12}


@pytest.mark.parametrize("S", [3, 17])
def test_planner_parity_split_actions(S):
    # feature actions after the frame actions: per-action prefix times,
    # suffix shares of T^o and static feasibility
    for seed in range(4):
        plans, runners = _plan_three([("cbo", 12)] * S, 900 + 10 * S + seed, S=S, actions=True)
        _assert_three(plans, runners, f"split S={S} seed={seed}")
    assert any((p.off_kind == 1).any() for p in plans), "no feature action planned"


@pytest.mark.parametrize("actions", [False, True], ids=["frames", "split"])
def test_planner_parity_server_time_override(actions):
    # an occupancy-calibrated T^o different from the nominal goes in as a
    # float32 scalar, and the sums around it become float32 arithmetic
    for policy in (["cbo"] if actions else POLICIES):
        for seed in range(3):
            plans, runners = _plan_three([(policy, 12)] * 17, 3100 + seed, S=17, actions=actions,
                                         server_time=0.0515625)
            _assert_three(plans, runners, f"override {policy} split={actions} seed={seed}")


def test_planner_parity_active_mask_and_churn():
    # inactive streams keep empty rows; a second plan after consume and new
    # frames still agrees with the numpy runner
    names = [("cbo", 12)] * 17
    (pn, _, pt), (rn, _, rt) = _plan_three(names, 55, S=17)
    rng = np.random.default_rng(55)
    for r, p in ((rn, pn), (rt, pt)):
        r.consume(p)
    stream = np.repeat(np.arange(17), 3)
    arrival = 3.0 + np.tile(np.arange(3), 17) / 32.0
    conf = rng.uniform(0.05, 0.95, size=len(stream))
    now = np.full(17, 3.0 + 3 / 32.0 + 1 / 64.0)
    active = rng.random(17) < 0.6
    for r in (rn, rt):
        r.observe_frames(stream, arrival, conf)
        r.retire(~active)
    assert_plan_equal(rn.plan_all(now, active), rt.plan_all(now, active), ctx="second round")
    assert_fleet_equal(rn.state, rt.state)


# ------------------------------ plan_fleet against fleet_jax ---------------- #


@functools.lru_cache(maxsize=None)
def _jax_planner(spec):
    return fj.make_planner(spec)


def _specs(kind, F=0, actions=False):
    kw = {"max_backlog": 12}
    if kind == "server":
        kw["frame_interval"] = 1.0 / 32.0
    common = dict(sizes=tuple(png_size_model(np.asarray((4, 8)))), acc_server=(0.7, 0.99),
                  deadline=0.2, latency=0.05, server_time=0.037, F=F)
    js = fj.spec_for_policy(jmake(kind, **kw), actions=canonical_actions() if actions else None,
                            **common)
    ts = ft.spec_for_policy(tmake(kind, **kw), actions=_torch_actions() if actions else None,
                            **common)
    return js, ts


def _padded(S, seed, L=12):
    stream, arrival, conf, now, bw, active = fuzz_backlog(S, L, seed)
    lens = np.bincount(stream, minlength=S)
    now = np.where(np.isfinite(now), now, np.inf)
    jf = fj.pad_fleet(arrival, conf, lens, L)
    tf = ft.pad_fleet(arrival, conf, lens, L, device="cpu")
    return jf, tf, now, bw


def _assert_out_equal(jo, to, ctx):
    for k in ("dec", "resolution", "n_offloads", "n_frames", "overflow", "inexact"):
        a, b = np.asarray(getattr(jo, k)), getattr(to, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{ctx}: {k}"
    np.testing.assert_allclose(to.theta.numpy(), np.asarray(jo.theta), atol=THETA_ATOL, err_msg=ctx)
    for k in ("total_gain", "base_acc"):
        np.testing.assert_allclose(getattr(to, k).numpy(), np.asarray(getattr(jo, k)), atol=1e-4,
                                   err_msg=f"{ctx}: {k}")


@pytest.mark.parametrize("kind,actions", [(k, False) for k in POLICIES] + [("cbo", True)],
                         ids=POLICIES + ["cbo-split"])
def test_plan_out_rows_equal_plan_fleet(kind, actions):
    js, ts = _specs(kind, actions=actions)
    for seed in range(3):
        jf, tf, now, bw = _padded(17, 500 + seed)
        for st in (None, 0.0515625):
            jo = _jax_planner(js)(jf, jnp.asarray(now, jnp.float32), jnp.asarray(bw, jnp.float32),
                                  None if st is None else jnp.asarray(st, jnp.float32))
            to = ft.plan_fleet(ts, tf, torch.as_tensor(now, dtype=torch.float32),
                               torch.as_tensor(bw, dtype=torch.float32), st)
            _assert_out_equal(jo, to, f"{kind} split={actions} seed={seed} st={st}")
            assert not to.overflow.any() and not to.inexact.any()


def test_small_frontier_overflows_in_both():
    js, ts = _specs("cbo", F=2)
    assert ts.frontier == 2
    jf, tf, now, bw = _padded(17, 77)
    jo = _jax_planner(js)(jf, jnp.asarray(now, jnp.float32), jnp.asarray(bw, jnp.float32))
    to = ft.plan_fleet(ts, tf, torch.as_tensor(now, dtype=torch.float32),
                       torch.as_tensor(bw, dtype=torch.float32))
    _assert_out_equal(jo, to, "F=2")
    assert to.overflow.any(), "a 2-state frontier should have truncated"


def test_runner_keeps_frontier_flags():
    # FleetRunner(backend="torch") keeps the PlanOut flags of its last
    # plan_all per stream (False on inactive streams), heterogeneous
    # groups scattered back to their rows
    names = [("cbo", 12), ("threshold", 8), ("cbo", 12)] * 3
    r = make_runner("torch", names, "torch")
    stream, arrival, conf, now, bw, active = fuzz_backlog(9, 12, 77)
    r.observe_frames(stream, arrival, conf)
    r.bw_est[:] = bw
    r.plan_all(now, active)
    for flags in (r.last_overflow, r.last_inexact):
        assert flags.dtype == bool and flags.shape == (9,) and not flags.any()
    # a 2-state frontier in the cbo group must show its truncation
    i, (spec, _, streams) = next((i, g) for i, g in enumerate(r._torch_planner) if g[0].kind == "cbo")
    small = dataclasses.replace(spec, F=2)
    r._torch_planner[i] = (small, ft.make_planner(small, "cpu"), streams)
    r.plan_all(now, active)
    sub = ft.fleet_from_state(r.state, small.L, device="cpu")
    idx = torch.as_tensor(streams)
    out = ft.plan_fleet(small, ft.PaddedFleet(sub.arrival[idx], sub.conf[idx], sub.length[idx]),
                        torch.as_tensor(now[streams], dtype=torch.float32),
                        torch.as_tensor(bw[streams], dtype=torch.float32))
    want = np.zeros(9, dtype=bool)
    want[streams] = out.overflow.numpy()
    assert np.array_equal(r.last_overflow, want & active) and r.last_overflow.any()


def test_pad_fleet_defaults_to_the_card():
    stream, arrival, conf, _, _, _ = fuzz_backlog(5, 12, 3)
    lens = np.bincount(stream, minlength=5)
    assert ft.pad_fleet(arrival, conf, lens, 12, device="cpu").arrival.device == torch.device("cpu")
    state = make_runner("torch", [("cbo", 12)] * 5, "numpy").state
    assert ft.fleet_from_state(state, 12, device="cpu").length.device == torch.device("cpu")
    if not torch.cuda.is_available():  # no device means the card, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            ft.pad_fleet(arrival, conf, lens, 12)
        with pytest.raises(RuntimeError, match="CUDA"):
            ft.fleet_from_state(state, 12)


def test_plan_batch_bridge_equal():
    js, ts = _specs("cbo")
    jf, tf, now, bw = _padded(9, 31)
    jo = _jax_planner(js)(jf, jnp.asarray(now, jnp.float32), jnp.asarray(bw, jnp.float32))
    to = ft.plan_fleet(ts, tf, torch.as_tensor(now, dtype=torch.float32),
                       torch.as_tensor(bw, dtype=torch.float32))
    assert_plan_equal(fj.plan_batch_from_out(jo, 9, 2), ft.plan_batch_from_out(to, 9, 2), ctx="bridge")
    a, b = fj.unpad_fleet(jf), ft.unpad_fleet(tf)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y)


# ------------------------------ segment ops -------------------------------- #


def _random_fleet(rng, S=7, L=12):
    """A padded fleet with garbage in the invalid slots, as both packages
    leave it after compaction."""
    lens = rng.integers(0, L + 1, size=S)
    arr = (rng.integers(0, 64, size=(S, 1)) + np.arange(L)) / 32.0
    conf = rng.uniform(0.05, 0.95, size=(S, L))
    junk = np.arange(L)[None, :] >= lens[:, None]
    arr = np.where(junk, rng.uniform(-5, 5, size=(S, L)), arr).astype(np.float32)
    conf = np.where(junk, rng.uniform(-5, 5, size=(S, L)), conf).astype(np.float32)
    lens = lens.astype(np.int32)
    return (fj.PaddedFleet(jnp.asarray(arr), jnp.asarray(conf), jnp.asarray(lens)),
            ft.PaddedFleet(torch.as_tensor(arr), torch.as_tensor(conf), torch.as_tensor(lens)))


def _assert_fleets_bit_equal(jf, tf, ctx):
    for name, a, b in zip(("arrival", "conf", "length"), jf, tf):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{ctx}: {name}"


@pytest.mark.parametrize("seed", range(4))
def test_segment_ops_bit_equal(seed):
    rng = np.random.default_rng(seed)
    S, L, B = 7, 12, 5
    jf, tf = _random_fleet(rng, S, L)
    now = (rng.integers(0, 80, size=S) / 32.0).astype(np.float32)
    do = rng.random(S) < 0.7
    _assert_fleets_bit_equal(fj.prune_fleet(jf, jnp.asarray(now), 0.2, jnp.asarray(do)),
                             ft.prune_fleet(tf, torch.as_tensor(now), 0.2, torch.as_tensor(do)),
                             "prune")
    take = rng.random((S, L)) < 0.3
    clear = rng.random(S) < 0.2
    _assert_fleets_bit_equal(fj.consume_fleet(jf, jnp.asarray(take), jnp.asarray(clear)),
                             ft.consume_fleet(tf, torch.as_tensor(take), torch.as_tensor(clear)),
                             "consume")
    new_arr = (3.0 + rng.integers(0, 8, size=(S, B)) / 32.0).astype(np.float32)
    new_conf = rng.uniform(0.05, 0.95, size=(S, B)).astype(np.float32)
    new_ok = rng.random((S, B)) < 0.6
    per_stream = rng.integers(4, L + 1, size=S).astype(np.int32)
    for mb, ctx in ((L, "extend, one mb"), (per_stream, "extend, per-stream mb")):
        jmb = mb if np.ndim(mb) == 0 else jnp.asarray(mb)
        tmb = mb if np.ndim(mb) == 0 else torch.as_tensor(mb)
        _assert_fleets_bit_equal(
            fj.extend_fleet(jf, jnp.asarray(new_arr), jnp.asarray(new_conf), jnp.asarray(new_ok), jmb),
            ft.extend_fleet(tf, torch.as_tensor(new_arr), torch.as_tensor(new_conf),
                            torch.as_tensor(new_ok), tmb), ctx)
    mask = rng.random(S) < 0.4
    _assert_fleets_bit_equal(fj.clear_fleet(jf, jnp.asarray(mask)),
                             ft.clear_fleet(tf, torch.as_tensor(mask)), "clear")


# ------------------------------ ewma_fold ---------------------------------- #


@pytest.mark.parametrize("case", ["random", "all-not-ok", "over-deep", "empty-streams"])
def test_ewma_fold_bit_equal(case):
    rng = np.random.default_rng({"random": 0, "all-not-ok": 1, "over-deep": 2, "empty-streams": 3}[case])
    S, N, depth = 40, 160, 6
    if case == "over-deep":  # streams 0-3 carry ~30 observations each, depth 6
        stream = rng.integers(0, 4, size=N)
    elif case == "empty-streams":
        stream = rng.integers(0, 5, size=N) * 8
    else:
        stream = rng.integers(0, S, size=N)
    bw = rng.uniform(1e5, 1e7, size=S).astype(np.float32)
    rate = rng.uniform(1e5, 1e7, size=N).astype(np.float32)
    ok = np.zeros(N, bool) if case == "all-not-ok" else rng.random(N) < 0.7
    want = np.asarray(fj.ewma_fold(jnp.asarray(bw), 0.3, jnp.asarray(stream, jnp.int32),
                                   jnp.asarray(rate), jnp.asarray(ok), S, depth))
    got = ft.ewma_fold(torch.as_tensor(bw), 0.3, torch.as_tensor(stream), torch.as_tensor(rate),
                       torch.as_tensor(ok), S, depth).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want), case
    if case == "all-not-ok":
        assert np.array_equal(got, bw)
    if case == "over-deep":
        assert np.bincount(stream[ok], minlength=S).max() > depth
    with pytest.raises(TypeError, match="float32"):
        ft.ewma_fold(torch.as_tensor(bw, dtype=torch.float64), 0.3, torch.as_tensor(stream),
                     torch.as_tensor(rate), torch.as_tensor(ok), S, depth)


def test_fma_rounds_once():
    """``_fma`` against the exact rational a*b + c rounded once to float32,
    on random values and on sums that sit next to a float32 halfway point
    (where rounding the float64 sum again would go wrong)."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0.5, 1.0, 400).astype(np.float32)
    b = rng.uniform(1e5, 1e7, 400).astype(np.float32)
    c = rng.uniform(1e4, 1e6, 400).astype(np.float32)
    # every fourth c is the float32 nearest to (a float32 midpoint above
    # a*b) - a*b: the exact sum then lies a hair off the midpoint, and its
    # float64 rounding often lands on it
    for i in range(0, 400, 4):
        p = Fraction(float(a[i])) * Fraction(float(b[i]))
        r = np.float32(float(p))
        half = Fraction(float(r)) + Fraction(float(np.spacing(r))) / 2
        c[i] = np.float32(float(half - p))
    got = ft._fma(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()

    def exact(x, y, z):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(v))  # within one f32 step; fix by comparing distances
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - v),
                                         int(np.float32(f).view(np.int32)) & 1))
        return best

    want = np.asarray([exact(x, y, z) for x, y, z in zip(a, b, c)], dtype=np.float32)
    assert np.array_equal(got, want)


def test_first_max_and_stable_sort_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [-torch.inf] * 4, [0.0, 0.0, 5.0, 5.0]])
    assert ft._first_max(x).tolist() == [1, 0, 2]
    key = torch.tensor([[True, False, True, False, False]])
    assert ft._argsort(key).tolist() == [[1, 3, 4, 0, 2]]
    assert ft._argsort(torch.tensor([[2.0, 1.0, 2.0, 1.0]])).tolist() == [[1, 3, 0, 2]]


# ------------------------------ construction and refusals ------------------- #


def test_unsupported_policy_messages_match_reference():
    for names in (["optimal"], ["cbo"], ["threshold", "optimal"]):
        jp = [jmake(n) if n == "optimal" else jmake(n, max_backlog=None) for n in names]
        tp = [tmake(n) if n == "optimal" else tmake(n, max_backlog=None) for n in names]
        want = [r.replace("JAX", "torch") for r in fj.jax_unsupported_policies(jp)]
        assert ft.torch_unsupported_policies(tp) == want
    assert ft.TORCH_PLANNABLE == fj.JAX_PLANNABLE
    assert ft.torch_unsupported_policies([tmake(n, max_backlog=8) for n in POLICIES]) == []
    with pytest.raises(ValueError) as ei:
        tfleet.FleetRunner([tmake("optimal")], size_of=png_size_model, backend="torch",
                           device="cpu", **COMMON)
    assert "no torch planner" in str(ei.value) and "max_backlog" in str(ei.value)
    with pytest.raises(ValueError, match="max_backlog"):
        ft.spec_for_policy(tmake("cbo", max_backlog=None), sizes=(1.0,), acc_server=(0.9,),
                           deadline=0.2, latency=0.05, server_time=0.037)
    with pytest.raises(ValueError, match="pad_L"):
        ft.spec_for_policy(tmake("cbo", max_backlog=12), sizes=(1.0,), acc_server=(0.9,),
                           deadline=0.2, latency=0.05, server_time=0.037, pad_L=8)


def test_runner_backend_and_device_validation():
    pols = lambda: [tmake("cbo", max_backlog=8)]  # noqa: E731
    with pytest.raises(NotImplementedError, match="A.9"):
        tfleet.FleetRunner(pols(), size_of=png_size_model, backend="jax", **COMMON)
    with pytest.raises(ValueError, match="backend"):
        tfleet.FleetRunner(pols(), size_of=png_size_model, backend="tpu", **COMMON)
    r = tfleet.FleetRunner(pols(), size_of=png_size_model, backend="numpy", device="no-such", **COMMON)
    assert r.device is None and r._torch_planner is None  # numpy ignores device
    r = tfleet.FleetRunner(pols(), size_of=png_size_model, backend="torch", device="cpu", **COMMON)
    assert r.device == torch.device("cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tfleet.FleetRunner(pols(), size_of=png_size_model, backend="torch", **COMMON)
        with pytest.raises(RuntimeError, match="CUDA"):
            ft.make_planner(ft.spec_for_policy(pols()[0], sizes=(1.0,), acc_server=(0.9,), deadline=0.2,
                                               latency=0.05, server_time=0.037))


def test_profiler_times_plan_all_on_both_backends():
    from repro_torch.obs import PhaseProfiler

    for backend in ("numpy", "torch"):
        r = make_runner("torch", [("cbo", 12)] * 3, backend)
        r.profiler = PhaseProfiler()
        stream, arrival, conf, now, bw, active = fuzz_backlog(3, 12, 5)
        r.observe_frames(stream, arrival, conf)
        r.plan_all(now, active)
        r.plan_all(now, active)
        assert r.profiler.counts == {"plan": 2}, backend
