"""The port's split offloading against the JAX package's ``repro.split`` and
its action plane.

Catalogs, costs and action tables are host arithmetic in both packages:
shapes and bytes bit-equal, FLOPs and costs equal.  A catalog's int8 wire
size equals what the port's own ``quantize_tensor(x, axis=-1)`` makes of a
real activation.  The frontier planners over split tables give bit-equal
integer decisions and theta within ``THETA_ATOL`` (both float64: exact).
A frames-only table reproduces ``tests/data/fabric_snapshot.json``, and
``MultiStreamServer`` with split actions over trace-driven cells matches
the reference's numpy engine round for round: ``_diff.EXACT_KEYS``
bit-equal, theta within ``THETA_ATOL``, bandwidth estimates within
``BW_RTOL`` and latencies within ``LAT_ATOL``.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core.netsim as jnet
import repro.net as jfab
import repro.policy as jpol
import repro.policy.fleet as jfleet
import repro.quant.quantize as jq
import repro.serving as jsrv
import repro.split as jsplit
import repro_torch.core.netsim as tnet
import repro_torch.net as tfab
import repro_torch.policy as tpol
import repro_torch.policy.fleet as tfleet
import repro_torch.quant.quantize as tq
import repro_torch.serving as tsrv
import repro_torch.split as tsplit
from _diff import THETA_ATOL, assert_round_equal, canonical_actions
from repro.serving.synthetic import synthetic_tiers as jax_synthetic_tiers
from repro_torch.configs.base import LMConfig, get_arch
from repro_torch.configs.deit_b import FULL as DEIT_B
from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers

DATA = os.path.join(os.path.dirname(__file__), "data")
ARCHS = ["resnet-50", "vit-s16", "deit-b", "swin-b"]
TABLE_FIELDS = ("kind", "res", "cut", "sizes", "acc", "t_dev", "srv_frac")


def _catalogs(arch, **kw):
    return tsplit.catalog_for(arch, **kw), jsplit.catalog_for(arch, **kw)


@pytest.mark.parametrize("kw", [{}, dict(max_cuts=4), dict(img_res=160), dict(smoke=True)],
                         ids=["full", "max_cuts4", "res160", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_catalog_bit_equal(arch, kw):
    got, ref = _catalogs(arch, **kw)
    assert (got.model, got.family, got.img_res, len(got)) == (ref.model, ref.family, ref.img_res, len(ref))
    assert got.total_flops == ref.total_flops
    for p, q in zip(got, ref):
        assert (p.cut_id, p.name, p.block, p.n_blocks, p.act_shape) == (q.cut_id, q.name, q.block, q.n_blocks,
                                                                         q.act_shape)
        assert (p.raw_nbytes, p.payload_nbytes) == (q.raw_nbytes, q.payload_nbytes)
        assert (p.prefix_flops, p.total_flops, p.suffix_fraction) == (q.prefix_flops, q.total_flops,
                                                                      q.suffix_fraction)
        assert p.compression == q.compression
    np.testing.assert_array_equal(got.payload_bytes(), ref.payload_bytes())


def test_catalog_from_config_and_registry_agree():
    by_cfg = tsplit.catalog_for(DEIT_B, max_cuts=4)
    by_id = tsplit.catalog_for("deit-b", max_cuts=4)
    assert by_cfg == by_id
    assert [p.act_shape for p in by_cfg] == [(198, 768)] * 4  # 14 x 14 patches + cls + distill
    with pytest.raises(ValueError, match="no split catalog"):
        tsplit.catalog_for(get_arch("stablelm-12b").full)
    assert isinstance(get_arch("stablelm-12b").full, LMConfig)
    with pytest.raises(ValueError, match="no split catalog"):  # as tests/test_split.py holds
        tsplit.catalog_for("dit-b2")


@pytest.mark.parametrize("arch", ARCHS)
def test_payload_bytes_equal_quantized_activation(arch):
    """The analytic wire size against a materialized int8 activation (the
    smoke catalogs' shapes, to keep the tensors small)."""
    cat = tsplit.catalog_for(arch, smoke=True)
    rng = np.random.default_rng(0)
    for p in list(cat)[:3]:
        x = rng.standard_normal(p.act_shape).astype(np.float32)
        q = tq.quantize_tensor(torch.as_tensor(x), axis=-1)
        assert q.values.dtype == torch.int8 and q.scale.shape == (*p.act_shape[:-1], 1)
        assert tsplit.qtensor_nbytes(q) == p.payload_nbytes == tsplit.activation_payload_nbytes(p.act_shape)
        assert jsplit.points.qtensor_nbytes(jq.quantize_tensor(x, axis=-1)) == p.payload_nbytes


@pytest.mark.parametrize("arch", ARCHS)
def test_split_costs_and_action_table_equal(arch):
    got_cat, ref_cat = _catalogs(arch, max_cuts=5)
    for peak in (tsplit.DEFAULT_NPU_PEAK, 2.5e12):
        for c, d in zip(tsplit.split_costs(got_cat, device_peak=peak),
                        jsplit.split_costs(ref_cat, device_peak=peak)):
            assert (c.cut_id, c.t_dev, c.srv_frac, c.t_srv_peak) == (d.cut_id, d.t_dev, d.srv_frac, d.t_srv_peak)
    kw = dict(resolutions=(45, 90, 134, 179, 224), size_of=tnet.png_size_model,
              acc_server=(0.35, 0.5, 0.6, 0.66, 0.7), acc_drop=0.02)
    got = tsplit.build_action_table(got_cat, **kw)
    ref = jsplit.build_action_table(ref_cat, **kw)
    for f in TABLE_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.names == ref.names and got.has_splits and got.n_frame_actions == 5
    np.testing.assert_array_equal(got.rtt(0.16, 0.03), ref.rtt(0.16, 0.03))
    none = tsplit.build_action_table(None, **kw)
    assert not none.has_splits and none.n_actions == 5


def test_action_table_invariants_raise():
    good = tpol.ActionTable.frames_only(sizes=[1.0, 2.0], acc=[0.5, 0.6])
    bad = {f: getattr(good, f).copy() for f in TABLE_FIELDS}
    bad["t_dev"][0] = 1e-3  # a frame action with device time
    with pytest.raises(ValueError, match="frame actions"):
        tpol.ActionTable(**bad)


def _to_port(table):
    return tpol.ActionTable(**{f: getattr(table, f) for f in TABLE_FIELDS}, names=table.names)


def _tables():
    """(port, reference) split tables: ``_diff``'s canonical two-cut table,
    and a DeiT-B catalog over the (4, 8) grid."""
    kw = dict(resolutions=(4, 8), size_of=jnet.png_size_model, acc_server=(0.7, 0.99))
    return {"canonical": (_to_port(canonical_actions()), canonical_actions()),
            "deit-b": (tsplit.build_action_table(tsplit.catalog_for(DEIT_B, max_cuts=4), **kw),
                       jsplit.build_action_table(jsplit.catalog_for("deit-b", max_cuts=4), **kw))}


@pytest.mark.parametrize("table", ["canonical", "deit-b"])
@pytest.mark.parametrize("seed", range(4))
def test_cbo_plan_on_split_tables_bit_equal(table, seed):
    tt, jt = _tables()[table]
    rng = np.random.default_rng(seed)
    sizes = tuple(jt.sizes[:2])
    for trial in range(20):
        k = int(rng.integers(1, 20))
        conf = rng.integers(20, 99, size=k) / 100.0
        env = dict(bandwidth=float(rng.uniform(2e4, 5e6)), latency=0.03, server_time=float(rng.choice([0.037, 0.16])),
                   deadline=0.2, acc_server=(0.7, 0.99))
        now = float(rng.choice([0.0, 0.1]))
        got = tpol.cbo_plan([tpol.Frame(i / 32.0, float(c), sizes) for i, c in enumerate(conf)],
                            tpol.Env(**env, actions=tt), now=now)
        ref = jpol.cbo_plan([jpol.Frame(i / 32.0, float(c), sizes) for i, c in enumerate(conf)],
                            jpol.Env(**env, actions=jt), now=now)
        assert got.offloads == ref.offloads and got.resolution == ref.resolution, trial
        assert got.theta == pytest.approx(ref.theta, abs=THETA_ATOL)
        assert got.total_gain == ref.total_gain


def _states(rng, S):
    ts, js = tfleet.FleetState(S, max_backlog=64), jfleet.FleetState(S, max_backlog=64)
    for s in range(S):
        k = int(rng.integers(0, 16))
        if k:
            args = (np.full(k, s, dtype=np.int64), np.arange(k) / 32.0, rng.integers(20, 99, size=k) / 100.0)
            ts.extend(*args)
            js.extend(*args)
    return ts, js


@pytest.mark.parametrize("table", ["canonical", "deit-b", "frames-only"])
@pytest.mark.parametrize("seed", range(4))
def test_cbo_plan_many_on_split_tables_bit_equal(table, seed):
    tables = _tables()
    tables["frames-only"] = (tpol.ActionTable.frames_only(sizes=tables["canonical"][1].sizes[:2], acc=(0.7, 0.99)),
                             jpol.types.ActionTable.frames_only(sizes=tables["canonical"][1].sizes[:2],
                                                                acc=(0.7, 0.99)))
    tt, jt = tables[table]
    rng = np.random.default_rng(300 + seed)
    S = int(rng.integers(2, 7))
    ts, js = _states(rng, S)
    env = dict(bandwidth=rng.uniform(3e4, 3e6, size=S), latency=0.03, server_time=0.16, deadline=0.2,
               acc_server=(0.7, 0.99), sizes=np.asarray(jt.sizes[:2]))
    now = np.zeros(S)
    got = tpol.cbo_plan_many(ts, tpol.EnvBatch(**env, actions=tt), now)
    ref = jpol.cbo_plan_many(js, jpol.EnvBatch(**env, actions=jt), now)
    for f in ("resolution", "n_offloads", "n_frames", "off_stream", "off_pos", "off_res", "off_kind", "off_cut"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    np.testing.assert_allclose(got.theta, ref.theta, rtol=0, atol=THETA_ATOL)
    if table == "frames-only":  # the degenerate table changes nothing
        plain = tpol.cbo_plan_many(ts, tpol.EnvBatch(**env), now)
        for f in ("theta", "resolution", "off_res", "total_gain"):
            np.testing.assert_array_equal(getattr(got, f), getattr(plain, f), err_msg=f)


def _fabric_cfg(pkg, actions):
    return pkg.ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), batch_size=16, frame_rate=32.0,
                           deadline=0.2, actions=actions)


@pytest.mark.parametrize("case", ["degenerate", "fabric"])
def test_frames_only_table_reproduces_fabric_snapshot(case):
    with open(os.path.join(DATA, "fabric_snapshot.json")) as f:
        snap = json.load(f)[case]
    table = tpol.ActionTable.frames_only(sizes=tnet.payload_sizes(tnet.png_size_model, np.asarray((4, 8))),
                                         acc=(0.7, 0.99))
    cfg = _fabric_cfg(tsrv, table)
    fast, slow, cal = synthetic_tiers()
    if case == "degenerate":
        S = 4
        srv = tsrv.MultiStreamServer(
            cfg, fast, slow, cal, tnet.Uplink(bandwidth_bps=tnet.mbps(50.0), latency=0.05,
                                              server_time=cfg.server_time), n_streams=S, device="cpu")
    else:
        S = 12
        ups = [tnet.Uplink(bandwidth_bps=tnet.mbps(30.0), latency=0.05, server_time=cfg.server_time, seed=c)
               for c in range(2)]
        pool = tfab.ReplicaPool(2, np.array([cfg.server_time, cfg.server_time * 1.5]), serial=True)
        srv = tsrv.MultiStreamServer(cfg, fast, slow, cal, None, n_streams=S, device="cpu",
                                     fabric=tfab.EdgeFabric(ups, pool, n_streams=S, placement="jsq"))
    assert srv.fleet.actions is None  # a degenerate table keeps the frame-only path
    agg = srv.process_streams(*synthetic_streams(S, 64))
    assert int(agg.n_offloaded) == snap["n_offloaded"]
    assert int(agg.n_deadline_miss) == snap["n_deadline_miss"]
    assert agg.accuracy == pytest.approx(snap["accuracy"], abs=1e-12)
    for m, ref in zip(agg.per_stream, snap["per_stream"]):
        assert m.n_frames == ref["n_frames"]
        assert m.accuracy == pytest.approx(ref["accuracy"], abs=1e-12)
        assert m.offload_frac == pytest.approx(ref["offload_frac"], abs=1e-12)
        assert m.deadline_miss_frac == pytest.approx(ref["deadline_miss_frac"], abs=1e-12)


ACC_LADDER = (0.35, 0.5, 0.6, 0.66, 0.7)  # chip_smoke.py's fixed ladder


def _split_server(pkg, which, S, table):
    """One split-enabled fleet over trace-driven cells in package ``pkg``:
    ``canonical`` is ``_diff``'s table on the (4, 8) grid behind two traced
    cells; ``deit-b`` is chip_smoke.py's path-5 regime (the 224 px ladder,
    T^o = 0.16 s, L = 0.03 s, an LTE and a WiFi cell, 2 replicas, jsq)."""
    is_port = pkg is tsrv
    net, fab = (tnet, tfab) if is_port else (jnet, jfab)
    fast, slow, cal = (synthetic_tiers if is_port else jax_synthetic_tiers)()
    traces = [fab.lte_trace(mean_mbps=6, seed=0), fab.wifi_trace(seed=1)]
    if which == "canonical":
        cfg = _fabric_cfg(pkg, table)
        fabric = fab.EdgeFabric.build(n_streams=S, n_cells=2, n_replicas=2, bandwidth_bps=net.mbps(3.0),
                                      latency=0.05, server_time=cfg.server_time, placement="jsq", traces=traces)
    else:
        cfg = pkg.ServeConfig(batch_size=16, acc_server=ACC_LADDER, server_time=0.16, deadline=0.2,
                              actions=table)
        fabric = fab.EdgeFabric.build(n_streams=S, n_cells=2, n_replicas=2, bandwidth_bps=net.mbps(6.0),
                                      latency=0.03, server_time=0.16, placement="jsq", traces=traces)
    kw = dict(device="cpu") if is_port else {}
    return pkg.MultiStreamServer(cfg, fast, slow, cal, None, n_streams=S, fabric=fabric, policy="cbo", **kw)


def _deit_tables():
    kw = dict(resolutions=(45, 90, 134, 179, 224), size_of=jnet.png_size_model, acc_server=ACC_LADDER)
    return (tsplit.build_action_table(tsplit.catalog_for(DEIT_B, max_cuts=4), **kw),
            jsplit.build_action_table(jsplit.catalog_for("deit-b", max_cuts=4), **kw))


@pytest.mark.parametrize("which,S,churn", [("canonical", 6, False), ("canonical", 6, True),
                                           ("deit-b", 8, False), ("deit-b", 8, True)])
def test_split_fleet_matches_numpy_engine_round_for_round(which, S, churn):
    tt, jt = _deit_tables() if which == "deit-b" else (_to_port(canonical_actions()), canonical_actions())
    imgs, labels = synthetic_streams(S, 64, seed=0)
    sched = {}
    if churn:
        rng = np.random.default_rng(1)
        join = rng.integers(0, 32, size=S)
        length = rng.integers(1, 64 - join + 1)
        sched = {m: m.ArrivalSchedule.churn(S, 64, 30.0, 0.2, join=join, length=length) for m in (jsrv, tsrv)}
    recs = {}
    metrics = {}
    for pkg, table in ((jsrv, jt), (tsrv, tt)):
        srv = _split_server(pkg, which, S, table)
        recs[pkg] = []
        srv.round_hook = recs[pkg].append
        metrics[pkg] = srv.process_streams(imgs, labels, schedule=sched.get(pkg))
    assert len(recs[tsrv]) == len(recs[jsrv]) == 4
    for i, (a, b) in enumerate(zip(recs[jsrv], recs[tsrv])):
        assert_round_equal(a, b, ctx=f"{which} round {i}")
    assert metrics[tsrv].summary() == metrics[jsrv].summary()
    kinds = np.concatenate([r["off_kind"] for r in recs[tsrv]])
    assert (kinds == 1).any()  # feature actions were planned
