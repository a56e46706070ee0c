"""The port's bandwidth traces and trace-driven uplinks against the JAX
package's ``repro.net.traces`` / ``repro.core.netsim``.

Both are host numpy in float64: the generators' breakpoints and rates, the
trace lookups and the per-second jitter on top are bit-equal.  A
trace-driven ``Uplink`` solves its transfers by the same fixed-point
iteration over the same rates, so its landing times agree within
``LAT_ATOL`` (they come out bit-equal).  A traced cell's nominal rate is
the trace's time-weighted mean in both.  The reference's counter-mode
jitter (JAX threefry bits) still raises, naming ROADMAP A.9.
"""
import numpy as np
import pytest

import repro.core.netsim as jnet
import repro.net as jfab
import repro.net.traces as jtr
import repro_torch.core.netsim as tnet
import repro_torch.net as tfab
import repro_torch.net.traces as ttr
from _diff import LAT_ATOL

GENERATORS = {
    "lte": ("lte_trace", dict(duration=60.0, mean_mbps=6.0, seed=0)),
    "lte-fady": ("lte_trace", dict(duration=33.3, mean_mbps=2.0, step=0.25, fade_prob=0.2, seed=5)),
    "lte-noloop": ("lte_trace", dict(duration=10.0, seed=2, loop=False)),
    "wifi": ("wifi_trace", dict(seed=1)),
    "wifi-bursty": ("wifi_trace", dict(duration=45.0, p_bad=0.3, p_recover=0.1, wobble=0.4, seed=7)),
    "regime": ("regime_shift_trace", dict(levels_mbps=(20.0, 2.0))),
    "regime3": ("regime_shift_trace", dict(levels_mbps=(8.0, 1.0, 30.0), period=2.5, loop=False)),
}


def _pair(kind):
    name, kw = GENERATORS[kind]
    return getattr(ttr, name)(**kw), getattr(jtr, name)(**kw)


@pytest.mark.parametrize("kind", list(GENERATORS))
def test_generators_bit_equal(kind):
    got, ref = _pair(kind)
    assert got.t.dtype == np.float64 and got.bps.dtype == np.float64
    np.testing.assert_array_equal(got.t, ref.t)
    np.testing.assert_array_equal(got.bps, ref.bps)
    assert (got.loop, got.duration, len(got)) == (ref.loop, ref.duration, len(ref))
    assert got.mean_bps == ref.mean_bps


@pytest.mark.parametrize("kind", list(GENERATORS))
def test_bandwidth_at_bit_equal(kind):
    got, ref = _pair(kind)
    rng = np.random.default_rng(3)
    ts = np.concatenate([got.t, np.nextafter(got.t, -np.inf), got.t + 1e-9,  # breakpoints
                         [got.duration, got.duration * 2.5, 1e6, -0.5],  # wrap-around
                         rng.uniform(0, 3 * got.duration, 500)])
    np.testing.assert_array_equal(got.bandwidth_at(ts), ref.bandwidth_at(ts))
    grid = rng.uniform(0, 10, (4, 7))  # shape kept
    assert got.bandwidth_at(grid).shape == (4, 7)
    np.testing.assert_array_equal(got.bandwidth_at(grid), ref.bandwidth_at(grid))


def test_hand_built_trace_matches_reference():
    kw = dict(t=np.array([0.0, 0.4, 1.7, 2.0]), bps=np.array([3e5, 1e6, 2e4, 7e5]), loop=True)
    got, ref = ttr.BandwidthTrace(**kw), jtr.BandwidthTrace(**kw)
    assert got.duration == ref.duration and got.mean_bps == ref.mean_bps
    ts = np.linspace(-1, 9, 1001)
    np.testing.assert_array_equal(got.bandwidth_at(ts), ref.bandwidth_at(ts))
    a = ttr.BandwidthTrace.from_mbps([0.0, 1.0], [4.0, 8.0])
    b = jtr.BandwidthTrace.from_mbps([0.0, 1.0], [4.0, 8.0])
    np.testing.assert_array_equal(a.bps, b.bps)


BAD_TRACES = [
    (dict(t=[1.0, 2.0], bps=[1e6, 2e6]), "start at 0.0"),
    (dict(t=[0.0, 1.0, 1.0], bps=[1e6, 2e6, 3e6]), "ascending"),
    (dict(t=[0.0, 1.0], bps=[1e6, 0.0]), "positive"),
    (dict(t=[0.0, 1.0], bps=[1e6]), "matching"),
    (dict(t=[0.0, 5.0], bps=[1e6, 2e6], loop=True, duration=4.0), "cover every breakpoint"),
]


@pytest.mark.parametrize("kw,match", BAD_TRACES)
def test_trace_validation_matches_reference(kw, match):
    for mod in (ttr, jtr):
        with pytest.raises(ValueError, match=match):
            mod.BandwidthTrace(**{k: np.asarray(v) if k in ("t", "bps") else v for k, v in kw.items()})
    with pytest.raises(ValueError, match="two levels"):
        ttr.regime_shift_trace((5.0,))


UPLINKS = {
    "lte": dict(trace="lte"),
    "wifi": dict(trace="wifi"),
    "regime": dict(trace="regime"),
    "lte+jitter": dict(trace="lte-fady", jitter=0.3, seed=4),
    "wifi+jitter": dict(trace="wifi-bursty", jitter=0.9, seed=11),
}


def _uplinks(kind):
    kw = dict(UPLINKS[kind])
    got_tr, ref_tr = _pair(kw.pop("trace"))
    common = dict(bandwidth_bps=jnet.mbps(5.0), latency=0.05, server_time=0.037, **kw)
    return tnet.Uplink(trace=got_tr, **common), jnet.Uplink(trace=ref_tr, **common)


@pytest.mark.parametrize("kind", list(UPLINKS))
def test_trace_uplink_transfers_match_reference(kind):
    tu, ju = _uplinks(kind)
    rng = np.random.default_rng(8)
    t0 = 0.0
    for _ in range(6):
        n = int(rng.integers(1, 40))
        subs = t0 + np.sort(rng.uniform(0, 1.5, n))
        pay = tnet.png_size_model(rng.choice([45, 90, 134, 179, 224], n))
        np.testing.assert_array_equal(tu.bandwidth_at(subs), ju.bandwidth_at(subs))
        got, ref = tu.transmit_batch(pay, subs), ju.transmit_batch(pay, subs)
        np.testing.assert_allclose(got, ref, rtol=0, atol=LAT_ATOL)
        np.testing.assert_array_equal(got, ref)  # the same float64 arithmetic
        p, t = float(rng.uniform(1e3, 6e4)), float(t0 + rng.uniform(0, 2))
        assert tu.would_land_at(p, t) == pytest.approx(ju.would_land_at(p, t), abs=LAT_ATOL)
        assert tu.transmit(p, t) == pytest.approx(ju.transmit(p, t), abs=LAT_ATOL)
        t0 += 1.7
    for f in ("_busy_until", "n_transfers", "busy_seconds", "queued_seconds"):
        assert getattr(tu, f) == pytest.approx(getattr(ju, f), abs=LAT_ATOL), f
    assert tu._varying


def test_uplink_trace_replaces_base_rate():
    tr = ttr.regime_shift_trace((8.0, 1.0), period=1.0)
    up = tnet.Uplink(bandwidth_bps=123.0, latency=0.0, server_time=0.0, trace=tr)
    assert up.bandwidth_at(np.array([0.5, 1.5])).tolist() == [tnet.mbps(8.0), tnet.mbps(1.0)]
    # a 1 Mbit transfer starting at 0.5 s takes 0.125 s at 8 Mbps
    assert up.transmit(125_000.0, 0.5) == pytest.approx(0.625, abs=1e-12)


def _fabrics(pkg_net, pkg_fab, pkg_tr):
    traces = [pkg_tr.lte_trace(mean_mbps=6, seed=0), pkg_tr.wifi_trace(seed=1), None]
    return pkg_fab.EdgeFabric.build(n_streams=7, n_cells=3, n_replicas=2, bandwidth_bps=pkg_net.mbps(4.0),
                                    latency=0.03, server_time=0.16, placement="jsq", traces=traces)


def test_fabric_trace_mean_stream_bandwidth_and_transmit():
    tf, jf = _fabrics(tnet, tfab, ttr), _fabrics(jnet, jfab, jtr)
    np.testing.assert_array_equal(tf.stream_bandwidth(), jf.stream_bandwidth())
    bw = tf.stream_bandwidth()
    assert bw[tf.cell_of == 0][0] == ttr.lte_trace(mean_mbps=6, seed=0).mean_bps
    assert bw[tf.cell_of == 2][0] == tnet.mbps(4.0)  # untraced cell: the nominal rate
    rng = np.random.default_rng(2)
    t0 = 0.0
    for _ in range(5):
        n = int(rng.integers(1, 25))
        stream = rng.integers(0, 7, n)
        subs = np.sort(t0 + rng.uniform(0, 0.5, n))
        pay = rng.uniform(2e3, 6e4, n)
        scale = rng.choice([1.0, 0.5, 0.083], n)
        np.testing.assert_allclose(tf.transmit(stream, pay, subs, service_scale=scale),
                                   jf.transmit(stream, pay, subs, service_scale=scale), rtol=0, atol=LAT_ATOL)
        t0 += 0.5
    with pytest.raises(ValueError, match="one trace"):
        tfab.EdgeFabric.build(n_streams=2, n_cells=2, traces=[None])


def test_counter_jitter_still_raises_naming_a9():
    with pytest.raises(NotImplementedError, match="A.9"):
        tnet.Uplink(bandwidth_bps=1e6, latency=0.05, server_time=0.037, jitter=0.2, jitter_mode="counter",
                    trace=ttr.wifi_trace())
