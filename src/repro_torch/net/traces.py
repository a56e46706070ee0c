"""Trace-driven bandwidth: piecewise-constant replay and synthetic
generators (port of ``repro.net.traces``; host numpy, float64, as the
reference).

Real cellular and WiFi links fade, burst and shift regime; that
non-stationarity is what stresses the EWMA bandwidth estimators the
deployment loop plans with.  ``BandwidthTrace`` replays a piecewise-constant
rate profile through ``Uplink.bandwidth_at``: one vectorized
``searchsorted`` over the breakpoints.

Generators (deterministic given a seed):

  * ``lte_trace``          — log-space random walk with occasional deep
                             fades, the shape of drive-test LTE datasets;
  * ``wifi_trace``         — two-state good/bad channel (interference
                             bursts) with in-state wobble;
  * ``regime_shift_trace`` — square wave between rate levels.

Values are bytes/s inside (like ``Uplink.bandwidth_bps``); the generators
take megabits/s at the API surface.  The reference's padded ``grid`` for a
compiled round loop comes with that loop (ROADMAP A.9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.netsim import mbps

__all__ = ["BandwidthTrace", "lte_trace", "wifi_trace", "regime_shift_trace"]


@dataclass(frozen=True)
class BandwidthTrace:
    """Piecewise-constant bandwidth profile.

    ``bps[i]`` is the rate over ``[t[i], t[i+1])``; the last segment holds
    forever unless ``loop`` is set, in which case the profile repeats with
    period ``duration``.  ``t`` must be ascending and start at 0.0 so every
    simulated instant is covered.
    """

    t: np.ndarray  # (T,) segment start times, ascending, t[0] == 0.0
    bps: np.ndarray  # (T,) bytes/s per segment
    loop: bool = False
    duration: float = 0.0  # loop period; defaults to t[-1] + median segment

    def __post_init__(self):
        t = np.asarray(self.t, dtype=np.float64)
        bps = np.asarray(self.bps, dtype=np.float64)
        if t.ndim != 1 or t.shape != bps.shape or len(t) == 0:
            raise ValueError("trace needs matching 1-D t and bps arrays")
        if t[0] != 0.0 or (np.diff(t) <= 0).any():
            raise ValueError("trace times must be ascending and start at 0.0")
        if (bps <= 0).any():
            raise ValueError("trace bandwidths must be positive")
        object.__setattr__(self, "t", t)
        object.__setattr__(self, "bps", bps)
        if self.duration <= 0:
            # default period: last breakpoint plus one median segment length
            # (== the grid step for the uniform grids the generators emit);
            # pass duration explicitly for non-uniform hand-built traces
            gap = float(np.median(np.diff(t))) if len(t) > 1 else 1.0
            object.__setattr__(self, "duration", float(t[-1]) + gap)
        elif self.duration < t[-1]:
            raise ValueError("loop duration must cover every breakpoint")

    def __len__(self) -> int:
        return len(self.t)

    def bandwidth_at(self, ts) -> np.ndarray:
        """Vectorized lookup: rate in effect at each time (bytes/s)."""
        ts = np.asarray(ts, dtype=np.float64)
        if self.loop:
            ts = np.mod(ts, self.duration)
        idx = np.searchsorted(self.t, ts, side="right") - 1
        return self.bps[np.clip(idx, 0, len(self.t) - 1)]

    @property
    def mean_bps(self) -> float:
        """Time-weighted mean rate over one period (segment-length weighted)."""
        seg = np.diff(np.r_[self.t, self.duration])
        return float((self.bps * seg).sum() / max(seg.sum(), 1e-12))

    @classmethod
    def from_mbps(cls, t, rates_mbps, **kw) -> "BandwidthTrace":
        return cls(t=np.asarray(t, dtype=np.float64),
                   bps=np.asarray([mbps(float(r)) for r in np.asarray(rates_mbps).ravel()]),
                   **kw)


def lte_trace(duration: float = 120.0, *, mean_mbps: float = 6.0, step: float = 1.0,
              sigma: float = 0.25, fade_prob: float = 0.03, fade_depth: float = 8.0,
              seed: int = 0, loop: bool = True) -> BandwidthTrace:
    """Cellular-shaped trace: mean-reverting log-space walk + deep fades.

    The walk keeps the rate log-normally distributed around ``mean_mbps``;
    with probability ``fade_prob`` per step the channel drops by
    ``fade_depth``x for one step (handover / shadowing), the signature that
    makes LTE drive tests so much burstier than their mean suggests.
    """
    rng = np.random.default_rng(seed)
    n = max(int(np.ceil(duration / step)), 1)
    log_r = np.empty(n)
    x = 0.0
    for i in range(n):
        x = 0.85 * x + sigma * rng.standard_normal()  # AR(1) around the mean
        log_r[i] = x
    rates = mean_mbps * np.exp(log_r - log_r.mean())
    fades = rng.random(n) < fade_prob
    rates = np.where(fades, rates / fade_depth, rates)
    return BandwidthTrace.from_mbps(np.arange(n) * step, np.maximum(rates, 0.05),
                                    loop=loop, duration=n * step)


def wifi_trace(duration: float = 120.0, *, good_mbps: float = 30.0, bad_mbps: float = 3.0,
               step: float = 0.5, p_bad: float = 0.08, p_recover: float = 0.4,
               wobble: float = 0.15, seed: int = 0, loop: bool = True) -> BandwidthTrace:
    """WiFi-shaped trace: two-state Gilbert channel with in-state wobble.

    Good state near ``good_mbps``; interference bursts drop to ``bad_mbps``
    and persist geometrically (``p_recover`` per step to heal)."""
    rng = np.random.default_rng(seed)
    n = max(int(np.ceil(duration / step)), 1)
    rates = np.empty(n)
    bad = False
    for i in range(n):
        bad = (not bad and rng.random() < p_bad) or (bad and rng.random() >= p_recover)
        base = bad_mbps if bad else good_mbps
        rates[i] = base * float(np.clip(1.0 + wobble * rng.standard_normal(), 0.3, 1.7))
    return BandwidthTrace.from_mbps(np.arange(n) * step, rates,
                                    loop=loop, duration=n * step)


def regime_shift_trace(levels_mbps=(20.0, 2.0), *, period: float = 10.0,
                       loop: bool = True) -> BandwidthTrace:
    """Square wave cycling through ``levels_mbps``, ``period`` seconds each —
    the deterministic stimulus for testing how fast EWMA estimators re-lock
    after an abrupt regime change (cell handover, mmWave blockage)."""
    levels = np.asarray(levels_mbps, dtype=np.float64)
    if len(levels) < 2:
        raise ValueError("need at least two levels to shift between")
    t = np.arange(len(levels)) * float(period)
    return BandwidthTrace.from_mbps(t, levels, loop=loop,
                                    duration=len(levels) * float(period))
