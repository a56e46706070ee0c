"""Network simulator for the paper's testbed regime (port of ``repro.core.netsim``).

Serial uplink with (possibly time-varying) bandwidth, fixed latency and a
server processing time; deterministic given a seed.  Bandwidths are in
megabits/s at the API surface (``mbps``), bytes/s inside.  Host numpy,
float64, exactly as the reference.

Bandwidth can vary with time two ways, composable:

  * ``jitter`` — a per-second factor drawn from ``default_rng((seed,
    second))`` (the reference's "pcg" mode);
  * ``trace`` — a ``net.traces.BandwidthTrace`` (piecewise-constant replay
    of a cellular or WiFi profile); when set it replaces ``bandwidth_bps``
    as the base rate and jitter multiplies on top.

The reference's ``jitter_mode="counter"`` takes its bits from JAX's
threefry generator so that its compiled round loop sees the same channel;
it comes with that loop (ROADMAP A.9) and raises here.

``transmit`` queues one transfer; ``upload_batch`` a whole round in array
order (the wire only: transmission-complete times), which is what the edge
fabric (``net/fabric.py``) routes each cell's uploads through;
``transmit_batch`` is ``upload_batch`` plus the lumped server time and
latency, the paper's single-server abstraction.  All of them move the same
busy cursor and the same contention counters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# cap on fixed-point sweeps before falling back to the exact serial loop
_FIXED_POINT_SWEEPS = 50


def mbps(x: float) -> float:
    """Megabits/s -> bytes/s."""
    return x * 1e6 / 8.0


@dataclass
class Uplink:
    bandwidth_bps: float  # bytes per second (base rate)
    latency: float  # seconds (one-way + reply, lumped as L in the paper)
    server_time: float  # T^o
    jitter: float = 0.0  # relative bandwidth jitter
    seed: int = 0
    jitter_mode: str = "pcg"
    trace: Optional[object] = None  # BandwidthTrace (duck-typed: .bandwidth_at, .mean_bps)
    _busy_until: float = 0.0
    _jit_keys: Optional[np.ndarray] = field(default=None, repr=False)
    _jit_vals: Optional[np.ndarray] = field(default=None, repr=False)
    # contention accounting (updated by transmit / upload_batch)
    n_transfers: int = 0
    busy_seconds: float = 0.0  # total wire time
    queued_seconds: float = 0.0  # total head-of-line blocking across transfers
    # per-row start times of the most recent upload_batch
    last_starts: Optional[np.ndarray] = field(default=None, repr=False)

    def __post_init__(self):
        if self.jitter_mode == "counter":
            raise NotImplementedError(
                "jitter_mode='counter' needs JAX's threefry bits; it comes with the compiled"
                " round loop (ROADMAP A.9; listed under A.7 before)")
        if self.jitter_mode != "pcg":
            raise ValueError(f"jitter_mode must be 'pcg' or 'counter', got {self.jitter_mode!r}")
        self._jit_keys = np.zeros(0, dtype=np.int64)
        self._jit_vals = np.zeros(0, dtype=np.float64)

    # -- bandwidth model -------------------------------------------------- #

    def _jitter_factors(self, seconds: np.ndarray) -> np.ndarray:
        """Per-second factors for the requested integer seconds, cached;
        each second's factor comes from its own ``default_rng((seed, s))``."""
        if len(seconds) == 0:
            return np.zeros(0, dtype=np.float64)
        uniq = np.unique(seconds)
        new = uniq[~np.isin(uniq, self._jit_keys)]
        if len(new):
            vals = np.asarray([
                np.clip(1.0 + self.jitter *
                        np.random.default_rng((self.seed, int(s))).standard_normal(), 0.2, 2.0)
                for s in new])
            keys = np.concatenate([self._jit_keys, new])
            order = np.argsort(keys)
            self._jit_keys = keys[order]
            self._jit_vals = np.concatenate([self._jit_vals, vals])[order]
        return self._jit_vals[np.searchsorted(self._jit_keys, seconds)]

    def bandwidth_at(self, t) -> np.ndarray:
        """Vectorized instantaneous bandwidth (bytes/s) at times ``t``."""
        t = np.asarray(t, dtype=np.float64)
        base = (np.asarray(self.trace.bandwidth_at(t), dtype=np.float64)
                if self.trace is not None
                else np.full(t.shape, self.bandwidth_bps))
        if self.jitter > 0:
            base = base * self._jitter_factors(t.astype(np.int64))
        return base

    @property
    def _varying(self) -> bool:
        return self.jitter > 0 or self.trace is not None

    def current_bandwidth(self, t: float) -> float:
        return float(self.bandwidth_at(np.asarray([t]))[0])

    # -- transfers --------------------------------------------------------- #

    def transmit(self, payload_bytes: float, t_submit: float) -> float:
        """Queue one transfer; returns the time the *reply* lands."""
        start = max(t_submit, self._busy_until)
        bw = self.current_bandwidth(start)
        end_tx = start + payload_bytes / bw
        self._busy_until = end_tx
        self.n_transfers += 1
        self.busy_seconds += end_tx - start
        self.queued_seconds += start - t_submit
        return end_tx + self.server_time + self.latency

    def _lindley(self, tx: np.ndarray, subs: np.ndarray) -> np.ndarray:
        """end_i = max(t_submit_i, end_{i-1}) + tx_i with end_{-1} = busy,
        as one cumsum + running max (max-plus / Lindley recursion)."""
        csum = np.cumsum(tx)
        eff = np.maximum(subs, self._busy_until) - (csum - tx)
        return np.maximum.accumulate(eff) + csum

    def upload_batch(self, payload_bytes, t_submit) -> np.ndarray:
        """Queue many transfers in array order; returns the time each
        *transmission* completes (no server time or latency) and updates the
        busy cursor and the counters, exactly as one ``transmit`` per
        element would.  Time-varying bandwidth is solved by fixed-point
        iteration over the start times, with the serial loop as the safety
        net."""
        payloads = np.asarray(payload_bytes, dtype=np.float64)
        subs = np.asarray(t_submit, dtype=np.float64)
        if payloads.size == 0:
            self.last_starts = np.zeros(0, dtype=np.float64)
            return np.zeros(0, dtype=np.float64)
        if not self._varying:
            tx = payloads / self.bandwidth_bps
            end_tx = self._lindley(tx, subs)
        else:
            starts = np.maximum(subs, self._busy_until)
            for _ in range(_FIXED_POINT_SWEEPS):
                tx = payloads / self.bandwidth_at(starts)
                end_tx = self._lindley(tx, subs)
                new_starts = end_tx - tx
                if np.array_equal(new_starts, starts):
                    break
                starts = new_starts
            else:  # did not settle: fall back to the exact serial loop
                end_tx = np.empty(len(payloads), dtype=np.float64)
                busy = self._busy_until
                for i in range(len(payloads)):
                    s = max(subs[i], busy)
                    busy = s + payloads[i] / self.current_bandwidth(s)
                    end_tx[i] = busy
                tx = end_tx - np.maximum(subs, np.r_[self._busy_until, end_tx[:-1]])
        starts = end_tx - tx
        self.last_starts = starts
        self._busy_until = float(end_tx[-1])
        self.n_transfers += payloads.size
        self.busy_seconds += float(tx.sum())
        self.queued_seconds += float(np.clip(starts - subs, 0.0, None).sum())
        return end_tx

    def transmit_batch(self, payload_bytes, t_submit) -> np.ndarray:
        """``upload_batch`` plus the lumped server+latency tail: reply-land
        times under the paper's single-server abstraction."""
        end_tx = self.upload_batch(payload_bytes, t_submit)
        if end_tx.size == 0:
            return end_tx
        return end_tx + self.server_time + self.latency

    def would_land_at(self, payload_bytes: float, t_submit: float) -> float:
        """Predicted reply-land time of the next transfer, without queueing it."""
        start = max(t_submit, self._busy_until)
        bw = self.current_bandwidth(start)
        return start + payload_bytes / bw + self.server_time + self.latency

    def utilization(self, horizon: float) -> float:
        """Wire time over [0, horizon]; above 1.0 means overload."""
        return self.busy_seconds / max(horizon, 1e-12)

    def reset(self):
        self._busy_until = 0.0
        self.n_transfers = 0
        self.busy_seconds = 0.0
        self.queued_seconds = 0.0


def png_size_model(res, *, base_res: int = 224, base_bytes: float = 60_000.0):
    """Approximate lossless-PNG payload size vs resolution (scales ~ r²);
    scalar in, float out; array in, float64 array out."""
    res = np.asarray(res, dtype=np.float64)
    out = base_bytes * (res / base_res) ** 2
    return float(out) if out.ndim == 0 else out


def payload_sizes(size_of, res) -> np.ndarray:
    """Vectorized ``size_of`` with a per-element fallback for scalar-only callables."""
    res = np.asarray(res)
    try:
        out = np.asarray(size_of(res), dtype=np.float64)
        if out.shape == res.shape:
            return out
    except (TypeError, ValueError):
        pass
    return np.asarray([float(size_of(int(r))) for r in res.ravel()],
                      dtype=np.float64).reshape(res.shape)


def transfer_seconds(lands, t_submit, *, latency: float, server_time) -> np.ndarray:
    """Observed wire time per transfer: reply-land minus submit minus the
    known round-trip components (what bandwidth estimators feed on)."""
    return np.asarray(lands, dtype=np.float64) - np.asarray(t_submit, dtype=np.float64) \
        - latency - server_time
