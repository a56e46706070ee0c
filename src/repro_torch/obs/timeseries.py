"""Per-round fleet time series: the SoA recorder behind ``telemetry=``
(port of ``repro.obs.timeseries``; host numpy, copied).

``FleetRecorder`` captures, once per serving round:

  * cumulative per-stream counters — frames, offloads (landed), misses,
    correct — as ``(S,)`` int64 rows;
  * the planner's view of the world: per-stream bandwidth EWMA
    (``bw_est``) next to the true instantaneous cell bandwidth at the
    round start (``bw_true``), so estimation error is a recorded series;
  * contention state: per-cell and per-replica busy/queued seconds, the
    slow tier's occupancy EWMA (``avg_batch``) and the occupancy-calibrated
    ``server_time`` the planner used this round;
  * the decision mix: a per-round histogram of planned offloads over the
    ``ActionTable`` grid (``action_off``).

Buffers are preallocated struct-of-arrays, grown by doubling: recording a
round is a handful of row writes, no Python per stream.  ``assert_close``
compares two recordings under the exactness policy (integers bit-equal,
floats at tolerance).
"""
from __future__ import annotations

import numpy as np

__all__ = ["FleetRecorder", "relock_lags"]

# integer-exact series vs tolerance floats (tests/_diff.py's EXACT_KEYS
# policy for round records)
INT_KEYS = ("frames", "offloads", "misses", "correct", "action_off")
# host-derived floats, computed the same way by every engine
HOST_KEYS = ("t", "bw_true")


class FleetRecorder:
    """Growable SoA ring of per-round fleet records."""

    def __init__(self, n_streams: int, n_cells: int = 1, n_replicas: int = 1,
                 n_actions: int = 1, capacity: int = 64):
        self.n_streams = int(n_streams)
        self.n_cells = int(n_cells)
        self.n_replicas = int(n_replicas)
        self.n_actions = int(n_actions)
        self._n = 0
        self._buf = {name: np.zeros((int(capacity),) + shape, dtype=dtype)
                     for name, (shape, dtype) in self._schema().items()}

    def _schema(self) -> dict:
        S, C, K, A = self.n_streams, self.n_cells, self.n_replicas, self.n_actions
        f8, i8 = np.float64, np.int64
        return {
            "t": ((), f8),              # round start (first finite arrival)
            "frames": ((S,), i8),       # cumulative valid frames served
            "offloads": ((S,), i8),     # cumulative landed escalations
            "misses": ((S,), i8),       # cumulative deadline misses
            "correct": ((S,), i8),      # cumulative correct answers
            "bw_est": ((S,), f8),       # post-fold EWMA bandwidth (bytes/s)
            "bw_true": ((S,), f8),      # true cell bandwidth at round start
            "cell_busy_s": ((C,), f8),  # cumulative wire seconds per cell
            "cell_queued_s": ((C,), f8),
            "rep_busy_s": ((K,), f8),   # cumulative service seconds per replica
            "rep_queued_s": ((K,), f8),
            "avg_batch": ((), f8),      # slow-tier occupancy EWMA post-round
            "server_time": ((), f8),    # planner's T^o estimate this round
            "action_off": ((A,), i8),   # planned offloads per action this round
        }

    # -- writing ---------------------------------------------------------- #

    def record_round(self, **fields) -> None:
        """Append one round's record; every schema key must be supplied."""
        schema = self._schema()
        missing = set(schema) - set(fields)
        unknown = set(fields) - set(schema)
        if missing or unknown:
            raise ValueError(f"recorder fields mismatch: missing={sorted(missing)} "
                             f"unknown={sorted(unknown)}")
        n = self._n
        cap = len(self._buf["t"])
        if n == cap:  # grow by doubling; views handed out earlier stay valid
            for name, buf in self._buf.items():
                new = np.zeros((cap * 2,) + buf.shape[1:], dtype=buf.dtype)
                new[:cap] = buf
                self._buf[name] = new
        for name, value in fields.items():
            self._buf[name][n] = np.asarray(value, dtype=schema[name][1])
        self._n = n + 1

    # -- reading ---------------------------------------------------------- #

    @property
    def n_rounds(self) -> int:
        return self._n

    def series(self, name: str) -> np.ndarray:
        """The recorded ``(n_rounds, ...)`` series for one field (a view)."""
        return self._buf[name][: self._n]

    def as_dict(self) -> dict:
        return {name: self.series(name).copy() for name in self._buf}

    # -- derived views ---------------------------------------------------- #

    def jain_series(self) -> np.ndarray:
        """Per-round Jain fairness index over cumulative landed offloads."""
        from repro_torch.serving.metrics import jain_index

        off = self.series("offloads")
        return np.asarray([jain_index(row) for row in off])

    def bw_error(self) -> np.ndarray:
        """(n_rounds, S) relative bandwidth estimation error
        ``|bw_est - bw_true| / bw_true`` (nan where bw_true is unknown)."""
        est, true = self.series("bw_est"), self.series("bw_true")
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.abs(est - true) / np.where(true > 0, true, np.nan)

    def summary(self) -> dict:
        """End-of-run digest."""
        if self._n == 0:
            return {"rounds": 0}
        off = self.series("action_off")
        frames_total = int(self.series("frames")[-1].sum())
        off_total = int(off.sum())
        err = self.bw_error()
        last_err = err[-1][np.isfinite(err[-1])]
        jain = self.jain_series()
        return {
            "rounds": self._n,
            "streams": self.n_streams,
            "frames": frames_total,
            "offloads_planned": off_total,
            "local_frac": round(1.0 - off_total / max(frames_total, 1), 4),
            "action_mix": [int(x) for x in off.sum(axis=0)],
            "jain_first": round(float(jain[0]), 4),
            "jain_last": round(float(jain[-1]), 4),
            "jain_min": round(float(jain.min()), 4),
            "bw_err_last": (round(float(last_err.mean()), 4)
                            if last_err.size else None),
            "avg_batch_last": round(float(self.series("avg_batch")[-1]), 4),
        }

    # -- comparison ------------------------------------------------------- #

    def assert_close(self, other: "FleetRecorder", *, bw_rtol: float = 1e-2,
                     time_rtol: float = 1e-2, time_atol: float = 1e-4,
                     ctx: str = "") -> None:
        """Pin two recorded series to each other: integer series bit-equal,
        host-derived floats bit-equal, simulated-float series at tolerance
        (a float32 engine accumulates float32 timestamps)."""
        assert self._n == other._n, (
            f"{ctx}: round counts differ: {self._n} vs {other._n}")
        for k in INT_KEYS:
            a, b = self.series(k), other.series(k)
            assert np.array_equal(a, b), (
                f"{ctx}: integer series mismatch on {k!r}")
        for k in HOST_KEYS:
            np.testing.assert_allclose(
                other.series(k), self.series(k), rtol=1e-12, equal_nan=True,
                err_msg=f"{ctx}: host-derived series {k}")
        np.testing.assert_allclose(other.series("bw_est"), self.series("bw_est"),
                                   rtol=bw_rtol, err_msg=f"{ctx}: bw_est")
        for k in ("cell_busy_s", "cell_queued_s", "rep_busy_s", "rep_queued_s",
                  "avg_batch", "server_time"):
            np.testing.assert_allclose(other.series(k), self.series(k),
                                       rtol=time_rtol, atol=time_atol,
                                       err_msg=f"{ctx}: {k}")


def relock_lags(recorder: FleetRecorder, *, rtol: float = 0.25,
                shift_rtol: float = 0.2) -> list:
    """EWMA re-lock lag per bandwidth regime shift.

    Detects rounds where the fleet-mean true bandwidth jumps by more than
    ``shift_rtol`` relative, then counts how many rounds the mean
    ``|bw_est - bw_true| / bw_true`` needs to drop back under ``rtol``.
    Returns ``[(shift_round, lag_rounds | None)]`` — ``None`` when the
    estimate never re-locked before the run ended.
    """
    true = recorder.series("bw_true")
    if len(true) == 0:
        return []
    mean_true = np.nanmean(true, axis=1)
    err = recorder.bw_error()
    mean_err = np.nanmean(err, axis=1)
    out = []
    prev = mean_true[0]
    for r in range(1, len(mean_true)):
        cur = mean_true[r]
        if np.isfinite(prev) and np.isfinite(cur) and prev > 0 \
                and abs(cur - prev) / prev > shift_rtol:
            lag = None
            for d in range(r, len(mean_err)):
                if np.isfinite(mean_err[d]) and mean_err[d] < rtol:
                    lag = d - r
                    break
            out.append((r, lag))
        prev = cur
    return out
