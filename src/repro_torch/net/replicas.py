"""Sharded slow tier: K server replicas, each a serial queue
(port of ``repro.net.replicas``; host numpy, copied).

The paper's edge server is an infinite-capacity fixed delay — every
offload pays ``server_time`` and nothing ever queues behind another
request.  That abstraction is what breaks first at fleet scale: the N=64+
sweeps hammer one implicit server with hundreds of escalations per round.
``ReplicaPool`` makes the slow tier a real resource: K replicas, each with
its own busy-until cursor and its own ``server_time`` (heterogeneous
replicas allowed), processing assigned requests in arrival order via the
same vectorized max-plus (Lindley) recursion the uplink uses — grouped by
replica, one recursion per replica, no per-request Python.

``serial=False`` recovers the paper's infinite-capacity abstraction
(``done = arrive + server_time``, nothing queues): the degenerate edge
fabric uses it so a 1-cell/1-replica fabric reproduces the legacy
single-uplink metrics bit-for-bit.

``batching=ContinuousBatching(...)`` upgrades each replica to a
continuous-batching inference server (``repro_torch.slowtier``): requests landing
within an admission window share a batch whose cost is a latency curve
f(batch) rather than per-request service times.  The *degenerate* batching
config (``FlatService``, zero window, cap 1) routes back through the legacy
serial recursion above and stays bit-for-bit with a batching-free pool.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ReplicaPool"]


class ReplicaPool:
    """K slow-tier replicas with per-replica queues and service times."""

    def __init__(self, n_replicas: int, server_time, *, serial: bool = True,
                 batching=None, batch_beta: float = 0.25):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.n_replicas = int(n_replicas)
        st = np.broadcast_to(np.asarray(server_time, dtype=np.float64),
                             (self.n_replicas,)).copy()
        if (st < 0).any():
            raise ValueError("server_time must be >= 0")
        self.server_time = st
        self.serial = bool(serial)
        if batching is not None and not serial:
            raise ValueError("batching implies serial replicas "
                             "(batches run back-to-back on each replica)")
        if not (0.0 < batch_beta <= 1.0):
            raise ValueError(f"batch_beta must be in (0, 1], got {batch_beta}")
        self.batching = batching
        self.batch_beta = float(batch_beta)
        # EWMA of observed per-request batch occupancy; 1.0 = serial regime
        self.avg_batch = 1.0
        # per-request service time of the most recent ``process`` batch (for
        # batched service this is the member's whole-batch f(n))
        self.last_service = np.zeros(0, dtype=np.float64)
        # per-request batch id of the most recent ``process`` batch:
        # pool-unique, monotone ids for batched service, -1 for unbatched
        # requests (telemetry: which escalations shared one f(n) launch)
        self.last_batch_id = np.zeros(0, dtype=np.int64)
        self._bid_seq = 0  # next global batch id
        self.busy_until = np.zeros(self.n_replicas, dtype=np.float64)
        # contention accounting, per replica
        self.n_jobs = np.zeros(self.n_replicas, dtype=np.int64)
        self.busy_seconds = np.zeros(self.n_replicas, dtype=np.float64)
        self.queued_seconds = np.zeros(self.n_replicas, dtype=np.float64)

    @property
    def nominal_server_time(self) -> float:
        """The scalar T^o planners/estimators assume (mean over replicas)."""
        return float(self.server_time.mean())

    @property
    def _batching_live(self) -> bool:
        return self.batching is not None and not self.batching.degenerate

    def expected_server_time(self) -> float:
        """Occupancy-calibrated T^o: amortized per-request cost
        f(expected_batch)/expected_batch under the configured latency curve
        at the observed occupancy EWMA; the nominal mean without batching
        (bit-equal to the pre-batching estimate)."""
        if not self._batching_live:
            return self.nominal_server_time
        return float(self.batching.model.per_request(self.avg_batch))

    def queue_depth(self, now: float) -> float:
        """Mean pending work (seconds of busy-until beyond ``now``) across
        replicas — the decision plane's congestion observable."""
        return float(np.clip(self.busy_until - now, 0.0, None).mean())

    def process(self, t_arrive, replica, *, service_scale=None) -> np.ndarray:
        """Serve one batch: each request lands on ``replica[i]`` when its
        upload finishes at ``t_arrive[i]``; returns service-completion
        times (reply latency is the fabric's concern, not the pool's).

        Serial replicas serve their requests in arrival order (ties keep
        batch order): within each replica the completion times follow
        ``done_i = max(arrive_i, done_{i-1}) + server_time`` — one Lindley
        recursion per replica over the batch, carried across batches by
        ``busy_until``.  With live (non-degenerate) ``batching``, requests
        are instead grouped into admission-window batches and each batch
        costs f(n) (``repro_torch.slowtier.form_batches``).

        ``service_scale`` (optional, per-request) multiplies each job's
        service time — split-computation offloads run only a suffix of the
        model, so their cost is ``srv_frac * server_time``.  Scale 1.0 is a
        float no-op, so frame-only batches stay bit-for-bit.  Live batching
        shares one f(n) across a batch and cannot price per-request
        suffixes; mixing the two is rejected.
        """
        t_arrive = np.asarray(t_arrive, dtype=np.float64)
        replica = np.asarray(replica, dtype=np.int64)
        if t_arrive.shape != replica.shape:
            raise ValueError("t_arrive and replica must have matching shapes")
        if len(t_arrive) == 0:
            self.last_service = np.zeros(0, dtype=np.float64)
            self.last_batch_id = np.zeros(0, dtype=np.int64)
            return np.zeros(0, dtype=np.float64)
        if (replica < 0).any() or (replica >= self.n_replicas).any():
            raise ValueError("replica id out of range")
        self.last_batch_id = np.full(len(t_arrive), -1, dtype=np.int64)
        st = self.server_time[replica]
        if service_scale is not None:
            scale = np.broadcast_to(
                np.asarray(service_scale, dtype=np.float64), t_arrive.shape)
            if self._batching_live and (scale != 1.0).any():
                raise ValueError(
                    "per-request service_scale (split offloading) is not "
                    "supported with continuous batching — batches share one "
                    "f(n) latency curve")
            st = st * scale
        if self._batching_live:
            return self._process_batched(t_arrive, replica)
        if not self.serial:  # infinite-capacity fixed delay (paper semantics)
            done = t_arrive + st
            self.n_jobs += np.bincount(replica, minlength=self.n_replicas)
            self.busy_seconds += np.bincount(replica, weights=st,
                                             minlength=self.n_replicas)
            np.maximum.at(self.busy_until, replica, done)  # last-completion marker
            self.last_service = st
            return done
        done = np.empty(len(t_arrive), dtype=np.float64)
        order = np.lexsort((np.arange(len(t_arrive)), t_arrive, replica))
        r_s, a_s, s_s = replica[order], t_arrive[order], st[order]
        seg = np.r_[0, np.flatnonzero(np.diff(r_s)) + 1]  # segment starts
        csum = np.cumsum(s_s)
        excl = csum - s_s
        excl -= np.repeat(excl[seg], np.diff(np.r_[seg, len(r_s)]))
        csum_seg = excl + s_s  # per-replica inclusive service cumsum
        eff = np.maximum(a_s, self.busy_until[r_s]) - excl
        for a, b in zip(seg, np.r_[seg[1:], len(r_s)]):  # runmax per replica
            eff[a:b] = np.maximum.accumulate(eff[a:b])
        done_s = eff + csum_seg
        starts = done_s - s_s
        done[order] = done_s
        # fold the batch into the persistent per-replica state
        last = np.r_[seg[1:], len(r_s)] - 1
        self.busy_until[r_s[last]] = done_s[last]
        self.n_jobs += np.bincount(replica, minlength=self.n_replicas)
        self.busy_seconds += np.bincount(r_s, weights=s_s, minlength=self.n_replicas)
        self.queued_seconds += np.bincount(
            r_s, weights=np.clip(starts - a_s, 0.0, None), minlength=self.n_replicas)
        self.last_service = st
        return done

    def _process_batched(self, t_arrive, replica) -> np.ndarray:
        """Continuous-batching service: group by replica (arrival order, ties
        keep batch order — same lexsort as the serial path), run admission-
        window batch formation per replica, fold occupancy into the EWMA."""
        from repro_torch.slowtier.batching import form_batches

        n = len(t_arrive)
        done = np.empty(n, dtype=np.float64)
        service = np.empty(n, dtype=np.float64)
        bsize = np.empty(n, dtype=np.int64)
        order = np.lexsort((np.arange(n), t_arrive, replica))
        r_s, a_s = replica[order], t_arrive[order]
        seg = np.r_[0, np.flatnonzero(np.diff(r_s)) + 1]
        for a, b in zip(seg, np.r_[seg[1:], len(r_s)]):
            k = int(r_s[a])
            d, f, nb, bid = form_batches(a_s[a:b], self.batching,
                                         busy0=self.busy_until[k])
            done[order[a:b]] = d
            service[order[a:b]] = f
            bsize[order[a:b]] = nb
            self.last_batch_id[order[a:b]] = self._bid_seq + bid
            self._bid_seq += int(bid[-1]) + 1
            self.busy_until[k] = d[-1]  # last batch's completion
            first = np.r_[True, bid[1:] != bid[:-1]]  # one row per batch
            self.busy_seconds[k] += float(f[first].sum())
            self.queued_seconds[k] += float(((d - f) - a_s[a:b]).sum())
        self.n_jobs += np.bincount(replica, minlength=self.n_replicas)
        self.last_service = service
        obs = float(bsize.mean())  # per-request mean occupancy this round
        self.avg_batch = (1.0 - self.batch_beta) * self.avg_batch \
            + self.batch_beta * obs
        return done

    def utilization(self, horizon: float) -> np.ndarray:
        """Per-replica service time over [0, horizon].  For serial replicas
        > 1.0 means overload; a ``serial=False`` pool serves concurrently,
        so its ratio measures offered load, not saturation."""
        return self.busy_seconds / max(horizon, 1e-12)

    def reset(self):
        self.busy_until[:] = 0.0
        self.n_jobs[:] = 0
        self.busy_seconds[:] = 0.0
        self.queued_seconds[:] = 0.0
        self.avg_batch = 1.0
        self.last_service = np.zeros(0, dtype=np.float64)
        self.last_batch_id = np.zeros(0, dtype=np.int64)
        self._bid_seq = 0
