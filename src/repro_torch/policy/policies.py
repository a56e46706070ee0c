"""The built-in offload policies (port of ``repro.policy.policies``).

  * ``cbo``         — paper Algorithm 1 (vectorized frontier DP)
  * ``optimal``     — the paper's offline optimal (full-knowledge DP)
  * ``threshold``   — fixed confidence threshold θ at a fixed resolution
  * ``local``       — never offload
  * ``server``      — offload everything at the highest sustainable resolution
  * ``greedy-rate`` — the FastVA/Compress rule: offload whenever the best
                      deadline-feasible resolution beats the local tier's
                      population accuracy

All of them speak the batched fleet path too (``plan_many``, see
``policy/fleet.py``): ``cbo``, ``threshold``, ``local`` and ``server``
plan S backlogs in one set of numpy segment operations; the others fall
back to the looped default in ``BacklogPolicy``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.policy.base import BacklogPolicy, OneShotPolicy, empty_plan
from repro_torch.policy.frontier import cbo_plan, cbo_plan_many, optimal_schedule
from repro_torch.policy.registry import register
from repro_torch.policy.types import Env, Plan, PlanBatch, plan_from_chain


@register("cbo")
class CBOPolicy(BacklogPolicy):
    """Algorithm 1: re-plan the confidence-sorted backlog every call."""

    def _plan(self, now: float, env: Env) -> Plan:
        return cbo_plan(self.backlog, env, now=now)

    def plan_many(self, now, state, env) -> PlanBatch:
        """S frontier DPs in one set of segment operations (bit-identical
        offload schedules to looping ``plan`` — see ``cbo_plan_many``)."""
        return cbo_plan_many(state, env, now)


@register("optimal")
class OptimalPolicy(BacklogPolicy):
    """Offline optimal over the observed window: plans as if the uplink
    were free at t=0 and never prunes; unbounded backlog by default."""

    prune_expired = False

    def __init__(self, max_backlog: int | None = None):
        super().__init__(max_backlog=max_backlog)

    def _plan(self, now: float, env: Env) -> Plan:
        return optimal_schedule(self.backlog, env)


@register("threshold")
class ThresholdPolicy(BacklogPolicy):
    """Fixed θ: offload every backlog frame with conf < θ, serially, at a
    fixed resolution index (-1 = highest), skipping infeasible frames."""

    def __init__(self, theta: float = 0.5, resolution: int = -1,
                 max_backlog: int | None = 64):
        super().__init__(max_backlog=max_backlog)
        self.theta = float(theta)
        self.resolution = int(resolution)

    def _plan(self, now: float, env: Env) -> Plan:
        m = len(env.acc_server)
        r = self.resolution % m
        chain: list[tuple[int, int]] = []
        gain = 0.0
        t = now
        for i, f in enumerate(self.backlog):
            if f.conf >= self.theta:
                continue
            t_new = max(t, f.arrival) + f.sizes[r] / env.bandwidth
            if t_new + env.server_time + env.latency <= f.arrival + env.deadline:
                chain.append((i, r))
                gain += env.acc_server[r] - f.conf
                t = t_new
        return plan_from_chain(chain, self.backlog, gain, m)

    def plan_many(self, now, state, env) -> PlanBatch:
        """Vectorized across streams: the serial-uplink acceptance
        recursion runs one backlog *depth* per pass with (S,) vector ops —
        the same max-plus accumulation per stream, in the same order."""
        m = len(env.acc_server)
        r = self.resolution % m
        arr_p, conf_p, valid = state.padded()
        tx = env.sizes[r] / env.bandwidth  # (S,)
        rtt = env.server_time + env.latency
        dacc = env.acc_server[r] - conf_p  # (S, L)
        t = np.asarray(now, dtype=np.float64).copy()
        gain = np.zeros(state.n_streams)
        take = np.zeros_like(valid)
        for d in range(arr_p.shape[1]):
            cand = valid[:, d] & (conf_p[:, d] < self.theta)
            t_new = np.maximum(t, arr_p[:, d]) + tx
            ok = cand & (t_new + rtt <= arr_p[:, d] + env.deadline)
            t = np.where(ok, t_new, t)
            gain = np.where(ok, gain + dacc[:, d], gain)
            take[:, d] = ok
        off_s, off_p = np.nonzero(take)
        return PlanBatch.from_offloads(
            state.n_streams, m, off_stream=off_s, off_pos=off_p,
            off_res=np.full(len(off_s), r, dtype=np.int64),
            off_conf=conf_p[off_s, off_p], total_gain=gain,
            base_acc=(np.bincount(state.stream_id, weights=state.conf,
                                  minlength=state.n_streams)
                      if len(state) else np.zeros(state.n_streams)),
            n_frames=state.lengths)


@register("local")
class LocalPolicy(OneShotPolicy):
    """Never offload: the fast tier's answer always stands."""

    def _plan(self, now: float, env: Env) -> Plan:
        return empty_plan(self.backlog, len(env.acc_server))

    def plan_many(self, now, state, env) -> PlanBatch:
        out = PlanBatch.empty(state.n_streams, len(env.acc_server))
        out.n_frames = state.lengths.copy()
        out.base_acc = (np.bincount(state.stream_id, weights=state.conf,
                                    minlength=state.n_streams)
                        if len(state) else out.base_acc)
        out.planned = np.ones(state.n_streams, dtype=bool)
        return out


@register("server")
class ServerPolicy(OneShotPolicy):
    """Offload every frame at the highest resolution whose transmission fits
    both the frame interval and the per-frame deadline budget; frames are
    sent even if queueing will make them late (there is no local fallback
    to save them for)."""

    transmit_late = True

    def __init__(self, frame_interval: float = 1.0 / 30.0,
                 max_backlog: int | None = 64):
        super().__init__(max_backlog=max_backlog)
        self.frame_interval = float(frame_interval)

    def _plan(self, now: float, env: Env) -> Plan:
        m = len(env.acc_server)
        if not self.backlog:
            return empty_plan(self.backlog, m)
        tx_budget = min(self.frame_interval,
                        env.deadline - env.server_time - env.latency)
        sizes = self.backlog[0].sizes
        res_ok = [r for r in range(m) if sizes[r] / max(env.bandwidth, 1e-9) <= tx_budget]
        if not res_ok:
            return empty_plan(self.backlog, m)
        r = max(res_ok)
        chain = [(i, r) for i in range(len(self.backlog))]
        gain = sum(env.acc_server[r] - f.conf for f in self.backlog)
        return plan_from_chain(chain, self.backlog, gain, m)

    def plan_many(self, now, state, env) -> PlanBatch:
        """Vectorized: one (S, m) feasibility table picks each stream's
        highest sustainable resolution; every backlog frame offloads."""
        m = len(env.acc_server)
        S = state.n_streams
        acc = np.asarray(env.acc_server, dtype=np.float64)
        tx_budget = min(self.frame_interval,
                        env.deadline - env.server_time - env.latency)
        feas = env.sizes[None, :] / np.maximum(env.bandwidth, 1e-9)[:, None] <= tx_budget
        has_res = feas.any(axis=1)
        r_s = (m - 1) - np.argmax(feas[:, ::-1], axis=1)  # highest feasible
        lens = state.lengths
        send = has_res[state.stream_id] if len(state) else np.zeros(0, dtype=bool)
        off_s = state.stream_id[send]
        off_p = (np.arange(len(state)) - state.offsets[:-1][state.stream_id])[send]
        rr = r_s[off_s]
        gain = np.bincount(off_s, weights=acc[rr] - state.conf[send], minlength=S)
        return PlanBatch.from_offloads(
            S, m, off_stream=off_s, off_pos=off_p, off_res=rr,
            off_conf=state.conf[send], total_gain=gain,
            base_acc=(np.bincount(state.stream_id, weights=state.conf, minlength=S)
                      if len(state) else np.zeros(S)),
            n_frames=lens)


@register("greedy-rate")
class GreedyRatePolicy(OneShotPolicy):
    """Per frame, walk resolutions from the highest down; stop once the
    server's population accuracy no longer beats ``local_acc``; offload
    at the first resolution that also meets the deadline."""

    def __init__(self, local_acc: float = 0.5, max_backlog: int | None = 64):
        super().__init__(max_backlog=max_backlog)
        self.local_acc = float(local_acc)

    def _plan(self, now: float, env: Env) -> Plan:
        m = len(env.acc_server)
        chain: list[tuple[int, int]] = []
        gain = 0.0
        t = now
        for i, f in enumerate(self.backlog):
            for r in range(m - 1, -1, -1):
                if env.acc_server[r] <= self.local_acc:
                    break  # lower resolutions are worse than answering locally
                t_new = max(t, f.arrival) + f.sizes[r] / env.bandwidth
                if t_new + env.server_time + env.latency <= f.arrival + env.deadline:
                    chain.append((i, r))
                    gain += env.acc_server[r] - f.conf
                    t = t_new
                    break
        return plan_from_chain(chain, self.backlog, gain, m)
