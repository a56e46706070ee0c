"""The built-in offload policies (port of ``repro.policy.policies``,
single-stream ``_plan`` only; the batched ``plan_many`` waits for the
fleet slice).

  * ``cbo``         — paper Algorithm 1 (vectorized frontier DP)
  * ``optimal``     — the paper's offline optimal (full-knowledge DP)
  * ``threshold``   — fixed confidence threshold θ at a fixed resolution
  * ``local``       — never offload
  * ``server``      — offload everything at the highest sustainable resolution
  * ``greedy-rate`` — the FastVA/Compress rule: offload whenever the best
                      deadline-feasible resolution beats the local tier's
                      population accuracy
"""
from __future__ import annotations

from repro_torch.policy.base import BacklogPolicy, OneShotPolicy, empty_plan
from repro_torch.policy.frontier import cbo_plan, optimal_schedule
from repro_torch.policy.registry import register
from repro_torch.policy.types import Env, Plan, plan_from_chain


@register("cbo")
class CBOPolicy(BacklogPolicy):
    """Algorithm 1: re-plan the confidence-sorted backlog every call."""

    def _plan(self, now: float, env: Env) -> Plan:
        return cbo_plan(self.backlog, env, now=now)


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


@register("local")
class LocalPolicy(OneShotPolicy):
    """Never offload: the fast tier's answer always stands."""

    def _plan(self, now: float, env: Env) -> Plan:
        return empty_plan(self.backlog, len(env.acc_server))


@register("server")
class ServerPolicy(OneShotPolicy):
    """Offload every frame at the highest resolution whose transmission fits
    both the frame interval and the per-frame deadline budget."""

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
