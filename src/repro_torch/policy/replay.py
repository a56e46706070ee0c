"""Unified trace replay: one uplink/deadline simulation for every policy
(port of ``repro.policy.replay``; host numpy, as the reference).

The paper's §V methodology: both tiers' predictions are precomputed over a
frame trace; the replay walks the trace at the stream's frame rate, lets
the policy plan against the real ``Env``, and scores *realized* accuracy
under the serial uplink and per-frame deadlines.

Replay physics, the same for every policy:

  * ``local_pred``/``local_time`` — what a non-offloaded frame falls back
    to, and how long the local tier is busy per frame (0 = always keeps
    up; ``None`` pred = unanswered, scored wrong: the Server baseline);
  * ``replan_every`` — online planning cadence in frames;
  * ``window`` — offline mode: plan whole windows with full knowledge (the
    Optimal baseline) instead of frame by frame;
  * ``transmit_late`` — send planned frames even when they will land past
    the deadline (a policy with no local fallback keeps the uplink busy;
    policies may declare it, as ``server`` does).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.policy.registry import make_policy
from repro_torch.policy.types import Env, Frame


@dataclass
class ReplayResult:
    results: np.ndarray  # final answer per frame (-1 = unanswered)
    offloaded: np.ndarray  # bool: reply landed within the deadline
    n_late: int  # planned transmissions that missed the deadline

    @property
    def n_offloaded(self) -> int:
        return int(self.offloaded.sum())

    def accuracy(self, labels) -> float:
        return float((self.results == np.asarray(labels)).mean())


def replay_trace(policy, *, conf, slow_pred, sizes, env: Env,
                 frame_interval: float, local_pred=None, local_time: float = 0.0,
                 replan_every: int = 1, window: int = 0,
                 transmit_late: bool | None = None) -> ReplayResult:
    """Replay a trace through ``policy`` (name or instance) under ``env``.

    ``conf``: (n,) per-frame confidence fed to the policy;
    ``slow_pred``: (m, n) server prediction per resolution index;
    ``sizes``: (m,) payload bytes per resolution (``env.acc_server`` is the
    policy's planning table, length m).
    """
    policy = make_policy(policy)
    if transmit_late is None:
        transmit_late = bool(getattr(policy, "transmit_late", False))
    conf = np.asarray(conf, dtype=np.float64)
    slow_pred = np.asarray(slow_pred)
    n = len(conf)
    gamma = float(frame_interval)
    sizes_t = tuple(float(s) for s in sizes)
    results = np.full(n, -1, dtype=np.int64)
    offloaded = np.zeros(n, dtype=bool)
    n_late = 0
    busy = 0.0

    def execute(plan) -> None:
        nonlocal busy, n_late
        for bi, r in plan.offloads:
            f = policy.backlog[bi]
            if f.fid < 0:
                raise ValueError(
                    "replay_trace planned a frame it never observed (fid "
                    "unset) — pass a policy with an empty backlog"
                )
            tx = f.sizes[r] / env.bandwidth
            t_land = max(busy, f.arrival) + tx + env.server_time + env.latency
            if t_land <= f.arrival + env.deadline:
                busy = max(busy, f.arrival) + tx
                results[f.fid] = slow_pred[r][f.fid]
                offloaded[f.fid] = True
            else:
                n_late += 1
                if transmit_late:
                    busy = max(busy, f.arrival) + tx

    if window:
        # offline: full-knowledge planning over fixed windows; the realized
        # uplink cursor still carries across windows
        for s in range(0, n, window):
            idx = range(s, min(s + window, n))
            policy.observe([Frame(i * gamma, float(conf[i]), sizes_t, fid=i) for i in idx])
            execute(policy.plan(max(busy, s * gamma), env))
            policy.consume(range(len(policy.backlog)))  # window closed
    else:
        for i in range(n):
            arr = i * gamma
            policy.observe([Frame(arr, float(conf[i]), sizes_t, fid=i)])
            if i % replan_every:
                continue
            plan = policy.plan(max(busy, arr), env)
            execute(plan)
            # planned frames left the device (landed or not) — never re-plan
            policy.consume(i for i, _ in plan.offloads)

    # local tier: frames that never landed a reply fall back to the local
    # answer — if the local tier kept up.  A busy local tier sheds the frame
    # (scored wrong); local_time=0 models the paper's instant NPU answers.
    if local_pred is not None:
        local_pred = np.asarray(local_pred)
        local_busy = 0.0
        for i in np.flatnonzero(~offloaded):
            arr = i * gamma
            if local_busy <= arr:
                results[i] = local_pred[i]
                local_busy = arr + local_time
    return ReplayResult(results=results, offloaded=offloaded, n_late=n_late)
