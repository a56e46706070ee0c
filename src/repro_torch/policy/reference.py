"""Reference (pre-vectorization) planners (port of ``repro.policy.reference``).

The original tuple-chain implementations of Algorithm 1 and the offline
optimal, kept verbatim: the ground truth the vectorized ``frontier``
planners are checked against.  Not for serving paths.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.policy.types import Env, Frame, Plan, plan_from_chain


def cbo_plan_reference(frames: Sequence[Frame], env: Env, *, now: float = 0.0) -> Plan:
    """Original Algorithm 1: Python list of (t, gain, parent, decision)."""
    k = len(frames)
    m = len(env.acc_server)
    order = sorted(range(k), key=lambda i: -frames[i].conf)

    pairs: list[tuple] = [(now, 0.0, None, None)]
    for j in order:
        f = frames[j]
        cand = list(pairs)  # "no offload" carries every pair over unchanged
        for p in pairs:
            t, gain = p[0], p[1]
            for r in range(m):
                t_new = max(t, f.arrival) + f.sizes[r] / env.bandwidth
                if t_new + env.server_time + env.latency <= f.arrival + env.deadline:
                    dA = env.acc_server[r] - f.conf
                    if dA > 0:
                        cand.append((t_new, gain + dA, p, (j, r)))
        cand.sort(key=lambda p: (p[0], -p[1]))
        pairs = []
        best = -np.inf
        for p in cand:
            if p[1] > best + 1e-12:
                pairs.append(p)
                best = p[1]
    best_pair = max(pairs, key=lambda p: p[1])
    chain: list[tuple[int, int]] = []
    node = best_pair
    while node is not None and node[3] is not None:
        chain.append(node[3])
        node = node[2]
    return plan_from_chain(chain, frames, best_pair[1] if chain else 0.0, m)


def optimal_schedule_reference(frames: Sequence[Frame], env: Env) -> Plan:
    """Original offline optimal: arrival-order DP over tuple-chain states."""
    m = len(env.acc_server)
    order = sorted(range(len(frames)), key=lambda i: frames[i].arrival)
    states: list[tuple] = [(0.0, 0.0, None, None)]
    for i in order:
        f = frames[i]
        nxt: list = []
        for st in states:
            t, acc = st[0], st[1]
            nxt.append((t, acc + f.conf, st, None))  # NPU option
            for r in range(m):
                t_new = max(t, f.arrival) + f.sizes[r] / env.bandwidth
                if t_new + env.server_time + env.latency <= f.arrival + env.deadline:
                    nxt.append((t_new, acc + env.acc_server[r], st, (i, r)))
        nxt.sort(key=lambda p: (p[0], -p[1]))
        states = []
        best = -np.inf
        for p in nxt:
            if p[1] > best + 1e-12:
                states.append(p)
                best = p[1]
    best_state = max(states, key=lambda p: p[1])
    chain = []
    node = best_state
    while node is not None:
        if node[3] is not None:
            chain.append(node[3])
        node = node[2]
    base = sum(f.conf for f in frames)
    return plan_from_chain(chain, frames, best_state[1] - base, m)
