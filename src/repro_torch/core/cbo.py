"""CBO scheduling (paper §IV; port of ``repro.core.cbo``): online
Algorithm 1, the offline optimal and the brute-force oracle.

Frames arrive at rate f; each is classified on the fast tier with a
calibrated confidence p_i, its expected accuracy.  A frame may be
offloaded over a serial uplink of bandwidth B at one of m resolutions r
(payload S(i, r) bytes, server accuracy A^o_r); the reply arrives after
T^o + L and must land within the frame's deadline.  The planners and their
value types live in ``repro_torch.policy`` and are re-exported here under
their historical names; the brute-force oracle (tests only) stays here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.policy.frontier import cbo_plan, optimal_schedule
from repro_torch.policy.types import Env, Frame, Plan

__all__ = ["Frame", "Env", "Plan", "cbo_plan", "optimal_schedule", "brute_force"]


# --------------------------------------------------------------------------- #
# Brute-force oracle (tests only)
# --------------------------------------------------------------------------- #


def brute_force(frames: Sequence[Frame], env: Env) -> float:
    """Max achievable total accuracy by exhaustive enumeration (small n)."""
    import itertools

    m = len(env.acc_server)
    n = len(frames)
    order = sorted(range(n), key=lambda i: frames[i].arrival)
    best = -np.inf
    for choice in itertools.product(range(m + 1), repeat=n):  # m = local
        t = 0.0
        acc = 0.0
        ok = True
        for idx in order:
            f, c = frames[idx], choice[idx]
            if c == m:
                acc += f.conf
                continue
            t = max(t, f.arrival) + f.sizes[c] / env.bandwidth
            if t + env.server_time + env.latency > f.arrival + env.deadline:
                ok = False
                break
            acc += env.acc_server[c]
        if ok:
            best = max(best, acc)
    return float(best)
