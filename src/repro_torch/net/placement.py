"""Placement: which slow-tier replica serves each escalation
(port of ``repro.net.placement``; host numpy, copied).

The fabric's per-round decision: a batch of uploads finishes on the cells'
uplinks at times ``t_arrive``; each row must be assigned a replica before
``ReplicaPool.process`` computes completion times.  Assignment happens in
arrival order (the order requests actually reach the tier), ties broken by
batch position, so a policy's view of the queues is causally consistent.

Policies:

  * ``round_robin`` — cyclic over replicas in arrival order, counter
    carried across rounds; state-oblivious, fully vectorized, the right
    default when replicas are homogeneous.
  * ``jsq``         — join-shortest-queue: each request goes to the
    replica with the least pending work (earliest ``busy_until`` in the
    simulated schedule), the classic load balancer.
  * ``least_land``  — least-expected-land-time: minimizes this request's
    own completion ``max(arrive, busy_k) + server_time_k``; differs from
    JSQ exactly when replicas are heterogeneous (a short queue on a slow
    replica can still lose).

``assign`` never mutates the pool — it simulates queue growth on a copy so
the subsequent ``pool.process`` call is the single source of truth.
``assign_looped`` is the obviously-correct per-row reference the
equivalence tests compare against.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.net.replicas import ReplicaPool

__all__ = ["Placement", "assign_looped", "PLACEMENT_POLICIES"]

PLACEMENT_POLICIES = ("round_robin", "jsq", "least_land")


def assign_looped(policy: str, pool: ReplicaPool, t_arrive: np.ndarray,
                  start: int = 0) -> np.ndarray:
    """Reference implementation: one Python decision per request, in
    arrival order, against an explicitly simulated queue state."""
    t_arrive = np.asarray(t_arrive, dtype=np.float64)
    busy = pool.busy_until.copy()
    st = pool.server_time
    out = np.empty(len(t_arrive), dtype=np.int64)
    nxt = start
    for i in np.lexsort((np.arange(len(t_arrive)), t_arrive)):
        if policy == "round_robin":
            k = nxt % pool.n_replicas
            nxt += 1
        elif policy == "jsq":
            k = int(np.argmin(busy))
        elif policy == "least_land":
            k = int(np.argmin(np.maximum(t_arrive[i], busy) + st))
        else:
            raise ValueError(f"unknown placement policy: {policy!r}")
        busy[k] = max(t_arrive[i], busy[k]) + st[k]
        out[i] = k
    return out


@dataclass
class Placement:
    policy: str = "round_robin"
    _next: int = field(default=0, repr=False)  # round-robin cursor across rounds

    def __post_init__(self):
        if self.policy not in PLACEMENT_POLICIES:
            raise ValueError(f"unknown placement policy: {self.policy!r} "
                             f"(choose from {PLACEMENT_POLICIES})")

    def assign(self, pool: ReplicaPool, t_arrive) -> np.ndarray:
        """Replica id per request.  Round-robin is pure index arithmetic;
        the queue-aware policies run one greedy decision per request (the
        recurrence is inherently serial — each choice changes the queue the
        next one sees) but operate on (K,) vectors per step."""
        t_arrive = np.asarray(t_arrive, dtype=np.float64)
        n = len(t_arrive)
        out = np.empty(n, dtype=np.int64)
        if n == 0:
            return out
        order = np.lexsort((np.arange(n), t_arrive))  # arrival order, stable
        if self.policy == "round_robin":
            out[order] = (self._next + np.arange(n)) % pool.n_replicas
            self._next = (self._next + n) % pool.n_replicas
            return out
        busy = pool.busy_until.copy()
        st = pool.server_time
        for i in order:
            if self.policy == "jsq":
                k = int(np.argmin(busy))
            else:  # least_land
                k = int(np.argmin(np.maximum(t_arrive[i], busy) + st))
            busy[k] = max(t_arrive[i], busy[k]) + st[k]
            out[i] = k
        return out

    def reset(self):
        self._next = 0
