"""Fair scheduling of escalations onto the shared uplink
(port of ``repro.serving.scheduler``; host numpy, copied).

With one stream the uplink order is trivial (FIFO by readiness). With N
streams contending for one serial link, the order frames enter the queue
decides who eats the head-of-line blocking: pure FIFO lets a bursty stream
park its whole batch ahead of everyone else's first frame, starving the
others' deadlines. The scheduler therefore permutes each round's
``EscalationBatch`` before it hits ``Uplink.transmit_batch``.

Policies (the ``policy`` knob):
  * ``"fifo"``        — global readiness order; max-throughput, unfair under
                        asymmetric load;
  * ``"round_robin"`` — start-time fair queueing (default): each frame gets
                        a virtual tag ``max(t_ready, prev_tag + cost/w)``
                        computed per stream, and the queue is sorted by tag.
                        Tags never precede readiness, so the wire is not
                        idled waiting for an unready frame; a stream that
                        dumps a burst accumulates cost and its tail yields
                        to other streams' earlier frames. ``weights`` makes
                        it weighted fair queueing (stream s gets ~w_s of the
                        link under contention).

Everything is vectorized: per-stream tag recurrences are the same max-plus
(Lindley) form the uplink uses, computed with cumsum + running max.

Under a multi-cell edge fabric the one global ordering still works: only
*within-cell* relative order matters (each cell's uplink serializes just
its own rows, in the order given), and restricting an SFQ-sorted sequence
to one cell's rows preserves their tag order.  The engine normalizes
``cost`` by each stream's own cell rate (``payload / cell_bandwidth``), so
tags stay comparable across heterogeneous cells.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def sfq_tags(stream: np.ndarray, t_ready: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Per-stream virtual start tags: tag_k = max(t_ready_k, tag_{k-1} + cost_{k-1}).

    Unrolled, tag_k = runmax_j(t_ready_j - excl_cumsum_j) + excl_cumsum_k over
    the stream's frames in readiness order — one cumsum and one running max
    per stream group.
    """
    n = len(stream)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    idx = np.lexsort((t_ready, stream))  # grouped by stream, ready-ascending
    r, c = t_ready[idx], cost[idx]
    starts = np.r_[0, np.flatnonzero(np.diff(stream[idx])) + 1]
    group_len = np.diff(np.r_[starts, n])
    excl = np.cumsum(c) - c
    excl -= np.repeat(excl[starts], group_len)  # per-group exclusive prefix sum
    eff = r - excl
    for a, l in zip(starts, group_len):  # running max restarts per group (S iterations)
        eff[a : a + l] = np.maximum.accumulate(eff[a : a + l])
    tags = np.empty(n, dtype=np.float64)
    tags[idx] = eff + excl
    return tags


@dataclass
class FairScheduler:
    policy: str = "round_robin"  # "round_robin" | "fifo"
    weights: Optional[np.ndarray] = None  # per-stream weights (round_robin only)

    def __post_init__(self):
        if self.policy not in ("round_robin", "fifo"):
            raise ValueError(f"unknown scheduler policy: {self.policy!r}")
        if self.weights is not None:
            self.weights = np.asarray(self.weights, dtype=np.float64)
            if np.any(self.weights <= 0):
                raise ValueError("scheduler weights must be positive")

    def order(self, stream: np.ndarray, t_ready: np.ndarray,
              cost: Optional[np.ndarray] = None) -> np.ndarray:
        """Permutation giving the uplink transmission order for one round.

        ``cost`` is each frame's nominal wire time (payload / bandwidth);
        it drives the fair-queueing tags. Without it, tags degenerate to
        readiness order (== fifo).

        ``stream`` ids are global (stable under churn: a stream keeps its
        id across join/leave), so per-stream ``weights`` stay aligned for
        dynamic fleets — absent streams simply contribute no frames.
        """
        stream = np.asarray(stream)
        t_ready = np.asarray(t_ready, dtype=np.float64)
        if self.policy == "fifo" or len(stream) == 0:
            return np.lexsort((stream, t_ready))
        cost = np.zeros(len(stream)) if cost is None else np.asarray(cost, dtype=np.float64)
        if self.weights is not None:
            if int(stream.max()) >= len(self.weights):
                raise ValueError(
                    f"scheduler weights cover {len(self.weights)} streams but "
                    f"stream id {int(stream.max())} appeared in this round")
            cost = cost / self.weights[stream]
        tags = sfq_tags(stream, t_ready, cost)
        return np.lexsort((stream, t_ready, tags))
