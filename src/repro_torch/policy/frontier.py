"""Vectorized dominance-pruned DP: the decision plane's hot path
(port of ``repro.policy.frontier``, single-stream planners only).

Both planners (paper Algorithm 1 online, §IV-C offline optimal) are the
same Pareto-frontier recursion: walk the frames in some order; each
frontier state is (uplink busy time, accuracy); every frame expands each
state by "keep local" plus one candidate per deadline-feasible resolution;
dominated states (later AND no better) are pruned.  The frontier is a
struct-of-arrays and schedules are rebuilt through integer parent indices.
Candidate order and float accumulation are the reference's, so ties break
the same way and the returned schedule is the same, bit for bit.  The
batched ``cbo_plan_many`` waits for the fleet slice.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.policy.types import Env, Frame, Plan, plan_from_chain

_EPS = 1e-12


def _soa(frames: Sequence[Frame]):
    arr = np.asarray([f.arrival for f in frames], dtype=np.float64)
    conf = np.asarray([f.conf for f in frames], dtype=np.float64)
    sizes = np.asarray([f.sizes for f in frames], dtype=np.float64)
    return arr, conf, sizes


def _prune_positions(cand_t: np.ndarray, cand_gain: np.ndarray) -> np.ndarray:
    """Pareto frontier over (t ascending, gain ascending): stable sort by
    (t, -gain), keep a state iff its gain strictly exceeds the best *kept*
    gain so far (by more than eps) — the old loop, vectorized.  Returns the
    surviving candidate positions in sorted order."""
    order = np.argsort(cand_t, kind="stable")
    t = cand_t[order]
    if len(t) > 1 and (t[1:] == t[:-1]).any():
        # busy-time ties: fall back to the full (t, -gain) key so the
        # tie-break matches the reference sort exactly
        order = np.lexsort((-cand_gain, cand_t))
    g = cand_gain[order]
    n = len(g)
    keep = np.empty(n, dtype=bool)
    keep[0] = True
    if n > 1:
        # prefix-max shortcut: threshold on the max of ALL prior gains.  The
        # reference advances its bar only on KEPT gains, which differs only
        # when a pruned gain sits within eps of a later one — verify
        # self-consistency and fall back to the sequential rule if violated.
        keep[1:] = g[1:] > np.maximum.accumulate(g)[:-1] + _EPS
        last_kept = np.maximum.accumulate(np.where(keep, g, -np.inf))
        if (g[1:] > last_kept[:-1] + _EPS)[~keep[1:]].any():
            best = -np.inf
            for i in range(n):
                keep[i] = g[i] > best + _EPS
                if keep[i]:
                    best = g[i]
    return order[keep]


class _NodePool:
    """Append-only SoA pool of (parent, frame, res) decisions; parent
    indices instead of object chains make reconstruction O(depth)."""

    def __init__(self):
        self._chunks: list[tuple[np.ndarray, int, np.ndarray]] = []
        self.n = 1  # node 0 = root

    def append(self, parent: np.ndarray, frame_idx: int, res: np.ndarray) -> np.ndarray:
        self._chunks.append((parent, frame_idx, res))
        first = self.n
        self.n += len(parent)
        return np.arange(first, self.n, dtype=np.int64)

    def chain(self, node: int) -> list[tuple[int, int]]:
        """Walk parent indices back to the root, collecting offload
        decisions (nodes with frame >= 0; carry nodes are skipped)."""
        parent = np.concatenate([np.asarray([-1], dtype=np.int64)]
                                + [c[0] for c in self._chunks])
        frame = np.concatenate([np.asarray([-1], dtype=np.int64)]
                               + [np.full(len(c[0]), c[1], dtype=np.int64) for c in self._chunks])
        res = np.concatenate([np.asarray([-1], dtype=np.int64)]
                             + [c[2] for c in self._chunks])
        out: list[tuple[int, int]] = []
        while node >= 0:
            if frame[node] >= 0:
                out.append((int(frame[node]), int(res[node])))
            node = int(parent[node])
        return out


def cbo_plan(frames: Sequence[Frame], env: Env, *, now: float = 0.0) -> Plan:
    """Paper Algorithm 1 (online): DP over the confidence-sorted backlog.

    Only offloads with a strictly positive accuracy gain are candidates;
    "keep local" carries a state over unchanged.  Returns theta = max
    confidence among planned offloads and r° selected by frame index
    (see ``plan_from_chain``).
    """
    m = len(env.acc_server)
    if len(frames) == 0:
        return plan_from_chain([], frames, 0.0, m)
    arr, conf, sizes = _soa(frames)
    order = np.argsort(-conf, kind="stable")
    acc = np.asarray(env.acc_server, dtype=np.float64)
    rtt = env.server_time + env.latency
    tx = sizes / env.bandwidth  # (k, m)
    # static feasibility: even an idle uplink cannot make a transmission
    # with tx > deadline - rtt land in time, and dA <= 0 never helps —
    # drop those (frame, resolution) pairs
    dA_all = acc[None, :] - conf[:, None]  # (k, m)
    static = (tx <= env.deadline - rtt) & (dA_all > 0)

    pool = _NodePool()
    f_t = np.asarray([now])
    f_gain = np.asarray([0.0])
    f_id = np.zeros(1, dtype=np.int64)
    for j in order:
        j = int(j)
        cols = np.flatnonzero(static[j])
        if len(cols) == 0:
            continue
        P = len(f_t)
        # Collapse: every state with t <= arrival starts transmitting at the
        # (effective) arrival, so their expansions tie in t; frontier gain
        # is strictly ascending in t, so only the last such state's
        # expansions can survive pruning — expand from it alone.  (Survivor
        # set, and hence the schedule, is provably identical to expanding
        # them all.)
        lo = max(int(np.searchsorted(f_t, arr[j], side="right")) - 1, 0)
        dA = dA_all[j, cols]
        start = np.maximum(f_t[lo:, None], arr[j])
        t_new = start + tx[j, cols][None, :]  # (P - lo, C)
        good = t_new + rtt <= arr[j] + env.deadline
        if good.all():  # fast path: every (state, resolution) pair lands
            new_t = t_new.ravel()
            new_gain = (f_gain[lo:, None] + dA[None, :]).ravel()
            pi = lo + np.repeat(np.arange(P - lo), len(cols))
            ri = np.tile(cols, P - lo)
        else:
            if not good.any():
                continue  # pure carry-over: the frontier is already pruned
            pi, ci = np.nonzero(good)  # row-major: frontier outer, res inner
            new_t = t_new[pi, ci]
            new_gain = f_gain[lo + pi] + dA[ci]
            ri = cols[ci]
            pi = lo + pi
        # candidates: every carried-over state first, then the expansions —
        # the old list order, which pruning tie-breaks depend on
        cand_t = np.concatenate([f_t, new_t])
        cand_gain = np.concatenate([f_gain, new_gain])
        pos = _prune_positions(cand_t, cand_gain)
        new = pos >= P  # surviving expansions get pool nodes; pruned ones never do
        sel = pos[new] - P
        new_ids = pool.append(f_id[pi[sel]], j, ri[sel])
        nxt_id = np.empty(len(pos), dtype=np.int64)
        nxt_id[~new] = f_id[pos[~new]]
        nxt_id[new] = new_ids
        f_id = nxt_id
        f_t, f_gain = cand_t[pos], cand_gain[pos]
    best = int(np.argmax(f_gain))
    return plan_from_chain(pool.chain(int(f_id[best])), frames, float(f_gain[best]), m)


def optimal_schedule(frames: Sequence[Frame], env: Env) -> Plan:
    """The paper's offline optimal (§IV-C): DP over frames in arrival order,
    m+1 options per level (local + every feasible resolution, gain sign
    unconstrained), dominance-pruned (T, C) path attributes.

    Accumulates total *accuracy* (local frames contribute their confidence)
    exactly as the reference did, so pruning near the epsilon boundary makes
    identical decisions; the returned gain is accuracy minus the all-local
    base.
    """
    k = len(frames)
    m = len(env.acc_server)
    if k == 0:
        return plan_from_chain([], frames, 0.0, m)
    arr, conf, sizes = _soa(frames)
    order = np.argsort(arr, kind="stable")
    tx = sizes / env.bandwidth
    rtt = env.server_time + env.latency
    acc = np.asarray(env.acc_server, dtype=np.float64)
    static = tx <= env.deadline - rtt  # (k, m): feasible from an idle uplink

    pool = _NodePool()
    f_t = np.asarray([0.0])
    f_gain = np.asarray([0.0])
    f_id = np.zeros(1, dtype=np.int64)
    for j in order:
        j = int(j)
        P = len(f_t)
        cols = np.flatnonzero(static[j])
        C = len(cols)
        carry_g = f_gain + conf[j]  # "NPU option": accuracy + conf_j
        if C == 0:
            cand_t, cand_gain = f_t, carry_g
            pos = _prune_positions(cand_t, cand_gain)
            src_state, is_off, off_res = pos, np.zeros(len(pos), dtype=bool), None
        else:
            # collapse (see cbo_plan): states with t <= arrival tie in
            # expansion t; only the last (max-gain) one's expansions can
            # survive, so expand from states lo.. only.  Carries never tie.
            lo = max(int(np.searchsorted(f_t, arr[j], side="right")) - 1, 0)
            start = np.maximum(f_t[lo:], arr[j])
            t_new = start[:, None] + tx[j, cols][None, :]
            good = t_new + rtt <= arr[j] + env.deadline
            # old candidate order interleaves per state: carry, then its
            # feasible offload expansions, state by state; states below the
            # collapse point contribute their carry only
            grid_t = np.empty((P - lo, C + 1))
            grid_g = np.full((P - lo, C + 1), -np.inf)
            grid_t[:, 0] = f_t[lo:]
            grid_g[:, 0] = carry_g[lo:]
            np.copyto(grid_t[:, 1:], t_new, where=good)
            np.copyto(grid_g[:, 1:], (f_gain[lo:, None] + acc[cols][None, :]), where=good)
            flat = np.flatnonzero(grid_g.reshape(-1) > -np.inf)
            cand_t = np.concatenate([f_t[:lo], grid_t.reshape(-1)[flat]])
            cand_gain = np.concatenate([carry_g[:lo], grid_g.reshape(-1)[flat]])
            pos = _prune_positions(cand_t, cand_gain)
            in_grid = pos >= lo
            src = flat[pos[in_grid] - lo]  # position in the (P - lo, C+1) grid
            src_state = np.empty(len(pos), dtype=np.int64)
            src_state[~in_grid] = pos[~in_grid]  # prefix carries
            src_state[in_grid] = lo + src // (C + 1)
            src_col = src % (C + 1) - 1  # -1 = carry
            is_off = np.zeros(len(pos), dtype=bool)
            is_off[in_grid] = src_col >= 0
            off_res = cols[src_col[src_col >= 0]]
        nxt_id = np.empty(len(pos), dtype=np.int64)
        if is_off.any():
            nxt_id[is_off] = pool.append(f_id[src_state[is_off]], j, off_res)
        # carries record no decision — chain() would skip them — so they
        # keep their parent's node id instead of minting dead pool nodes
        nxt_id[~is_off] = f_id[src_state[~is_off]]
        f_id = nxt_id
        f_t, f_gain = cand_t[pos], cand_gain[pos]
    best = int(np.argmax(f_gain))
    base = sum(f.conf for f in frames)
    return plan_from_chain(pool.chain(int(f_id[best])), frames,
                           float(f_gain[best]) - base, m)
