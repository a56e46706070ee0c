"""Vectorized dominance-pruned DP: the decision plane's hot path
(port of ``repro.policy.frontier``).

Both planners (paper Algorithm 1 online, §IV-C offline optimal) are the
same Pareto-frontier recursion: walk the frames in some order; each
frontier state is (uplink busy time, accuracy); every frame expands each
state by "keep local" plus one candidate per deadline-feasible resolution;
dominated states (later AND no better) are pruned.  The frontier is a
struct-of-arrays and schedules are rebuilt through integer parent indices.
Candidate order and float accumulation are the reference's, so ties break
the same way and the returned schedule is the same, bit for bit.
``cbo_plan_many`` runs S such DPs at once over a ``FleetState``.  A
column is a frame resolution or, with ``env.actions``, any action of the
grid (frames, then feature cuts, each with its own device-prefix time and
suffix-scaled round trip).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.policy.types import Env, Frame, Plan, PlanBatch, plan_from_chain

_EPS = 1e-12


def _action_vectors(env):
    """Per-action planner columns: (sizes, rtt, t_dev, acc, m_frame).

    Frame-only (``env.actions is None``): ``sizes`` is None (callers use
    their legacy payload source), rtt is the scalar server+latency
    broadcast over the m resolutions, device time is zero.  With an
    ``ActionTable`` the columns are actions — frames first (action index ==
    resolution index), splits after, with per-action rtt (suffix-scaled
    server time) and device-prefix seconds.  For a degenerate table the
    extra vectors are all-zero / all-equal, and ``x + 0.0`` / ``t * 1.0``
    keep every float bit-identical to the frame-only path.
    ``m_frame`` is the frame-action count — plan defaults (r° = m-1) stay
    on the top *resolution*, never a split action.
    """
    if env.actions is None:
        acc = np.asarray(env.acc_server, dtype=np.float64)
        m = len(acc)
        return None, np.full(m, env.server_time + env.latency), np.zeros(m), acc, m
    act = env.actions
    return (np.asarray(act.sizes, dtype=np.float64),
            act.rtt(env.server_time, env.latency),
            np.asarray(act.t_dev, dtype=np.float64),
            np.asarray(act.acc, dtype=np.float64),
            act.n_frame_actions)


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

    With ``env.actions`` set, columns are the full action grid (frames ∪
    feature cuts): a split column's upload starts no earlier than
    ``arrival + t_dev`` (device prefix) and pays a suffix-scaled rtt.
    """
    k = len(frames)
    if k == 0:
        return plan_from_chain([], frames, 0.0, len(env.acc_server))
    arr, conf, sizes = _soa(frames)
    order = np.argsort(-conf, kind="stable")
    act_sizes, rtt, t_dev, acc, m = _action_vectors(env)
    if act_sizes is None:
        tx = sizes / env.bandwidth  # (k, m) from per-frame sizes
    else:
        tx = np.broadcast_to(act_sizes / env.bandwidth, (k, len(act_sizes)))
    # static feasibility: even an idle uplink (start = arrival + t_dev)
    # cannot make a transmission with t_dev + tx > deadline - rtt land in
    # time, and dA <= 0 never helps — drop those (frame, action) pairs
    dA_all = acc[None, :] - conf[:, None]  # (k, A)
    static = (tx <= (env.deadline - rtt - t_dev)[None, :]) & (dA_all > 0)

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
        # them all.  With device time, arrival <= arrival + t_dev for every
        # column, so collapsing on the raw arrival stays conservative.)
        lo = max(int(np.searchsorted(f_t, arr[j], side="right")) - 1, 0)
        dA = dA_all[j, cols]
        start = np.maximum(f_t[lo:, None], arr[j] + t_dev[cols][None, :])
        t_new = start + tx[j, cols][None, :]  # (P - lo, C)
        good = t_new + rtt[cols][None, :] <= arr[j] + env.deadline
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


def _merge_prune(f_t, f_gain, f_seg, f_offs, fkey, e_t, e_gain, e_seg, K):
    """Prune candidates = [sorted frontier] + [expansions] WITHOUT re-sorting
    the frontier: the expansions (few) are sorted among themselves and their
    merge positions into the carries (many, already (t, gain)-ascending per
    segment) come from one searchsorted over the segment-offset keys
    ``fkey = f_t + f_seg*K``.  The keep-if-gain-beats-running-max rule then
    needs only O(F + E) vector ops: a carry's prior-max is its predecessor's
    gain (frontier gains ascend) vs the prefix max of expansions inserted
    before it, and vice versa.  Exact busy-time ties place the expansion
    before the carry iff its gain is higher (candidate order is
    gain-descending on ties); eps-near gains — where this all-prior
    shortcut may disagree with the reference's kept-only bar — are rerun
    per affected segment with the sequential rule (few and small).

    Returns (e_order, keep_carry, keep_exp_sorted, merge_positions,
    exp_count_cumsum).
    """
    F, E = len(f_t), len(e_t)
    eo = np.lexsort((-e_gain, e_t, e_seg))
    et, eg, es = e_t[eo], e_gain[eo], e_seg[eo]
    ekey = et + es * K
    insL = np.searchsorted(fkey, ekey, side="left")
    ins = np.searchsorted(fkey, ekey, side="right")
    tie = insL != ins
    if tie.any():
        # key-equal carr(ies): usually one carry with an exactly equal busy
        # time (frontier t strictly ascends per segment) — candidate order
        # is gain-descending on ties, so the expansion goes before the
        # carry iff its gain is higher.  Key rounding can only merge
        # sub-ulp-distinct busy-times; verify exact equality and resolve
        # the (pathological) collapsed windows by scalar comparison.
        cL = np.minimum(insL, F - 1)
        simple = tie & (ins - insL == 1) & (et == f_t[cL])
        before = simple & (eg > f_gain[cL])
        ins = np.where(before, insL, ins)
        odd = tie & ~simple
        for k in np.flatnonzero(odd):
            n_before = 0
            for j in range(int(insL[k]), int(ins[k])):
                if f_t[j] < et[k] or (f_t[j] == et[k] and f_gain[j] >= eg[k]):
                    n_before += 1
            ins[k] = insL[k] + n_before
    # prefix max of expansion gains per segment (sorted order); dense
    # (S, Le) pad when segments are balanced, flat log-pass scan when one
    # segment dominates (the pad would mostly be padding)
    e_counts = np.bincount(es, minlength=len(f_offs) - 1)
    e_starts = np.concatenate([[0], np.cumsum(e_counts)[:-1]])
    Le = int(e_counts.max())
    if len(e_counts) * Le <= 4 * E:
        ecols = np.arange(Le)
        evalid = ecols[None, :] < e_counts[:, None]
        eidx = np.minimum(e_starts[:, None] + ecols[None, :], E - 1)
        edense = np.where(evalid, eg[eidx], -np.inf)
        erun = np.maximum.accumulate(edense, axis=1)
        pm = erun[evalid]
    else:
        from repro_torch.policy.fleet import segment_cummax

        pm = segment_cummax(eg, e_starts[es])
    pm_prev = np.empty(E)
    pm_prev[0] = -np.inf
    pm_prev[1:] = pm[:-1]
    pm_prev[e_starts[e_counts > 0]] = -np.inf
    # expansion keep: beat the last carry before it and all prior expansions
    cstar = ins - 1
    c_ok = cstar >= f_offs[es]
    prev_all_e = np.maximum(np.where(c_ok, f_gain[np.maximum(cstar, 0)], -np.inf), pm_prev)
    keep_e = eg > prev_all_e + _EPS
    # carry keep: beat its predecessor carry and expansions inserted before.
    # cum[j] = #expansions merged at or before carry j (bincount + cumsum —
    # no O(F log E) search)
    cum = np.cumsum(np.bincount(ins, minlength=F + 1))
    nb = cum[:F] - 1  # index of the last expansion before carry j
    e_ok = (nb >= 0) & (es[np.maximum(nb, 0)] == f_seg)
    # a carry's predecessor carry can never veto it (frontier gains ascend
    # by more than eps within a segment), so only the prefix max of the
    # expansions inserted before it matters
    prev_all_c = np.where(e_ok, pm[np.maximum(nb, 0)], -np.inf)
    keep_c = f_gain > prev_all_c + _EPS
    # eps-near gains: a dropped candidate strictly above the prior max (but
    # within eps) means the all-prior shortcut may disagree with the
    # reference's kept-only bar — rerun just those segments sequentially.
    # Cheap screen first: counts of (g > prev) vs (g > prev + eps) differ
    # only when a near gain exists.
    over_e = eg > prev_all_e
    over_c = f_gain > prev_all_c
    if int(over_e.sum()) == int(keep_e.sum()) and int(over_c.sum()) == int(keep_c.sum()):
        near = ()
    else:
        near = np.union1d(es[over_e & ~keep_e], f_seg[over_c & ~keep_c])
    for s in near:
        # verify against the kept-only bar, vectorized; drop to the true
        # sequential rule only on an actual disagreement (rarer still than
        # the conservative screen above)
        ci = np.arange(f_offs[s], f_offs[s + 1])
        ei = np.flatnonzero(es == s)
        pc = ci + cum[ci]
        pe = ins[ei] + ei
        order = np.argsort(np.concatenate([pc, pe]), kind="stable")
        gg = np.concatenate([f_gain[ci], eg[ei]])[order]
        kk = np.concatenate([keep_c[ci], keep_e[ei]])[order]
        last_kept = np.maximum.accumulate(np.where(kk, gg, -np.inf))
        prev_kept = np.empty(len(gg))
        prev_kept[0] = -np.inf
        prev_kept[1:] = last_kept[:-1]
        if ((~kk) & (gg > prev_kept + _EPS)).any():
            best = -np.inf
            for i in range(len(gg)):
                kk[i] = gg[i] > best + _EPS
                if kk[i]:
                    best = gg[i]
        back = np.empty(len(gg), dtype=bool)
        back[order] = kk
        keep_c[ci] = back[: len(ci)]
        keep_e[ei] = back[len(ci):]
    return eo, keep_c, keep_e, ins, cum


class _BatchNodePool:
    """Shared append-only decision pool for S concurrent DPs: (parent,
    backlog position, resolution) per node; node 0 is every stream's root."""

    def __init__(self):
        self._parents: list[np.ndarray] = [np.asarray([-1], dtype=np.int64)]
        self._pos: list[np.ndarray] = [np.asarray([-1], dtype=np.int64)]
        self._res: list[np.ndarray] = [np.asarray([-1], dtype=np.int64)]
        self.n = 1

    def append(self, parent: np.ndarray, pos: np.ndarray, res: np.ndarray) -> np.ndarray:
        self._parents.append(parent.astype(np.int64))
        self._pos.append(pos.astype(np.int64))
        self._res.append(res.astype(np.int64))
        first = self.n
        self.n += len(parent)
        return np.arange(first, self.n, dtype=np.int64)

    def chains(self, nodes: np.ndarray):
        """Walk all S chains to the root in parallel; returns flat
        (stream, pos, res) arrays of every offload decision."""
        parent = np.concatenate(self._parents)
        pos = np.concatenate(self._pos)
        res = np.concatenate(self._res)
        node = np.asarray(nodes, dtype=np.int64).copy()
        streams = np.arange(len(node), dtype=np.int64)
        out_s, out_p, out_r = [], [], []
        while True:
            live = node > 0
            if not live.any():
                break
            out_s.append(streams[live])
            out_p.append(pos[node[live]])
            out_r.append(res[node[live]])
            node[live] = parent[node[live]]
        if not out_s:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        return (np.concatenate(out_s), np.concatenate(out_p), np.concatenate(out_r))


def cbo_plan_many(state, env, now: np.ndarray):
    """Algorithm 1 over S independent backlogs in one set of segment ops.

    Each stream runs exactly the ``cbo_plan`` recursion — same candidate
    ordering, same float accumulation, same tie-breaks — but all S
    frontiers live in one flat struct-of-arrays keyed by stream id, so a
    planning round is O(max backlog depth) numpy passes instead of O(S)
    Python DPs.  The tests fuzz bit-equality of the returned offload
    schedules against the per-stream planner.
    """
    from repro_torch.policy.fleet import ragged_rank
    S = state.n_streams
    arr, conf, sid, offs = state.arrival, state.conf, state.stream_id, state.offsets
    lens = np.diff(offs)
    now = np.asarray(now, dtype=np.float64)
    act_sizes, rtt, t_dev, acc, m = _action_vectors(env)
    sizes_a = env.sizes if act_sizes is None else act_sizes  # (A,)
    base_acc = np.bincount(sid, weights=conf, minlength=S) if len(arr) else np.zeros(S)
    out_empty = PlanBatch.empty(S, m)
    out_empty.n_frames = lens.copy()
    out_empty.base_acc = base_acc
    out_empty.planned = np.ones(S, dtype=bool)
    if len(arr) == 0:
        return out_empty

    tx_sm = sizes_a[None, :] / env.bandwidth[:, None]  # (S, A)
    dA = acc[None, :] - conf[:, None]  # (T, A)
    static = (tx_sm[sid] <= (env.deadline - rtt - t_dev)[None, :]) & (dA > 0)

    # per-stream confidence-descending stable order (== argsort(-conf))
    sort_idx = np.lexsort((-conf, sid))

    pool = _BatchNodePool()
    f_t = now.copy()
    f_gain = np.zeros(S)
    f_node = np.zeros(S, dtype=np.int64)
    f_seg = np.arange(S, dtype=np.int64)
    # one segment-offset key scale for the whole DP: every busy time and
    # deadline bound lives in [t_lo, t_hi], so K separates segments in all
    # the searchsorted-based merges below
    t_hi = float(max(now.max(), arr.max() + env.deadline))
    t_lo = float(min(now.min(), arr.min()))
    K = t_hi - t_lo + 1.0
    # per-depth frame grids, gathered once up front: row d holds each
    # stream's depth-d frame (conf-sorted order), padded where the backlog
    # is shorter
    D = int(lens.max())
    depth_rng = np.arange(D)
    fi_mat = sort_idx[np.minimum(offs[:-1][None, :] + depth_rng[:, None],
                                 np.maximum(offs[1:] - 1, 0)[None, :])]  # (D, S)
    static_mat = static[fi_mat] & (depth_rng[:, None] < lens[None, :])[:, :, None]
    any_mat = static_mat.any(axis=(1, 2))  # (D,)
    arr_mat = arr[fi_mat]  # (D, S) — garbage where padded, never used there
    pos_mat = fi_mat - offs[:-1][None, :]
    dA_mat = dA[fi_mat]  # (D, S, m)
    for d in range(D):
        if not any_mat[d]:
            continue
        frame_static = static_mat[d]  # (S, m)
        arr_d = arr_mat[d]
        pos_d = pos_mat[d]
        f_counts = np.bincount(f_seg, minlength=S)
        f_offs = np.empty(S + 1, dtype=np.int64)
        f_offs[0] = 0
        np.cumsum(f_counts, out=f_offs[1:])
        # collapse (see cbo_plan): only states from the last one with
        # t <= arrival onward can produce surviving expansions
        below = np.bincount(f_seg, weights=f_t <= arr_d[f_seg], minlength=S)
        lo = np.maximum(below.astype(np.int64) - 1, 0)
        # deadline-feasible states form a PREFIX of each (stream, col)'s
        # t-ascending frontier segment: start <= arr + deadline - rtt - tx.
        # One searchsorted over segment-offset keys finds every cutoff, so
        # the (mostly infeasible) full expansion grid is never
        # materialized; offset rounding can only over-include, and the
        # exact ``good`` check below re-filters the stragglers.
        cs, cc = np.nonzero(frame_static)  # (stream, col) pairs, s-major
        hi = arr_d[cs] + (env.deadline - rtt[cc]) - tx_sm[cs, cc]
        fkey = f_t + f_seg * K
        cut = np.searchsorted(fkey, hi + cs * K, side="right")
        first = f_offs[cs] + lo[cs]
        n_sc = np.maximum(cut - first, 0)
        blk = np.repeat(np.arange(len(cs)), n_sc)
        state_rep = first[blk] + ragged_rank(n_sc)
        seg_rep, col_rep = cs[blk], cc[blk]
        # candidate order is state-major with columns ascending — restore it
        # (the construction above is column-major); ties downstream depend
        # on the original candidate order
        o = np.lexsort((col_rep, state_rep))
        state_rep, seg_rep, col_rep = state_rep[o], seg_rep[o], col_rep[o]
        start = np.maximum(f_t[state_rep], arr_d[seg_rep] + t_dev[col_rep])
        t_new = start + tx_sm[seg_rep, col_rep]
        good = t_new + rtt[col_rep] <= arr_d[seg_rep] + env.deadline
        e_t = t_new[good]
        e_parent = state_rep[good]
        e_seg = seg_rep[good]
        e_col = col_rep[good]
        e_gain = f_gain[e_parent] + dA_mat[d][e_seg, e_col]
        if not len(e_t):
            continue  # pure carry-over everywhere: frontier already pruned
        # pre-filter: an expansion whose gain does not strictly beat the
        # best carry with strictly smaller busy-time is certain to be
        # pruned (the kept bar is within eps of the carry prefix max), so
        # drop it before the merge's per-expansion machinery.  Offset
        # rounding can only weaken the filter (monotone), never mis-drop.
        cpos = np.searchsorted(fkey, e_t + e_seg * K, side="right") - 1
        cpos_c = np.maximum(cpos, 0)
        # exact t compare guards against sub-ulp key collapses: only a
        # carry at or before the expansion's busy time may veto it (an
        # equal-t carry precedes the expansion iff its gain is >= — which
        # is exactly when the veto condition holds)
        covered = (cpos >= f_offs[e_seg]) & (f_t[cpos_c] <= e_t)
        weak = covered & (e_gain <= f_gain[cpos_c])
        if weak.any():
            strong = ~weak
            e_t, e_gain, e_parent = e_t[strong], e_gain[strong], e_parent[strong]
            e_seg, e_col = e_seg[strong], e_col[strong]
            if not len(e_t):
                continue
        # merge the (few) expansions into the already-sorted frontier
        # without re-sorting it
        eo, keep_c, keep_e, ins, cum = _merge_prune(
            f_t, f_gain, f_seg, f_offs, fkey, e_t, e_gain, e_seg, K)
        all_c = bool(keep_c.all())
        kc = np.arange(len(f_t)) if all_c else np.flatnonzero(keep_c)
        ke = np.flatnonzero(keep_e)
        orig_e = eo[ke]
        new_ids = pool.append(f_node[e_parent[orig_e]], pos_d[e_seg[orig_e]],
                              e_col[orig_e])
        # interleave kept carries/expansions by merged position (positions
        # on both sides are already sorted)
        pos_c = kc + cum[kc] if not all_c else kc + cum[:len(kc)]
        pos_e = ins[ke] + ke
        rc = np.arange(len(kc)) + np.searchsorted(pos_e, pos_c)
        re = np.arange(len(ke)) + np.searchsorted(pos_c, pos_e)
        n_new = len(kc) + len(ke)
        nt, ng = np.empty(n_new), np.empty(n_new)
        ns, nn = np.empty(n_new, dtype=np.int64), np.empty(n_new, dtype=np.int64)
        if all_c:
            nt[rc], ng[rc], ns[rc], nn[rc] = f_t, f_gain, f_seg, f_node
        else:
            nt[rc], ng[rc], ns[rc], nn[rc] = f_t[kc], f_gain[kc], f_seg[kc], f_node[kc]
        nt[re], ng[re], ns[re] = e_t[orig_e], e_gain[orig_e], e_seg[orig_e]
        nn[re] = new_ids
        f_t, f_gain, f_seg, f_node = nt, ng, ns, nn

    # best state per stream: max gain, first occurrence (np.argmax order)
    f_counts = np.bincount(f_seg, minlength=S)
    f_offs = np.r_[0, np.cumsum(f_counts)]
    best_gain = np.maximum.reduceat(f_gain, f_offs[:-1])
    hit = f_gain == best_gain[f_seg]
    first_hit = np.minimum.reduceat(np.where(hit, np.arange(len(f_gain)), len(f_gain)),
                                    f_offs[:-1])
    off_s, off_p, off_r = pool.chains(f_node[first_hit])
    return PlanBatch.from_offloads(
        S, m, off_stream=off_s, off_pos=off_p, off_res=off_r,
        off_conf=conf[offs[:-1][off_s] + off_p], total_gain=best_gain,
        base_acc=base_acc, n_frames=lens).annotate_actions(env.actions)


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
