"""Plain versions of the serving loop's simulated planes, replayed by the
output check to hold each sampled round's plan and fabric outcome.

Fed the program's confidences (which ``conf`` holds to the reference's
own logits), ``Replay`` works out again, from the configuration, the
traffic and the uplinks' seeds alone, what the program's planner and edge
fabric decide each round of a clip:

* the arrivals: S streams at one frame rate, stream s shifted by
  s / (S · rate);
* the planner: per stream, a backlog of the frames answered locally
  (arrival, confidence), the newest 64 kept, those whose deadline has
  passed dropped before each plan; a bandwidth estimate per stream, an
  EWMA (weight 0.3) of the observed transfers starting from the cell's
  nominal rate; the paper's Algorithm 1 as the original tuple-chain
  dynamic program, which gives the threshold, the resolution and the
  number of planned offloads (the round's capacity, at least 1);
* the gate (``cascade.gate``): the round's frames below the threshold,
  lowest confidence first, up to the capacity;
* the data plane: start-time fair queueing of the escalations, one serial
  uplink a cell whose bandwidth takes a jitter factor a second,
  join-shortest-queue placement over the replicas, continuous batching
  (an admission window, a cap, f(n) = base + per_item · n), the reply
  latency; a reply is in time when it lands by arrival + deadline.

The float expressions are the program's, so a sound program agrees to the
bit: the uplink's, the scheduler's and the pool's recursions are frozen
copies of the program's numpy code, and the planner is the original that
the program's vectorized planner reproduces.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference.cascade import gate

EPS = 1e-12  # the planner's dominance margin
MAX_BACKLOG = 64
BW_ALPHA = 0.3  # the bandwidth estimate's EWMA weight
BATCH_BETA = 0.25  # the pool's occupancy EWMA weight
SWEEPS = 50  # fixed-point sweeps of a jittered upload before the serial loop


def arrivals(streams: int, frames: int, frame_rate: float) -> np.ndarray:
    gamma = 1.0 / frame_rate
    base = np.arange(frames, dtype=np.float64) * gamma
    phase = np.arange(streams, dtype=np.float64) * gamma / max(streams, 1)
    return phase[:, None] + base[None, :]


def payload_bytes(res) -> np.ndarray:
    """A lossless frame's upload size: 60 kB at 224 px, scaling as r²."""
    return 60_000.0 * (np.asarray(res, dtype=np.float64) / 224) ** 2


def cbo_plan(backlog: list, now: float, bandwidth: float, sizes: np.ndarray, acc: tuple, rtt: float,
             deadline: float) -> tuple[float, int, list[int]]:
    """Algorithm 1 over one backlog of (arrival, confidence): frames in
    descending confidence; each (busy time, gain) state keeps the frame
    local or sends it at a resolution whose reply lands in time with a
    positive gain; states later and no better are pruned.  Returns the
    threshold (the largest confidence planned, the earliest frame on a
    tie), its resolution and the planned backlog positions."""
    m = len(acc)
    pairs = [(now, 0.0, None, None)]
    for j in sorted(range(len(backlog)), key=lambda i: -backlog[i][1]):
        arr, conf = backlog[j]
        cand = list(pairs)
        for p in pairs:
            for r in range(m):
                t_new = max(p[0], arr) + sizes[r] / bandwidth
                gain = acc[r] - conf
                if t_new + rtt <= arr + deadline and gain > 0:
                    cand.append((t_new, p[1] + gain, p, (j, r)))
        cand.sort(key=lambda p: (p[0], -p[1]))
        pairs, best = [], -np.inf
        for p in cand:
            if p[1] > best + EPS:
                pairs.append(p)
                best = p[1]
    node, chain = max(pairs, key=lambda p: p[1]), []
    while node[3] is not None:
        chain.append(node[3])
        node = node[2]
    if not chain:
        return 0.0, m - 1, []
    i, r = max(chain, key=lambda ir: (backlog[ir[0]][1], -ir[0]))
    return backlog[i][1], r, sorted(i for i, _ in chain)


class Uplink:
    """One cell's serial uplink: a reply's wire time at the bandwidth of
    the second its upload starts, uploads queued in the given order."""

    def __init__(self, bandwidth_bps: float, jitter: float, seed: int):
        self.bandwidth_bps, self.jitter, self.seed = bandwidth_bps, jitter, seed
        self.busy = 0.0
        self.factors: dict = {}

    def bandwidth_at(self, t: np.ndarray) -> np.ndarray:
        base = np.full(t.shape, self.bandwidth_bps)
        if self.jitter > 0:
            base = base * np.asarray([self._factor(int(s)) for s in t.astype(np.int64)], dtype=np.float64)
        return base

    def _factor(self, second: int) -> float:
        if second not in self.factors:
            z = np.random.default_rng((self.seed, second)).standard_normal()
            self.factors[second] = np.clip(1.0 + self.jitter * z, 0.2, 2.0)
        return self.factors[second]

    def _lindley(self, tx: np.ndarray, subs: np.ndarray) -> np.ndarray:
        csum = np.cumsum(tx)
        eff = np.maximum(subs, self.busy) - (csum - tx)
        return np.maximum.accumulate(eff) + csum

    def upload(self, payloads: np.ndarray, subs: np.ndarray) -> np.ndarray:
        """Each upload's end: end_i = max(submit_i, end_{i-1}) + bytes_i /
        bandwidth(start_i), by fixed-point sweeps over the start times,
        the serial loop where they do not settle."""
        starts = np.maximum(subs, self.busy)
        for _ in range(SWEEPS):
            tx = payloads / self.bandwidth_at(starts)
            end = self._lindley(tx, subs)
            new = end - tx
            if np.array_equal(new, starts):
                break
            starts = new
        else:
            end, busy = np.empty(len(payloads)), self.busy
            for i in range(len(payloads)):
                s = max(subs[i], busy)
                busy = s + payloads[i] / float(self.bandwidth_at(np.asarray([s]))[0])
                end[i] = busy
        self.busy = float(end[-1])
        return end


def sfq_order(stream: np.ndarray, t_ready: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Start-time fair queueing: per stream, tag_k = max(ready_k, tag_{k-1}
    + cost_{k-1}) in readiness order; the uplink order is by (tag, ready,
    stream)."""
    n = len(stream)
    idx = np.lexsort((t_ready, stream))
    r, c = t_ready[idx], cost[idx]
    starts = np.r_[0, np.flatnonzero(np.diff(stream[idx])) + 1]
    group_len = np.diff(np.r_[starts, n])
    excl = np.cumsum(c) - c
    excl -= np.repeat(excl[starts], group_len)
    eff = r - excl
    for a, k in zip(starts, group_len):
        eff[a:a + k] = np.maximum.accumulate(eff[a:a + k])
    tags = np.empty(n, dtype=np.float64)
    tags[idx] = eff + excl
    return np.lexsort((stream, t_ready, tags))


class Pool:
    """Slow-tier replicas under continuous batching, placed by
    join-shortest-queue on their nominal service times."""

    def __init__(self, server_time: list, base: float, per_item: float, window_s: float, max_batch: int):
        self.server_time = np.asarray(server_time, dtype=np.float64)
        self.base, self.per_item, self.window_s, self.cap = base, per_item, window_s, float(max_batch)
        self.busy = np.zeros(len(server_time), dtype=np.float64)
        self.avg_batch = 1.0

    def latency(self, n):
        return self.base + self.per_item * np.asarray(n, dtype=np.float64)

    def expected_server_time(self) -> float:
        """The planner's T^o: f(n) / n at the occupancy estimate."""
        n = np.maximum(np.asarray(self.avg_batch, dtype=np.float64), 1.0)
        return float(self.latency(n) / n)

    def place(self, t_arrive: np.ndarray) -> np.ndarray:
        busy, out = self.busy.copy(), np.empty(len(t_arrive), dtype=np.int64)
        for i in np.lexsort((np.arange(len(t_arrive)), t_arrive)):
            k = int(np.argmin(busy))
            busy[k] = max(t_arrive[i], busy[k]) + self.server_time[k]
            out[i] = k
        return out

    def _batches(self, arr: np.ndarray, busy: float):
        """One replica's requests (arrival order) into batches: a batch
        opens at max(busy, first arrival), admits arrivals up to the
        window's end and the cap, and launches at the window's end or,
        where the cap binds, at its last member's arrival."""
        n = len(arr)
        done, service, size = np.empty(n), np.empty(n), np.empty(n, dtype=np.int64)
        p = 0
        while p < n:
            t_open = max(busy, arr[p])
            close = t_open + self.window_s
            hi = int(np.searchsorted(arr, close, side="right"))
            count = int(min(hi - p, self.cap))
            t_start = max(t_open, float(arr[p + count - 1])) if hi - p > count else close
            f = float(self.latency(count))
            done[p:p + count], service[p:p + count], size[p:p + count] = t_start + f, f, count
            busy = t_start + f
            p += count
        return done, service, size

    def process(self, t_arrive: np.ndarray, replica: np.ndarray):
        """(completion, service) of each request."""
        n = len(t_arrive)
        done, service, size = np.empty(n), np.empty(n), np.empty(n, dtype=np.int64)
        order = np.lexsort((np.arange(n), t_arrive, replica))
        r_s, a_s = replica[order], t_arrive[order]
        seg = np.r_[0, np.flatnonzero(np.diff(r_s)) + 1]
        for a, b in zip(seg, np.r_[seg[1:], n]):
            k = int(r_s[a])
            d, f, nb = self._batches(a_s[a:b], self.busy[k])
            done[order[a:b]], service[order[a:b]], size[order[a:b]] = d, f, nb
            self.busy[k] = d[-1]
        self.avg_batch = (1.0 - BATCH_BETA) * self.avg_batch + BATCH_BETA * float(size.mean())
        return done, service


class Replay:
    """One clip's planner and fabric, from the clip's start, round by
    round.  ``config`` and ``traffic`` are the cell's files;
    ``uplink_seeds`` the jitter seed of each cell's uplink in this clip."""

    def __init__(self, config: dict, traffic: dict, uplink_seeds: list):
        sv, fb, tr = config["serve"], config["fabric"], traffic
        S, C = tr["streams"], tr["n_cells"]
        self.arrival = arrivals(S, tr["frames_per_stream"], tr["frame_rate"])
        self.deadline, self.acc = sv["deadline"], tuple(sv["acc_server"])
        self.t_fast = sv["fast_time"] + sv["calib_time"]
        self.sizes = payload_bytes(sv["resolutions"])
        self.latency = tr["latency_s"]
        self.cell_of = np.arange(S) % C
        bw = tr["bw_mbps"] * 1e6 / 8.0
        self.stream_bw = np.full(S, bw)
        self.uplinks = [Uplink(bw, tr["jitter"], seed) for seed in uplink_seeds]
        bt = fb["batching"]
        self.pool = Pool([f * sv["server_time"] for f in fb["replica_time_factors"]], bt["base"],
                         bt["per_item"], bt["window_s"], bt["max_batch"])
        self.backlog = [[] for _ in range(S)]
        self.bw_est = self.stream_bw.copy()

    def _plan(self, now: np.ndarray):
        S = len(self.backlog)
        theta, res, n_off = np.zeros(S), np.zeros(S, dtype=np.int64), np.zeros(S, dtype=np.int64)
        rtt = self.pool.expected_server_time() + self.latency
        planned = []
        for s in range(S):
            self.backlog[s] = [f for f in self.backlog[s] if f[0] + self.deadline > now[s]]
            bandwidth = np.maximum(self.bw_est[s], 1.0)
            theta[s], res[s], pos = cbo_plan(self.backlog[s], now[s], bandwidth, self.sizes, self.acc, rtt,
                                             self.deadline)
            n_off[s] = len(pos)
            planned.append(pos)
        return theta, res, n_off, planned

    def round(self, start: int, valid: np.ndarray, conf: np.ndarray) -> dict:
        """The plan (theta, cap, res_idx per stream), the gate's (stream,
        slot) in order, the masks of escalated and landed frames, and each
        frame's latency, for the round at slot ``start`` given the
        program's confidences ``conf`` (S, b); every stream sends a frame
        in every slot of the clip."""
        S, b = valid.shape
        arr = self.arrival[:, start:start + b]
        theta, res_idx, n_off, planned = self._plan(np.min(arr, axis=1))
        cap = np.maximum(n_off, 1)
        s_idx, j_idx = gate(np.where(valid, conf, np.inf), theta, cap, valid)
        esc = np.zeros((S, b), dtype=bool)
        esc[s_idx, j_idx] = True
        ok = np.zeros((S, b), dtype=bool)
        lat = np.full((S, b), self.t_fast)
        if len(s_idx):
            t_ready = arr[s_idx, j_idx] + self.t_fast
            pay = self.sizes[res_idx[s_idx]]
            order = sfq_order(s_idx, t_ready, pay / self.stream_bw[s_idx])
            qs, qj, qt, qp = s_idx[order], j_idx[order], t_ready[order], pay[order]
            end = np.empty(len(qs))
            for c, up in enumerate(self.uplinks):
                rows = np.flatnonzero(self.cell_of[qs] == c)
                if len(rows):
                    end[rows] = up.upload(qp[rows], qt[rows])
            done, service = self.pool.process(end, self.pool.place(end))
            lands = done + self.latency
            land = lands <= arr[qs, qj] + self.deadline
            ok[qs[land], qj[land]] = True
            lat[qs[land], qj[land]] = lands[land] - arr[qs[land], qj[land]]
            lat[qs[~land], qj[~land]] = self.deadline
            for s, size, sec in zip(qs, qp, lands - qt - self.latency - service):
                if sec > 1e-9:
                    self.bw_est[s] = (1 - BW_ALPHA) * self.bw_est[s] + BW_ALPHA * (size / sec)
        for s in range(S):
            drop = set(planned[s])
            self.backlog[s] = [f for i, f in enumerate(self.backlog[s]) if i not in drop]
            self.backlog[s] += [(arr[s, j], float(conf[s, j])) for j in range(b) if valid[s, j] and not esc[s, j]]
            self.backlog[s] = self.backlog[s][-MAX_BACKLOG:]
        return {"theta": theta, "cap": cap, "res_idx": res_idx, "s_idx": s_idx, "j_idx": j_idx, "esc": esc,
                "ok": ok, "lat": lat}
