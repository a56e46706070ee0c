"""Value types of the offload decision plane (port of ``repro.policy.types``).

A policy observes ``Frame``s, plans against an ``Env`` (the network and
deadline regime at that instant) and answers with a ``Plan``.
``EnvBatch`` / ``PlanBatch`` are their struct-of-arrays fleet
counterparts: one env snapshot and one plan for S streams at once, the
vocabulary of the batched ``plan_many`` path (``policy/fleet.py``).
``ActionTable`` is the planner's action grid: frame uploads at each
resolution and, from ``split/``, feature uploads at each cut.  Host numpy,
as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class Frame:
    arrival: float  # seconds
    conf: float  # calibrated confidence = expected fast-tier accuracy
    sizes: tuple[float, ...]  # payload bytes per resolution (ascending res)
    fid: int = -1  # caller-side frame id; -1 = unset


@dataclass(frozen=True)
class ActionTable:
    """The planner's action grid: {frame@res r} ∪ {features@cut k}.

    Frame actions occupy indices ``[0, m)`` with action index ==
    resolution index, so a consumer that treats a plan's ``resolution`` as
    an index into ``cfg.resolutions`` keeps working, and a table with no
    split actions is the (m,) payload vector.  Split actions (``kind ==
    1``) follow: the device runs the first k blocks (``t_dev`` seconds,
    from ``split/costs.py``), ships int8 features (``sizes`` bytes), and the
    server runs the suffix (``srv_frac`` x its current full-model time
    estimate).  ``res`` is the resolution index the action's prediction is
    evaluated at (full resolution for splits); ``cut`` is the catalog cut
    id (-1 for frames).

    Invariants (checked): frame actions first with ``res == arange(m)``,
    ``t_dev == 0``, ``srv_frac == 1`` and ``cut == -1``; those identities
    make a degenerate table reproduce the frame-only system bit for bit
    (``x + 0.0`` and ``t * 1.0`` are float no-ops).
    """

    kind: np.ndarray  # (A,) int8 — 0 = frame upload, 1 = feature (split)
    res: np.ndarray  # (A,) int — evaluation resolution index
    cut: np.ndarray  # (A,) int — catalog cut id; -1 for frame actions
    sizes: np.ndarray  # (A,) float64 — payload bytes on the wire
    acc: np.ndarray  # (A,) float64 — server-side accuracy if offloaded
    t_dev: np.ndarray  # (A,) float64 — device prefix seconds (0 for frames)
    srv_frac: np.ndarray  # (A,) float64 — fraction of server_time (1 for frames)
    names: tuple = ()  # optional per-split-action labels

    def __post_init__(self):
        m = self.n_frame_actions
        if not (m >= 1 and np.array_equal(self.kind[:m], np.zeros(m, dtype=np.int8))
                and np.array_equal(self.res[:m], np.arange(m))
                and not np.any(self.t_dev[:m]) and np.all(self.srv_frac[:m] == 1.0)
                and np.all(self.cut[:m] == -1)):
            raise ValueError("ActionTable: frame actions must come first, with res == arange(m),"
                             " t_dev == 0, srv_frac == 1 and cut == -1")

    @property
    def n_actions(self) -> int:
        return len(self.sizes)

    @property
    def n_frame_actions(self) -> int:
        return int(np.sum(self.kind == 0))

    @property
    def has_splits(self) -> bool:
        return self.n_actions > self.n_frame_actions

    @classmethod
    def frames_only(cls, *, sizes, acc) -> "ActionTable":
        """The degenerate table: the (m,) resolution grid."""
        m = len(sizes)
        return cls(kind=np.zeros(m, dtype=np.int8), res=np.arange(m),
                   cut=np.full(m, -1, dtype=np.int64),
                   sizes=np.asarray(sizes, dtype=np.float64),
                   acc=np.asarray(acc, dtype=np.float64),
                   t_dev=np.zeros(m), srv_frac=np.ones(m))

    def rtt(self, server_time: float, latency: float) -> np.ndarray:
        """(A,) per-action server + latency time: split suffixes scale the
        current server-time estimate, frames pay it in full."""
        return server_time * self.srv_frac + latency


@dataclass(frozen=True)
class Env:
    bandwidth: float  # uplink bytes/s
    latency: float  # network latency L (s)
    server_time: float  # T^o (s)
    deadline: float  # T (s), per-frame window
    acc_server: tuple[float, ...]  # A^o_r per resolution (ascending res)
    actions: Optional[ActionTable] = None  # split-aware grid; None = frame-only


@dataclass
class Plan:
    """Result of a planning pass over a policy's backlog."""

    theta: float  # confidence threshold for offloading
    resolution: int  # r° — resolution index for the next offload
    offloads: list[tuple[int, int]]  # (backlog/frame index, resolution index)
    total_gain: float  # sum of (A^o_r - p_i) over planned offloads
    base_acc: float  # sum of p_i (all local)
    n_frames: int = 0

    @property
    def mean_acc(self) -> float:
        return (self.base_acc + self.total_gain) / max(self.n_frames, 1)


@dataclass(frozen=True)
class EnvBatch:
    """One ``Env`` snapshot for S streams: per-stream bandwidth estimates,
    shared link/deadline scalars, and the (m,) payload-size vector that
    every stream's frames share (``Frame.sizes`` is per-config, not
    per-frame).

    Under an edge fabric the (S,) bandwidth vector is per-*cell* in
    spirit: each stream's EWMA tracks its own cell's uplink (that is where
    its transfers serialize), so ``plan_many`` automatically plans against
    the stream's cell.  ``cell_id`` carries the partition for policies
    that want topology awareness; ``None`` means the single-uplink world.

    With a continuous-batching slow tier, ``server_time`` is already the
    *calibrated* amortized estimate f(expected_batch)/expected_batch;
    ``occupancy`` (the batch-occupancy EWMA behind it) and ``queue_depth``
    (mean seconds of pending replica work) are the raw observables for
    policies that want to reason about congestion directly.
    """

    bandwidth: np.ndarray  # (S,) uplink bytes/s, floored at 1.0
    latency: float
    server_time: float
    deadline: float
    acc_server: tuple[float, ...]
    sizes: np.ndarray  # (m,) payload bytes per resolution
    cell_id: Optional[np.ndarray] = None  # (S,) int cell per stream; None = one cell
    occupancy: float = 1.0  # slow-tier batch-occupancy EWMA (1.0 = serial)
    queue_depth: float = 0.0  # mean pending replica work (s) at plan time
    actions: Optional[ActionTable] = None  # split-aware grid; None = frame-only

    @property
    def n_streams(self) -> int:
        return len(self.bandwidth)

    @property
    def sizes_tuple(self) -> tuple[float, ...]:
        return tuple(float(x) for x in self.sizes)

    def for_stream(self, s: int) -> Env:
        return Env(bandwidth=float(self.bandwidth[s]), latency=self.latency,
                   server_time=self.server_time, deadline=self.deadline,
                   acc_server=self.acc_server, actions=self.actions)

    def subset(self, streams: np.ndarray) -> "EnvBatch":
        return EnvBatch(bandwidth=self.bandwidth[streams], latency=self.latency,
                        server_time=self.server_time, deadline=self.deadline,
                        acc_server=self.acc_server, sizes=self.sizes,
                        cell_id=None if self.cell_id is None else self.cell_id[streams],
                        occupancy=self.occupancy, queue_depth=self.queue_depth,
                        actions=self.actions)


@dataclass
class PlanBatch:
    """S ``Plan``s as struct-of-arrays: per-stream scalars plus one flat
    (stream, backlog position, resolution) offload list sorted by
    (stream, pos).  ``plan(s)`` materializes the per-stream ``Plan`` —
    identical to what the looped path returns (gains/base accuracies may
    differ from the looped floats only by summation order)."""

    theta: np.ndarray  # (S,)
    resolution: np.ndarray  # (S,) int — a° per stream (m-1 when no offloads)
    n_offloads: np.ndarray  # (S,) int
    total_gain: np.ndarray  # (S,)
    base_acc: np.ndarray  # (S,)
    n_frames: np.ndarray  # (S,) int — backlog length at plan time
    off_stream: np.ndarray  # (E,) int
    off_pos: np.ndarray  # (E,) int — position within the stream's backlog
    off_res: np.ndarray  # (E,) int — action index (== resolution index for frames)
    planned: np.ndarray = None  # (S,) bool — streams this batch planned for
    off_kind: np.ndarray = None  # (E,) int8 — 0 frame, 1 features (from ActionTable)
    off_cut: np.ndarray = None  # (E,) int — catalog cut id; -1 for frame actions

    def __post_init__(self):
        if self.off_kind is None:
            self.off_kind = np.zeros(len(self.off_res), dtype=np.int8)
        if self.off_cut is None:
            self.off_cut = np.full(len(self.off_res), -1, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.theta)

    def annotate_actions(self, actions: Optional[ActionTable]) -> "PlanBatch":
        """Fill the (kind, cut) columns from the action table ``off_res``
        indexes into.  A ``None`` or degenerate table is all frames."""
        if actions is not None and len(self.off_res):
            self.off_kind = actions.kind[self.off_res]
            self.off_cut = actions.cut[self.off_res]
        return self

    @classmethod
    def empty(cls, n_streams: int, m: int) -> "PlanBatch":
        z = np.zeros(n_streams)
        zi = np.zeros(n_streams, dtype=np.int64)
        return cls(theta=z.copy(), resolution=np.full(n_streams, m - 1, dtype=np.int64),
                   n_offloads=zi.copy(), total_gain=z.copy(), base_acc=z.copy(),
                   n_frames=zi.copy(), off_stream=np.zeros(0, dtype=np.int64),
                   off_pos=np.zeros(0, dtype=np.int64), off_res=np.zeros(0, dtype=np.int64),
                   planned=np.zeros(n_streams, dtype=bool))

    @classmethod
    def from_plans(cls, plans: list[Plan], m: int) -> "PlanBatch":
        """Pack per-stream ``Plan``s (the looped fallback) into one batch."""
        out = cls.empty(len(plans), m)
        offs = []
        for s, p in enumerate(plans):
            out.theta[s] = p.theta
            out.resolution[s] = p.resolution
            out.n_offloads[s] = len(p.offloads)
            out.total_gain[s] = p.total_gain
            out.base_acc[s] = p.base_acc
            out.n_frames[s] = p.n_frames
            out.planned[s] = True
            offs.extend((s, i, r) for i, r in p.offloads)
        if offs:
            a = np.asarray(offs, dtype=np.int64)
            out.off_stream, out.off_pos, out.off_res = a[:, 0], a[:, 1], a[:, 2]
            out.off_kind = np.zeros(len(out.off_res), dtype=np.int8)
            out.off_cut = np.full(len(out.off_res), -1, dtype=np.int64)
        return out

    @classmethod
    def from_offloads(cls, n_streams: int, m: int, *, off_stream, off_pos, off_res,
                      off_conf, total_gain, base_acc, n_frames) -> "PlanBatch":
        """Assemble from a flat offload list — the batched counterpart of
        ``plan_from_chain``: theta is the max confidence among each stream's
        offloads, r° that frame's resolution, ties broken toward the
        earliest backlog position."""
        out = cls.empty(n_streams, m)
        out.total_gain = np.asarray(total_gain, dtype=np.float64)
        out.base_acc = np.asarray(base_acc, dtype=np.float64)
        out.n_frames = np.asarray(n_frames, dtype=np.int64)
        out.planned = np.ones(n_streams, dtype=bool)
        off_stream = np.asarray(off_stream, dtype=np.int64)
        off_pos = np.asarray(off_pos, dtype=np.int64)
        off_res = np.asarray(off_res, dtype=np.int64)
        if len(off_stream) == 0:
            return out
        order = np.lexsort((off_pos, off_stream))
        out.off_stream = off_stream[order]
        out.off_pos = off_pos[order]
        out.off_res = off_res[order]
        out.off_kind = np.zeros(len(out.off_res), dtype=np.int8)
        out.off_cut = np.full(len(out.off_res), -1, dtype=np.int64)
        out.n_offloads = np.bincount(out.off_stream, minlength=n_streams)
        conf = np.asarray(off_conf, dtype=np.float64)[order]
        # theta/r° selection: per stream, highest conf, earliest pos on ties
        pick = np.lexsort((out.off_pos, -conf, out.off_stream))
        first = np.r_[True, out.off_stream[pick][1:] != out.off_stream[pick][:-1]]
        sel = pick[first]
        out.theta[out.off_stream[sel]] = conf[sel]
        out.resolution[out.off_stream[sel]] = out.off_res[sel]
        return out

    def scatter(self, streams: np.ndarray, sub: "PlanBatch") -> None:
        """Merge a group-local batch (stream ids local to ``streams``) in."""
        for name in ("theta", "resolution", "n_offloads", "total_gain",
                     "base_acc", "n_frames", "planned"):
            getattr(self, name)[streams] = getattr(sub, name)
        if len(sub.off_stream):
            self.off_stream = np.concatenate([self.off_stream, streams[sub.off_stream]])
            self.off_pos = np.concatenate([self.off_pos, sub.off_pos])
            self.off_res = np.concatenate([self.off_res, sub.off_res])
            self.off_kind = np.concatenate([self.off_kind, sub.off_kind])
            self.off_cut = np.concatenate([self.off_cut, sub.off_cut])

    def sort_offloads(self) -> None:
        order = np.lexsort((self.off_pos, self.off_stream))
        self.off_stream = self.off_stream[order]
        self.off_pos = self.off_pos[order]
        self.off_res = self.off_res[order]
        self.off_kind = self.off_kind[order]
        self.off_cut = self.off_cut[order]

    def plan(self, s: int) -> Plan:
        """Materialize stream ``s``'s per-stream ``Plan`` view."""
        sel = self.off_stream == s
        return Plan(theta=float(self.theta[s]), resolution=int(self.resolution[s]),
                    offloads=sorted(zip(self.off_pos[sel].tolist(), self.off_res[sel].tolist())),
                    total_gain=float(self.total_gain[s]), base_acc=float(self.base_acc[s]),
                    n_frames=int(self.n_frames[s]))


def plan_from_chain(chain: list[tuple[int, int]], frames, gain: float, m: int) -> Plan:
    """Assemble a ``Plan`` from a planner's offload chain: theta is the max
    confidence among planned offloads and r° the resolution of the frame
    attaining it (ties toward the earliest frame, chosen by index)."""
    base = sum(f.conf for f in frames)
    k = len(frames)
    if not chain:
        return Plan(theta=0.0, resolution=m - 1, offloads=[], total_gain=0.0,
                    base_acc=base, n_frames=k)
    i_star, r_star = max(chain, key=lambda ij: (frames[ij[0]].conf, -ij[0]))
    return Plan(theta=frames[i_star].conf, resolution=r_star, offloads=sorted(chain),
                total_gain=gain, base_acc=base, n_frames=k)
