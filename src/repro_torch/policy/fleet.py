"""Struct-of-arrays fleet control plane: S streams' policy state, batched
(port of ``repro.policy.fleet``; host numpy, and the fixed-shape tensor
planner of ``policy/fleet_torch.py`` behind ``backend="torch"``).

The per-stream path keeps one ``PolicyRunner`` per stream — a Python list
of ``Frame`` objects per backlog and one EWMA estimator per link — and the
serving engine loops them.  At fleet scale the control plane becomes the
bottleneck: the frontier DP underneath is vectorized, but everything
around it is O(S) Python per round.

``FleetState`` replaces the object lists with flat numpy arrays:

  * ragged backlogs as flat ``conf`` / ``arrival`` / ``stream_id`` arrays,
    grouped by stream with ``offsets`` (segment boundaries), each segment
    in insertion (arrival) order — exactly the per-stream list semantics;
  * EWMA bandwidth estimates as one ``(S,)`` vector;
  * an ``active`` mask so streams can join and leave mid-run (churn).

``FleetRunner`` is the batched counterpart of ``PolicyRunner``: it owns
the fleet state, materializes an ``EnvBatch`` per round, groups streams by
(policy class, config) and drives each group through the policy's
``plan_many`` (vectorized where the policy provides one, a per-stream loop
over ``_plan`` otherwise), then applies consume/observe as segment
operations.  Per-stream and batched paths are interchangeable: the fuzz
tests assert ``plan_all`` reproduces looped ``plan`` for every registered
policy.  ``backend="torch"`` plans on the card (``device``; the CPU when
the caller asks) through ``fleet_torch.plan_fleet``, the counterpart of the
reference's ``backend="jax"``, which raises here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.netsim import payload_sizes
from repro_torch.device import resolve_device
from repro_torch.obs.profile import NULL_PROFILER
from repro_torch.policy.base import OneShotPolicy
from repro_torch.policy.types import ActionTable, EnvBatch, Frame, PlanBatch

__all__ = ["FleetState", "FleetRunner", "segment_cummax", "ragged_rank", "looped_plan_many"]


# --------------------------------------------------------------------------- #
# segment primitives
# --------------------------------------------------------------------------- #


def segment_cummax(values: np.ndarray, seg_start_idx: np.ndarray) -> np.ndarray:
    """Inclusive running max within contiguous segments, vectorized.

    ``seg_start_idx[i]`` is the global index where element i's segment
    begins.  Hillis–Steele doubling: O(log n) passes of exact ``maximum``
    (no arithmetic on the values, so float comparisons downstream are
    unaffected — unlike offset-per-segment tricks).
    """
    out = np.asarray(values, dtype=np.float64).copy()
    n = len(out)
    idx = np.arange(n)
    shift = 1
    while shift < n:
        ok = idx - shift >= seg_start_idx
        out[ok] = np.maximum(out[ok], out[idx[ok] - shift])
        shift *= 2
    return out


def ragged_rank(counts: np.ndarray) -> np.ndarray:
    """0..c-1 within each block of a ragged layout given block ``counts``."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    excl = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(excl, counts)


# --------------------------------------------------------------------------- #
# FleetState
# --------------------------------------------------------------------------- #


class FleetState:
    """Ragged per-stream backlogs as one flat struct-of-arrays.

    Invariants: entries are grouped by stream (``stream_id`` ascending),
    and within a stream keep insertion order — the same order a
    ``BacklogPolicy.backlog`` list would have, so backlog positions mean
    the same thing on both paths.
    """

    def __init__(self, n_streams: int, max_backlog=64, cell_id=None):
        self.n_streams = int(n_streams)
        self.arrival = np.zeros(0, dtype=np.float64)
        self.conf = np.zeros(0, dtype=np.float64)
        self.stream_id = np.zeros(0, dtype=np.int64)
        self.offsets = np.zeros(n_streams + 1, dtype=np.int64)
        mb = np.asarray(max_backlog if np.ndim(max_backlog) else
                        [max_backlog] * n_streams)
        # None (unbounded) is encoded as a negative sentinel
        self.max_backlog = np.asarray(
            [-1 if b is None else int(b) for b in mb], dtype=np.int64)
        # the fleet's topology partition: stream s lives in cell_id[s]
        # (all zeros = the single-uplink world; set by the serving engine
        # when an EdgeFabric is attached)
        self.cell_id = (np.zeros(n_streams, dtype=np.int64) if cell_id is None
                        else np.asarray(cell_id, dtype=np.int64))
        if len(self.cell_id) != self.n_streams:
            raise ValueError("cell_id must have one entry per stream")

    def __len__(self) -> int:
        return len(self.arrival)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def _rebuild_offsets(self) -> None:
        counts = np.bincount(self.stream_id, minlength=self.n_streams)
        self.offsets = np.r_[0, np.cumsum(counts)].astype(np.int64)

    def filter(self, keep: np.ndarray) -> None:
        """Drop entries where ``keep`` is False (order preserved)."""
        self.arrival = self.arrival[keep]
        self.conf = self.conf[keep]
        self.stream_id = self.stream_id[keep]
        self._rebuild_offsets()

    def prune_expired(self, now: np.ndarray, deadline: float, streams_mask: np.ndarray) -> None:
        """Drop frames whose deadline window expired — the vectorized form
        of ``BacklogPolicy.plan``'s prune (same float compare per frame)."""
        if not len(self) or not streams_mask.any():
            return
        expired = ~(self.arrival + deadline > now[self.stream_id])
        drop = expired & streams_mask[self.stream_id]
        if drop.any():
            self.filter(~drop)

    def extend(self, stream: np.ndarray, arrival: np.ndarray, conf: np.ndarray) -> None:
        """Batched ``add_frame``: append frames (grouped per stream in the
        given order) then trim each stream to its ``max_backlog`` newest
        entries — list ``observe`` semantics, as segment ops."""
        if len(stream) == 0:
            return
        sid = np.concatenate([self.stream_id, np.asarray(stream, dtype=np.int64)])
        arr = np.concatenate([self.arrival, np.asarray(arrival, dtype=np.float64)])
        cf = np.concatenate([self.conf, np.asarray(conf, dtype=np.float64)])
        order = np.argsort(sid, kind="stable")  # regroup; old-before-new per stream
        self.stream_id, self.arrival, self.conf = sid[order], arr[order], cf[order]
        self._rebuild_offsets()
        mb = self.max_backlog[self.stream_id]
        # keep the last max_backlog entries of each segment
        over = (self.offsets[self.stream_id + 1] - np.arange(len(self))) > mb
        drop = (mb >= 0) & over
        if drop.any():
            self.filter(~drop)

    def clear(self, streams_mask: np.ndarray) -> None:
        """Empty the backlogs of the masked streams (retired clients)."""
        if len(self) and streams_mask.any():
            self.filter(~streams_mask[self.stream_id])

    def consume(self, off_stream: np.ndarray, off_pos: np.ndarray,
                clear_streams: np.ndarray) -> int:
        """Remove planned offloads (backlog positions as of the last plan)
        plus the entire backlog of ``clear_streams`` (one-shot policies)."""
        keep = np.ones(len(self), dtype=bool)
        if len(off_stream):
            keep[self.offsets[off_stream] + off_pos] = False
        if clear_streams.any():
            keep &= ~clear_streams[self.stream_id]
        removed = int((~keep).sum())
        if removed:
            self.filter(keep)
        return removed

    # -- views ----------------------------------------------------------- #

    def subset(self, streams: np.ndarray) -> "FleetState":
        """View restricted to ``streams`` (local ids 0..len(streams)-1).

        Returns ``self`` (an alias, not a copy) when ``streams`` covers the
        whole fleet in order; a fresh copy otherwise.  ``plan_many``
        implementations must treat the received state as read-only.
        """
        streams = np.asarray(streams, dtype=np.int64)
        if len(streams) == self.n_streams and np.array_equal(streams, np.arange(self.n_streams)):
            return self
        sub = FleetState(len(streams), max_backlog=self.max_backlog[streams],
                         cell_id=self.cell_id[streams])
        local = np.full(self.n_streams, -1, dtype=np.int64)
        local[streams] = np.arange(len(streams))
        sel = local[self.stream_id] >= 0
        sub.arrival = self.arrival[sel]
        sub.conf = self.conf[sel]
        sub.stream_id = local[self.stream_id[sel]]
        sub._rebuild_offsets()
        return sub

    def padded(self, pad_conf: float = np.inf):
        """Dense (S, L) views of the ragged backlogs plus a validity mask.
        Invalid slots get ``inf`` arrival/confidence so vectorized policies
        can keep static shapes without per-stream branches."""
        lens = self.lengths
        L = int(lens.max()) if len(self) else 0
        if L == 0:
            z = np.zeros((self.n_streams, 0))
            return z, z.copy(), np.zeros((self.n_streams, 0), dtype=bool)
        idx = self.offsets[:-1, None] + np.arange(L)[None, :]
        valid = np.arange(L)[None, :] < lens[:, None]
        idx = np.minimum(idx, len(self) - 1)
        arr = np.where(valid, self.arrival[idx], np.inf)
        conf = np.where(valid, self.conf[idx], pad_conf)
        return arr, conf, valid

    def frames_list(self, s: int, sizes: tuple) -> list[Frame]:
        """Materialize stream ``s``'s backlog as ``Frame`` objects — the
        bridge to per-stream ``plan`` for policies without a vectorized
        ``plan_many``."""
        lo, hi = int(self.offsets[s]), int(self.offsets[s + 1])
        return [Frame(arrival=float(self.arrival[i]), conf=float(self.conf[i]), sizes=sizes)
                for i in range(lo, hi)]


# --------------------------------------------------------------------------- #
# looped fallback
# --------------------------------------------------------------------------- #


def looped_plan_many(policy, now: np.ndarray, state: FleetState, env: EnvBatch) -> PlanBatch:
    """Default ``plan_many``: loop per-stream ``_plan`` over materialized
    ``Frame`` lists.  Correct for any policy; the vectorized overrides in
    ``policies.py`` / ``frontier.py`` exist because this is O(S) Python.

    Expired frames must already be pruned (``FleetRunner`` does this), so
    ``_plan`` sees the same backlog the per-stream path would after its
    own prune.
    """
    sizes = env.sizes_tuple
    step = getattr(policy, "_plan", policy.plan)  # plan() would just re-prune
    plans = []
    saved = policy.backlog
    try:
        for s in range(state.n_streams):
            policy.backlog = state.frames_list(s, sizes)
            plans.append(step(float(now[s]), env.for_stream(s)))
    finally:
        policy.backlog = saved
    return PlanBatch.from_plans(plans, len(env.acc_server))


# --------------------------------------------------------------------------- #
# FleetRunner
# --------------------------------------------------------------------------- #


def _group_key(policy) -> tuple:
    cfg = tuple(sorted((k, repr(v)) for k, v in vars(policy).items() if k != "backlog"))
    return (type(policy), cfg)


class FleetRunner:
    """Batched ``PolicyRunner``: one object drives S streams' policies.

    Owns what deployment measures per stream — the ``(S,)`` EWMA bandwidth
    vector — plus the shared link/deadline parameters, and keeps all
    backlog state in a ``FleetState``.  Heterogeneous fleets are grouped
    by (policy class, config); each group plans all of its streams in one
    ``plan_many`` call.

    ``backend="torch"`` plans each group with ``fleet_torch``'s fixed-shape
    planner on ``device`` (``None`` is the card; without a GPU that
    raises); ``backend="numpy"`` ignores ``device``.
    """

    def __init__(self, policies: Sequence, *, resolutions: tuple, acc_server: tuple,
                 deadline: float, latency: float, server_time: float, size_of,
                 bw_init: float | np.ndarray = 1e6, bw_alpha: float = 0.3,
                 cell_id: np.ndarray | None = None, backend: str = "numpy",
                 actions: ActionTable | None = None, device=None):
        if backend == "jax":
            raise NotImplementedError(
                "backend='jax' is the reference's; the port's compiled planner is"
                " backend='torch' (ROADMAP A.9)")
        if backend not in ("numpy", "torch"):
            raise ValueError(f"backend must be 'numpy' or 'torch', got {backend!r}")
        self.policies = list(policies)
        S = len(self.policies)
        self.n_streams = S
        self.resolutions = tuple(resolutions)
        self.acc_server = tuple(acc_server)
        self.deadline = float(deadline)
        self.latency = float(latency)
        self.server_time = float(server_time)
        # slow-tier congestion observables, refreshed each round by the
        # serving engine when the pool batches (see EnvBatch docs); the
        # engine also refreshes ``server_time`` with the calibrated
        # amortized estimate — identical to the nominal without batching
        self.occupancy = 1.0
        self.queue_depth = 0.0
        # the action -> bytes table: one source of truth for planner-assumed
        # and engine-transmitted payloads.  With no split actions it is the
        # (m,) resolution grid and ``self.actions`` stays None, so every
        # frame-only code path, and its pinned snapshots, is untouched.
        if actions is None:
            actions = ActionTable.frames_only(
                sizes=payload_sizes(size_of, np.asarray(self.resolutions)),
                acc=np.asarray(self.acc_server, dtype=np.float64))
        if actions.n_frame_actions != len(self.resolutions):
            raise ValueError(
                f"action table has {actions.n_frame_actions} frame actions "
                f"but {len(self.resolutions)} resolutions")
        self.action_table = actions
        self.actions = actions if actions.has_splits else None
        self.sizes = actions.sizes[:actions.n_frame_actions]
        self.bw_alpha = float(bw_alpha)
        # telemetry hook (``obs.PhaseProfiler``): plan_all folds its wall
        # clock into the "plan" phase; the default does nothing
        self.profiler = NULL_PROFILER
        # under an edge fabric, ``bw_init`` is the (S,) per-cell prior and
        # each stream's EWMA tracks its own cell's uplink from then on
        self.bw_est = np.broadcast_to(np.asarray(bw_init, dtype=np.float64), (S,)).copy()
        self.state = FleetState(
            S, max_backlog=[getattr(p, "max_backlog", None) for p in self.policies],
            cell_id=cell_id)
        self._prune = np.asarray([getattr(p, "prune_expired", True) for p in self.policies])
        self._oneshot = np.asarray([isinstance(p, OneShotPolicy) for p in self.policies])
        groups: dict[tuple, list[int]] = {}
        for s, p in enumerate(self.policies):
            groups.setdefault(_group_key(p), []).append(s)
        self.groups = [(self.policies[ss[0]], np.asarray(ss, dtype=np.int64))
                       for ss in groups.values()]
        self.backend = backend
        self.device = None
        self._torch_planner = None
        # backend="torch": the last plan_all's per-stream frontier flags
        # (``PlanOut.overflow`` / ``inexact``; False on inactive streams)
        self.last_overflow = self.last_inexact = None
        if backend == "torch":
            from repro_torch.policy.fleet_torch import (make_planner, spec_for_policy,
                                                        torch_unsupported_policies)

            reasons = torch_unsupported_policies([p for p, _ in self.groups])
            if reasons:
                raise ValueError("backend='torch' cannot express this fleet: "
                                 + "; ".join(reasons))
            self.device = resolve_device(device)
            # heterogeneous fleets share one pad width L (the largest
            # group's max_backlog); a homogeneous fleet pads to its own
            het = len(self.groups) != 1
            L = max(int(p.max_backlog) for p, _ in self.groups)
            self._torch_planner = []
            for policy, streams in self.groups:
                spec = spec_for_policy(
                    policy, sizes=self.sizes, acc_server=self.acc_server,
                    deadline=self.deadline, latency=self.latency,
                    server_time=self.server_time, pad_L=L if het else None,
                    actions=self.actions)
                self._torch_planner.append((spec, make_planner(spec, self.device), streams))

    # -- env ------------------------------------------------------------- #

    def env_batch(self) -> EnvBatch:
        # same 1 byte/s floor as PolicyRunner.env: a dead link plans
        # "all local" instead of dividing by zero inside the DP
        return EnvBatch(bandwidth=np.maximum(self.bw_est, 1.0), latency=self.latency,
                        server_time=self.server_time, deadline=self.deadline,
                        acc_server=self.acc_server, sizes=self.sizes,
                        cell_id=self.state.cell_id,
                        occupancy=self.occupancy, queue_depth=self.queue_depth,
                        actions=self.actions)

    # -- control-plane ops (all batched) --------------------------------- #

    def plan_all(self, now: np.ndarray, active: np.ndarray | None = None) -> PlanBatch:
        """One planning pass over every active stream's backlog."""
        with self.profiler.phase("plan"):
            return self._plan_all(now, active)

    def _plan_all(self, now: np.ndarray, active: np.ndarray | None = None) -> PlanBatch:
        S = self.n_streams
        now = np.asarray(now, dtype=np.float64)
        active = np.ones(S, dtype=bool) if active is None else np.asarray(active, dtype=bool)
        self.state.prune_expired(now, self.deadline, active & self._prune)
        if self.backend == "torch":
            return self._plan_all_torch(now, active)
        env = self.env_batch()
        batch = PlanBatch.empty(S, len(self.acc_server))
        batch.n_frames = self.state.lengths.copy()
        for policy, streams in self.groups:
            sel = streams[active[streams]]
            if len(sel) == 0:
                continue
            sub_state = self.state.subset(sel)
            sub_env = env.subset(sel) if len(sel) != S else env
            plan_many = getattr(policy, "plan_many", None)
            if plan_many is None:
                pb = looped_plan_many(policy, now[sel], sub_state, sub_env)
            else:
                pb = plan_many(now[sel], sub_state, sub_env)
            batch.scatter(sel, pb)
        batch.sort_offloads()
        batch.planned = active.copy()
        return batch.annotate_actions(self.actions)

    def _plan_all_torch(self, now: np.ndarray, active: np.ndarray) -> PlanBatch:
        """Tensor planning pass: pad the (already pruned) ragged state to
        fixed shapes on the device, run each group's planner, bridge back
        to one ``PlanBatch``; heterogeneous fleets reuse the numpy path's
        group scatter and sort on the host."""
        import torch

        from repro_torch.policy.fleet_torch import PaddedFleet, fleet_from_state, plan_batch_from_out

        spec0 = self._torch_planner[0][0]
        dev = self.device
        fleet = fleet_from_state(self.state, spec0.L, dtype=spec0.dtype, device=dev)
        now_t = torch.as_tensor(np.where(np.isfinite(now), now, np.inf), dtype=spec0.dtype, device=dev)
        bw_t = torch.as_tensor(np.maximum(self.bw_est, 1.0), dtype=spec0.dtype, device=dev)
        # occupancy-aware T^o: an override only when the calibrated estimate
        # deviates from the spec's nominal, so batching-free runs keep the
        # nominal's Python-float arithmetic
        st = (None if float(self.server_time) == spec0.server_time
              else torch.tensor(self.server_time, dtype=spec0.dtype, device=dev))
        m = len(self.acc_server)
        overflow = np.zeros(self.n_streams, dtype=bool)
        inexact = np.zeros(self.n_streams, dtype=bool)
        if len(self._torch_planner) == 1:
            _, planner, _ = self._torch_planner[0]
            out = planner(fleet, now_t, bw_t, st)
            batch = plan_batch_from_out(out, self.n_streams, m)
            overflow[:], inexact[:] = out.overflow.cpu().numpy(), out.inexact.cpu().numpy()
        else:
            batch = PlanBatch.empty(self.n_streams, m)
            for _, planner, streams in self._torch_planner:
                idx = torch.as_tensor(streams, device=dev)
                sub = PaddedFleet(fleet.arrival[idx], fleet.conf[idx], fleet.length[idx])
                out = planner(sub, now_t[idx], bw_t[idx], st)
                batch.scatter(streams, plan_batch_from_out(out, len(streams), m))
                overflow[streams], inexact[streams] = out.overflow.cpu().numpy(), out.inexact.cpu().numpy()
            batch.sort_offloads()
        self.last_overflow, self.last_inexact = overflow & active, inexact & active
        if not active.all():  # inactive streams keep PlanBatch.empty rows
            batch.theta[~active] = 0.0
            batch.resolution[~active] = m - 1
            batch.n_offloads[~active] = 0
            batch.total_gain[~active] = 0.0
            batch.base_acc[~active] = 0.0
            sel = active[batch.off_stream]
            batch.off_stream = batch.off_stream[sel]
            batch.off_pos = batch.off_pos[sel]
            batch.off_res = batch.off_res[sel]
            batch.off_kind = batch.off_kind[sel]
            batch.off_cut = batch.off_cut[sel]
        batch.n_frames = self.state.lengths.copy()
        batch.planned = active.copy()
        return batch.annotate_actions(self.actions)

    def consume(self, batch: PlanBatch) -> int:
        """Planned offloads left the device; one-shot streams clear fully."""
        clear = batch.planned & self._oneshot
        osh = self._oneshot[batch.off_stream]
        return self.state.consume(batch.off_stream[~osh], batch.off_pos[~osh], clear)

    def observe_frames(self, stream: np.ndarray, arrival: np.ndarray, conf: np.ndarray) -> None:
        """Batched ``add_frame`` for one round's locally-answered frames."""
        self.state.extend(stream, arrival, conf)

    def observe_bandwidth(self, stream: np.ndarray, payload: np.ndarray,
                          seconds: np.ndarray) -> None:
        """Fold one round's transfer observations into the EWMA vector.

        Bit-identical to calling ``BandwidthEstimator.observe`` per
        transfer in array order: observations are grouped by stream
        (stably, preserving transmission order) and folded depth-wise, so
        each stream's estimate sees the same sequence of
        ``(1-a)*est + a*rate`` updates the scalar path applies.
        """
        stream = np.asarray(stream, dtype=np.int64)
        payload = np.asarray(payload, dtype=np.float64)
        seconds = np.asarray(seconds, dtype=np.float64)
        ok = seconds > 1e-9  # same guard as the scalar estimator
        if not ok.any():
            return
        stream, rate = stream[ok], payload[ok] / seconds[ok]
        order = np.argsort(stream, kind="stable")
        s_sorted, rate = stream[order], rate[order]
        counts = np.bincount(s_sorted, minlength=self.n_streams)
        starts = np.r_[0, np.cumsum(counts)[:-1]]
        rank = np.arange(len(s_sorted)) - starts[s_sorted]
        K = int(counts.max())
        grid = np.zeros((self.n_streams, K))
        grid[s_sorted, rank] = rate
        a = self.bw_alpha
        for k in range(K):
            m = counts > k
            self.bw_est[m] = (1 - a) * self.bw_est[m] + a * grid[m, k]

    def retire(self, streams_mask: np.ndarray) -> None:
        """Drop all state of streams that left the fleet."""
        self.state.clear(np.asarray(streams_mask, dtype=bool))
