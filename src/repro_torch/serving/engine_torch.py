"""The whole fleet round in fixed shapes on one device (port of
``repro.serving.engine_jax``).

``MultiStreamServer.process_streams`` runs plan -> transmit -> observe ->
consume per round in host numpy (``serving/engine.py``).  This module is
the same round re-expressed in fixed shapes (``serve`` runs it for a
server built with ``backend="torch"``), so one round is one static
sequence of tensor operations: on the card it is captured once as a CUDA
graph and replayed once a round, with no host round trip between rounds;
on the CPU the same step runs eagerly.  The numpy engine stays the
semantic reference: every ordering rule (escalation gate, SFQ tags,
per-cell Lindley, placement, per-replica Lindley, EWMA fold) is reproduced
with the same tie-breaks, and ``tests/test_torch_engine.py`` holds the two
round for round.

Shape and masking scheme (the reference's):

  * rounds are padded to the batch size B: trailing partial rounds get
    ``valid=False`` slots with ``arrival=+inf`` (never gate, never count);
  * backlogs are a ``PaddedFleet`` of pad L == ``max_backlog``;
  * one round's escalations live in the flat (S*B,) row space (``flat =
    s*B + slot``); masked rows ride through every recursion as no-ops;
  * the neural tiers run outside the step: confidences and per-resolution
    slow-tier correctness are precomputed per round (deterministic per
    frame, so identical to the numpy path's escalated-only batching) and
    fed to it as (R, S, B[, m]) inputs.

Where the reference uses ``lax.scan`` / ``lax.while_loop`` / ``fori_loop``
the port unrolls a fixed number of steps: the scan becomes one graph
replay a round (``RoundLoop``), the fixed-point ``while_loop`` runs its
whole sweep cap with the starts frozen once settled (a settled fixed point
reproduces itself, so the values are the while-loop's bit for bit), and
the per-row placement and batch-formation loops are Python loops over the
static row count.  Nothing in the step reads a value back to the host: no
``.item()``, no boolean-mask indexing, no data-dependent Python branch,
and the spec's tables are tensors made once before the capture
(``EngineConsts``).  Those unrolled row loops make the graph grow with
S * B * K: ``RoundLoop`` warns above ``MAX_UNROLLED_ROWS``.

Exactness: float32 throughout, as the reference's engine, with the same
operations in the same order, so integer decisions match the float64
numpy engine on the tie-free workloads the differential tests use, and
floats within ``tests/_diff.py``'s tolerances.  A float running sum
(``_cumsum``) adds in sequence on the CPU, as the reference's CPU engine
does; on the card it is a log-step scan with one fixed association, so
it rounds differently from the CPU but the same in every run (torch's
own CUDA ``cumsum`` is a parallel scan whose association changes from
run to run).  Card and CPU agree in their integer outputs and within the
float tolerances; two runs on the card agree bit for bit.  Counter-mode
jitter is ``core.threefry``'s, the same bits on both devices.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.netsim import _FIXED_POINT_SWEEPS
from repro_torch.core.threefry import fma_f32, jitter_factors, prng_key
from repro_torch.device import resolve_device
from repro_torch.obs.profile import NULL_PROFILER, aot_split
from repro_torch.policy.fleet_torch import (PaddedFleet, PlannerSpec, PlanOut,
                                            clear_fleet, consume_fleet, ewma_fold, extend_fleet,
                                            plan_fleet, planner_tables, prune_fleet, unpad_fleet)
from repro_torch.serving import engine
from repro_torch.serving.metrics import AggregateMetrics

__all__ = ["EngineSpec", "EngineGroup", "EngineParams", "EngineConsts", "RoundInputs",
           "EngineCarry", "RoundTrace", "RoundLoop", "init_carry", "engine_consts",
           "make_engine", "simulate", "trace_lookup", "torch_unsupported", "supports_torch",
           "spec_from_server", "params_from_server", "serve", "unrolled_rows", "MAX_UNROLLED_ROWS"]

_NEG = -torch.inf
_INF = torch.inf

#: Unrolled per-row steps a round (``unrolled_rows``) above which
#: ``RoundLoop`` warns: ``chip_smoke.py``'s path 7 (a) unrolls 384 into a
#: graph of 19,213 kernels that replays in 36.7 ms on an H100 (700 W), so
#: 4,096 steps are ~200,000 kernels, ~0.4 s a round.
MAX_UNROLLED_ROWS = 4096


# --------------------------------------------------------------------------- #
# static spec + tuples of tensors
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class EngineGroup:
    """One policy group of a heterogeneous fleet (static): the group's
    planner (padded to the fleet-wide backlog width), the global stream
    indices it owns, and its consume/prune semantics."""

    planner: PlannerSpec
    streams: tuple  # global stream indices (FleetRunner group order)
    prune: bool = True  # BacklogPolicy.prune_expired
    oneshot: bool = False  # OneShotPolicy consume semantics
    mb: int = 0  # the group's own max_backlog (<= planner.L)


@dataclass(frozen=True)
class EngineSpec:
    """Everything the round step specializes on (the reference's fields)."""

    n_streams: int
    batch: int  # B: round batch size (rounds are padded to it)
    n_cells: int
    n_replicas: int
    planner: PlannerSpec
    placement: str = "round_robin"  # round_robin | jsq | least_land
    serial_replicas: bool = False
    scheduler: str = "round_robin"  # round_robin | fifo
    prune: bool = True  # BacklogPolicy.prune_expired
    oneshot: bool = False  # OneShotPolicy consume semantics
    t_fast: float = 0.028  # fast_time + calib_time
    bw_alpha: float = 0.3
    collect: str = "metrics"  # none | metrics | trace
    # continuous-batching slow tier: "none" = per-request service.
    # coeffs: flat=(st,); linear=(base, per_item); step=(base, per_page, page_size)
    batch_kind: str = "none"  # none | flat | linear | step
    batch_coeffs: tuple = ()
    batch_window: float = 0.0  # admission window (s)
    batch_cap: int = 0  # occupancy cap per batch; 0 = unbounded
    batch_beta: float = 0.25  # occupancy EWMA fold
    # heterogeneous fleets: one EngineGroup per policy group; () is the
    # homogeneous single-planner step with spec-level prune/oneshot
    groups: tuple = ()
    # time-varying uplinks: trace replay and/or counter-mode jitter
    varying: bool = False
    cell_jitter: tuple = ()  # (C,) per-cell jitter amplitude (0.0 = none)
    cell_seed: tuple = ()  # (C,) per-cell jitter seeds
    cell_trace: tuple = ()  # (C,) bool: the cell replays a BandwidthTrace
    cell_loop: tuple = ()  # (C,) bool: the trace wraps at trace_dur
    # split-computation action table (full A-length vectors, frames first;
    # () = frames only)
    act_t_dev: tuple = ()  # (A,) device prefix seconds per action
    act_srv_frac: tuple = ()  # (A,) fraction of replica service per action
    act_res: tuple = ()  # (A,) evaluation resolution index per action
    # telemetry: the FleetRecorder's per-round series as extra outputs
    telemetry: bool = False

    @property
    def has_splits(self) -> bool:
        return bool(self.act_t_dev)

    @property
    def m(self) -> int:
        return self.planner.m

    @property
    def deadline(self) -> float:
        return self.planner.deadline

    @property
    def latency(self) -> float:
        return self.planner.latency


class EngineConsts(NamedTuple):
    """The spec's static tables as tensors on the engine's device, made
    once by ``engine_consts`` before the round is captured (a copy from
    the host cannot run inside a capture)."""

    tables: tuple  # PlannerTables: (the planner's,) or one per group
    group_idx: tuple  # (n_g,) int64 global stream indices per group
    g_prune: Optional[torch.Tensor]  # (S,) bool, per-group prune (groups only)
    g_oneshot: Optional[torch.Tensor]  # (S,) bool (groups only)
    g_mb: Optional[torch.Tensor]  # (S,) int32 per-group max_backlog (groups only)
    act_t_dev: Optional[torch.Tensor]  # (A,) split actions only
    act_srv_frac: Optional[torch.Tensor]  # (A,)
    act_res: Optional[torch.Tensor]  # (A,) int64


class EngineParams(NamedTuple):
    """Per-run tensors the step reads (on the engine's device).  The trace
    grids are ``None`` unless some cell replays a ``BandwidthTrace``;
    ``consts`` is ``engine_consts(spec)``, made by ``RoundLoop`` when not
    given."""

    sizes: torch.Tensor  # (A,) payload bytes per action (== (m,) frames only)
    cell_bw: torch.Tensor  # (C,) base bytes/s (trace cells: nominal base)
    cell_of: torch.Tensor  # (S,) int64
    replica_st: torch.Tensor  # (K,) per-replica service time
    stream_bw: torch.Tensor  # (S,) nominal cell rate (scheduler normalizer)
    weights: torch.Tensor  # (S,) scheduler weights (ones = unweighted)
    bw_init: torch.Tensor  # (S,) EWMA prior
    trace_t: Optional[torch.Tensor] = None  # (C, T) breakpoints, +inf-padded
    trace_bps: Optional[torch.Tensor] = None  # (C, T) rates, last repeated
    trace_dur: Optional[torch.Tensor] = None  # (C,) loop periods
    consts: Optional[EngineConsts] = None


class RoundInputs(NamedTuple):
    """One round of precomputed data-plane inputs (stacked to (R, ...))."""

    arr: torch.Tensor  # (S, B) arrival seconds; +inf on invalid slots
    valid: torch.Tensor  # (S, B) bool
    conf: torch.Tensor  # (S, B) calibrated confidence (fast pass)
    fast_ok: torch.Tensor  # (S, B) bool: fast prediction correct
    slow_ok: torch.Tensor  # (S, B, m) bool: slow prediction correct per res


class EngineCarry(NamedTuple):
    fleet: PaddedFleet
    bw_est: torch.Tensor  # (S,)
    cell_busy: torch.Tensor  # (C,) uplink busy-until cursors
    cell_n: torch.Tensor  # (C,) int32 transfer counts
    cell_busy_s: torch.Tensor  # (C,)
    cell_queued_s: torch.Tensor  # (C,)
    rep_busy: torch.Tensor  # (K,)
    rep_n: torch.Tensor  # (K,) int32
    rep_busy_s: torch.Tensor  # (K,)
    rep_queued_s: torch.Tensor  # (K,)
    rr_next: torch.Tensor  # () int32 round-robin placement cursor
    frames: torch.Tensor  # (S,) int32
    offloaded: torch.Tensor  # (S,) int32
    missed: torch.Tensor  # (S,) int32
    correct: torch.Tensor  # (S,) int32
    avg_batch: torch.Tensor  # () slow-tier occupancy EWMA (1.0 = serial)
    # time-varying uplinks only:
    jit_key: Optional[torch.Tensor] = None  # (C, 2) int64 words: per-cell threefry keys
    fp_bad: Optional[torch.Tensor] = None  # () bool: a fixed point never settled


class RoundTrace(NamedTuple):
    """Per-round outputs (``collect`` >= "metrics"; "trace" adds decisions)."""

    off_counts: torch.Tensor  # (S,) int32
    miss_counts: torch.Tensor  # (S,) int32
    correct: torch.Tensor  # (S,) int32
    lat: torch.Tensor  # (S, B)
    # -- collect == "trace" extras (zero-size placeholders otherwise) ----- #
    theta: torch.Tensor
    res_idx: torch.Tensor
    cap: torch.Tensor
    n_off: torch.Tensor
    n_frames: torch.Tensor  # post-prune backlog lengths at plan time
    dec: torch.Tensor  # (S, L) int8
    esc: torch.Tensor  # (S, B) bool
    ok: torch.Tensor  # (S, B) bool
    bw_est: torch.Tensor  # (S,) after the round's EWMA fold
    lengths: torch.Tensor  # (S,) backlog lengths after extend
    overflow: torch.Tensor  # (S,) bool
    inexact: torch.Tensor  # (S,) bool
    # -- spec.telemetry extras -------------------------------------------- #
    ts_bw_est: Optional[torch.Tensor] = None  # (S,) post-fold EWMA
    ts_off_hist: Optional[torch.Tensor] = None  # (A,) int32 planned offloads
    ts_cell_busy_s: Optional[torch.Tensor] = None  # (C,) carry-relative
    ts_cell_queued_s: Optional[torch.Tensor] = None  # (C,)
    ts_rep_busy_s: Optional[torch.Tensor] = None  # (K,)
    ts_rep_queued_s: Optional[torch.Tensor] = None  # (K,)
    ts_avg_batch: Optional[torch.Tensor] = None  # () post-round EWMA
    ts_st_est: Optional[torch.Tensor] = None  # () planner's T^o this round


def init_carry(spec: EngineSpec, params: EngineParams) -> EngineCarry:
    """A fresh carry on ``params``' device."""
    S, C, K, L = spec.n_streams, spec.n_cells, spec.n_replicas, spec.planner.L
    dt, dev = spec.planner.dtype, params.bw_init.device
    z = lambda *s: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)  # noqa: E731
    extra = {}
    if spec.varying:
        extra["fp_bad"] = torch.zeros((), dtype=torch.bool, device=dev)
        if any(j > 0 for j in spec.cell_jitter):
            extra["jit_key"] = torch.stack([prng_key(s, device=dev) for s in spec.cell_seed])
    return EngineCarry(
        fleet=PaddedFleet(z(S, L), z(S, L), zi(S)),
        bw_est=params.bw_init.to(dt).clone(),
        cell_busy=z(C), cell_n=zi(C), cell_busy_s=z(C), cell_queued_s=z(C),
        rep_busy=z(K), rep_n=zi(K), rep_busy_s=z(K), rep_queued_s=z(K),
        rr_next=zi(), frames=zi(S), offloaded=zi(S), missed=zi(S), correct=zi(S),
        avg_batch=torch.ones((), dtype=dt, device=dev), **extra)


def engine_consts(spec: EngineSpec, device) -> EngineConsts:
    """The spec's static tables on ``device``: the planners' tables, the
    policy groups' stream indices and per-stream flags, and the split
    action table."""
    dev = torch.device(device)
    dt = spec.planner.dtype
    planners = tuple(g.planner for g in spec.groups) or (spec.planner,)
    tables = tuple(planner_tables(p, dev) for p in planners)
    group_idx = tuple(torch.tensor(g.streams, dtype=torch.int64, device=dev) for g in spec.groups)
    flags = (None,) * 3
    if spec.groups:
        prune, oneshot, mb = _group_flags(spec)
        flags = (torch.as_tensor(prune, device=dev), torch.as_tensor(oneshot, device=dev),
                 torch.as_tensor(mb, dtype=torch.int32, device=dev))
    acts = (None,) * 3
    if spec.has_splits:
        acts = (torch.tensor(spec.act_t_dev, dtype=dt, device=dev),
                torch.tensor(spec.act_srv_frac, dtype=dt, device=dev),
                torch.tensor(spec.act_res, dtype=torch.int64, device=dev))
    return EngineConsts(tables, group_idx, *flags, *acts)


def unrolled_rows(spec: EngineSpec) -> int:
    """Per-row steps the round unrolls into its graph: the jsq/least_land
    placement scan's S * B rows and the continuous-batching loop's S * B
    steps for each of the K replicas."""
    N = spec.n_streams * spec.batch
    return ((N if spec.placement != "round_robin" else 0)
            + (spec.n_replicas * N if spec.batch_kind != "none" else 0))


# --------------------------------------------------------------------------- #
# masked recursions
# --------------------------------------------------------------------------- #


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running float sum along dim 0 with one association every run: on
    the CPU ``torch.cumsum``, which adds in sequence as the reference's CPU
    engine does; on the card ``_log_step_scan``."""
    return _log_step_scan(x) if x.is_cuda else torch.cumsum(x, 0)


def _log_step_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along dim 0 by the log-step (Hillis-Steele) scan: add
    the sums shifted by 1, 2, 4, ... rows, ceil(log2 n) elementwise adds,
    the same association on every device, in every run and capture."""
    n, k = x.shape[0], 1
    while k < n:
        x = torch.cat([x[:k], x[k:] + x[:-k]])
        k *= 2
    return x


def _argsort(key: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable ascending argsort (booleans as uint8)."""
    if key.dtype == torch.bool:
        key = key.to(torch.uint8)
    return torch.argsort(key, dim=dim, stable=True)


def _first_min(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum of a 1-D tensor (``jnp.argmin``'s choice
    among ties), from a mask."""
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.amin(), idx, x.shape[0]).amin()


def _masked_lindley(sub, tx, mask, busy0):
    """end_i = max(sub_i, end_{i-1}) + tx_i over the masked rows, masked
    rows exact no-ops (tx=0 / sub=-inf rows contribute ``busy0 - excl <=
    busy0``, which the first live row already dominates).  Returns (end,
    new_busy, wire, queued)."""
    txm = torch.where(mask, tx, 0.0)
    subm = torch.where(mask, sub, _NEG)
    csum = _cumsum(txm)
    eff = torch.maximum(subm, busy0) - (csum - txm)
    end = torch.cummax(eff, 0).values + csum
    new_busy = torch.where(mask.any(), torch.where(mask, end, _NEG).amax(), busy0)
    wire = txm.sum()
    queued = torch.where(mask, torch.clamp_min(end - txm - subm, 0.0), 0.0).sum()
    return end, new_busy, wire, queued


def _lexsort2(primary, rows_sorted_by_secondary):
    """Stable argsort by ``primary`` on top of an existing stable secondary
    order: the composed-argsort form of ``np.lexsort``."""
    o = rows_sorted_by_secondary
    return o[_argsort(primary[o])]


def _mod(x, y):
    """``jnp.mod`` for floats: C ``fmod`` plus the sign fix (the result
    takes the divisor's sign)."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


def trace_lookup(t_grid, bps_grid, ts):
    """Rate in effect at each time over one padded breakpoint grid:
    ``BandwidthTrace.bandwidth_at``'s right ``searchsorted`` minus one.
    Callers take looping times mod the period first; the +inf pad
    breakpoints never capture a finite time."""
    idx = torch.searchsorted(t_grid, ts.contiguous(), right=True) - 1
    return bps_grid[idx.clamp(0, t_grid.shape[0] - 1)]


def _cell_bw_at(spec: EngineSpec, params: EngineParams, c: int, key_c, ts):
    """Instantaneous bandwidth of cell ``c`` at times ``ts``:
    ``Uplink.bandwidth_at`` on the device, trace replay (looping times mod
    the period) times the counter-mode jitter factors drawn at the integer
    second (``core.threefry``, the bits the host ``Uplink`` draws)."""
    dt = spec.planner.dtype
    if spec.cell_trace[c]:
        tm = _mod(ts, params.trace_dur[c]) if spec.cell_loop[c] else ts
        base = trace_lookup(params.trace_t[c], params.trace_bps[c], tm)
    else:
        base = params.cell_bw[c].to(dt).expand(ts.shape)
    if spec.cell_jitter[c] > 0:
        base = base * jitter_factors(key_c, ts.to(torch.int32), spec.cell_jitter[c]).to(dt)
    return base


def _masked_lindley_varying(spec: EngineSpec, params: EngineParams, c: int,
                            key_c, sub, mask, payload, busy0):
    """Time-varying masked Lindley: each row's rate depends on its start,
    which depends on the previous row's end.  ``Uplink.upload_batch``'s
    fixed-point iteration (guess the starts, look every rate up, re-run
    the recursion) for the whole sweep cap, the state frozen once the
    starts stop moving: the reference's ``while_loop`` values bit for bit.
    A fixed point that never settles raises the sticky ``fp_bad`` flag
    (the numpy path's exact serial fallback has no fixed-shape analogue).
    Returns ``(end, new_busy, wire, queued, fp_bad)``."""
    subm = torch.where(mask, sub, _NEG)
    base = torch.maximum(subm, busy0)  # eff numerator == the start guess

    def sweep(starts):
        ts = torch.where(mask, starts, 0.0)  # guard masked +inf/-inf rows
        bw = _cell_bw_at(spec, params, c, key_c, ts)
        tx = torch.where(mask, payload / bw, 0.0)
        csum = _cumsum(tx)
        end = torch.cummax(base - (csum - tx), 0).values + csum
        return end, tx

    def settled(a, b):  # np.array_equal over the live rows
        return (torch.where(mask, a, 0.0) == torch.where(mask, b, 0.0)).all()

    end, tx = sweep(base)
    starts = end - tx
    conv = settled(starts, base)
    for _ in range(_FIXED_POINT_SWEEPS - 1):
        end_n, tx_n = sweep(starts)
        starts_n = end_n - tx_n
        conv_n = settled(starts_n, starts)
        end = torch.where(conv, end, end_n)
        tx = torch.where(conv, tx, tx_n)
        starts = torch.where(conv, starts, starts_n)
        conv = conv | conv_n
    any_live = mask.any()
    new_busy = torch.where(any_live, torch.where(mask, end, _NEG).amax(), busy0)
    wire = tx.sum()
    queued = torch.where(mask, torch.clamp_min(end - tx - subm, 0.0), 0.0).sum()
    return end, new_busy, wire, queued, any_live & ~conv


def _plan_groups(spec: EngineSpec, consts: EngineConsts, fleet: PaddedFleet, now, bw, st_eff):
    """Heterogeneous control plane: gather each policy group's streams, run
    the group's own planner, scatter the outputs back (``FleetRunner
    .plan_all``'s group loop with static index sets).  Streams outside
    every group keep the inactive-row defaults (dec=-1, theta=0, r°=m-1)."""
    S, L, m = spec.n_streams, spec.planner.L, spec.m
    dt, dev = spec.planner.dtype, fleet.arrival.device
    out = PlanOut(
        dec=torch.full((S, L), -1, dtype=torch.int8, device=dev),
        theta=torch.zeros(S, dtype=dt, device=dev),
        resolution=torch.full((S,), m - 1, dtype=torch.int32, device=dev),
        n_offloads=torch.zeros(S, dtype=torch.int32, device=dev),
        total_gain=torch.zeros(S, dtype=dt, device=dev),
        base_acc=torch.zeros(S, dtype=dt, device=dev),
        n_frames=fleet.length,
        overflow=torch.zeros(S, dtype=torch.bool, device=dev),
        inexact=torch.zeros(S, dtype=torch.bool, device=dev))
    for g, idx, tables in zip(spec.groups, consts.group_idx, consts.tables):
        sub = PaddedFleet(fleet.arrival[idx], fleet.conf[idx], fleet.length[idx])
        p = plan_fleet(g.planner, sub, now[idx], bw[idx], st_eff, tables)
        out = PlanOut(*(o if k == "n_frames" else o.index_copy(0, idx, getattr(p, k).to(o.dtype))
                        for k, o in zip(PlanOut._fields, out)))
    return out


def _group_flags(spec: EngineSpec):
    """Static per-stream (prune, oneshot, max_backlog) rows from the group
    table; ungrouped streams get (False, False, 0)."""
    S = spec.n_streams
    prune = np.zeros(S, dtype=bool)
    oneshot = np.zeros(S, dtype=bool)
    mb = np.zeros(S, dtype=np.int32)
    for g in spec.groups:
        ss = list(g.streams)
        prune[ss] = g.prune
        oneshot[ss] = g.oneshot
        mb[ss] = g.mb
    return prune, oneshot, mb


def _batch_latency(spec: EngineSpec, n):
    """The slow tier's latency curve f(n) from the flat static coefficients
    (``slowtier``'s LatencyModel classes on tensors)."""
    c = spec.batch_coeffs
    if spec.batch_kind == "flat":
        return c[0] * n
    if spec.batch_kind == "linear":
        return c[0] + c[1] * n
    if spec.batch_kind == "step":
        return c[0] + c[1] * torch.ceil(n / c[2])
    raise ValueError(f"unknown batch_kind {spec.batch_kind!r}")


def _set(t: torch.Tensor, i: int, v) -> torch.Tensor:
    """``t.at[i].set(v)`` (out of place) for a static index."""
    out = t.clone()
    out[i] = v
    return out


# --------------------------------------------------------------------------- #
# the round step
# --------------------------------------------------------------------------- #


def _round_step(spec: EngineSpec, params: EngineParams, carry: EngineCarry, x: RoundInputs):
    S, B, C, K = spec.n_streams, spec.batch, spec.n_cells, spec.n_replicas
    L, m = spec.planner.L, spec.m
    dt = spec.planner.dtype
    dev = carry.bw_est.device
    consts = params.consts
    N = S * B
    i32 = torch.int32
    arr = x.arr.to(dt)
    valid, conf = x.valid, x.conf.to(dt)

    # (1) active streams; retire the rest (FleetRunner.retire)
    active = valid.any(dim=1)
    fleet = clear_fleet(carry.fleet, ~active)

    # (2) control plane: prune + one batched plan (FleetRunner.plan_all);
    # heterogeneous fleets prune per group's policy and plan group by group
    now = arr.amin(dim=1)  # first valid arrival; +inf when none
    if spec.groups:
        prune_mask = active & consts.g_prune
    else:
        prune_mask = active if spec.prune else torch.zeros_like(active)
    fleet = prune_fleet(fleet, now, spec.deadline, prune_mask)
    bw_plan = torch.clamp_min(carry.bw_est, 1.0)  # same dead-link floor
    st_eff = None
    if spec.batch_kind != "none":
        # occupancy-calibrated T^o = f(expected_batch)/expected_batch at the
        # observed occupancy EWMA (ReplicaPool.expected_server_time)
        nb = torch.clamp_min(carry.avg_batch, 1.0)
        st_eff = (_batch_latency(spec, nb) / nb).to(dt)
    if spec.groups:
        plan = _plan_groups(spec, consts, fleet, now, bw_plan, st_eff)
    else:
        plan = plan_fleet(spec.planner, fleet, now, bw_plan, st_eff, consts.tables[0])
    theta = torch.where(active, plan.theta, 0.0)
    res_idx = torch.where(active, plan.resolution, m - 1)
    res_l = res_idx.long()
    n_off = torch.where(active, plan.n_offloads, 0)
    dec = torch.where(active[:, None], plan.dec, -1)
    cap = torch.where(active, torch.clamp_min(n_off, 1), 0)

    # (3) escalation gate (select_escalations): per stream the cap lowest
    # confidences below theta (stable conf argsort + cumsum gate)
    conf_gate = torch.where(valid, conf, _INF)
    o_slot = _argsort(conf_gate, dim=1)
    gate_sorted = (conf_gate < theta[:, None]).gather(1, o_slot)
    take_sorted = gate_sorted & (torch.cumsum(gate_sorted.to(i32), dim=1) <= cap[:, None])
    esc = torch.zeros((S, B), dtype=torch.bool, device=dev).scatter(1, o_slot, take_sorted)

    payload_s = params.sizes[res_l].to(dt)  # (S,) planned upload bytes
    t_ready = arr + spec.t_fast
    if spec.has_splits:
        # a split action's upload leaves the device only after the model
        # prefix runs: shifts SFQ readiness and the wire submit below
        t_dev_s = consts.act_t_dev[res_l]  # (S,)
        t_ready = t_ready + t_dev_s[:, None]

    # (4) fair uplink schedule (FairScheduler.order).  Cost is constant per
    # stream within a round, so the SFQ tag recurrence unrolls over slots
    esc_flat = esc.reshape(-1)
    o = _argsort(torch.where(esc, t_ready, _INF).reshape(-1))  # ties keep (stream, slot)
    if spec.scheduler == "round_robin":
        cost_s = payload_s / params.stream_bw / params.weights
        cols = []
        prev = torch.full((S,), _NEG, dtype=dt, device=dev)
        for d in range(B):
            cand = torch.maximum(t_ready[:, d], prev + cost_s)
            cols.append(torch.where(esc[:, d], cand, _INF))
            prev = torch.where(esc[:, d], cand, prev)
        o = _lexsort2(torch.stack(cols, dim=1).reshape(-1), o)

    # (5) fabric transmit: per-cell masked Lindley over the scheduled rows
    stream_flat = torch.arange(S, device=dev)[:, None].expand(S, B).reshape(-1)
    s_o = stream_flat[o]
    m_o = esc_flat[o]
    sub_o = x.arr.reshape(-1)[o] + spec.t_fast  # real t_ready per row
    if spec.has_splits:
        sub_o = sub_o + t_dev_s[s_o]  # the prefix runs before the upload
    pay_o = params.sizes[res_l[s_o]].to(dt)
    cell_o = params.cell_of[s_o]
    end_tx = torch.zeros(N, dtype=dt, device=dev)
    cell_busy, cell_n = carry.cell_busy, carry.cell_n
    cell_busy_s, cell_queued_s = carry.cell_busy_s, carry.cell_queued_s
    fp_bad = carry.fp_bad
    for c in range(C):
        mk = m_o & (cell_o == c)
        if spec.varying and (spec.cell_trace[c] or spec.cell_jitter[c] > 0):
            key_c = None if carry.jit_key is None else carry.jit_key[c]
            end_c, busy_c, wire_c, queued_c, bad_c = _masked_lindley_varying(
                spec, params, c, key_c, sub_o, mk, pay_o, cell_busy[c])
            fp_bad = fp_bad | bad_c
        else:
            end_c, busy_c, wire_c, queued_c = _masked_lindley(
                sub_o, pay_o / params.cell_bw[c], mk, cell_busy[c])
        end_tx = torch.where(mk, end_c, end_tx)
        cell_busy = _set(cell_busy, c, busy_c)
        cell_n = _set(cell_n, c, cell_n[c] + mk.sum().to(i32))
        cell_busy_s = _set(cell_busy_s, c, cell_busy_s[c] + wire_c)
        cell_queued_s = _set(cell_queued_s, c, cell_queued_s[c] + queued_c)

    # (6) replica placement in upload-arrival order (Placement.assign)
    end_m = torch.where(m_o, end_tx, _INF)
    o2 = _argsort(end_m)  # ties keep scheduler order
    m2 = m_o[o2]
    rr_next = carry.rr_next
    if spec.placement == "round_robin":
        rank = torch.cumsum(m2.to(i32), 0) - 1
        rep2 = (rr_next + rank) % K
        rr_next = ((rr_next + m_o.sum().to(i32)) % K).to(i32)
    else:
        # one row at a time in arrival order (the reference's lax.scan):
        # the chosen replica's cursor moves to max(t, busy) + st
        st = params.replica_st.to(dt)
        kk = torch.arange(K, device=dev)
        busy = carry.rep_busy.to(dt)
        t2 = end_m[o2]
        picks = []
        for i in range(N):
            land = torch.maximum(t2[i], busy) + st
            k = _first_min(busy if spec.placement == "jsq" else land)
            busy = torch.where(m2[i] & (kk == k), land, busy)
            picks.append(torch.where(m2[i], k, 0))
        rep2 = torch.stack(picks)
    replica_o = torch.zeros(N, dtype=torch.int64, device=dev).scatter(0, o2, rep2.long())

    # (7) replica pool service (ReplicaPool.process)
    rep_busy, rep_n = carry.rep_busy, carry.rep_n
    rep_busy_s, rep_queued_s = carry.rep_busy_s, carry.rep_queued_s
    st_row = params.replica_st[replica_o].to(dt)
    if spec.has_splits:
        # split suffixes cost srv_frac of the replica's service time; not
        # combinable with continuous batching (torch_unsupported rejects it)
        srv_o = consts.act_srv_frac[res_l[s_o]]  # (N,)
        st_row = st_row * srv_o
    service_o = st_row  # per-row reported processing time
    avg_batch = carry.avg_batch
    if spec.batch_kind != "none":
        # continuous batching (ReplicaPool._process_batched): per replica,
        # admission-window batch formation over arrival-sorted rows; each
        # step forms one batch through a rank-space pointer, N steps a
        # replica (the reference's fori_loop)
        w = spec.batch_window
        bcap = spec.batch_cap if spec.batch_cap > 0 else N
        repk = torch.where(m_o, replica_o, K)
        o3 = _lexsort2(repk.to(dt), _argsort(torch.where(m_o, end_tx, _INF)))
        m3 = m_o[o3]
        a3, k3 = end_tx[o3], repk[o3]
        done3 = torch.zeros(N, dtype=dt, device=dev)
        serv3 = torch.zeros(N, dtype=dt, device=dev)
        size3 = torch.zeros(N, dtype=dt, device=dev)
        for k in range(K):
            mk = m3 & (k3 == k)
            n_k = mk.sum().to(i32)
            rk = torch.cumsum(mk.to(i32), 0) - 1  # rank within replica
            p = torch.zeros((), dtype=i32, device=dev)
            busy = rep_busy[k].to(dt)
            wire_k = torch.zeros((), dtype=dt, device=dev)
            queued_k = torch.zeros((), dtype=dt, device=dev)
            for _ in range(N):
                live = p < n_k
                rem = mk & (rk >= p)  # not-yet-batched rows, a3 ascending
                a0 = torch.where(rem, a3, _INF).amin()
                t_open = torch.maximum(busy, a0)
                nwin = (rem & (a3 <= t_open + w)).sum().to(i32)
                count = torch.clamp_max(nwin, bcap)
                member = rem & (rk < p + count)  # smallest-a3 rows first
                arr_last = torch.where(member, a3, _NEG).amax()
                # cap binding: launch at the last member's landing; else
                # when the admission window closes
                t_start = torch.where(nwin > bcap, torch.maximum(t_open, arr_last), t_open + w)
                fb = _batch_latency(spec, count.to(dt))
                done_v = t_start + fb
                upd = member & live
                done3 = torch.where(upd, done_v, done3)
                serv3 = torch.where(upd, fb, serv3)
                size3 = torch.where(upd, count.to(dt), size3)
                wire_k = wire_k + torch.where(live, fb, 0.0)
                queued_k = queued_k + torch.where(upd, t_start - a3, 0.0).sum()
                busy = torch.where(live, done_v, busy)
                p = p + torch.where(live, count, 0)
            rep_busy = _set(rep_busy, k, busy)
            rep_n = _set(rep_n, k, rep_n[k] + n_k)
            rep_busy_s = _set(rep_busy_s, k, rep_busy_s[k] + wire_k)
            rep_queued_s = _set(rep_queued_s, k, rep_queued_s[k] + queued_k)
        done_o = torch.zeros(N, dtype=dt, device=dev).scatter(0, o3, done3)
        service_o = torch.zeros(N, dtype=dt, device=dev).scatter(0, o3, serv3)
        size_o = torch.zeros(N, dtype=dt, device=dev).scatter(0, o3, size3)
        n_live = m_o.sum().to(i32)
        obs = torch.where(m_o, size_o, 0.0).sum() / torch.clamp_min(n_live, 1)
        # XLA contracts this fold into one fused multiply-add; so does the port
        fold = fma_f32(torch.full((), 1.0 - spec.batch_beta, dtype=dt, device=dev), carry.avg_batch,
                       spec.batch_beta * obs)
        avg_batch = torch.where(n_live > 0, fold, carry.avg_batch)
    elif spec.serial_replicas:
        repk = torch.where(m_o, replica_o, K)
        o3 = _lexsort2(repk.to(dt), _argsort(torch.where(m_o, end_tx, _INF)))
        m3 = m_o[o3]
        a3, k3 = end_tx[o3], repk[o3]
        done3 = torch.zeros(N, dtype=dt, device=dev)
        for k in range(K):
            mk = m3 & (k3 == k)
            st_k = (params.replica_st[k].to(dt) * srv_o[o3] if spec.has_splits
                    else params.replica_st[k].to(dt).expand(N))
            end_k, busy_k, wire_k, queued_k = _masked_lindley(a3, st_k, mk, rep_busy[k])
            done3 = torch.where(mk, end_k, done3)
            rep_busy = _set(rep_busy, k, busy_k)
            rep_n = _set(rep_n, k, rep_n[k] + mk.sum().to(i32))
            rep_busy_s = _set(rep_busy_s, k, rep_busy_s[k] + wire_k)
            rep_queued_s = _set(rep_queued_s, k, rep_queued_s[k] + queued_k)
        done_o = torch.zeros(N, dtype=dt, device=dev).scatter(0, o3, done3)
    else:  # infinite-capacity fixed delay (paper semantics)
        done_o = end_tx + st_row
        for k in range(K):
            mk = m_o & (replica_o == k)
            rep_n = _set(rep_n, k, rep_n[k] + mk.sum().to(i32))
            rep_busy_s = _set(rep_busy_s, k, rep_busy_s[k] + torch.where(mk, st_row, 0.0).sum())
            rep_busy = _set(rep_busy, k, torch.maximum(
                rep_busy[k], torch.where(mk, done_o, _NEG).amax()))
    lands_o = done_o + spec.latency

    # (8) deadline check + final correctness
    inv = torch.empty_like(o).scatter_(0, o, torch.arange(N, device=dev))  # row -> grid
    arr_o = x.arr.reshape(-1)[o].to(dt)
    ok_o = m_o & (lands_o <= arr_o + spec.deadline)
    lands_grid = lands_o[inv].reshape(S, B)
    ok_grid = ok_o[inv].reshape(S, B)
    eval_res = consts.act_res[res_l] if spec.has_splits else res_l  # action -> evaluation resolution
    slow_sel = x.slow_ok.gather(2, eval_res[:, None, None].expand(S, B, 1))[..., 0]
    final_ok = torch.where(ok_grid, slow_sel, x.fast_ok)
    correct_r = (final_ok & valid).sum(dim=1).to(i32)

    # (9) EWMA bandwidth observations in transmission order
    # (FleetRunner.observe_bandwidth; replica queueing deliberately included;
    # replies report their actual processing time)
    seconds_o = lands_o - sub_o - spec.latency - service_o
    okbw = m_o & (seconds_o > 1e-9)
    rate_o = pay_o / torch.where(okbw, seconds_o, 1.0)
    bw_est = ewma_fold(carry.bw_est, spec.bw_alpha, s_o, rate_o, okbw, S, B)

    # (10) backlog bookkeeping: consume planned offloads, extend the rest
    add = valid & ~esc
    if spec.groups:
        # mixed per-policy semantics: one consume pass takes the non-oneshot
        # offloads and clears the oneshot streams, then extend trims each
        # stream to its group's bound
        osh = consts.g_oneshot
        fleet = consume_fleet(fleet, (dec >= 0) & ~osh[:, None], osh & active)
        fleet = extend_fleet(fleet, arr, conf, add, consts.g_mb)
    else:
        if spec.oneshot:
            fleet = clear_fleet(fleet, active)
        else:
            fleet = consume_fleet(fleet, dec >= 0, torch.zeros_like(active))
        fleet = extend_fleet(fleet, arr, conf, add, L)

    # (11) metrics (AggregateMetrics.update_round inputs)
    lat = torch.where(ok_grid, lands_grid - arr, spec.t_fast)
    miss_grid = esc & ~ok_grid
    lat = torch.where(miss_grid, spec.deadline, lat).to(dt)
    off_counts = ok_grid.sum(dim=1).to(i32)
    miss_counts = miss_grid.sum(dim=1).to(i32)

    out = EngineCarry(
        fleet=fleet, bw_est=bw_est,
        cell_busy=cell_busy, cell_n=cell_n, cell_busy_s=cell_busy_s,
        cell_queued_s=cell_queued_s,
        rep_busy=rep_busy, rep_n=rep_n, rep_busy_s=rep_busy_s,
        rep_queued_s=rep_queued_s, rr_next=rr_next,
        frames=carry.frames + valid.sum(dim=1).to(i32),
        offloaded=carry.offloaded + off_counts,
        missed=carry.missed + miss_counts,
        correct=carry.correct + correct_r,
        avg_batch=avg_batch, jit_key=carry.jit_key, fp_bad=fp_bad)

    if spec.collect == "none":
        if spec.telemetry:
            raise ValueError("spec.telemetry needs collect >= 'metrics': the "
                             "recorder's series ride on the round outputs")
        return out, None
    z0 = torch.zeros(0, device=dev)
    extras = dict(theta=z0, res_idx=z0, cap=z0, n_off=z0, n_frames=z0,
                  dec=z0, esc=z0, ok=z0, bw_est=z0, lengths=z0,
                  overflow=z0, inexact=z0)
    if spec.collect == "trace":
        extras = dict(theta=theta, res_idx=res_idx, cap=cap, n_off=n_off,
                      n_frames=plan.n_frames, dec=dec, esc=esc, ok=ok_grid,
                      bw_est=bw_est, lengths=fleet.length,
                      overflow=plan.overflow, inexact=plan.inexact)
    if spec.telemetry:
        # the FleetRecorder's per-round record: the cumulative per-stream
        # counters come from host cumsums of the off/miss/correct columns,
        # so only the simulated-state series are emitted here; every planned
        # offload of stream s carries action res_idx[s]
        A = params.sizes.shape[0]
        extras.update(
            ts_bw_est=bw_est,
            ts_off_hist=torch.zeros(A, dtype=i32, device=dev).index_add_(0, res_l, n_off.to(i32)),
            ts_cell_busy_s=cell_busy_s, ts_cell_queued_s=cell_queued_s,
            ts_rep_busy_s=rep_busy_s, ts_rep_queued_s=rep_queued_s,
            ts_avg_batch=avg_batch,
            ts_st_est=(st_eff if st_eff is not None
                       else torch.full((), spec.planner.server_time, dtype=dt, device=dev)))
    ys = RoundTrace(off_counts=off_counts, miss_counts=miss_counts,
                    correct=correct_r, lat=lat, **extras)
    return out, ys


# --------------------------------------------------------------------------- #
# the round loop: one CUDA graph replay a round
# --------------------------------------------------------------------------- #


def _leaves(t) -> list:
    """The tensors of a (nested) tuple of tensors, ``None`` skipped."""
    if t is None:
        return []
    if torch.is_tensor(t):
        return [t]
    return [x for item in t for x in _leaves(item)]


class RoundLoop:
    """One run's rounds on static buffers: ``step()`` advances one round in
    place (the carry's tensors, the round index, the stacked outputs), so
    the same step can be captured once and replayed once a round.

    ``carry`` is consumed: its tensors are the loop's state and hold the
    final carry after the last round (the reference donates its carry).
    ``params.consts`` is made here when not given."""

    def __init__(self, spec: EngineSpec, params: EngineParams, carry: EngineCarry,
                 inputs: RoundInputs):
        if params.consts is None:
            params = params._replace(consts=engine_consts(spec, carry.bw_est.device))
        n = unrolled_rows(spec)
        if n > MAX_UNROLLED_ROWS:
            warnings.warn(
                f"the round unrolls {n} per-row steps (jsq/least_land placement and "
                f"continuous batching over S*B = {spec.n_streams * spec.batch} rows, "
                f"{spec.n_replicas} replicas), above {MAX_UNROLLED_ROWS}: each step adds tens of "
                "kernels to the round's CUDA graph, so capture and replay slow down in proportion",
                stacklevel=2)
        self.spec, self.params, self.carry, self.inputs = spec, params, carry, inputs
        self.n_rounds = int(inputs.arr.shape[0])
        self.r = torch.zeros(1, dtype=torch.int64, device=carry.bw_est.device)
        self.ys: Optional[RoundTrace] = None

    @property
    def state(self) -> list:
        """The tensors ``step`` updates in place (outputs excluded: each
        round writes its own row)."""
        return _leaves(self.carry) + [self.r]

    @torch.inference_mode()
    def step(self) -> None:
        x = RoundInputs(*(col.index_select(0, self.r)[0] for col in self.inputs))
        new, y = _round_step(self.spec, self.params, self.carry, x)
        old = _leaves(self.carry)
        ptrs = {t.untyped_storage().data_ptr() for t in old}
        for dst, src in zip(old, _leaves(new)):
            if src is not dst:
                if src.untyped_storage().data_ptr() in ptrs:
                    src = src.clone()  # a view of the state: read it before any write
                dst.copy_(src)
        if y is not None:
            if self.ys is None:  # allocated on the first (warm-up) call
                self.ys = RoundTrace(*(None if v is None else
                                       torch.zeros((self.n_rounds,) + tuple(v.shape),
                                                   dtype=v.dtype, device=v.device)
                                       for v in y))
            for buf, v in zip(self.ys, y):
                if buf is not None:
                    buf.index_copy_(0, self.r, v.unsqueeze(0))
        self.r.add_(1)

    def run(self, profiler=NULL_PROFILER):
        """Every round: warm up and capture the step (``aot_split``), then
        one replay a round, and wait for the device.  Returns ``(carry,
        RoundTrace | None)``; the profiler gets ``"compile"`` (warm-up +
        capture) and ``"scan"`` (the rounds)."""
        replay, _ = aot_split(self.step, *self.state, profiler=profiler)
        t0 = time.perf_counter()
        for _ in range(self.n_rounds):
            replay()
        if self.r.is_cuda:
            torch.cuda.synchronize(self.r.device)
        profiler.add("scan", time.perf_counter() - t0)
        return self.carry, self.ys


def make_engine(spec: EngineSpec):
    """The round loop closed over the static spec: ``run(params, carry,
    inputs, profiler) -> (carry, RoundTrace | None)`` where ``inputs``
    is a ``RoundInputs`` of (R, ...) stacked rounds on the engine's device.
    On the card one round is captured as a CUDA graph and replayed R times;
    a capture that fails raises (there is no eager fallback on the card).
    The carry is consumed (updated in place and returned)."""

    def run(params: EngineParams, carry: EngineCarry, inputs: RoundInputs, profiler=NULL_PROFILER):
        return RoundLoop(spec, params, carry, inputs).run(profiler)

    return run


def simulate(spec: EngineSpec, params: EngineParams, inputs: RoundInputs,
             carry: Optional[EngineCarry] = None, profiler=NULL_PROFILER):
    """One-shot convenience: init the carry (unless given), run every round."""
    if carry is None:
        carry = init_carry(spec, params)
    return make_engine(spec)(params, carry, inputs, profiler)


# --------------------------------------------------------------------------- #
# bridges from the numpy serving stack
# --------------------------------------------------------------------------- #


def torch_unsupported(server) -> list:
    """Every reason this ``MultiStreamServer`` cannot run on
    ``backend="torch"`` (the reference's ``jax_unsupported``): an empty
    list when fully supported, else one entry per unsupported feature."""
    from repro_torch.policy.fleet_torch import torch_unsupported_policies

    reasons = torch_unsupported_policies([g[0] for g in server.fleet.groups])
    for c, cell in enumerate(server.fabric.cells):
        up = cell.uplink
        if up.jitter > 0 and up.jitter_mode != "counter":
            reasons.append(
                f"cell {c}: jitter_mode='pcg' draws from a host rng the round "
                "engine cannot reproduce; construct the Uplink with "
                "jitter_mode='counter' for jitter on the device")
    if server.fleet.actions is not None:
        at = server.fleet.action_table
        if at.n_actions > 127:
            reasons.append(
                f"split action table with {at.n_actions} actions exceeds the "
                "int8 decision grid (subsample the cut catalog to <= 127)")
        pool = server.fabric.pool
        if getattr(pool, "batching", None) is not None and pool._batching_live:
            reasons.append(
                "split actions with a live continuous-batching slow tier: "
                "batches share one f(n) latency curve, so per-request "
                "srv_frac scaling is not expressible (numpy raises too)")
    tel = getattr(server, "telemetry", None)
    if tel is not None and (tel.tracer is not None or getattr(tel, "trace", False)):
        reasons.append(
            "frame-lifecycle tracing (Telemetry.trace) needs per-frame host "
            "visibility the round engine does not have; use the numpy "
            "backend for traces (the per-round recorder works on both)")
    return reasons


def supports_torch(server) -> bool:
    """True iff every feature of this server's configuration is expressible
    in the round engine (the reasons come from ``torch_unsupported``)."""
    return not torch_unsupported(server)


def spec_from_server(server, collect: str = "metrics", telemetry: bool = False) -> EngineSpec:
    """Build the static spec from a ``MultiStreamServer`` (validating that
    the configuration is expressible in fixed shapes)."""
    from repro_torch.policy.base import OneShotPolicy
    from repro_torch.policy.fleet_torch import spec_for_policy

    reasons = torch_unsupported(server)
    if reasons:
        raise ValueError("backend='torch' cannot express this configuration: "
                         + "; ".join(reasons))
    if telemetry and collect == "none":
        collect = "metrics"  # the recorder's series ride on the round outputs
    fleet = server.fleet
    pool = server.fabric.pool
    batch_kind, batch_coeffs, batch_window, batch_cap = "none", (), 0.0, 0
    batch_beta = 0.25
    if getattr(pool, "batching", None) is not None and pool._batching_live:
        # live continuous batching: the latency model as static coefficients;
        # a degenerate config stays on the per-request path
        from repro_torch.slowtier import model_coeffs

        batch_kind, batch_coeffs = model_coeffs(pool.batching.model)
        batch_window = float(pool.batching.window_s)
        cap = pool.batching.cap
        batch_cap = 0 if np.isinf(cap) else int(cap)
        batch_beta = pool.batch_beta
    common = dict(sizes=fleet.sizes, acc_server=fleet.acc_server,
                  deadline=fleet.deadline, latency=fleet.latency,
                  server_time=fleet.server_time, actions=fleet.actions)
    if len(fleet.groups) == 1:
        policy = fleet.groups[0][0]
        planner = spec_for_policy(policy, **common)
        groups = ()
        prune = bool(getattr(policy, "prune_expired", True))
        oneshot = isinstance(policy, OneShotPolicy)
    else:
        # heterogeneous: every group shares one (S, L) grid padded to the
        # largest max_backlog; each group trims to its own bound
        L = max(int(p.max_backlog) for p, _ in fleet.groups)
        groups = tuple(
            EngineGroup(planner=spec_for_policy(p, pad_L=L, **common),
                        streams=tuple(int(s) for s in ss),
                        prune=bool(getattr(p, "prune_expired", True)),
                        oneshot=isinstance(p, OneShotPolicy),
                        mb=int(p.max_backlog))
            for p, ss in fleet.groups)
        planner = groups[0].planner  # shared L/m/deadline/latency/dtype
        prune, oneshot = True, False  # unused: per-group flags govern
    uplinks = [c.uplink for c in server.fabric.cells]
    varying = any(u.jitter > 0 or u.trace is not None for u in uplinks)
    at = fleet.action_table
    has_splits = fleet.actions is not None
    return EngineSpec(
        n_streams=server.n_streams, batch=server.cfg.batch_size,
        n_cells=server.fabric.n_cells, n_replicas=server.fabric.n_replicas,
        planner=planner, placement=server.fabric.placement.policy,
        serial_replicas=server.fabric.pool.serial,
        scheduler=server.scheduler.policy,
        prune=prune, oneshot=oneshot,
        t_fast=float(server.cfg.fast_time + server.cfg.calib_time),
        bw_alpha=fleet.bw_alpha, collect=collect,
        batch_kind=batch_kind, batch_coeffs=tuple(float(c) for c in batch_coeffs),
        batch_window=batch_window, batch_cap=batch_cap,
        batch_beta=batch_beta, groups=groups, varying=varying,
        cell_jitter=tuple(float(u.jitter) for u in uplinks) if varying else (),
        cell_seed=tuple(int(u.seed) for u in uplinks) if varying else (),
        cell_trace=tuple(u.trace is not None for u in uplinks) if varying else (),
        cell_loop=tuple(bool(u.trace.loop) if u.trace is not None else False
                        for u in uplinks) if varying else (),
        act_t_dev=tuple(float(x) for x in at.t_dev) if has_splits else (),
        act_srv_frac=tuple(float(x) for x in at.srv_frac) if has_splits else (),
        act_res=tuple(int(r) for r in at.res) if has_splits else (),
        telemetry=bool(telemetry))


def params_from_server(server, spec: EngineSpec, device=None) -> EngineParams:
    """The run's tensors from a ``MultiStreamServer``, on ``device`` (the
    card unless the caller passes the CPU): float64 on the host, one cast
    to ``spec.planner.dtype``, as the reference casts."""
    dev = resolve_device(device)
    dt = spec.planner.dtype
    S = server.n_streams
    sched_w = server.scheduler.weights
    weights = np.ones(S) if sched_w is None else np.asarray(sched_w, dtype=np.float64)
    uplinks = [c.uplink for c in server.fabric.cells]
    f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev).to(dt)  # noqa: E731
    extra = {}
    if spec.varying and any(spec.cell_trace):
        # one fixed-shape breakpoint grid per cell, padded to the longest
        # trace; constant cells get a single all-time segment
        T = max(len(u.trace) for u in uplinks if u.trace is not None)
        ts, rates, durs = [], [], []
        for u in uplinks:
            if u.trace is not None:
                t, bps = u.trace.grid(pad_to=T)
                durs.append(float(u.trace.duration))
            else:
                t = np.r_[0.0, np.full(T - 1, np.inf)]
                bps = np.full(T, u.bandwidth_bps)
                durs.append(np.inf)
            ts.append(t)
            rates.append(bps)
        extra = dict(trace_t=f(np.stack(ts)), trace_bps=f(np.stack(rates)), trace_dur=f(durs))
    return EngineParams(
        # the shared action -> bytes table, full width: (A,) with splits,
        # the (m,) resolution grid otherwise
        sizes=f(server.fleet.action_table.sizes),
        cell_bw=f([u.bandwidth_bps for u in uplinks]),
        cell_of=torch.as_tensor(np.asarray(server.fabric.cell_of, dtype=np.int64), device=dev),
        replica_st=f(server.fabric.pool.server_time),
        stream_bw=f(server._stream_bw),
        weights=f(weights),
        bw_init=f(server.fleet.bw_est),
        consts=engine_consts(spec, dev),
        **extra)


# --------------------------------------------------------------------------- #
# the server's replay on the round engine
# --------------------------------------------------------------------------- #


def serve(server, frames: np.ndarray, labels: Optional[np.ndarray], schedule) -> AggregateMetrics:
    """``server.process_streams`` for a ``MultiStreamServer`` built with
    ``backend="torch"``: precompute the tiers of every round on its device
    (one fast pass, and the slow tier at each resolution over every frame,
    compared with the labels in place), stack the rounds' inputs, run one
    CUDA graph replay a round, then fold the final state back into the
    server's host objects.  The tiers are ``serving.engine``'s
    ``fast_pass`` and ``slow_pass_multires``, looked up at call time.
    Decisions are held to the numpy loop by ``tests/test_torch_engine.py``."""
    cfg = server.cfg
    S, B, dev = server.n_streams, cfg.batch_size, server.device
    resolutions = np.asarray(cfg.resolutions)
    m = len(resolutions)
    rec = getattr(server.telemetry, "recorder", None)
    prof = server.profiler
    spec = spec_from_server(server, collect="trace" if server.round_hook is not None else "metrics",
                            telemetry=rec is not None)
    params = params_from_server(server, spec, device=dev)
    dt = spec.planner.dtype

    # precompute on the device: both tiers are deterministic per frame,
    # so this equals the numpy loop's escalated-only batching
    t0 = time.perf_counter()
    stage = engine.FrameStage(frames, B, dev)
    rounds, host_rounds = [], []
    for start, arr, valid in schedule.rounds(B):
        b = arr.shape[1]
        flat = stage.to_device(stage.fill(start, b))
        fp, cf = engine.fast_pass(server.fast_forward, server.calibrate, flat,
                                  use_fused=cfg.use_fused, platt_ab=cfg.platt_ab)
        conf = cf.reshape(S, b).to(dt)
        fast_ok = torch.zeros((S, b), dtype=torch.bool, device=dev)
        slow_ok = torch.zeros((S, b, m), dtype=torch.bool, device=dev)
        if labels is not None:
            lab = torch.as_tensor(labels[:, start : start + b], device=dev)
            fast_ok = fp.reshape(S, b) == lab
            slow_ok = torch.stack([
                engine.slow_pass_multires(server.slow_forward, flat, np.full(S * b, r)).reshape(S, b) == lab
                for r in resolutions], dim=-1)
        pad = B - b
        arr_t = torch.as_tensor(np.pad(arr, ((0, 0), (0, pad)), constant_values=np.inf),
                                device=dev).to(dt)
        valid_t = torch.as_tensor(np.pad(valid, ((0, 0), (0, pad))), device=dev)
        rounds.append((arr_t, valid_t,
                       torch.nn.functional.pad(conf, (0, pad), value=torch.inf),
                       torch.nn.functional.pad(fast_ok, (0, pad)),
                       torch.nn.functional.pad(slow_ok, (0, 0, 0, pad))))
        host_rounds.append((start, b, arr, valid))
    prof.add("precompute", time.perf_counter() - t0)
    if not rounds:
        return server.metrics
    inputs = RoundInputs(*(torch.stack(col) for col in zip(*rounds)))
    carry, ys = simulate(spec, params, inputs, profiler=prof)
    if carry.fp_bad is not None and bool(carry.fp_bad):
        warnings.warn(
            "a time-varying uplink fixed point failed to settle inside the round "
            "engine; the numpy reference would have used its exact serial "
            "fallback, so results may diverge", RuntimeWarning)

    # fold the per-round counters and latencies into the same
    # AggregateMetrics, and the final state into the host objects
    t0 = time.perf_counter()
    metrics, fabric, fleet = server.metrics, server.fabric, server.fleet
    cells, pool = fabric.cells, fabric.pool
    base_cb = np.asarray([c.uplink.busy_seconds for c in cells])
    base_cq = np.asarray([c.uplink.queued_seconds for c in cells])
    base_rb, base_rq = pool.busy_seconds.copy(), pool.queued_seconds.copy()
    base_ctr = (metrics._frames.copy(), metrics._offloaded.copy(),
                metrics._missed.copy(), metrics._correct.copy())

    def to_np(t, dtype=None):
        a = t.cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    off, miss, corr = to_np(ys.off_counts), to_np(ys.miss_counts), to_np(ys.correct)
    lat = to_np(ys.lat, np.float64)
    for i, (start, b, arr, valid) in enumerate(host_rounds):
        metrics.update_round(valid.sum(axis=1), off[i], miss[i], corr[i], lat[i][:, :b], valid)
    for c, cell in enumerate(cells):
        cell.uplink._busy_until = float(carry.cell_busy[c])
        cell.uplink.n_transfers += int(carry.cell_n[c])
        cell.uplink.busy_seconds += float(carry.cell_busy_s[c])
        cell.uplink.queued_seconds += float(carry.cell_queued_s[c])
    pool.busy_until[:] = to_np(carry.rep_busy, np.float64)
    pool.n_jobs += to_np(carry.rep_n, np.int64)
    pool.busy_seconds += to_np(carry.rep_busy_s, np.float64)
    pool.queued_seconds += to_np(carry.rep_queued_s, np.float64)
    pool.avg_batch = float(carry.avg_batch)  # occupancy EWMA (1.0 = serial)
    fabric.placement._next = int(carry.rr_next)
    fleet.bw_est[:] = to_np(carry.bw_est, np.float64)
    arr_f, conf_f, lens = unpad_fleet(carry.fleet)
    st = fleet.state
    st.arrival = arr_f.astype(np.float64)
    st.conf = conf_f.astype(np.float64)
    st.stream_id = np.repeat(np.arange(S), lens)
    st._rebuild_offsets()
    prof.add("fold", time.perf_counter() - t0)

    if rec is not None:
        # the stacked telemetry columns into the recorder: cumulative
        # counters from host cumsums of the per-round integer columns
        # (numpy's running sums exactly), t and bw_true recomputed on the
        # host from the same float64 arrival grid
        frames_c = base_ctr[0] + np.cumsum([v.sum(axis=1) for _, _, _, v in host_rounds], axis=0)
        off_c = base_ctr[1] + np.cumsum(off, axis=0, dtype=np.int64)
        miss_c = base_ctr[2] + np.cumsum(miss, axis=0, dtype=np.int64)
        corr_c = base_ctr[3] + np.cumsum(corr, axis=0, dtype=np.int64)
        bw_ts = to_np(ys.ts_bw_est, np.float64)
        hist_ts = to_np(ys.ts_off_hist, np.int64)
        cb = base_cb + to_np(ys.ts_cell_busy_s, np.float64)
        cq = base_cq + to_np(ys.ts_cell_queued_s, np.float64)
        rb = base_rb + to_np(ys.ts_rep_busy_s, np.float64)
        rq = base_rq + to_np(ys.ts_rep_queued_s, np.float64)
        ab = to_np(ys.ts_avg_batch, np.float64)
        st_ts = to_np(ys.ts_st_est, np.float64)
        for i, (_, _, arr, _) in enumerate(host_rounds):
            fin = arr[np.isfinite(arr)]
            t_round = float(fin.min()) if len(fin) else np.nan
            rec.record_round(
                t=t_round, frames=frames_c[i], offloads=off_c[i],
                misses=miss_c[i], correct=corr_c[i], bw_est=bw_ts[i],
                bw_true=fabric.true_bandwidth(t_round),
                cell_busy_s=cb[i], cell_queued_s=cq[i],
                rep_busy_s=rb[i], rep_queued_s=rq[i],
                avg_batch=ab[i], server_time=st_ts[i],
                action_off=hist_ts[i])

    if server.round_hook is not None:
        act = fleet.action_table
        y = {k: to_np(v) for k, v in ys._asdict().items() if v is not None}
        for i, (start, b, _, valid) in enumerate(host_rounds):
            dec = y["dec"][i]
            off_s, off_p = np.nonzero(dec >= 0)
            a = dec[off_s, off_p]
            server.round_hook({
                "start": start,
                "theta": y["theta"][i].astype(np.float64),
                "res_idx": y["res_idx"][i].astype(np.int64),
                "cap": y["cap"][i].astype(np.int64),
                "n_off": y["n_off"][i].astype(np.int64),
                "n_frames": y["n_frames"][i].astype(np.int64),
                "off_stream": off_s.astype(np.int64),
                "off_pos": off_p.astype(np.int64),
                "off_res": a.astype(np.int64),
                # from the shared table: the decision grid holds the action index
                "off_kind": act.kind[a].astype(np.int8),
                "off_cut": act.cut[a].astype(np.int64),
                "esc": y["esc"][i][:, :b],
                "ok": y["ok"][i][:, :b],
                "lat": lat[i][:, :b],
                "valid": valid,
                "correct": corr[i].astype(np.int64),
                "bw_est": y["bw_est"][i].astype(np.float64),
                "lengths": y["lengths"][i].astype(np.int64),
                "overflow": y["overflow"][i],
                "inexact": y["inexact"][i],
            })
    return metrics
