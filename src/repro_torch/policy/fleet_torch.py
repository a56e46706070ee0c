"""Fixed-shape fleet control plane on tensors (port of
``repro.policy.fleet_jax``).

The numpy control plane (``policy/fleet.py`` + ``policy/frontier.py``) is
the semantic reference; this module re-expresses it in fixed shapes that
stay on one device (the card unless the caller passes the CPU):

  * ragged backlogs become a ``PaddedFleet`` — ``(S, L)`` arrival/conf
    grids plus an ``(S,)`` length vector; slot ``j`` of stream ``s`` is
    valid iff ``j < length[s]``, and valid slots are packed at the front
    in insertion order (the order a ``FleetState`` segment has, so backlog
    positions mean the same thing on every path);
  * the segment ops (``prune_expired`` / ``consume`` / ``extend`` /
    ``clear``) become mask-and-compact passes over the (S, L) grid:
    compaction is one stable argsort of the dropped mask, which moves kept
    slots to the front without reordering them;
  * the planners run every stream at once, tensors with a leading S axis
    where the reference ``vmap``s a single-stream function, and a Python
    loop over the L backlog depths where it runs ``lax.fori_loop``.  The
    CBO frontier DP runs with a capped frontier of ``F`` states and
    reports ``overflow`` when the cap would have truncated it, plus
    ``inexact`` for the one epsilon corner where the vectorized prune
    could disagree with the reference's sequential rule.

Exactness: each operation is the reference's, in ``spec.dtype`` (float32
by default) and in the same order, so integer decisions are bit-equal to
``fleet_jax``'s and to the float64 numpy planner's on tie-free inputs.
Python-float constants become ``spec.dtype`` scalars where JAX's weak
typing converts them, and sums the reference forms in Python (``st +
latency``, ``deadline - rtt``) are formed in Python here too.  Every sort
is stable (``stable=True``; boolean keys sort as uint8), every argmax the
first maximum (built from a mask, not ``torch.argmax``), and every
scatter unique (rows that would collide or fall out of range are masked
first, where the reference scatters with ``mode="drop"``).  The planner
runs eagerly, or recorded as the same kernels in the round engine's CUDA
graph; nothing is compiled, so no multiply and add are contracted into
one rounding, except in ``ewma_fold``, whose
update XLA compiles to one fused multiply-add and which the port computes
as that FMA, exactly (``core.threefry.fma_f32``).

Capture: nothing here copies from the host or waits for the device when
its inputs already lie there: a spec's tables (``planner_tables``) are
made once, before any capture, scalars are filled on the device
(``_scalar``), and there is no boolean indexing and no ``.item()``.  So
the round engine (``serving/engine_torch.py``) captures a planning pass in
its CUDA graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.threefry import fma_f32 as _fma
from repro_torch.device import resolve_device

__all__ = [
    "PaddedFleet", "PlanOut", "PlannerSpec",
    "pad_fleet", "unpad_fleet", "fleet_from_state", "plan_batch_from_out",
    "prune_fleet", "consume_fleet", "extend_fleet", "clear_fleet",
    "plan_fleet", "make_planner", "spec_for_policy", "planner_kind",
    "torch_unsupported_policies", "ewma_fold", "PlannerTables", "planner_tables",
    "TORCH_PLANNABLE",
]

_EPS = 1e-12  # same dominance epsilon as policy/frontier.py

#: policy registry names the tensor planner supports
TORCH_PLANNABLE = ("cbo", "threshold", "local", "server", "greedy-rate")


# --------------------------------------------------------------------------- #
# padded fleet state
# --------------------------------------------------------------------------- #


class PaddedFleet(NamedTuple):
    """Fixed-shape fleet backlog: valid slots packed at the front."""

    arrival: torch.Tensor  # (S, L)
    conf: torch.Tensor  # (S, L)
    length: torch.Tensor  # (S,) int32 — slots < length are valid


def pad_fleet(arrival, conf, lengths, L: int, dtype=torch.float32, device=None) -> PaddedFleet:
    """Host constructor from flat ragged arrays (``FleetState`` layout):
    float64 on the host, one cast to ``dtype`` as the reference casts.
    ``device=None`` is the card (raises without a GPU)."""
    device = resolve_device(device)
    lengths = np.asarray(lengths, dtype=np.int64)
    S = len(lengths)
    if lengths.max(initial=0) > L:
        raise ValueError(f"backlog length {int(lengths.max())} exceeds pad L={L}")
    arr = np.zeros((S, L), dtype=np.float64)
    cf = np.zeros((S, L), dtype=np.float64)
    offsets = np.r_[0, np.cumsum(lengths)]
    flat_a = np.asarray(arrival, dtype=np.float64)
    flat_c = np.asarray(conf, dtype=np.float64)
    if len(flat_a):
        sid = np.repeat(np.arange(S), lengths)
        pos = np.arange(len(flat_a)) - offsets[:-1][sid]
        arr[sid, pos] = flat_a
        cf[sid, pos] = flat_c
    return PaddedFleet(torch.as_tensor(arr, dtype=dtype, device=device),
                       torch.as_tensor(cf, dtype=dtype, device=device),
                       torch.as_tensor(lengths, dtype=torch.int32, device=device))


def fleet_from_state(state, L: int, dtype=torch.float32, device=None) -> PaddedFleet:
    """Pad a ``FleetState`` (numpy, ragged) into tensors on ``device``
    (``None`` is the card)."""
    return pad_fleet(state.arrival, state.conf, state.lengths, L, dtype=dtype, device=device)


def unpad_fleet(fleet: PaddedFleet):
    """Back to host ragged arrays: (arrival, conf, lengths) numpy tuples."""
    arr = fleet.arrival.cpu().numpy()
    conf = fleet.conf.cpu().numpy()
    lens = fleet.length.cpu().numpy().astype(np.int64)
    L = arr.shape[1]
    valid = np.arange(L)[None, :] < lens[:, None]
    return arr[valid], conf[valid], lens


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d tensor of ``like``'s dtype and device: the
    conversion JAX's weak typing applies when a Python float meets an
    array.  It is filled on the device, not copied from the host, so a
    CUDA graph can capture it."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _argsort(key: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort along the last axis (booleans as uint8)."""
    if key.dtype == torch.bool:
        key = key.to(torch.uint8)
    return torch.argsort(key, dim=-1, stable=True)


def _first_max(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (``jnp.argmax``'s
    choice among ties), from a mask: no reliance on ``torch.argmax``."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device).expand_as(x)
    hit = x == x.amax(dim=-1, keepdim=True)
    return torch.where(hit, idx, n).amin(dim=-1)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=-1).values


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[s, idx[s]]`` for every row s."""
    return x.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


# --------------------------------------------------------------------------- #
# segment ops (mask-and-compact)
# --------------------------------------------------------------------------- #


def _valid(fleet: PaddedFleet) -> torch.Tensor:
    L = fleet.arrival.shape[1]
    return torch.arange(L, device=fleet.arrival.device) < fleet.length[:, None]


def _compact(arr, conf, keep) -> PaddedFleet:
    """Move kept slots to the front, preserving order (stable argsort)."""
    o = _argsort(~keep)  # False < True; stable, so kept order survives
    return PaddedFleet(arr.gather(1, o), conf.gather(1, o),
                       keep.sum(dim=1).to(torch.int32))


def prune_fleet(fleet: PaddedFleet, now, deadline: float, do_mask) -> PaddedFleet:
    """Batched ``FleetState.prune_expired``: drop expired frames of the
    streams where ``do_mask`` is set (the same float compare per frame)."""
    arr = fleet.arrival
    now = torch.as_tensor(now, dtype=arr.dtype, device=arr.device)
    do_mask = torch.as_tensor(do_mask, device=arr.device)
    live = arr + _scalar(deadline, arr) > now[:, None]
    keep = _valid(fleet) & torch.where(do_mask[:, None], live, True)
    return _compact(arr, fleet.conf, keep)


def consume_fleet(fleet: PaddedFleet, take, clear) -> PaddedFleet:
    """Batched ``FleetState.consume``: ``take`` is an (S, L) mask of backlog
    positions that left the device; ``clear`` empties whole streams."""
    dev = fleet.arrival.device
    take = torch.as_tensor(take, device=dev)
    clear = torch.as_tensor(clear, device=dev)
    keep = _valid(fleet) & ~take & ~clear[:, None]
    return _compact(fleet.arrival, fleet.conf, keep)


def extend_fleet(fleet: PaddedFleet, new_arr, new_conf, new_ok, mb) -> PaddedFleet:
    """Batched ``FleetState.extend``: append each stream's (B,) new frames
    (mask ``new_ok``, slot order) and trim to the ``mb`` newest.  ``mb`` is
    one int (homogeneous fleet) or an (S,) per-stream bound (heterogeneous
    policy groups with distinct ``max_backlog`` sharing one pad width L)."""
    arr, conf, length = fleet
    dev = arr.device
    L = arr.shape[1]
    new_arr = torch.as_tensor(new_arr, dtype=arr.dtype, device=dev)
    new_conf = torch.as_tensor(new_conf, dtype=conf.dtype, device=dev)
    new_ok = torch.as_tensor(new_ok, device=dev)
    B = new_arr.shape[1]
    if isinstance(mb, (int, np.integer)):
        mb = int(mb)  # a Python bound: no tensor to copy to the device
    else:
        mb = torch.as_tensor(mb, dtype=torch.int32, device=dev)[:, None]
    po = _argsort(~new_ok)  # pack new frames, slot order preserved
    na, nc = new_arr.gather(1, po), new_conf.gather(1, po)
    n_new = new_ok.sum(dim=1).to(torch.int32)
    total = (length + n_new)[:, None]
    start = torch.clamp_min(total - mb, 0)
    idx = start + torch.arange(L, dtype=torch.int32, device=dev)
    from_old = idx < length[:, None]
    oi = idx.clamp(0, L - 1).long()
    ni = (idx - length[:, None]).clamp(0, B - 1).long()
    out_a = torch.where(from_old, arr.gather(1, oi), na.gather(1, ni))
    out_c = torch.where(from_old, conf.gather(1, oi), nc.gather(1, ni))
    lens = total.clamp_max(mb) if isinstance(mb, int) else torch.minimum(total, mb)
    return PaddedFleet(out_a, out_c, lens[:, 0].to(torch.int32))


def clear_fleet(fleet: PaddedFleet, mask) -> PaddedFleet:
    """Batched ``FleetState.clear``: empty the masked streams' backlogs."""
    mask = torch.as_tensor(mask, device=fleet.length.device)
    return PaddedFleet(fleet.arrival, fleet.conf,
                       torch.where(mask, 0, fleet.length).to(torch.int32))


# --------------------------------------------------------------------------- #
# planners
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class PlannerSpec:
    """Static planner configuration."""

    kind: str  # "cbo" | "threshold" | "local" | "server" | "greedy-rate"
    sizes: tuple  # (m,) payload bytes per resolution
    acc_server: tuple  # (m,)
    deadline: float
    latency: float
    server_time: float  # nominal T^o; plan_fleet can override per call
    L: int  # backlog pad (== max_backlog)
    F: int = 0  # CBO frontier cap; 0 -> 1 + L * n_actions
    theta: float = 0.5  # threshold policy
    resolution: int = -1  # threshold policy (index, -1 = highest)
    frame_interval: float = 1.0 / 30.0  # server policy
    local_acc: float = 0.5  # greedy-rate policy
    dtype: torch.dtype = torch.float32
    # split-computation actions appended after the m frame actions
    # (``split`` / ``policy.types.ActionTable``); empty tuples keep every
    # frame-only code path
    split_sizes: tuple = ()  # payload bytes per split action
    split_acc: tuple = ()  # server accuracy per split action
    split_t_dev: tuple = ()  # device prefix seconds per split action
    split_srv_frac: tuple = ()  # fraction of T^o the suffix costs

    @property
    def m(self) -> int:
        return len(self.acc_server)

    @property
    def n_actions(self) -> int:
        return self.m + len(self.split_sizes)

    @property
    def rtt(self) -> float:
        return self.server_time + self.latency

    @property
    def frontier(self) -> int:
        return self.F if self.F > 0 else 1 + self.L * self.n_actions


class PlanOut(NamedTuple):
    """One fleet planning pass, fixed shapes (the ``PlanBatch`` analogue).

    ``dec[s, j]`` is the planned action index for backlog slot ``j`` of
    stream ``s``, or -1 to keep it local — the offload set and the consume
    mask in one array.
    """

    dec: torch.Tensor  # (S, L) int8
    theta: torch.Tensor  # (S,)
    resolution: torch.Tensor  # (S,) int32
    n_offloads: torch.Tensor  # (S,) int32
    total_gain: torch.Tensor  # (S,)
    base_acc: torch.Tensor  # (S,)
    n_frames: torch.Tensor  # (S,) int32
    overflow: torch.Tensor  # (S,) bool — frontier cap would have truncated
    inexact: torch.Tensor  # (S,) bool — eps-window prune disagreement possible


class PlannerTables(NamedTuple):
    """A spec's per-action tables on one device, made once by
    ``planner_tables`` (before a capture: a copy from the host cannot run
    inside one).  Frame actions first, then split actions."""

    sizes: torch.Tensor  # (A,) payload bytes
    acc: torch.Tensor  # (A,) server accuracy
    t_dev: torch.Tensor  # (A,) device prefix seconds (0 for frames)
    srv_frac: torch.Tensor  # (A,) fraction of T^o the reply costs (1 for frames)
    greedy_cand: torch.Tensor  # greedy-rate's candidate resolutions, descending


def _greedy_candidates(spec: PlannerSpec) -> list:
    """GreedyRatePolicy's resolutions to try, from m-1 down to (but
    excluding) the first r with ``acc_server[r] <= local_acc``: the
    reference's inner break is static."""
    cand = []
    for r in range(spec.m - 1, -1, -1):
        if spec.acc_server[r] <= spec.local_acc:
            break
        cand.append(r)
    return cand


def planner_tables(spec: PlannerSpec, device=None) -> PlannerTables:
    """``spec``'s tables as ``spec.dtype`` tensors on ``device`` (the card
    unless the caller passes the CPU)."""
    dev = resolve_device(device)
    f = lambda x: torch.tensor(x, dtype=spec.dtype, device=dev)  # noqa: E731
    return PlannerTables(
        sizes=f(spec.sizes + spec.split_sizes), acc=f(spec.acc_server + spec.split_acc),
        t_dev=f((0.0,) * spec.m + spec.split_t_dev),
        srv_frac=f((1.0,) * spec.m + spec.split_srv_frac),
        greedy_cand=torch.tensor(_greedy_candidates(spec), dtype=torch.int64, device=dev))


def _summarize(dec, conf, length, spec: PlannerSpec):
    """theta / r° / counters from the decision rows — ``plan_from_chain``
    and ``PlanBatch.from_offloads`` semantics: theta is the max confidence
    among offloads, r° that frame's action, ties to the earliest slot."""
    L = dec.shape[1]
    valid = torch.arange(L, device=dec.device) < length[:, None]
    take = dec >= 0
    n_off = take.sum(dim=1).to(torch.int32)
    confm = torch.where(take, conf, -torch.inf)
    mx = confm.amax(dim=1)
    has = take.any(dim=1)
    first = _first_max((confm == mx[:, None]).to(torch.uint8))  # earliest slot at the max
    theta = torch.where(has, mx, _scalar(0.0, conf))
    r0 = torch.where(has, _take(dec, first).to(torch.int32), spec.m - 1)
    base = torch.where(valid, conf, _scalar(0.0, conf)).sum(dim=1)
    return theta, r0, n_off, base


def _no_flags(S: int, dev) -> tuple:
    z = torch.zeros(S, dtype=torch.bool, device=dev)
    return z, z.clone()


def _plan_local(arr, conf, length, now, bw, st, spec: PlannerSpec, tb: PlannerTables):
    S, L = arr.shape
    dec = torch.full((S, L), -1, dtype=torch.int8, device=arr.device)
    return (dec, torch.zeros(S, dtype=arr.dtype, device=arr.device)) + _no_flags(S, arr.device)


def _plan_server(arr, conf, length, now, bw, st, spec: PlannerSpec, tb: PlannerTables):
    """ServerPolicy.plan_many: highest resolution sustainable within both
    the frame interval and the deadline budget; offload every frame."""
    S, L = arr.shape
    m, dev = spec.m, arr.device
    sizes, acc = tb.sizes[:m], tb.acc[:m]
    if isinstance(st, float):  # static T^o: Python-float math, as the reference
        tx_budget = _scalar(min(spec.frame_interval, spec.deadline - st - spec.latency), arr)
    else:  # a T^o override, dtype arithmetic
        tx_budget = torch.minimum(_scalar(spec.frame_interval, arr),
                                  _scalar(spec.deadline, arr) - st - _scalar(spec.latency, arr))
    feas = sizes / torch.maximum(bw, _scalar(1e-9, bw))[:, None] <= tx_budget  # (S, m)
    has_res = feas.any(dim=1)
    r_s = (m - 1) - _first_max(feas.flip(1).to(torch.uint8))
    valid = torch.arange(L, device=dev) < length[:, None]
    take = valid & has_res[:, None]
    dec = torch.where(take, r_s[:, None].to(torch.int8), torch.full((), -1, dtype=torch.int8, device=dev))
    gain = torch.where(take, acc[r_s][:, None] - conf, _scalar(0.0, conf)).sum(dim=1)
    return (dec, gain) + _no_flags(S, dev)


def _rtt(st, spec: PlannerSpec, like):
    """``st + latency``: a Python sum for the static T^o, as the reference
    forms it; a dtype sum for an override."""
    if isinstance(st, float):
        return st + spec.latency
    return st + _scalar(spec.latency, like)


def _plan_threshold(arr, conf, length, now, bw, st, spec: PlannerSpec, tb: PlannerTables):
    """ThresholdPolicy.plan_many: serial acceptance in backlog order at a
    fixed resolution — the same max-plus accumulation, the same order."""
    S, L = arr.shape
    m, dev = spec.m, arr.device
    r = spec.resolution % m
    rtt = _rtt(st, spec, arr)
    rtt = rtt if torch.is_tensor(rtt) else _scalar(rtt, arr)
    tx = _scalar(spec.sizes[r], arr) / bw
    dacc = _scalar(spec.acc_server[r], arr) - conf  # (S, L)
    valid = torch.arange(L, device=dev) < length[:, None]
    theta, deadline = _scalar(spec.theta, arr), _scalar(spec.deadline, arr)
    t = now.to(arr.dtype)
    gain = torch.zeros(S, dtype=arr.dtype, device=dev)
    dec = torch.full((S, L), -1, dtype=torch.int8, device=dev)
    for d in range(L):
        cand = valid[:, d] & (conf[:, d] < theta)
        t_new = torch.maximum(t, arr[:, d]) + tx
        ok = cand & (t_new + rtt <= arr[:, d] + deadline)
        t = torch.where(ok, t_new, t)
        gain = torch.where(ok, gain + dacc[:, d], gain)
        dec[:, d] = torch.where(ok, r, -1).to(torch.int8)
    return (dec, gain) + _no_flags(S, dev)


def _plan_cbo(arr, conf, length, now, bw, st, spec: PlannerSpec, tb: PlannerTables):
    """``cbo_plan`` (paper Algorithm 1) with a capped fixed-shape frontier,
    every stream at once.

    Semantics notes against ``frontier.py`` (the reference's):
      * frames walk in confidence-descending stable order; invalid slots
        sort last (conf key -inf) so depths >= length are pure carries;
      * candidates are [frontier carries] ++ [expansions, state-major /
        action-minor]; infeasible rows are masked (t=+inf, gain=-inf)
        instead of removed, which the stable (t, -gain, idx) sort sends to
        the tail without disturbing the relative order of live rows;
      * the reference's "collapse" shortcut is omitted: expansions from
        earlier states with t <= arrival tie in t with strictly lower gain,
        so the prune drops them;
      * pruning keeps a candidate iff its gain beats the running max of
        all prior gains by > eps; the reference advances its bar on KEPT
        gains only, and the rare (eps, 2*eps] window where the two rules
        differ is flagged (``inexact``);
      * every frontier state carries its full decision row ((S, F, L)
        int8): survivors copy their parent's row and stamp their own
        (slot, action).

    A split action table enlarges the grid (frames first, then feature
    cuts): a split's upload leaves only after its device prefix
    (``arr_j + t_dev``), its reply pays the suffix's share of T^o
    (``rtt = st * srv_frac + latency``), and static feasibility subtracts
    ``t_dev``.  Frame-only columns keep the frame-only arithmetic
    (``t_dev`` = 0 adds exactly; ``rtt`` is the Python sum).
    """
    S, L = arr.shape
    A, F, dev = spec.n_actions, spec.frontier, arr.device
    neg, inf = _scalar(-torch.inf, arr), _scalar(torch.inf, arr)
    eps, deadline = _scalar(_EPS, arr), _scalar(spec.deadline, arr)
    sizes, acc, t_dev = tb.sizes, tb.acc, tb.t_dev
    tx = sizes / bw[:, None]  # (S, A)
    if spec.split_sizes:
        srv_frac = tb.srv_frac
        st_t = st if torch.is_tensor(st) else _scalar(st, arr)
        rtt = st_t * srv_frac + _scalar(spec.latency, arr)  # (A,)
        static_t = tx <= deadline - rtt - t_dev
    else:  # t_dev is all zeros
        rtt = _rtt(st, spec, arr)
        # static: ``deadline - rtt`` in Python, one cast; override: dtype
        thr = _scalar(spec.deadline - rtt, arr) if isinstance(rtt, float) else deadline - rtt
        rtt = rtt if torch.is_tensor(rtt) else _scalar(rtt, arr)
        static_t = tx <= thr
        rtt = rtt.expand(A)
    valid = torch.arange(L, device=dev) < length[:, None]
    # confidence-descending stable order, invalid slots last
    order = _argsort(-torch.where(valid, conf, neg))

    exp = torch.arange(F * A, device=dev)  # expansions, state-major / action-minor
    cand_parent = torch.cat([torch.arange(F, device=dev), exp // A])
    cand_res = torch.cat([torch.full((F,), -1, dtype=torch.int64, device=dev), exp % A])
    rows = torch.arange(S, device=dev)[:, None]

    f_t = torch.full((S, F), torch.inf, dtype=arr.dtype, device=dev)
    f_t[:, 0] = now.to(arr.dtype)
    f_gain = torch.full((S, F), -torch.inf, dtype=arr.dtype, device=dev)
    f_gain[:, 0] = 0.0
    f_valid = torch.zeros((S, F), dtype=torch.bool, device=dev)
    f_valid[:, 0] = True
    f_dec = torch.full((S, F, L), -1, dtype=torch.int8, device=dev)
    overflow = torch.zeros(S, dtype=torch.bool, device=dev)
    inexact = torch.zeros(S, dtype=torch.bool, device=dev)
    for d in range(L):
        j = order[:, d]
        arr_j, conf_j = _take(arr, j), _take(conf, j)
        live = d < length
        feas_j = static_t & (acc > conf_j[:, None]) & live[:, None]  # (S, A)
        start = torch.maximum(f_t[:, :, None], (arr_j[:, None] + t_dev)[:, None, :])  # (S, F, A)
        t_exp = start + tx[:, None, :]
        g_exp = f_gain[:, :, None] + (acc - conf_j[:, None])[:, None, :]
        ok_exp = (f_valid[:, :, None] & feas_j[:, None, :]
                  & (t_exp + rtt <= (arr_j + deadline)[:, None, None]))
        cand_t = torch.cat([f_t, t_exp.reshape(S, F * A)], dim=1)
        cand_g = torch.cat([f_gain, g_exp.reshape(S, F * A)], dim=1)
        cand_ok = torch.cat([f_valid, ok_exp.reshape(S, F * A)], dim=1)
        tkey = torch.where(cand_ok, cand_t, inf)
        gkey = torch.where(cand_ok, cand_g, neg)
        # stable (t asc, gain desc, candidate idx asc) via composed sorts
        o = _argsort(-gkey)
        o = o.gather(1, _argsort(tkey.gather(1, o)))
        ts, gs, oks = tkey.gather(1, o), gkey.gather(1, o), cand_ok.gather(1, o)
        prev_all = torch.cat([neg.expand(S, 1), _cummax(gs)[:, :-1]], dim=1)
        keep = oks & (gs > prev_all + eps)
        # the reference's bar advances on kept gains only: flag the window
        kept_bar = _cummax(torch.where(keep, gs, neg))
        prev_kept = torch.cat([neg.expand(S, 1), kept_bar[:, :-1]], dim=1)
        inexact |= (oks & ~keep & (gs > prev_kept + eps)).any(dim=1)
        overflow |= keep.sum(dim=1) > F
        sel = _argsort(~keep)[:, :F]  # kept first, sorted order preserved
        f_valid = keep.gather(1, sel)
        f_t = torch.where(f_valid, ts.gather(1, sel), inf)
        f_gain = torch.where(f_valid, gs.gather(1, sel), neg)
        src = o.gather(1, sel)
        par, res = cand_parent[src], cand_res[src]
        f_dec = f_dec[rows, par]  # (S, F, L): each survivor's parent row
        jj = j[:, None, None].expand(S, F, 1)
        col = f_dec.gather(2, jj)[:, :, 0]
        f_dec.scatter_(2, jj, torch.where(res >= 0, res.to(torch.int8), col)[:, :, None])
    best = _first_max(torch.where(f_valid, f_gain, neg))  # np.argmax order
    gain = torch.where(_take(f_valid, best), _take(f_gain, best), _scalar(0.0, arr))
    return f_dec[rows[:, 0], best], gain, overflow, inexact


def _plan_greedy_rate(arr, conf, length, now, bw, st, spec: PlannerSpec, tb: PlannerTables):
    """GreedyRatePolicy._plan: per frame in backlog order, walk resolutions
    from the highest down, stop at the first whose server accuracy no longer
    beats the local tier, offload at the first that also meets the
    deadline; the uplink finish time carries serially across frames."""
    S, L = arr.shape
    m, dev = spec.m, arr.device
    rtt = _rtt(st, spec, arr)
    rtt = rtt if torch.is_tensor(rtt) else _scalar(rtt, arr)
    cand_idx = tb.greedy_cand  # descending r
    if not cand_idx.shape[0]:
        return _plan_local(arr, conf, length, now, bw, st, spec, tb)
    sizes, acc = tb.sizes[:m], tb.acc[:m]
    tx = sizes[cand_idx] / bw[:, None]  # (S, n_cand)
    valid = torch.arange(L, device=dev) < length[:, None]
    deadline = _scalar(spec.deadline, arr)
    t = now.to(arr.dtype)
    gain = torch.zeros(S, dtype=arr.dtype, device=dev)
    dec = torch.full((S, L), -1, dtype=torch.int8, device=dev)
    for d in range(L):
        t_new = torch.maximum(t, arr[:, d])[:, None] + tx  # t untouched until a pick
        ok = t_new + rtt <= (arr[:, d] + deadline)[:, None]
        pick = _first_max(ok.to(torch.uint8))  # first feasible = highest feasible r
        has = ok.any(dim=1) & valid[:, d]
        r_sel = cand_idx[pick]
        t = torch.where(has, _take(t_new, pick), t)
        gain = torch.where(has, gain + acc[r_sel] - conf[:, d], gain)
        dec[:, d] = torch.where(has, r_sel, -1).to(torch.int8)
    return (dec, gain) + _no_flags(S, dev)


_PLANNERS = {
    "cbo": _plan_cbo,
    "threshold": _plan_threshold,
    "local": _plan_local,
    "server": _plan_server,
    "greedy-rate": _plan_greedy_rate,
}


@torch.inference_mode()
def plan_fleet(spec: PlannerSpec, fleet: PaddedFleet, now, bw, server_time=None,
               tables: Optional[PlannerTables] = None) -> PlanOut:
    """One planning pass over every stream, on the fleet's device.

    ``bw`` must already carry the 1 byte/s floor (``FleetRunner.env_batch``
    applies it); ``now`` is each stream's first valid arrival this round.
    ``server_time`` overrides the spec's nominal T^o with a ``spec.dtype``
    scalar (the occupancy-calibrated estimate under a batching slow tier);
    ``None`` keeps the nominal, in Python-float arithmetic.  ``tables``
    are ``planner_tables(spec)`` on the fleet's device, made here when not
    given (a capture needs them made before).
    """
    arr, conf, length = fleet
    dev = arr.device
    now = torch.as_tensor(now, dtype=spec.dtype, device=dev)
    bw = torch.as_tensor(bw, dtype=spec.dtype, device=dev)
    st = spec.server_time if server_time is None \
        else torch.as_tensor(server_time, dtype=spec.dtype, device=dev)
    if tables is None:
        tables = planner_tables(spec, dev)
    dec, gain, ovf, inx = _PLANNERS[spec.kind](arr, conf, length, now, bw, st, spec, tables)
    theta, r0, n_off, base = _summarize(dec, conf, length, spec)
    return PlanOut(dec=dec, theta=theta, resolution=r0, n_offloads=n_off,
                   total_gain=gain, base_acc=base, n_frames=length,
                   overflow=ovf, inexact=inx)


def make_planner(spec: PlannerSpec, device=None):
    """``plan_fleet`` closed over the spec, on ``device`` (the card unless
    the caller passes the CPU; without a GPU that raises).  The optional
    4th argument is a ``server_time`` override (``None`` for the spec's
    nominal).  It runs eagerly: nothing is compiled or captured.  The
    spec's tables are made once, here."""
    dev = resolve_device(device)
    tables = planner_tables(spec, dev)

    def planner(fleet: PaddedFleet, now, bw, server_time=None) -> PlanOut:
        fleet = PaddedFleet(*(x.to(dev) for x in fleet))
        return plan_fleet(spec, fleet, now, bw, server_time, tables)

    return planner


def planner_kind(policy) -> Optional[str]:
    """Registry kind of the tensor planner that covers ``policy`` (None when
    it has no equivalent)."""
    from repro_torch.policy.policies import (CBOPolicy, GreedyRatePolicy, LocalPolicy,
                                             ServerPolicy, ThresholdPolicy)

    for cls, kind in ((CBOPolicy, "cbo"), (ThresholdPolicy, "threshold"),
                      (ServerPolicy, "server"), (GreedyRatePolicy, "greedy-rate"),
                      (LocalPolicy, "local")):
        if isinstance(policy, cls):
            return kind
    return None


def torch_unsupported_policies(policies) -> list:
    """Every reason the given policy instances (one per fleet group) cannot
    run on ``backend="torch"``; an empty list means fully supported.  All
    blockers are collected, so callers can raise one complete message."""
    reasons = []
    for p in policies:
        name = type(p).__name__
        if planner_kind(p) is None:
            reasons.append(f"policy {name} has no torch planner "
                           f"(supported kinds: {', '.join(TORCH_PLANNABLE)})")
        if getattr(p, "max_backlog", None) is None:
            reasons.append(f"policy {name}: unbounded max_backlog cannot be "
                           "padded to fixed shapes (pass a finite max_backlog)")
    seen: set = set()
    return [r for r in reasons if not (r in seen or seen.add(r))]


def spec_for_policy(policy, *, sizes, acc_server, deadline, latency,
                    server_time, dtype=torch.float32, F: int = 0,
                    pad_L: Optional[int] = None, actions=None) -> PlannerSpec:
    """Build the static spec for one policy instance (one fleet group).

    ``pad_L`` overrides the backlog pad width: heterogeneous fleets share
    one (S, L) grid padded to the largest group's ``max_backlog``, while
    each group still trims to its own bound (``extend_fleet``'s per-stream
    ``mb``).  Raises for policies the tensor planner does not support (the
    numpy path takes every policy).

    ``actions`` is a split-computation ``ActionTable`` (or None): its split
    rows become the spec's ``split_*`` tuples, read by the cbo planner only,
    as on the numpy path (the baselines are frame-only).
    """
    mb = getattr(policy, "max_backlog", None)
    if mb is None:
        raise ValueError("backend='torch' needs a finite max_backlog "
                         "(fixed-shape backlogs); got None (unbounded)")
    L = int(mb) if pad_L is None else int(pad_L)
    if L < int(mb):
        raise ValueError(f"pad_L={L} is below the policy's max_backlog={mb}")
    common = dict(sizes=tuple(float(x) for x in sizes),
                  acc_server=tuple(float(x) for x in acc_server),
                  deadline=float(deadline), latency=float(latency),
                  server_time=float(server_time), L=L, F=F, dtype=dtype)
    kind = planner_kind(policy)
    if (actions is not None and getattr(actions, "has_splits", False)
            and kind == "cbo"):
        if actions.n_actions > 127:
            raise ValueError(
                f"backend='torch' stores decisions as int8: {actions.n_actions} "
                "actions exceed 127 (subsample the cut catalog)")
        k0 = actions.n_frame_actions
        common.update(
            split_sizes=tuple(float(x) for x in actions.sizes[k0:]),
            split_acc=tuple(float(x) for x in actions.acc[k0:]),
            split_t_dev=tuple(float(x) for x in actions.t_dev[k0:]),
            split_srv_frac=tuple(float(x) for x in actions.srv_frac[k0:]))
    if kind == "cbo":
        return PlannerSpec(kind="cbo", **common)
    if kind == "threshold":
        return PlannerSpec(kind="threshold", theta=policy.theta,
                           resolution=policy.resolution, **common)
    if kind == "server":
        return PlannerSpec(kind="server", frame_interval=policy.frame_interval,
                           **common)
    if kind == "greedy-rate":
        return PlannerSpec(kind="greedy-rate", local_acc=policy.local_acc,
                           **common)
    if kind == "local":
        return PlannerSpec(kind="local", **common)
    raise ValueError(f"backend='torch' supports policies {TORCH_PLANNABLE}; "
                     f"got {type(policy).__name__}")


def plan_batch_from_out(out: PlanOut, n_streams: int, m: int):
    """Host bridge: a numpy ``PlanBatch`` from a ``PlanOut``.

    Offloads come out of the (S, L) decision grid row-major, which is
    (stream, pos) order — the order ``PlanBatch.sort_offloads`` produces.
    """
    from repro_torch.policy.types import PlanBatch

    dec = out.dec.cpu().numpy()
    off_s, off_p = np.nonzero(dec >= 0)
    return PlanBatch(
        theta=out.theta.cpu().numpy().astype(np.float64),
        resolution=out.resolution.cpu().numpy().astype(np.int64),
        n_offloads=out.n_offloads.cpu().numpy().astype(np.int64),
        total_gain=out.total_gain.cpu().numpy().astype(np.float64),
        base_acc=out.base_acc.cpu().numpy().astype(np.float64),
        n_frames=out.n_frames.cpu().numpy().astype(np.int64),
        off_stream=off_s.astype(np.int64), off_pos=off_p.astype(np.int64),
        off_res=dec[off_s, off_p].astype(np.int64),
        planned=np.ones(n_streams, dtype=bool))


# --------------------------------------------------------------------------- #
# EWMA bandwidth fold
# --------------------------------------------------------------------------- #


@torch.inference_mode()
def ewma_fold(bw_est, alpha: float, stream, rate, ok, n_streams: int, depth: int):
    """Fold one round's transfer observations into the (S,) EWMA vector —
    ``FleetRunner.observe_bandwidth`` with static shapes.

    ``stream`` / ``rate`` / ``ok`` are flat rows in transmission order;
    each stream's valid observations are folded depth-wise in that order,
    the scalar estimator's update sequence.  ``depth`` bounds the
    observations per stream: where a stream has more, the reference's
    ``mode="drop"`` scatter writes them all into the last column and the
    last one stays, so the port keeps only that one.  Rows that are not
    ``ok``, or whose stream lies outside ``[0, n_streams)``, are dropped
    before any scatter (an out-of-range index would raise on the CPU and
    assert on the card).

    The estimates are float32, the compiled engine's dtype, and the update
    ``(1 - a) * bw + a * x`` is the reference's compiled one: XLA contracts
    it into ``fma(1 - a, bw, a * x)``, and ``_fma`` computes exactly that.
    """
    if bw_est.dtype != torch.float32:
        raise TypeError(f"ewma_fold folds float32 estimates, got {bw_est.dtype}")
    dev = bw_est.device
    stream = torch.as_tensor(stream, dtype=torch.int64, device=dev)
    rate = torch.as_tensor(rate, dtype=bw_est.dtype, device=dev)
    ok = torch.as_tensor(ok, dtype=torch.bool, device=dev)
    N = stream.shape[0]
    o = _argsort(torch.where(ok, stream, n_streams))  # group by stream, stable
    s_sorted, r_sorted, ok_sorted = stream[o], rate[o], ok[o]
    ok_sorted = ok_sorted & (s_sorted >= 0) & (s_sorted < n_streams)
    # rank within stream = position - first position of the stream's group
    idx = torch.arange(N, device=dev)
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          s_sorted[1:] != s_sorted[:-1]])
    rank = idx - _cummax(torch.where(is_first, idx, 0))
    # rows that are not ok count into a spare last slot, so nothing here
    # depends on how many are ok (no boolean indexing, no host sync)
    sink = torch.where(ok_sorted, s_sorted, n_streams)
    counts = torch.zeros(n_streams + 1, dtype=torch.int64, device=dev).index_add_(
        0, sink, torch.ones_like(sink))[:n_streams]
    # one writer a cell: an over-deep stream's last observation wins its
    # last column, the others there are dropped (into the spare row)
    cnt = counts[s_sorted.clamp(0, n_streams - 1)]
    last = (rank < depth - 1) | (rank == cnt - 1)
    w = ok_sorted & last
    cell = torch.where(w, sink * depth + torch.clamp_max(rank, depth - 1), n_streams * depth)
    grid = torch.zeros((n_streams + 1) * depth, dtype=bw_est.dtype, device=dev).scatter_(
        0, cell, torch.where(w, r_sorted, 0.0))[:n_streams * depth].view(n_streams, depth)
    one_minus_a, a = _scalar(1 - alpha, bw_est), _scalar(alpha, bw_est)
    bw = bw_est
    for k in range(depth):
        new = _fma(one_minus_a.expand_as(bw), bw, a * grid[:, k])
        bw = torch.where(counts > k, new, bw)
    return bw
