"""CBO serving engine, single stream (port of ``repro.serving.engine``).

``CascadeServer`` is the paper's control loop (§IV-D), per batch:
  1. the fast tier classifies the batch (int8 "NPU" model);
  2. calibrated confidences go to the offload policy (``policy=`` registry
     name or instance, default ``"cbo"``) through a ``PolicyRunner`` that
     owns the bandwidth estimate; the plan gives (theta, resolution,
     capacity);
  3. the data plane escalates the K lowest-confidence frames;
  4. replies that would land after the frame's deadline are dropped and
     the fast-tier answer stands;
  5. planned offloads leave the controller backlog, so they are never
     re-planned.

``MultiStreamServer`` generalizes this to N concurrent client streams
sharing an edge fabric (``net/``): streams are partitioned across cells
(one serial uplink each) and escalations are placed onto a pool of
slow-tier replicas, which may batch continuously (``slowtier/``).  Per
round: one fast-tier call over every stream's frames, one batched
``plan_many`` over every stream's backlog (``FleetRunner``), one
vectorized escalation gate, one fair uplink schedule, one gathered
slow-tier call and one fabric transmit.  Without a fabric, the ``uplink``
argument becomes the degenerate 1-cell/1-replica fabric, the shared-uplink
pipeline bit for bit.

The tiers run on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
With ``backend="numpy"`` the planner, the uplink, the fabric, the metrics
and the telemetry (``obs/``) stay on the host in float64, as the
reference's numpy engine; with ``backend="torch"`` the whole round runs on
``device`` as well (``serving/engine_torch.py::serve``): the tiers are
precomputed for every round first, then one CUDA graph replay a round
advances the fleet, and the final state is folded back into the host
objects.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.cascade import cascade_classify, fast_pass, slow_pass_multires
from repro_torch.core.netsim import Uplink, png_size_model, transfer_seconds
from repro_torch.device import resolve_device
from repro_torch.net import EdgeFabric
from repro_torch.obs.profile import NULL_PROFILER
from repro_torch.policy import BandwidthEstimator, FleetRunner, PolicyRunner, resolve_policies
from repro_torch.serving.events import ArrivalSchedule, EscalationBatch, select_escalations
from repro_torch.serving.metrics import AggregateMetrics, ServeMetrics
from repro_torch.serving.scheduler import FairScheduler


@dataclass
class ServeConfig:
    deadline: float = 0.2  # T (paper: 200 ms)
    frame_rate: float = 30.0
    resolutions: tuple = (45, 90, 134, 179, 224)
    acc_server: tuple = ()  # measured offline (bench_resolution)
    batch_size: int = 16
    fast_time: float = 0.020  # Table III: fast tier per frame
    calib_time: float = 0.008  # Table III: calibration
    server_time: float = 0.037  # Table III: slow tier per frame
    size_of: Callable = png_size_model  # resolution (scalar or array) -> upload bytes
    use_fused: bool = False  # fused calibrate+gate kernel in the fast pass
    platt_ab: Optional[tuple] = None  # (a, b) Platt coefficients for use_fused
    # split-computation action table (``policy.types.ActionTable``, built by
    # ``split.build_action_table``): adds features@cut actions to the
    # planner's grid.  None or a frames-only table keeps the paper's
    # frame-only action space bit for bit.  Read by ``MultiStreamServer``;
    # ``CascadeServer`` (the single-stream paper loop) stays frame-only.
    actions: Optional[object] = None


class CascadeServer:
    """Single-stream engine; ``policy`` is a registry name (``"cbo"``,
    ``"threshold"``, …) or an ``OffloadPolicy`` instance."""

    def __init__(self, cfg: ServeConfig, fast_forward: Callable, slow_forward: Callable,
                 calibrate: Callable, uplink: Uplink, policy="cbo", device=None):
        self.cfg = cfg
        self.fast_forward = fast_forward
        self.slow_forward = slow_forward
        self.calibrate = calibrate
        self.uplink = uplink
        self.device = resolve_device(device)
        self.controller = PolicyRunner(
            resolve_policies(policy, 1)[0],
            resolutions=cfg.resolutions,
            acc_server=cfg.acc_server,
            deadline=cfg.deadline,
            latency=uplink.latency,
            server_time=cfg.server_time,
            size_of=cfg.size_of,
            bw=BandwidthEstimator(estimate_bps=uplink.bandwidth_bps),
        )
        self.metrics = ServeMetrics()

    @torch.inference_mode()
    def process_stream(self, frames: np.ndarray, labels: Optional[np.ndarray] = None) -> ServeMetrics:
        """Replay a frame stream (N, H, W, C) at cfg.frame_rate through the
        cascade; a trailing partial batch runs as a smaller final round."""
        cfg = self.cfg
        gamma = 1.0 / cfg.frame_rate
        B = cfg.batch_size
        t_fast = cfg.fast_time + cfg.calib_time
        n = len(frames)
        for start in range(0, n, B):
            b = min(B, n - start)
            batch = torch.as_tensor(frames[start : start + b], device=self.device)
            arrivals = (start + np.arange(b)) * gamma
            t_done_fast = arrivals + t_fast

            # plan from current backlog + bandwidth estimate
            plan = self.controller.plan(now=float(arrivals[0]))
            capacity = max(len(plan.offloads), 1)
            theta = plan.theta if plan.offloads else 0.0
            res = cfg.resolutions[plan.resolution]

            out = cascade_classify(
                self.fast_forward, self.slow_forward, self.calibrate, batch,
                threshold=theta, capacity=capacity, resolution=res,
                use_fused=cfg.use_fused, platt_ab=cfg.platt_ab,
            )
            conf = out.conf.cpu().numpy()
            escalated = out.escalated.cpu().numpy()
            preds = out.preds.cpu().numpy()
            fast_preds = out.fast_preds.cpu().numpy()

            # simulate the uplink for the whole round at once; late replies
            # fall back to the fast answer
            esc = np.flatnonzero(escalated)
            payloads = np.full(len(esc), cfg.size_of(res))
            lands = self.uplink.transmit_batch(payloads, t_done_fast[esc])
            for k in range(len(esc)):
                self.controller.bw.observe(
                    payloads[k],
                    lands[k] - t_done_fast[esc[k]] - self.uplink.latency - self.uplink.server_time,
                )
            ok = lands <= arrivals[esc] + cfg.deadline
            final = fast_preds.copy()
            final[esc[ok]] = preds[esc[ok]]

            # planned offloads left the device: consume them; this batch's
            # escalated frames never enter the backlog
            self.controller.consume(i for i, _ in plan.offloads)
            for i in np.flatnonzero(~escalated):
                self.controller.add_frame(float(arrivals[i]), float(conf[i]))

            lat = np.full(b, t_fast)
            lat[esc] = np.where(ok, lands - arrivals[esc], cfg.deadline)
            n_correct = int((final == labels[start : start + b]).sum()) if labels is not None else 0
            self.metrics.update_batch(b, int(ok.sum()), int((~ok).sum()), n_correct, lat)
        return self.metrics


class FrameStage:
    """A round's frames on their way to the device, through one host
    buffer that every round of a replay reuses.

    ``frames`` is the (S, N, ...) pool.  The buffer holds S·``batch_size``
    frames of its dtype, pinned where ``device`` is CUDA (pinning needs it;
    elsewhere it is plain memory); a pinned buffer comes from torch's
    caching host allocator, so a later stage of the same size takes the
    freed block back with no new ``cudaHostAlloc`` and no page fault.  That
    allocator rounds the block up to a power of two and keeps it pinned
    until ``torch._C._host_emptyCache()``: each distinct S·B·frame size
    that one process stages holds one such block for its life.
    ``fill`` copies round ``start``'s ``b`` frames of every stream into the
    buffer's first S·b rows, in the layout of
    ``frames[:, start:start+b].reshape(S*b, ...)``; ``to_device`` starts
    their copy on the current stream and returns at once, so stream order
    puts it before the tiers that read it.  ``fill`` first waits for the
    previous copy to have read the buffer."""

    def __init__(self, frames: np.ndarray, batch_size: int, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.src = torch.from_numpy(frames)
        self.buf = torch.empty((frames.shape[0] * batch_size, *frames.shape[2:]),
                               dtype=self.src.dtype, pin_memory=cuda)
        self.copied = torch.cuda.Event() if cuda else None

    def fill(self, start: int, b: int) -> torch.Tensor:
        if self.copied is not None:
            self.copied.synchronize()
        S = self.src.shape[0]
        host = self.buf[: S * b]
        host.view(S, b, *self.src.shape[2:]).copy_(self.src[:, start : start + b])
        return host

    def to_device(self, host: torch.Tensor) -> torch.Tensor:
        flat = host.to(self.device, non_blocking=True)
        if self.copied is not None:
            self.copied.record()
        return flat


class MultiStreamServer:
    """N concurrent client streams sharing an edge fabric and a slow tier.

    Per round: one batched fast-tier call over all streams' frames (one
    calib-gate launch with ``use_fused``), one batched ``plan_many`` over
    every stream's backlog (``FleetRunner``), one vectorized escalation
    gate, one fair uplink schedule, one gather on the device and one
    batched slow-tier call over the cross-stream escalations, and
    vectorized deadline/metric accounting: no per-stream or per-frame
    Python.  ``round_hook``, when set, is called with one dict per round
    (the reference's keys).  ``telemetry`` (``obs.Telemetry``) adds a
    per-round recorder, a frame tracer and a profiler of the round's host
    spans (slice, h2d, fast, fast_wait, plan, gate, slow, slow_wait,
    transmit, fold, hook), of its blocking transfers (``syncs``) and of
    its rounds staged (``staged``); without a profiler the spans go to
    ``obs.NULL_PROFILER``, which does nothing.  On every device each
    round's frames are filled into one reused host buffer (``FrameStage``:
    the ``slice`` span; pinned on a CUDA device) and copied to the device
    (``h2d``: issuing the copy, which does not block on the card).
    ``backend="torch"`` runs the round loop on
    ``device`` (the reference's ``backend="jax"``; configurations it cannot
    express raise at construction, ``engine_torch.torch_unsupported``).
    """

    def __init__(self, cfg: ServeConfig, fast_forward: Callable, slow_forward: Callable,
                 calibrate: Callable, uplink: Optional[Uplink], n_streams: int,
                 scheduler: Optional[FairScheduler] = None, stagger: bool = True,
                 policy="cbo", fabric: Optional[EdgeFabric] = None,
                 backend: str = "numpy", telemetry=None, device=None):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if backend == "jax":
            raise NotImplementedError(
                "backend='jax' is the reference's compiled round loop; the port's is"
                " backend='torch' (ROADMAP A.9)")
        if backend not in ("numpy", "torch"):
            raise ValueError(f"backend must be 'numpy' or 'torch', got {backend!r}")
        self.backend = backend
        self.device = resolve_device(device)
        self.round_hook = None
        self.cfg = cfg
        self.fast_forward = fast_forward
        self.slow_forward = slow_forward
        self.calibrate = calibrate
        # the fabric's cells own all traffic: passing an uplink as well
        # would leave it idle but still feeding the metrics
        if fabric is None:
            if uplink is None:
                raise ValueError("pass an uplink or an EdgeFabric")
            fabric = EdgeFabric.degenerate(uplink, n_streams)
        else:
            if uplink is not None:
                raise ValueError("pass either uplink or fabric, not both "
                                 "(the fabric's cells own all traffic)")
            if fabric.n_streams != n_streams:
                raise ValueError(f"fabric maps {fabric.n_streams} streams, "
                                 f"engine has {n_streams}")
        self.fabric = fabric
        self.uplink = fabric.cells[0].uplink
        self.n_streams = n_streams
        self.stagger = stagger
        self.scheduler = scheduler or FairScheduler("round_robin")
        # nominal per-stream uplink rate (each stream's own cell): the
        # scheduler's cost normalizer and the EWMA estimators' optimistic
        # prior (a 1/N prior can deadlock: no stream transmits, so none
        # ever observes the link)
        self._stream_bw = fabric.stream_bandwidth()
        # plan against the network the fabric simulates: T^o is the pool's
        # nominal service time
        self.fleet = FleetRunner(
            resolve_policies(policy, n_streams),
            resolutions=cfg.resolutions, acc_server=cfg.acc_server,
            deadline=cfg.deadline, latency=fabric.latency,
            server_time=fabric.server_time, size_of=cfg.size_of,
            bw_init=self._stream_bw, cell_id=fabric.cell_of, actions=cfg.actions,
        )
        self.metrics = AggregateMetrics.for_streams(n_streams, uplink=self.uplink,
                                                    fabric=fabric)
        # optional observability bundle (``obs.Telemetry``).  The round's
        # spans, and the planner's ``plan`` span, go to its profiler, or
        # without one to ``NULL_PROFILER``, which does nothing
        self.telemetry = telemetry
        if telemetry is None:
            self.profiler = NULL_PROFILER
        else:
            telemetry.bind(n_streams=n_streams, n_cells=fabric.n_cells,
                           n_replicas=fabric.n_replicas,
                           n_actions=self.fleet.action_table.n_actions)
            self.profiler = NULL_PROFILER if telemetry.profiler is None else telemetry.profiler
        self.fleet.profiler = self.profiler
        if backend == "torch":
            from repro_torch.serving.engine_torch import torch_unsupported

            reasons = torch_unsupported(self)
            if reasons:
                raise ValueError("backend='torch' cannot express this configuration: "
                                 + "; ".join(reasons))

    @torch.inference_mode()
    def process_streams(self, frames: np.ndarray, labels: Optional[np.ndarray] = None,
                        schedule: Optional[ArrivalSchedule] = None) -> AggregateMetrics:
        """Replay S frame streams; ``frames`` is (S, N, H, W, C), ``labels``
        (S, N).  ``schedule`` defaults to the lockstep interleaved replay;
        an ``ArrivalSchedule.churn`` staggers stream join/leave."""
        cfg = self.cfg
        S = self.n_streams
        if frames.shape[0] != S:
            raise ValueError(f"expected {S} streams, got frames.shape[0]={frames.shape[0]}")
        B = cfg.batch_size
        t_fast = cfg.fast_time + cfg.calib_time
        resolutions = np.asarray(cfg.resolutions)
        if schedule is None:
            schedule = ArrivalSchedule.interleaved(S, frames.shape[1], cfg.frame_rate,
                                                  cfg.deadline, stagger=self.stagger)
        if schedule.n_streams != S or schedule.n_frames != frames.shape[1]:
            raise ValueError("schedule shape must match frames (S, N)")
        self.metrics.wall_time = schedule.horizon
        if self.backend == "torch":
            from repro_torch.serving.engine_torch import serve

            return serve(self, frames, labels, schedule)
        # the profiler's spans, on host clocks with no device synchronization
        # (a span holds device time where the round already waits for it): a
        # ``round`` root over the steps below (``plan`` is
        # ``FleetRunner.plan_all``'s own); ``syncs`` counts the round's
        # blocking transfers (copies to the host, and index copies to the
        # device from pageable memory, which wait for the stream); ``staged``
        # counts rounds whose frames went through the ``FrameStage``, whose
        # copy to the card does not block
        rec = getattr(self.telemetry, "recorder", None)
        tracer = getattr(self.telemetry, "tracer", None)
        prof = self.profiler
        stage = FrameStage(frames, B, self.device)

        try:
            for start, arr, valid in schedule.rounds(B):
                prof.open_round()
                b = arr.shape[1]
                active = valid.any(axis=1)  # (S,) streams with frames this round
                self.fleet.retire(~active)

                prof.open("slice")
                host = stage.fill(start, b)
                prof.switch("h2d")
                prof.count("staged")
                flat = stage.to_device(host)
                prof.switch("fast")
                fp, cf = fast_pass(self.fast_forward, self.calibrate, flat,
                                   use_fused=cfg.use_fused, platt_ab=cfg.platt_ab)
                prof.switch("fast_wait")
                prof.count("syncs", 2)
                fast_preds = fp.cpu().numpy().reshape(S, b)
                conf = cf.cpu().numpy().reshape(S, b)
                prof.close()
                t_ready = arr + t_fast  # (S, b); +inf on invalid slots

                # control plane: one batched plan over every active backlog,
                # against the slow tier's occupancy-calibrated service estimate
                # (identical to the nominal when the pool does not batch)
                now = np.min(arr, axis=1)  # first valid arrival (inf if none)
                pool = self.fabric.pool
                self.fleet.server_time = self.fabric.expected_server_time()
                self.fleet.occupancy = float(pool.avg_batch)
                fin = now[np.isfinite(now)]
                self.fleet.queue_depth = pool.queue_depth(float(fin.min()) if len(fin) else 0.0)
                batch = self.fleet.plan_all(now, active)
                theta = batch.theta
                cap = np.where(active, np.maximum(batch.n_offloads, 1), 0)
                res_idx = batch.resolution  # action index per stream

                # planner-assumed and transmitted payloads come from one table;
                # for frame actions ``+ t_dev`` and ``* srv_frac`` are no-ops
                prof.open("gate")
                act = self.fleet.action_table
                conf_gate = np.where(valid, conf, np.inf)
                s_idx, slot_idx = select_escalations(conf_gate, theta, cap)
                a_esc = res_idx[s_idx]
                esc = EscalationBatch(
                    stream=s_idx, slot=slot_idx,
                    t_ready=t_ready[s_idx, slot_idx] + act.t_dev[a_esc],
                    payload=act.sizes[a_esc],
                    res=resolutions[act.res][a_esc],
                )
                prof.close()

                # one gather on the device, one slow-tier call for every
                # stream's escalations
                if len(esc):
                    prof.open("slow")
                    # the gather's index, and one index a planned resolution
                    prof.count("syncs", 1 + len(np.unique(esc.res)))
                    gathered = flat.index_select(
                        0, torch.as_tensor(s_idx * b + slot_idx, device=self.device))
                    slow = slow_pass_multires(self.slow_forward, gathered, esc.res)
                    prof.switch("slow_wait")
                    prof.count("syncs")
                    slow_preds = slow.cpu().numpy()
                    prof.close()
                else:
                    slow_preds = np.zeros(0, dtype=fast_preds.dtype)

                # fair uplink schedule (cost normalized by each stream's own
                # cell rate), then one fabric transmit for the round
                prof.open("transmit")
                order = self.scheduler.order(esc.stream, esc.t_ready,
                                             cost=esc.payload / self._stream_bw[esc.stream])
                q = esc.permuted(order)
                slow_q = slow_preds[order]
                lands = self.fabric.transmit(q.stream, q.payload, q.t_ready,
                                             service_scale=act.srv_frac[res_idx[q.stream]],
                                             collect_detail=tracer is not None)
                prof.switch("fold")
                ok = lands <= arr[q.stream, q.slot] + cfg.deadline
                final = fast_preds.copy()
                final[q.stream[ok], q.slot[ok]] = slow_q[ok]

                # per-stream bandwidth observations in transmission order: each
                # reply's actual service time is subtracted, replica queueing is
                # not (a device cannot tell it from wire time)
                self.fleet.observe_bandwidth(
                    q.stream, q.payload,
                    transfer_seconds(lands, q.t_ready, latency=self.fabric.latency,
                                     server_time=self.fabric.last_service_time))

                # planned offloads left the device; non-escalated valid frames
                # join their stream's backlog in slot order
                self.fleet.consume(batch)
                esc_mask = np.zeros((S, b), dtype=bool)
                esc_mask[s_idx, slot_idx] = True
                add = valid & ~esc_mask
                add_s, _ = np.nonzero(add)
                self.fleet.observe_frames(add_s, arr[add], conf[add].astype(np.float64))

                lat = np.full((S, b), t_fast)
                lat[q.stream[ok], q.slot[ok]] = lands[ok] - arr[q.stream[ok], q.slot[ok]]
                lat[q.stream[~ok], q.slot[~ok]] = cfg.deadline
                off_counts = np.bincount(q.stream[ok], minlength=S)
                miss_counts = np.bincount(q.stream[~ok], minlength=S)
                correct = (((final == labels[:, start : start + b]) & valid).sum(axis=1)
                           if labels is not None else np.zeros(S, dtype=np.int64))
                self.metrics.update_round(valid.sum(axis=1), off_counts, miss_counts,
                                          correct, lat, valid)
                prof.switch("hook")

                if tracer is not None and len(q):
                    d = self.fabric.last_detail
                    tracer.record_round(
                        stream=q.stream, slot=q.slot,
                        arrival=arr[q.stream, q.slot], t_ready=q.t_ready,
                        cell=d["cell"], up_start=d["up_start"], up_end=d["up_end"],
                        replica=d["replica"], service=d["service"],
                        batch_id=d["batch_id"], done=d["done"],
                        land=lands, ok=ok, deadline=cfg.deadline)

                if rec is not None:
                    # cumulative counters, the planner's state as used this
                    # round, and the contention cursors after it
                    t_round = float(fin.min()) if len(fin) else np.nan
                    hist = np.zeros(rec.n_actions, dtype=np.int64)
                    np.add.at(hist, res_idx, np.where(active, batch.n_offloads, 0))
                    m, fab = self.metrics, self.fabric
                    rec.record_round(
                        t=t_round,
                        frames=m._frames, offloads=m._offloaded,
                        misses=m._missed, correct=m._correct,
                        bw_est=self.fleet.bw_est,
                        bw_true=fab.true_bandwidth(t_round),
                        cell_busy_s=[c.uplink.busy_seconds for c in fab.cells],
                        cell_queued_s=[c.uplink.queued_seconds for c in fab.cells],
                        rep_busy_s=pool.busy_seconds,
                        rep_queued_s=pool.queued_seconds,
                        avg_batch=pool.avg_batch,
                        server_time=self.fleet.server_time,
                        action_off=hist,
                    )

                if self.round_hook is not None:
                    ok_grid = np.zeros((S, b), dtype=bool)
                    ok_grid[q.stream[ok], q.slot[ok]] = True
                    self.round_hook({
                        "start": start,
                        "theta": theta.copy(), "res_idx": res_idx.copy(),
                        "cap": cap.copy(), "n_off": batch.n_offloads.copy(),
                        "n_frames": batch.n_frames.copy(),
                        "off_stream": batch.off_stream.copy(),
                        "off_pos": batch.off_pos.copy(),
                        "off_res": batch.off_res.copy(),
                        "off_kind": batch.off_kind.copy(),
                        "off_cut": batch.off_cut.copy(),
                        "esc": esc_mask, "ok": ok_grid, "lat": lat.copy(),
                        "valid": valid.copy(), "correct": np.asarray(correct).copy(),
                        "bw_est": self.fleet.bw_est.copy(),
                        "lengths": self.fleet.state.lengths.copy(),
                    })
                prof.close()  # hook
                prof.close()  # round
        finally:
            prof.close_all()  # a round hook that raised leaves its spans open
        return self.metrics
