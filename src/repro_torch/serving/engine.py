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

The tiers run on ``device`` (``cuda`` unless the caller passes ``"cpu"``);
the planner, the uplink and the metrics stay on the host in float64.
``MultiStreamServer`` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.cascade import cascade_classify
from repro_torch.core.netsim import Uplink, png_size_model
from repro_torch.device import resolve_device
from repro_torch.policy import BandwidthEstimator, PolicyRunner, resolve_policies
from repro_torch.serving.metrics import ServeMetrics


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
