"""Trace-replay evaluation of the §V approaches (port of
``benchmarks/approaches.py``): Local / Server / FastVA / Compress /
CBO-w/o-calibration / CBO / Optimal.

``build_trace`` precomputes both tiers' predictions (the slow tier at every
ladder resolution) on the stack's device into a ``Trace``; the calibrated
confidences come from ``core/cascade.py::fast_pass(use_fused=True)``, one
calib-gate launch per batch of 256 frames on the card.  The uplink and
deadline simulation is the port's ``policy.replay_trace`` (host numpy):
every approach is a registered policy plus replay knobs (fallback
predictions, local-tier occupancy, planning window).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.bench import stack as C
from repro_torch.core.cascade import fast_pass
from repro_torch.core.confidence import max_softmax
from repro_torch.core.netsim import mbps, png_size_model
from repro_torch.data.video import make_dataset
from repro_torch.policy import Env, make_policy, replay_trace

FAST_TIME = 0.020  # Table III (s/frame): NPU tier
SERVER_TIME = 0.037  # Table III: slow tier
COMPRESS_TIME = 0.080  # compressed DNN on CPU (~4x NPU; paper §V)


@dataclass
class Trace:
    labels: np.ndarray
    fast_pred: np.ndarray
    fast_fp_pred: np.ndarray  # unquantized fast model (the Compress local tier)
    slow_pred_by_res: dict  # res -> preds
    conf_raw: np.ndarray
    conf_cal: np.ndarray
    sizes: dict  # res -> payload bytes
    # planning tables, measured on the CALIBRATION split (no test peeking):
    plan_acc_by_res: tuple = ()  # A^o_r conditioned on low-confidence frames
    local_acc_mean: float = 0.5  # population fast-tier accuracy

    def __len__(self):
        return len(self.labels)


@torch.inference_mode()
def _fast_trace(stack, frames, bs: int = C.EVAL_BATCH):
    """(fast logits, Platt-calibrated confidences): one fast-tier call and one
    ``fast_pass(use_fused=True)`` over its logits per batch."""
    fast = stack.fast_params
    dev = next(fast.parameters()).device
    ab = (stack.platt.a, stack.platt.b)
    logits, conf = [], []
    for i in range(0, len(frames), bs):
        x = torch.as_tensor(frames[i:i + bs], device=dev)
        lg = fast(x)
        _, c = fast_pass(lambda _x, lg=lg: lg, None, x, use_fused=True, platt_ab=ab)
        logits.append(lg.float().cpu().numpy())
        conf.append(c.cpu().numpy())
    return np.concatenate(logits), np.concatenate(conf)


def build_trace(stack, max_frames: int = 1200) -> Trace:
    frames = stack.test["frames"][:max_frames]
    labels = stack.test["labels"][:max_frames]
    fl, conf_cal = _fast_trace(stack, frames)
    conf_raw = max_softmax(torch.as_tensor(fl)).numpy()

    # unquantized fast model = the "Compress" baseline's local tier
    fp = stack.fast_params_fp if stack.fast_params_fp is not None else stack.fast_params
    _, ffl = C._accuracy(lambda m, x: m(x), fp, frames, labels)
    slow_by_res = {r: C.slow_preds_at(stack.slow_params, frames, r) for r in C.RESOLUTIONS}

    # planning tables from the calibration split: A^o_r conditioned on the
    # low-confidence population (the frames CBO actually offloads)
    calib_frames = stack.calib.get("frames")
    if calib_frames is None:
        calib_d = make_dataset(C.DATA_CFG, 120, seed=1)
        calib_frames, calib_labels = calib_d["frames"], calib_d["labels"]
    else:
        calib_labels = stack.calib["labels"]
    calib_cal_conf = np.asarray(stack.platt(stack.calib["conf"]))
    lowmask = calib_cal_conf <= np.median(calib_cal_conf)
    plan_acc = tuple(float((C.slow_preds_at(stack.slow_params, calib_frames, r) == calib_labels)[lowmask].mean())
                     for r in C.RESOLUTIONS)

    sizes = {r: png_size_model(r, base_res=32, base_bytes=60000.0) for r in C.RESOLUTIONS}
    return Trace(labels=labels, fast_pred=np.argmax(fl, -1), fast_fp_pred=np.argmax(ffl, -1),
                 slow_pred_by_res=slow_by_res, conf_raw=conf_raw, conf_cal=conf_cal, sizes=sizes,
                 plan_acc_by_res=plan_acc, local_acc_mean=float(stack.calib["correct"].mean()))


@dataclass
class NetCfg:
    bandwidth_mbps: float = 5.0
    latency: float = 0.1
    frame_rate: float = 30.0
    deadline: float = 0.2

    @property
    def gamma(self):
        return 1.0 / self.frame_rate

    @property
    def bw(self):
        return mbps(self.bandwidth_mbps)


# --------------------------- unified replay ------------------------------- #


def _replay(trace: Trace, net: NetCfg, policy, *, conf=None, acc_server=None,
            local_pred=None, local_time: float = 0.0, **kw) -> float:
    """Run one policy through the shared replay engine; returns accuracy."""
    env = Env(bandwidth=net.bw, latency=net.latency, server_time=SERVER_TIME, deadline=net.deadline,
              acc_server=acc_server if acc_server is not None else trace.plan_acc_by_res)
    result = replay_trace(
        policy,
        conf=conf if conf is not None else trace.conf_cal,
        slow_pred=np.stack([trace.slow_pred_by_res[r] for r in C.RESOLUTIONS]),
        sizes=[trace.sizes[r] for r in C.RESOLUTIONS],
        env=env,
        frame_interval=net.gamma,
        local_pred=local_pred,
        local_time=local_time,
        **kw,
    )
    return result.accuracy(trace.labels)


def _pop_acc(trace: Trace) -> tuple:
    """Population server accuracy per resolution (the greedy rules' table)."""
    return tuple(float((trace.slow_pred_by_res[r] == trace.labels).mean()) for r in C.RESOLUTIONS)


# ------------------------------ approaches --------------------------------- #


def run_local(trace: Trace, net: NetCfg) -> float:
    return _replay(trace, net, make_policy("local"), local_pred=trace.fast_pred)


def run_server(trace: Trace, net: NetCfg) -> float:
    """All frames offloaded; unanswered frames score wrong (no fallback)."""
    return _replay(trace, net, make_policy("server", frame_interval=net.gamma), local_pred=None)


def run_fastva(trace: Trace, net: NetCfg) -> float:
    return _replay(trace, net, make_policy("greedy-rate", local_acc=trace.local_acc_mean),
                   acc_server=_pop_acc(trace), local_pred=trace.fast_pred, local_time=FAST_TIME)


def run_compress(trace: Trace, net: NetCfg) -> float:
    fp_acc = float((trace.fast_fp_pred == trace.labels).mean())
    return _replay(trace, net, make_policy("greedy-rate", local_acc=fp_acc),
                   acc_server=_pop_acc(trace), local_pred=trace.fast_fp_pred, local_time=COMPRESS_TIME)


def run_cbo(trace: Trace, net: NetCfg) -> float:
    return _replay(trace, net, make_policy("cbo", max_backlog=None), conf=trace.conf_cal,
                   local_pred=trace.fast_pred)


def run_cbo_wo(trace: Trace, net: NetCfg) -> float:
    return _replay(trace, net, make_policy("cbo", max_backlog=None), conf=trace.conf_raw,
                   local_pred=trace.fast_pred)


def run_optimal(trace: Trace, net: NetCfg) -> float:
    """Offline optimal, planned over 60-frame windows (replay, as in the
    paper) so the DP state stays small."""
    return _replay(trace, net, make_policy("optimal"), conf=trace.conf_cal, local_pred=trace.fast_pred,
                   window=60)


APPROACHES = {
    "Local": run_local,
    "Server": run_server,
    "FastVA": run_fastva,
    "Compress": run_compress,
    "CBO-w/o": run_cbo_wo,
    "CBO": run_cbo,
    "Optimal": run_optimal,
}
