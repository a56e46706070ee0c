#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA GPU, the CUDA toolkit (``nvcc``) and this checkout's ``src/``;
without them it exits non-zero before printing any result.  Phases:

  1. card: ``nvidia-smi`` name and power limit; build the port's kernel;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shape and at wider, ragged and extreme ones, with times;
  3. the main path: ``CascadeServer(use_fused=True)`` serving 256 synthetic
     224 px frames with two full-width ResNet-50 tiers (random weights from
     seeds; the fast tier int8 through ``qdq_tree``), with the kernels'
     launch counts read around that run alone; then the same stream again
     under ``torch.profiler`` for the device's idle share;
  4. one batch's fast pass on the card against the same pass on the CPU,
     TF32 off;
  5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Any failed check raises, and the script exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CALIB_ATOL = 1e-6  # kernel vs plain version on the card: one float32 row sum
CPU_CONF_ATOL = 1e-5  # card vs CPU through 53 float32 convolutions, TF32 off
PLATT = (-20.0, 5.0)
N_FRAMES = 256
ACC_SERVER = (0.35, 0.5, 0.6, 0.66, 0.7)  # fixed ladder: there are no trained weights
BW_MBPS = 5.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def traced(fn, iters: int = 1, host_ops: bool = True):
    """Call ``fn`` ``iters`` times inside one ``torch.profiler`` (CUPTI)
    trace.  Returns the device time the trace records, summed over every
    kernel and copy (ms; None when it records no device activity), and the
    host wall time of the traced window (ms).  ``host_ops=False`` traces the
    card's activity only, which adds less host time to the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return (total_us / 1e3 if total_us > 0 else None), wall_ms


def device_ms(fn, iters: int = 20):
    """Device time per call of ``fn``: the kernels' own durations, summed,
    without the host's launch gaps; None when the profiler records none."""
    import torch

    fn()
    torch.cuda.synchronize()
    total_ms, _ = traced(fn, iters)
    return None if total_ms is None else total_ms / iters


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:9.3f} us"


class TimedTier:
    """Wraps a tier: checks its tensors are on the card and records CUDA
    events around each call."""

    def __init__(self, model, name: str):
        self.model, self.name, self.events, self.sizes = model, name, [], []

    def __call__(self, x):
        import torch

        check(x.is_cuda, f"{self.name} tier input on {x.device}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = self.model(x)
        end.record()
        check(y.is_cuda, f"{self.name} tier output on {y.device}")
        self.events.append((start, end))
        self.sizes.append(x.shape[0])
        return y

    def ms(self) -> list[float]:
        return [s.elapsed_time(e) for s, e in self.events]


def calib_gate_phase(torch, calib_gate, calib_gate_ref):
    """Phase 2: the CUDA kernel against its plain version on the card."""
    g = torch.Generator(device="cuda").manual_seed(0)
    extreme = torch.cat([torch.full((16, 512), -1e4, device="cuda"),
                         torch.randn(16, 512, generator=g, device="cuda") * 50], dim=1)
    extreme[0] = -torch.inf
    extreme[1] = 1e4
    extreme[2, ::2] = -1e4
    cases = [("main path", torch.randn(16, 1000, generator=g, device="cuda") * 3),
             ("wide", torch.randn(128, 4096, generator=g, device="cuda") * 3),
             ("ragged", torch.randn(37, 1001, generator=g, device="cuda") * 3),
             ("vocab 152k", torch.randn(8, 152064, generator=g, device="cuda") * 3),
             ("extreme", extreme)]
    rows, max_err = [], 0.0
    print("calib_gate vs calib_gate_ref, inputs resident in L2; 'loop' is CUDA events over 200"
          " back-to-back calls from Python, 'device' the profiler's kernel time per call:")
    for name, x in cases:
        B, V = x.shape
        for a, b, theta in ((-6.0, 2.0, 0.5), (PLATT[0], PLATT[1], 0.3)):
            ck, gk = calib_gate(x, a, b, theta)
            cr, gr = calib_gate_ref(x, a, b, theta)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(ck).all()), f"{name}: non-finite calib")
            err = float((ck - cr).abs().max())
            check(err <= CALIB_ATOL, f"{name} {B}x{V}: calib err {err} > {CALIB_ATOL}")
            check(torch.equal(gk, gr), f"{name} {B}x{V}: gate differs")
            max_err = max(max_err, err)
        ms = cuda_ms(lambda: calib_gate(x, -6.0, 2.0, 0.5))
        plain_ms = cuda_ms(lambda: calib_gate_ref(x, -6.0, 2.0, 0.5))
        dev_ms = device_ms(lambda: calib_gate(x, -6.0, 2.0, 0.5))
        plain_dev_ms = device_ms(lambda: calib_gate_ref(x, -6.0, 2.0, 0.5))
        n_bytes = B * V * 4 + B * 4 + B  # logits read once; calib f32 and gate bool written
        n_ops = B * V * 4  # compare, subtract, exp, add per logit
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S) * 1e3
        bound_by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / FP32_OPS_PER_S else "operations"
        # the line reports device time: the timed loop is bound by the host's
        # launch cost (~30-160 us a call on a shared host), not by the kernel
        rows.append(dict(case=name, B=B, V=V, bound_ms=bound_ms, bound_by=bound_by,
                         ms=ms if dev_ms is None else dev_ms,
                         plain_ms=plain_ms if plain_dev_ms is None else plain_dev_ms))
        print(f"  {name:11s} ({B:4d},{V:6d})  kernel loop {_us(ms)} device {_us(dev_ms)}"
              f" | plain loop {_us(plain_ms)} device {_us(plain_dev_ms)}"
              f" | bound {_us(bound_ms)} ({bound_by})")
    print(f"  max |calib - plain| over all shapes: {max_err:.3e} (atol {CALIB_ATOL}); gates equal;"
          " no single PyTorch call computes this op, so library_ms is null")
    return rows, max_err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from repro_torch.configs.resnet_50 import FULL
    from repro_torch.core.cascade import fast_pass
    from repro_torch.core.netsim import Uplink, mbps
    from repro_torch.data.video import VideoDataConfig, make_dataset
    from repro_torch.kernels.fused_calib_gate import kernel as cg_kernel
    from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref
    from repro_torch.models.resnet import ResNet
    from repro_torch.quant.quantize import qdq_tree
    from repro_torch.serving.engine import CascadeServer, ServeConfig

    # ---- 1. card and build ------------------------------------------------ #
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    cg_kernel.LIBRARY.load()
    print(f"built kernels in {time.perf_counter() - t0:.2f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for line in cg_kernel.LIBRARY.ptxas_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # ---- 2. kernel vs plain version --------------------------------------- #
    rows, max_err = calib_gate_phase(torch, cg_kernel.calib_gate, calib_gate_ref)

    # ---- 3. the main path ------------------------------------------------- #
    t0 = time.perf_counter()
    fast = ResNet(FULL, generator=torch.Generator().manual_seed(0), device="cuda")
    fast.load_state_dict(qdq_tree(fast.state_dict()))  # int8 per-channel "NPU" weights
    slow = ResNet(FULL, generator=torch.Generator().manual_seed(1), device="cuda")
    data = make_dataset(VideoDataConfig(n_classes=FULL.n_classes, img_res=FULL.img_res,
                                        frames_per_video=16), N_FRAMES // 16, seed=0)
    frames, labels = data["frames"], data["labels"]
    check(frames.shape == (N_FRAMES, 224, 224, 3), f"frames {frames.shape}")
    print(f"set-up: weights and {N_FRAMES} frames {time.perf_counter() - t0:.2f} s")
    # cuDNN sets up each new batch shape on its first call (0.1-0.2 s on an
    # H100); a server warms every batch size it can see before serving
    t0 = time.perf_counter()
    warm = torch.as_tensor(frames[:16], device="cuda")
    with torch.inference_mode():
        fast(warm)
        for k in range(1, 17):
            slow(warm[:k])
    torch.cuda.synchronize()
    print(f"set-up: warm-up of the fast tier at 16 and the slow tier at 1..16 frames"
          f" {time.perf_counter() - t0:.2f} s")

    cfg = ServeConfig(batch_size=16, use_fused=True, platt_ab=PLATT, acc_server=ACC_SERVER)
    uplink = Uplink(bandwidth_bps=mbps(BW_MBPS), latency=0.05, server_time=cfg.server_time)
    fast_t, slow_t = TimedTier(fast, "fast"), TimedTier(slow, "slow")
    server = CascadeServer(cfg, fast_t, slow_t, calibrate=None, uplink=uplink, device="cuda")
    plan_s = []
    plan = server.controller.plan

    def timed_plan(now):
        t = time.perf_counter()
        out = plan(now)
        plan_s.append(time.perf_counter() - t)
        return out

    server.controller.plan = timed_plan
    n_batches = -(-N_FRAMES // cfg.batch_size)

    cg_kernel.calib_gate.launches = 0
    t0 = time.perf_counter()
    metrics = server.process_stream(frames, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"calib_gate": cg_kernel.calib_gate.launches}

    check(launches["calib_gate"] == n_batches,
          f"calib_gate launched {launches['calib_gate']} times for {n_batches} batches")
    check(metrics.n_frames == N_FRAMES, f"served {metrics.n_frames} frames")
    check(metrics.n_offloaded + metrics.n_deadline_miss > 0, "no frame escalated")
    check(len(fast_t.events) == n_batches and len(slow_t.events) == n_batches, "tier calls")
    check(all(np.isfinite(metrics.latencies)), "non-finite latency")
    fast_ms, slow_ms = fast_t.ms(), slow_t.ms()
    print(f"main path on {card}: ResNet-50 FULL x2, {N_FRAMES} frames, {n_batches} batches of "
          f"{cfg.batch_size}, {BW_MBPS} Mbps uplink, cuDNN TF32 {torch.backends.cudnn.allow_tf32}")
    print("  ServeMetrics.summary():", json.dumps(metrics.summary()))
    print(f"  frames/s {N_FRAMES / wall:.2f} (wall {wall:.3f} s); launches {launches}")
    print(f"  ms per batch: fast tier mean {np.mean(fast_ms):.3f} (min {np.min(fast_ms):.3f}),"
          f" slow tier mean {np.mean(slow_ms):.3f} (min {np.min(slow_ms):.3f}),"
          f" planner mean {np.mean(plan_s) * 1e3:.3f} (max {np.max(plan_s) * 1e3:.3f})")
    print("  slow tier calls (batch size: ms):",
          " ".join(f"{k}:{t:.2f}" for k, t in zip(slow_t.sizes, slow_ms)))
    with torch.inference_mode():
        fast_dev = device_ms(lambda: fast(warm), iters=5)
        slow_dev = device_ms(lambda: slow(warm[:3]), iters=5)
    print(f"  device time per call (profiler): fast tier at 16 frames {_us(fast_dev)},"
          f" slow tier at 3 frames {_us(slow_dev)}")
    # the same stream on a fresh server, inside one trace of the card's
    # activity: device time over the window's wall time.  The profiler's own
    # host cost lies inside the window, so the idle share is an upper bound.
    again = CascadeServer(cfg, fast, slow, calibrate=None, device="cuda",
                          uplink=Uplink(bandwidth_bps=mbps(BW_MBPS), latency=0.05,
                                        server_time=cfg.server_time))
    box = []
    busy_ms, traced_ms = traced(lambda: box.append(again.process_stream(frames, labels)),
                                host_ops=False)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / traced_ms:.4f}"
    print(f"  traced repeat: device busy {busy_ms} ms of {traced_ms:.3f} ms wall"
          f" ({N_FRAMES / traced_ms * 1e3:.2f} frames/s); device idle share {idle};"
          f" same summary as the counted run: {box[0].summary() == metrics.summary()}")

    # ---- 4. card against CPU ---------------------------------------------- #
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fast_cpu = ResNet(FULL, device="cpu")
    fast_cpu.load_state_dict(fast.state_dict())
    batch = torch.as_tensor(frames[:16])
    with torch.inference_mode():
        pg, cg = fast_pass(fast, None, batch.cuda(), use_fused=True, platt_ab=PLATT)
        pc, cc = fast_pass(fast_cpu, None, batch, use_fused=True, platt_ab=PLATT)
        lg, lc = fast(batch.cuda()).cpu(), fast_cpu(batch)
    conf_err = float((cg.cpu() - cc).abs().max())
    check(conf_err <= CPU_CONF_ATOL, f"card vs CPU conf err {conf_err} > {CPU_CONF_ATOL}")
    print(f"card vs CPU, one batch, TF32 off: max |conf| err {conf_err:.3e} (atol {CPU_CONF_ATOL}),"
          f" max |logit| err {float((lg - lc).abs().max()):.3e} of |logit| <= {float(lc.abs().max()):.3f},"
          f" fast preds equal {int((pg.cpu() == pc).sum())}/16")

    # ---- 5. result -------------------------------------------------------- #
    main_row = rows[0]
    kernels = [dict(name="calib_gate", route="cuda",
                    source="src/repro_torch/kernels/fused_calib_gate/csrc/calib_gate.cu",
                    replaces="src/repro/kernels/fused_calib_gate/kernel.py:48",
                    launches=launches["calib_gate"], max_abs_err=max_err,
                    ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                    bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                    library_ms=None)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
