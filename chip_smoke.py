#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA GPU, the CUDA toolkit (``nvcc``) and this checkout's ``src/``;
without them it exits non-zero before printing any result.  Phases:

  1. card: ``nvidia-smi`` name and power limit; build the port's four
     kernels, one ``nvcc`` per source, all started together; count the
     tensor-core instructions of the flash-attention kernels in the SASS,
     the int8-matmul kernel's IMMA and PRMT, the int8-KV decode
     kernel's I2F (none allowed), PRMT and HMMA, and the calib-gate
     kernel's 128-bit loads and cluster barriers; print the int8 matmul's
     and the decode kernel's launch plans (tiles, splits, registers,
     blocks a SM, cp.async stages, bytes in flight);
  2. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at wider, ragged and extreme ones (attention
     and decode also against a stand-in fault; the calib gate also on
     bf16 and f16 logits, misaligned bases and LM vocabularies, with its
     split plan), with times
     (and, for attention, ``scaled_dot_product_attention``'s, for the int8
     matmul ``torch._int_mm``'s and, for the int8-KV decode, SDPA's on a
     bf16 cache dequantized beforehand, as yardsticks);
  3. path 1: ``CascadeServer(use_fused=True)`` serving 256 synthetic
     224 px frames with two full-width ResNet-50 tiers (random weights from
     seeds; the fast tier int8 through ``qdq_tree``);
     3b. path 2: the same server and stream with a DeiT-B slow tier, whose
     every attention launches the flash-attention kernel.
     3c. path 3: the slow tier's f(batch) sweep on the card (the int8-matmul
     and flash-attention kernels), its best fit rescaled to T^o as the
     replicas' continuous-batching curve, then ``MultiStreamServer`` with
     8 streams x 64 frames over a 2-cell, 2-replica edge fabric (ResNet-50
     FULL fast tier, one calib-gate launch per round over 128 frames;
     DeiT-B FULL slow tier, one call per round).
     3d. path 4: StableLM-12B FULL (bf16 weights drawn on the card) with an
     int8 KV cache and the scales folded: prefill 8 prompts of 2048 random
     tokens, then 32 greedy decode steps, each layer's decode attention one
     launch of the int8-KV decode kernel.
     3e. path 5, the paper's evaluation: (a) the ResNet-50 fast tier over
     512 synthetic frames; the Table I calibrators (``fit_all``: Platt,
     isotonic, temperature) fitted on the card's tensors of the first 256,
     held against the same fits on the CPU, ECE and MCE on the other 256;
     (b) the §V trace replay (``replay_trace``) of all six registered
     policies x four calibrators over the card's predictions (Platt through
     the calib-gate kernel with the card's coefficients; DeiT-B at each rung
     of the 5-resolution ladder); (c) ``MultiStreamServer`` with split
     offloading (a DeiT-B cut catalog as feature actions) over an LTE and
     a WiFi trace-driven cell, and the same fleet with frames only.
     3f. path 6: (a) path 3's fleet served again with the telemetry off and
     on (``Telemetry``: recorder, frame tracer, phase profiler): the same
     metrics, the recorder's last counters equal to the metrics', one traced
     lifecycle per escalation, the Chrome trace exported under ``build/``;
     (b) ``FleetRunner(backend="torch")`` planning fleets of 1,024 to
     1,048,576 streams on the card against the numpy ``FleetRunner`` on the
     host (five policies, and cbo over the DeiT-B cut catalog): the same
     decisions, no frontier overflow, host and device times, peak memory.
     3g. path 7: (a) path 3's fleet at ``frame_rate=32`` served by
     ``MultiStreamServer(backend="numpy")`` and by ``backend="torch"``, the
     whole fleet round on the card: the tiers of every round precomputed
     there (one calib-gate launch a round, the DeiT-B slow tier at each of
     the 5 resolutions), then one CUDA-graph replay a round; every round's
     integer fields equal; (b) the round engine alone on synthetic rounds
     (``bench_fleet_control.py``'s) at 1,000 to 1,000,000 streams: capture
     and steady seconds, rounds and frames a second, device ms a round,
     peak card memory, the card against the CPU at 1,000.
     Each path's kernel launch counts are set to 0 just before its run and
     read just after; then the same stream (path 4: 8 more decode steps;
     path 5: the split fleet; path 6: the telemetry run, one cbo planning
     call at 131,072 streams; path 7: the torch run, and 8 rounds at
     100,000 streams) runs again under ``torch.profiler`` for the device's
     idle share;
  4. one batch's fast pass on the card against the same pass on the CPU,
     (4b) DeiT-B's logits on two frames likewise, TF32 off, (4c) the
     multi-stream engine with the synthetic tiers on the card against the
     CPU, (4d) a 2-layer model at StableLM-12B's widths, prefill and
     int8-fold decode, card (the kernel) against CPU (the plain version),
     (4e) path 5's split fleet with the synthetic tiers on the card
     against the CPU, and (4f) the round engine (``backend="torch"``) with
     the synthetic tiers on the card against the CPU, over a live-batching
     fabric and a counter-jittered 2-cell fabric;
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
TF32_OPS_PER_S = 494.7e12  # H100 SXM dense TF32 tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
CALIB_ATOL = 1e-6  # kernel vs plain version on the card: one float32 row sum
# flash attention, kernel vs plain version, (rtol, atol).  f32: atol 2e-5;
# the kernel takes three TF32 products a product (3xTF32), each within
# ~2^-20 of f32's (the kernel's arithmetic written out in torch meets 2e-5
# on the CPU with a sixth of it at most, tests/test_torch_flash.py), and
# sums the softmax in another order.  bf16: the tensor-core kernel rounds P
# to bf16 before P.V (the plain version multiplies f32 P), at most 2^-8 of
# each term p.v of a row and of random sign, which atol 5e-3 covers (the
# kernel's arithmetic written out in torch meets it on the CPU at these
# shapes cut to size); both round the output once, so they may differ by
# one bf16 step (at most 2^-7 of it, hence rtol 8e-3).  The phase also runs
# each kernel on a stand-in fault and fails unless this limit rejects it:
# in bf16 q cut to 5 of its 7 mantissa bits (a faulty load), in f32 q
# rounded to TF32 (a 1xTF32 kernel that drops q's small part).
ATTN_TOL = {"float32": (0.0, 2e-5), "bfloat16": (8e-3, 5e-3)}
CPU_CONF_ATOL = 1e-5  # card vs CPU through 53 float32 convolutions, TF32 off
CPU_LOGIT_ATOL = 1e-4  # card vs CPU through DeiT-B's 12 float32 layers, TF32 off (logits ~2.5)
# int8-KV decode, kernel vs plain version, (rtol, atol).  f32: 2e-5 each, the
# softmax summed in another order, across splits.  bf16: both keep f32 and
# round once, so they differ by at most one bf16 step of the output (2^-7 of
# it, hence rtol 8e-3) where their f32 values straddle a rounding boundary,
# plus f32 noise (4.5e-7 at the f32 shapes away from extreme scales) that
# atol 1e-4 covers.  At path 4's shape the outputs are ~0.03 and the largest
# difference seen was 2.44e-4, one step at [2^-5, 2^-4).  The phase also runs
# the kernel on q with its two lowest mantissa bits cut, a stand-in for a
# faulty bf16 load of q (largest error ~1e-2, median ~5e-4), and fails unless
# this limit rejects it; rtol = atol = 1e-2 let it pass.
DECODE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-4)}
# card vs CPU through a 2-layer float32 model at StableLM-12B's widths, TF32
# off (logits ~4): a decode step attends over int8 caches built on each
# device, and where the two devices' f32 K/V straddle a rounding boundary an
# entry differs by one int8 step, which moves the logits by up to ~1e-3
CPU_LM_ATOL = 2e-3
LM_BATCH, LM_PROMPT, LM_STEPS = 8, 2048, 32  # path 4
# int8-KV decode against its plain version: (name, B, S, KH, G, D, q's dtype)
KV_CASES = [("test sweep", 1, 512, 1, 1, 64, "float32"), ("test sweep", 2, 1024, 4, 3, 64, "float32"),
            ("test sweep", 2, 512, 8, 1, 128, "float32"), ("test sweep", 1, 2048, 2, 4, 64, "float32"),
            ("StableLM path", LM_BATCH, LM_PROMPT, 8, 4, 160, "bfloat16"),
            ("StableLM f32", LM_BATCH, LM_PROMPT, 8, 4, 160, "float32"),
            ("Qwen-like MHA", 2, 1024, 40, 1, 128, "float32"),
            ("ragged S", LM_BATCH, 2047, 8, 4, 160, "float32"), ("S=1", LM_BATCH, 1, 8, 4, 160, "float32"),
            ("extreme scales", 1, 256, 1, 2, 32, "float32"), ("Arctic G=7", 2, 1000, 8, 7, 128, "bfloat16")]
LM_TRACED_STEPS = 8
PLATT = (-20.0, 5.0)
N_FRAMES = 256
BATCH = 16
ACC_SERVER = (0.35, 0.5, 0.6, 0.66, 0.7)  # fixed ladder: there are no trained weights
BW_MBPS = 5.0
N_STREAMS = 8  # path 3: streams x frames each, 4 rounds of 16 frames a stream
STREAM_FRAMES = 64
BATCH_WINDOW_S = 0.02  # path 3: each replica's admission window
N_EVAL = 512  # path 5: frames 0-255 fit the calibrators, 256-511 evaluate them
CAL_ATOL = 1e-4  # path 5: Platt (a, b) card vs CPU; the temperature within this, relative
REPLAY_NET = dict(bw_mbps=5.0, latency=0.05, deadline=0.2)  # path 5 (b)
FAST_TIME = 0.020  # paper Table III: the fast tier's seconds a frame (the replay's local tier)
# path 5 (c): bench_split.py's regime, the slow tier nearly as slow as the deadline
SPLIT = dict(server_time=0.16, deadline=0.2, latency=0.03, max_cuts=4)
# path 6 (b): tests/test_fleet_jax.py's planner workload, planned at fleet sizes up to 2^20
PLAN = dict(max_backlog=12, resolutions=(4, 8), acc_server=(0.7, 0.99), deadline=0.2, latency=0.05,
            server_time=0.037)
PLAN_SIZES = (1024, 16384, 131072, 1048576)
THETA_ATOL = 1e-6  # tests/_diff.py: a float32 copy of a float64 confidence
BW_RTOL = 1e-2  # tests/_diff.py: bandwidth estimates, float32 timestamps against float64
LAT_ATOL = 1e-4  # tests/_diff.py: latencies, likewise
EXACT_KEYS = ("res_idx", "cap", "n_off", "n_frames", "off_stream", "off_pos", "off_res", "off_kind",
              "off_cut", "lengths", "correct", "esc", "ok", "valid")  # tests/_diff.py
ENGINE = dict(max_backlog=8, batch=8, rounds=8, bw_mbps=6.0)  # path 7 (b): bench_fleet_control.py's
ENGINE_SIZES = (1_000, 10_000, 100_000, 1_000_000)


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


def _profile(fn, iters: int, host_ops: bool):
    """Call ``fn`` ``iters`` times inside one ``torch.profiler`` (CUPTI)
    trace; returns the trace's device events, summed by name, and the host
    wall time of the traced window (ms)."""
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
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA], wall_ms


def traced(fn, iters: int = 1, host_ops: bool = True):
    """The device time one ``torch.profiler`` trace of ``iters`` calls of
    ``fn`` records, summed over every kernel and copy (ms; None when it
    records no device activity), and the host wall time of the traced
    window (ms).  ``host_ops=False`` traces the card's activity only, which
    adds less host time to the window."""
    events, wall_ms = _profile(fn, iters, host_ops)
    total_us = sum(e.self_device_time_total for e in events)
    return (total_us / 1e3 if total_us > 0 else None), wall_ms


def device_ms(fn, iters: int = 20, tries: int = 5):
    """Device time per call of ``fn``: the kernels' own durations, summed,
    without the host's launch gaps; None when none of ``tries`` traces is
    whole.  On that machine a trace may lose the first kernel of its
    window, and now and then it comes back with no device events or with
    the kernels of many calls missing (one read SDPA's ~108 µs as 22 µs).
    So each kernel's launches per call are its count in the trace over
    ``iters``, rounded, at least 1 and within one launch of that; a trace
    that fails this is not used, and each kernel counts at its mean
    duration times its launches per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        events, _ = _profile(fn, iters, host_ops=True)
        per_call = [round(e.count / iters) for e in events]
        if events and all(n >= 1 and abs(e.count - n * iters) <= 1 for e, n in zip(events, per_call)):
            return sum(e.self_device_time_total / e.count * n for e, n in zip(events, per_call)) / 1e3
    return None


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


def build_phase(libraries) -> None:
    """Phase 1: build every kernel's library, one ``nvcc`` per source
    started together, and show what ``ptxas`` made."""
    from repro_torch.kernels.build import build_all

    t0 = time.perf_counter()
    build_all(libraries)
    print(f"built {len(libraries)} kernel sources concurrently in {time.perf_counter() - t0:.2f} s"
          " (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for lib in libraries:
        for line in lib.ptxas_log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"  ptxas {lib.source.name}:", line.strip())


def sass_counts(lib, ops) -> dict[str, dict[str, int]]:
    """Phase 1: the instructions named in ``ops`` in each kernel of a built
    library, counted in ``cuobjdump -sass``, by mangled function name."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                      "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


def flash_sass(lib) -> dict[str, int]:
    """Phase 1: the tensor-core (HMMA) instructions in each flash-attention
    kernel of the built library: every kernel, f32 (TF32 products) and
    bf16, must have them."""
    import re

    counts = {}
    for fn, c in sass_counts(lib, ("HMMA",)).items():
        d = re.search(r"ILi(\d+)E", fn)
        counts[f"{'bf16' if 'bf16_kernel' in fn else 'f32'} D={d.group(1) if d else '?'}"] = c["HMMA"]
    print("  cuobjdump -sass flash_attention, HMMA instructions per kernel:",
          ", ".join(f"{k}: {v}" for k, v in sorted(counts.items())))
    for D in (16, 64, 128):
        for kind in ("f32", "bf16"):
            check(counts.get(f"{kind} D={D}", 0) > 0, f"{kind} flash-attention kernel D={D} has no HMMA")
    return counts


def kv_sass(kv_kernel) -> dict[str, dict[str, int]]:
    """Phase 1: the int8-KV decode kernel widens int8 by PRMT and f16x2
    subtractions, never by I2F, and multiplies on the tensor cores: count
    I2F (and sm_90's I2FP), PRMT and HMMA per instantiation (q's dtype,
    head dims up to 64 / 128 / 160 / 256), fail on any I2F and on an
    instantiation without PRMT or HMMA.  Then the launch plan at path 4's
    shape: blocks a SM, shared memory, the cp.async ring, and the K/V bytes
    in flight a SM while each block computes a tile."""
    import re

    import torch

    counts = {}
    for fn, c in sass_counts(kv_kernel.LIBRARY, ("I2F", "I2FP", "PRMT", "HMMA")).items():
        mb = re.search(r"ILi(\d+)E", fn)
        counts[f"{'bf16' if 'bfloat16' in fn else 'f32'} D<={16 * int(mb.group(1)) if mb else '?'}"] = c
    print("  cuobjdump -sass int8_kv_decode, per instantiation:",
          "; ".join(f"{k}: " + " ".join(f"{op} {n}" for op, n in v.items())
                    for k, v in sorted(counts.items())))
    check(len(counts) == 8, f"int8_kv_decode: {len(counts)} kernel instantiations, expected 8")
    for name, c in counts.items():
        check(c["I2F"] + c["I2FP"] == 0, f"int8_kv_decode {name} converts on I2F: {c}")
        check(c["PRMT"] > 0 and c["HMMA"] > 0,
              f"int8_kv_decode {name} lacks PRMT or HMMA, so it is not the designed kernel: {c}")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.bfloat16, torch.float32):
        plan = kv_kernel.launch_plan(0, dtype, 160)
        n_splits, per = kv_kernel.split_plan(LM_BATCH * 8, LM_PROMPT, n_sms, plan.blocks_per_sm)
        print(f"  int8_kv_decode plan at (8, 2048, 8, 4, 160) {str(dtype).removeprefix('torch.')}:"
              f" {plan.blocks_per_sm} blocks of 128 threads a SM, {plan.smem_bytes} B shared memory"
              f" a block, {plan.stages} stages of {plan.tile} tokens ({plan.tile_bytes} B of K and V),"
              f" {plan.blocks_per_sm * (plan.stages - 1) * plan.tile_bytes} B in flight a SM while"
              f" each block computes; {n_splits} splits of {per} tiles,"
              f" {LM_BATCH * 8 * n_splits} blocks on {n_sms} SMs")
    return counts


def int8_sass(i8_kernel) -> dict[str, dict[str, int]]:
    """Phase 1: the int8-matmul kernel multiplies on the int8 tensor cores
    (IMMA) and builds B's fragments by PRMT byte transposes: count both per
    instantiation (block tile, output mode, copy width), fail on an
    instantiation without IMMA or PRMT.  Then the launch plan at the
    sweep's largest shape and at ``bench_kernels``'s: tile, ring,
    registers, shared memory and blocks."""
    import re

    import torch

    modes = {0: "f32", 1: "bf16", 2: "int32"}
    counts = {}
    for fn, c in sass_counts(i8_kernel.LIBRARY, ("IMMA", "PRMT")).items():
        # int8_matmul_kernel<Tile<MI, WM, WN, KW>, MODE, VEC>
        m = re.search(r"TileI((?:Li\d+E)+)EELi(\d)ELb(\d)E", fn)
        if m:
            mi, wm, wn = (int(v) for v in re.findall(r"Li(\d+)E", m.group(1))[:3])
            name = f"{16 * mi * wm}x{32 * wn} {modes[int(m.group(2))]}{'' if m.group(3) == '1' else ' bytes'}"
        else:
            name = fn
        counts[name] = c
    print("  cuobjdump -sass int8_matmul, per instantiation:",
          "; ".join(f"{k}: " + " ".join(f"{op} {n}" for op, n in v.items())
                    for k, v in sorted(counts.items())))
    expected = 3 * (len(i8_kernel.CONFIGS) + 1)
    check(len(counts) == expected, f"int8_matmul: {len(counts)} kernel instantiations, expected {expected}")
    for name, c in counts.items():
        check(c["IMMA"] > 0 and c["PRMT"] > 0,
              f"int8_matmul {name} lacks IMMA or PRMT, so it is not the designed kernel: {c}")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M, K, N in ((1024, 512, 512), (1024, 4096, 4096)):
        tp = i8_kernel.tile_plan(M, N, K, n_sms)
        kp = i8_kernel.launch_plan(0, tp.config)
        print(f"  int8_matmul plan at {(M, K, N)}: {tp.bm} x {tp.bn} tiles of {kp.threads} threads,"
              f" {kp.stages} stages of {kp.bk} bytes of K, {tp.n_tiles} blocks on {n_sms} SMs;"
              f" {kp.registers} registers, {kp.local_bytes} B local,"
              f" {kp.smem_bytes} B shared memory a block, {kp.blocks_per_sm} blocks a SM")
    return counts


def calib_sass(cg_kernel) -> dict[str, dict[str, int]]:
    """Phase 1: the calib-gate kernel reads logits by 128-bit loads and
    merges a row's blocks behind cluster barriers: count both per
    instantiation (dtype, vectors a thread) and fail on one without them."""
    import re

    ops = ("LDG.E.NA.128.CONSTANT", "UCGABAR_ARV", "UCGABAR_WAIT")
    dtypes = {"0": "f32", "1": "bf16", "2": "f16"}
    counts = {}
    for fn, c in sass_counts(cg_kernel.LIBRARY, ops).items():
        m = re.search(r"calib_gate_kernelILi(\d)ELi(\d)E", fn)
        counts[f"{dtypes[m.group(1)]} vpt={m.group(2)}" if m else fn] = c
    print("  cuobjdump -sass calib_gate, per instantiation:",
          "; ".join(f"{k}: " + " ".join(f"{op} {n}" for op, n in v.items()) for k, v in sorted(counts.items())))
    check(len(counts) == 3 * len(cg_kernel.VPTS), f"calib_gate: {len(counts)} kernel instantiations")
    for name, c in counts.items():
        check(all(n > 0 for n in c.values()),
              f"calib_gate {name} lacks 128-bit loads or the cluster barrier, so it is not the designed kernel: {c}")
    return counts


def calib_gate_cases(torch):
    """Phase 2's calib-gate inputs, (name, logits), from seed 0: the paths'
    shapes and wider, ragged, extreme, bf16 and f16 ones."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(B, V, dtype=torch.float32):
        return (torch.randn(B, V, generator=g, device="cuda") * 3).to(dtype)

    def misaligned(x):  # one element past a 16-byte aligned base
        return torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape).copy_(x)

    extreme = torch.cat([torch.full((16, 512), -1e4, device="cuda"),
                         torch.randn(16, 512, generator=g, device="cuda") * 50], dim=1)
    extreme[0] = -torch.inf
    extreme[1] = 1e4
    extreme[2, ::2] = -1e4
    cases = [("main path", randn(16, 1000)),
             ("8-stream round", randn(N_STREAMS * BATCH, 1000)),
             ("wide", randn(128, 4096)),
             ("ragged", randn(37, 1001)),
             ("vocab 152k", randn(8, 152064)),
             ("extreme", extreme)]
    return cases + [("StableLM logits", randn(LM_BATCH, 100352, torch.bfloat16)),
                    ("bench_kernels", randn(256, 102400)),
                    ("bench_kernels", randn(256, 102400, torch.bfloat16)),
                    ("one row", randn(1, 152064)),
                    ("odd misaligned", misaligned(randn(37, 1001, torch.bfloat16))),
                    ("odd misaligned", misaligned(randn(37, 1001, torch.float16)))]


def calib_bound(B, V, elem_bytes):
    """Least time (ms) for the card, and what bounds it: the logits read
    once, calib (f32) and gate (bool) written once, against 4 float32
    operations a logit (compare, subtract, exp, add)."""
    n_bytes = B * V * elem_bytes + B * 4 + B
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, B * V * 4 / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def calib_gate_phase(torch, cg_kernel, calib_gate_ref):
    """Phase 2: the calib-gate kernel against its plain version on the card."""
    calib_gate = cg_kernel.calib_gate
    l2_bytes = torch.cuda.get_device_properties(0).L2_cache_size
    rows, max_err = [], 0.0
    print("calib_gate vs calib_gate_ref, 'loop' is CUDA events over 200 back-to-back calls from"
          " Python, 'device' the profiler's kernel time per call; plan = blocks a row (one cluster),"
          " threads a block, 16-byte vectors a thread; inputs resident in L2 unless marked:")
    for name, x in calib_gate_cases(torch):
        B, V = x.shape
        dtype = str(x.dtype).removeprefix("torch.")
        plan = cg_kernel.plan_for(x)
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
        bound_ms, bound_by = calib_bound(B, V, x.element_size())
        # the line reports device time: the timed loop is bound by the host's
        # launch cost (~30-160 us a call on a shared host), not by the kernel
        rows.append(dict(case=name, B=B, V=V, bound_ms=bound_ms, bound_by=bound_by,
                         ms=ms if dev_ms is None else dev_ms,
                         plain_ms=plain_ms if plain_dev_ms is None else plain_dev_ms))
        resident = "" if x.numel() * x.element_size() < l2_bytes else \
            f", not resident in L2: {x.numel() * x.element_size() / 1e6:.1f} MB against its {l2_bytes / 1e6:.1f}"
        print(f"  {name:15s} ({B:4d},{V:6d}) {dtype:8s} plan {plan.splits:2d} x {plan.threads:4d} x {plan.vpt}"
              f"  kernel loop {_us(ms)} device {_us(dev_ms)}"
              f" | plain loop {_us(plain_ms)} device {_us(plain_dev_ms)}"
              f" | bound {_us(bound_ms)} ({bound_by}{resident})")
    print(f"  max |calib - plain| over all shapes: {max_err:.3e} (atol {CALIB_ATOL}); gates equal;"
          " no single PyTorch call computes this op, so library_ms is null")
    return rows, max_err


def int8_bound(M, K, N):
    """Least time (ms) for the card, and what bounds it: x_q, w_q and both
    scales read once and the float32 output written once, against 2·M·N·K
    int8 operations at the dense int8 tensor-core peak."""
    n_bytes = M * K + K * N + 4 * M + 4 * N + M * N * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2 * M * N * K / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def int8_phase(torch, i8_kernel, i8_ref):
    """Phase 2: the int8-matmul kernel against its plain version on the card:
    the int32 product and the float32 output bit-equal, the bfloat16 output
    equal after the same one rounding; times beside ``torch._int_mm`` (the
    int32 product alone, without the epilogue)."""
    from repro_torch.slowtier.sweep import BATCH_SIZES, SWEEP_K, SWEEP_N, SWEEP_ROWS

    cases = [(f"sweep b={b}", SWEEP_ROWS * b, SWEEP_K, SWEEP_N) for b in BATCH_SIZES]
    cases += [("one row", 1, SWEEP_K, SWEEP_N), ("ragged", 37, 100, 77),
              ("misaligned", 37, 100, 77), ("bench_kernels", 1024, 4096, 4096),
              ("DeiT-B qkv x16", 3168, 768, 2304), ("DeiT-B fc1 x16", 3168, 768, 3072),
              ("DeiT-B fc2 x16", 3168, 3072, 768)]
    g = torch.Generator(device="cuda").manual_seed(2)
    rows, max_err = [], 0.0
    print("int8_matmul vs int8_matmul_ref (float32 output timed); device time per call from the"
          " profiler; torch._int_mm is the int32 product only:")
    for name, M, K, N in cases:
        xq, xs = i8_ref.quantize_rows(torch.randn(M, K, generator=g, device="cuda"))
        wq, ws = i8_ref.quantize_cols(torch.randn(K, N, generator=g, device="cuda"))
        if name == "misaligned":  # operands one byte past an aligned base: the byte-load copies
            xq, wq = (torch.empty(t.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(t.shape).copy_(t)
                      for t in (xq, wq))
            check(xq.data_ptr() % 16 == 1 and wq.data_ptr() % 16 == 1, "misaligned views")
        acc = i8_kernel.int8_matmul_acc(xq, wq)
        check(torch.equal(acc, i8_ref.int8_acc_ref(xq, wq)), f"{name} {(M, K, N)}: int32 product differs")
        for dtype in (torch.float32, torch.bfloat16):
            out = i8_kernel.int8_matmul(xq, xs, wq, ws, out_dtype=dtype)
            ref = i8_ref.int8_matmul_ref(xq, xs, wq, ws, dtype)
            check(out.dtype == dtype and out.shape == (M, N), f"{name}: {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
            max_err = max(max_err, float((out.float() - ref.float()).abs().max()))
            check(torch.equal(out, ref), f"{name} {(M, K, N)} {dtype}: not bit-equal to the plain version")
        # where the profiler records no device time, the loops stand in
        # (they also carry the host's launch cost)
        dev = (device_ms(lambda: i8_kernel.int8_matmul(xq, xs, wq, ws))
               or cuda_ms(lambda: i8_kernel.int8_matmul(xq, xs, wq, ws), iters=50, warmup=5))
        plain = (device_ms(lambda: i8_ref.int8_matmul_ref(xq, xs, wq, ws))
                 or cuda_ms(lambda: i8_ref.int8_matmul_ref(xq, xs, wq, ws), iters=50, warmup=5))
        lib = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            check(torch.equal(torch._int_mm(xq, wq), acc), f"{name}: torch._int_mm disagrees")
            lib = (device_ms(lambda: torch._int_mm(xq, wq))
                   or cuda_ms(lambda: torch._int_mm(xq, wq), iters=50, warmup=5))
        bound_ms, bound_by = int8_bound(M, K, N)
        rows.append(dict(case=name, shape=(M, K, N), ms=dev, plain_ms=plain, library_ms=lib,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"  {name:15s} {str((M, K, N)):20s} bit-equal f32/bf16 | kernel device {_us(dev)}"
              f" | plain device {_us(plain)} | _int_mm device {_us(lib)}"
              f" | bound {_us(bound_ms)} ({bound_by})")
    print(f"  max |kernel - plain| over every shape and output type: {max_err:.3e} (bit-equal)")
    return rows, max_err


def attention_bound(B, Sq, Sk, H, D, causal, dtype, same_qkv=False):
    """Least time (ms) for the card, and what bounds it: q, k, v read once
    (one tensor when the caller passes q as k and v, as the f(batch) sweep
    does) and o written once, against 4·D operations per (query, visible
    key) pair per head (q·k and p·v), at the bf16 tensor-core peak or, in
    f32, three times as many at the TF32 peak (the kernel's 3xTF32; the
    f32 FMA peak would give the bound of a kernel on the CUDA cores)."""
    import torch

    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    n_ops = 4 * B * H * D * pairs
    n_elems = 2 * B * Sq * H * D + (0 if same_qkv else 2 * B * Sk * H * D)
    n_bytes = n_elems * (4 if dtype == torch.float32 else 2)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 3 * n_ops / TF32_OPS_PER_S if dtype == torch.float32 else n_ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_phase(torch, flash_attention, attention_ref):
    """Phase 2: the flash-attention kernel against its plain version and
    against ``scaled_dot_product_attention`` (the library yardstick, on the
    (B, H, S, D) views) on the card.  Both dtypes run on the tensor cores,
    float32 in 3xTF32 products; the sweep's cases pass q as k and v, as
    ``slowtier/sweep.py`` does.  Each case prints the atol it needs at its
    rtol, and the error of a stand-in fault that the limit must reject."""
    import torch.nn.functional as F

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("path K=16", 16, 198, 198, 12, 64, False, f32, False),
             ("path K=3", 3, 198, 198, 12, 64, False, f32, False),
             ("path 7 B=128", 128, 198, 198, 12, 64, False, f32, False)]
    for B, S, H, D in ((1, 256, 2, 64), (2, 512, 4, 64), (2, 384, 2, 128), (1, 1024, 1, 64)):
        for causal in (True, False):
            cases.append((f"sweep{'-causal' if causal else ''}", B, S, S, H, D, causal, f32, False))
    cases += [("Sq100 Sk300", 1, 100, 300, 2, 64, True, f32, False),
              ("D16", 2, 70, 70, 3, 16, True, f32, False),
              ("S=1", 1, 1, 1, 1, 64, False, f32, False),
              ("sweep b=1 bf16", 1, 256, 256, 4, 64, True, bf16, True),
              ("sweep b=32 bf16", 32, 256, 256, 4, 64, True, bf16, True),
              ("bf16 causal", 2, 256, 256, 2, 64, True, bf16, False),
              ("bf16 K=3", 3, 198, 198, 12, 64, False, bf16, False),
              ("bf16 D16", 1, 16, 16, 1, 16, False, bf16, False),
              ("bf16 D16 causal", 2, 70, 70, 3, 16, True, bf16, False),
              ("bf16 D128", 2, 384, 384, 2, 128, True, bf16, False),
              ("bf16 D128 full", 2, 384, 384, 2, 128, False, bf16, False),
              ("bf16 Sq100 Sk300", 1, 100, 300, 2, 64, True, bf16, False),
              ("bf16 Sq300 Sk100", 1, 300, 100, 2, 128, True, bf16, False),
              ("bf16 S=1", 2, 1, 1, 3, 128, True, bf16, False),
              ("bf16 long", 1, 1024, 1024, 1, 64, True, bf16, False)]
    g = torch.Generator(device="cuda").manual_seed(1)
    rows, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    print("flash_attention vs attention_ref and SDPA; device time per call from the profiler,"
          " 'loop' CUDA events over 50 back-to-back calls from Python; (rtol, atol)"
          f" {ATTN_TOL['float32']} in float32 (3xTF32), {ATTN_TOL['bfloat16']} in bfloat16:")
    for name, B, Sq, Sk, H, D, causal, dtype, same in cases:
        q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        k = q if same else torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
        v = q if same else torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
        out = flash_attention(q, k, v, causal=causal)
        ref = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tname = str(dtype).removeprefix("torch.")
        rtol, atol = ATTN_TOL[tname]
        check(out.dtype == dtype and out.shape == (B, Sq, H, D), f"{name}: {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        check(bool((diff <= atol + rtol * ref.float().abs()).all()),
              f"{name} {(B, Sq, Sk, H, D)} {tname}: err {err} beyond rtol {rtol}, atol {atol}")
        max_err[tname] = max(max_err[tname], err)
        need = max(0.0, float((diff - rtol * ref.float().abs()).max()))
        fault_note = ""
        if Sk > 1:  # with one key the output is v, whatever q is
            if dtype == bf16:  # a faulty q load: 5 of 7 mantissa bits
                what, bad = "q cut to 5 mantissa bits", (q.view(torch.int16) & ~3).view(bf16)
            else:  # 1xTF32 on q: q's small part dropped
                what, bad = "q rounded to TF32", ((q.view(torch.int32) + 0x1000) & -0x2000).view(f32)
            fault = (flash_attention(bad, k, v, causal=causal).float() - ref.float()).abs()
            check(not bool((fault <= atol + rtol * ref.float().abs()).all()),
                  f"{name}: the {tname} limit passes {what} (err {float(fault.max())})")
            fault_note = f" | {what}: err {float(fault.max()):.1e}, rejected"
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        sdpa_err = float((sdpa().transpose(1, 2).float() - ref.float()).abs().max())
        dev = device_ms(lambda: flash_attention(q, k, v, causal=causal))
        plain_dev = device_ms(lambda: attention_ref(q, k, v, causal=causal))
        lib_dev = device_ms(sdpa)
        loop = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), iters=50, warmup=5)
        # where the profiler records no device time, the line falls back to
        # the loops, which also carry the host's launch cost
        if plain_dev is None:
            plain_dev = cuda_ms(lambda: attention_ref(q, k, v, causal=causal), iters=50, warmup=5)
        if lib_dev is None:
            lib_dev = cuda_ms(sdpa, iters=50, warmup=5)
        bound_ms, bound_by = attention_bound(B, Sq, Sk, H, D, causal, dtype, same_qkv=same)
        rows.append(dict(case=name, shape=(B, Sq, Sk, H, D), causal=causal, dtype=tname, err=err,
                         ms=loop if dev is None else dev, plain_ms=plain_dev, library_ms=lib_dev,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"  {name:16s} {str((B, Sq, Sk, H, D)):22s} {tname:8s} err {err:.2e} (atol needed {need:.2e})"
              f" | kernel device {_us(dev)} loop {_us(loop)} | plain device {_us(plain_dev)}"
              f" | SDPA device {_us(lib_dev)} (err {sdpa_err:.1e}) | bound {_us(bound_ms)} ({bound_by})"
              + fault_note)
    print(f"  max |kernel - plain|: float32 {max_err['float32']:.3e}, bfloat16 {max_err['bfloat16']:.3e}")
    return rows, max_err["float32"]


def serve_phase(label, fast, slow, frames, labels, counted):
    """Phases 3 and 3b: ``CascadeServer`` over the stream, with the launch
    counts of ``counted`` ({name: (wrapper, expected launches)}) set to 0
    just before the run and read just after; then the same stream again
    inside one trace of the card's activity."""
    import torch

    from repro_torch.core.netsim import Uplink, mbps
    from repro_torch.serving.engine import CascadeServer, ServeConfig

    cfg = ServeConfig(batch_size=BATCH, use_fused=True, platt_ab=PLATT, acc_server=ACC_SERVER)
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
    n_batches = -(-len(frames) // cfg.batch_size)

    for fn, _ in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = server.process_stream(frames, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _) in counted.items()}

    for name, (_, expected) in counted.items():
        check(launches[name] == expected, f"{label}: {name} launched {launches[name]} times,"
              f" expected {expected} for {n_batches} batches")
    check(metrics.n_frames == len(frames), f"{label}: served {metrics.n_frames} frames")
    check(metrics.n_offloaded + metrics.n_deadline_miss > 0, f"{label}: no frame escalated")
    check(len(fast_t.events) == n_batches and len(slow_t.events) == n_batches, f"{label}: tier calls")
    check(all(np.isfinite(metrics.latencies)), f"{label}: non-finite latency")
    fast_ms, slow_ms = fast_t.ms(), slow_t.ms()
    print(f"{label} on {card_line()}: {len(frames)} frames, {n_batches} batches of {cfg.batch_size},"
          f" {BW_MBPS} Mbps uplink, cuDNN TF32 {torch.backends.cudnn.allow_tf32},"
          f" matmul TF32 {torch.backends.cuda.matmul.allow_tf32}")
    print("  ServeMetrics.summary():", json.dumps(metrics.summary()))
    print(f"  frames/s {len(frames) / wall:.2f} (wall {wall:.3f} s); launches {launches}")
    print(f"  ms per batch: fast tier mean {np.mean(fast_ms):.3f} (min {np.min(fast_ms):.3f}),"
          f" slow tier mean {np.mean(slow_ms):.3f} (min {np.min(slow_ms):.3f}),"
          f" planner mean {np.mean(plan_s) * 1e3:.3f} (max {np.max(plan_s) * 1e3:.3f})")
    print("  slow tier calls (batch size: ms):",
          " ".join(f"{k}:{t:.2f}" for k, t in zip(slow_t.sizes, slow_ms)))
    warm = torch.as_tensor(frames[:BATCH], device="cuda")
    with torch.inference_mode():
        fast_dev = device_ms(lambda: fast(warm), iters=5)
        slow_dev = {k: device_ms(lambda: slow(warm[:k]), iters=5) for k in (3, BATCH)}
    print(f"  device time per call (profiler): fast tier at {BATCH} frames {_us(fast_dev)},"
          + ",".join(f" slow tier at {k} frames {_us(t)}" for k, t in slow_dev.items()))
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
          f" ({len(frames) / traced_ms * 1e3:.2f} frames/s); device idle share {idle};"
          f" same summary as the counted run: {box[0].summary() == metrics.summary()}")
    return launches


def multistream_phase(fast, deit, frames, labels, counted, flash_per_call):
    """Phase 3c: the f(batch) sweep on the card, its fit as the replicas'
    continuous-batching curve, then ``MultiStreamServer`` over the streams.
    ``counted`` maps each kernel's name to its wrapper; every count is set
    to 0 just before the sweep and read after it and after the serving run
    (``flash_per_call`` attention launches per slow-tier call).  Then the
    same streams run again under one trace of the card.  Returns the
    launches and the fabric factory (path 6 serves the same fleet again)."""
    import torch

    from repro_torch.core.netsim import Uplink, mbps
    from repro_torch.net import EdgeFabric, ReplicaPool
    from repro_torch.serving.engine import MultiStreamServer, ServeConfig
    from repro_torch.slowtier import ContinuousBatching
    from repro_torch.slowtier.sweep import BATCH_SIZES, batch_sweep, latency_model_from_fit

    S = frames.shape[0]
    cfg = ServeConfig(batch_size=BATCH, use_fused=True, platt_ab=PLATT, acc_server=ACC_SERVER)
    n_rounds = -(-frames.shape[1] // cfg.batch_size)
    for fn in counted.values():
        fn.launches = 0

    t0 = time.perf_counter()
    sweep = batch_sweep(device="cuda", n_timing=5)
    sweep_s = time.perf_counter() - t0
    after_sweep = {name: fn.launches for name, fn in counted.items()}
    per_kernel = len(BATCH_SIZES) * (1 + 5)  # one warm-up and five timed calls a batch size
    check(after_sweep["int8_matmul"] == per_kernel and after_sweep["flash_attention"] == per_kernel,
          f"sweep launches {after_sweep}, expected {per_kernel} int8_matmul and flash_attention")
    print(f"path 3 on {card_line()}: f(batch) sweep on the card ({sweep_s:.2f} s; CUDA events,"
          f" 5 timed calls a batch size; launches {after_sweep})")
    for r in sweep["rows"]:
        print(f"  batch {r['batch']:2d}: attention {r['attn_us']:9.1f} us, int8 matmul"
              f" {r['matmul_us']:9.1f} us, total {r['total_s'] * 1e6:9.1f} us")
    for kind, fit in sweep["fits"].items():
        print(f"  fit {kind:6s}: coeffs {fit['coeffs']} rmse {fit['rmse_us']} us")
    model = latency_model_from_fit(sweep["batch_fit"], cfg.server_time)
    batching = ContinuousBatching(model, window_s=BATCH_WINDOW_S, max_batch=BATCH)
    print(f"  best: {sweep['batch_fit']['kind']}; rescaled so f(1) = T^o = {cfg.server_time}: {model};"
          f" f(16) = {float(model.batch_latency(16)):.6f} s;"
          f" window {BATCH_WINDOW_S} s, max batch {BATCH}")

    def fabric():
        pool = ReplicaPool(2, [cfg.server_time, 1.5 * cfg.server_time], serial=True,
                           batching=batching)
        ups = [Uplink(bandwidth_bps=mbps(BW_MBPS), latency=0.05, server_time=cfg.server_time,
                      seed=c) for c in (0, 1)]
        return EdgeFabric(ups, pool, n_streams=S, placement="jsq")

    fast_t, slow_t = TimedTier(fast, "fast"), TimedTier(deit, "slow")
    server = MultiStreamServer(cfg, fast_t, slow_t, None, None, n_streams=S, fabric=fabric(),
                               policy="cbo", device="cuda")
    marks = []  # (host clock, fast calls, slow calls) at the end of each round
    server.round_hook = lambda rec: marks.append((time.perf_counter(), len(fast_t.events),
                                                  len(slow_t.events)))
    t0 = time.perf_counter()
    metrics = server.process_streams(frames, labels)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    served = {name: launches[name] - after_sweep[name] for name in launches}

    n_slow = len(slow_t.events)
    check(served["calib_gate"] == n_rounds, f"path 3: calib_gate launched {served['calib_gate']}"
          f" times in {n_rounds} rounds")
    check(served["flash_attention"] == flash_per_call * n_slow, f"path 3: flash_attention launched"
          f" {served['flash_attention']} times for {n_slow} slow-tier calls")
    check(served["int8_matmul"] == 0, "path 3: the serving run launched int8_matmul")
    check(len(fast_t.events) == n_rounds and set(fast_t.sizes) == {S * cfg.batch_size},
          f"path 3: fast tier calls {fast_t.sizes}")
    check(metrics.n_frames == frames.shape[0] * frames.shape[1], f"path 3: served {metrics.n_frames} frames")
    check(metrics.n_offloaded + metrics.n_deadline_miss > 0, "path 3: no frame escalated")
    check(all(np.isfinite(x) for m in metrics.per_stream for x in m.latencies), "path 3: non-finite latency")
    fast_ms, slow_ms = fast_t.ms(), slow_t.ms()
    print(f"  MultiStreamServer: {S} streams x {frames.shape[1]} frames, {n_rounds} rounds, 2 cells x"
          f" {BW_MBPS} Mbps, 2 replicas (T, 1.5 T), jsq placement, cuDNN TF32"
          f" {torch.backends.cudnn.allow_tf32}, matmul TF32 {torch.backends.cuda.matmul.allow_tf32}")
    print("  AggregateMetrics.summary():", json.dumps(metrics.summary()))
    print(f"  frames/s {metrics.n_frames / wall:.2f} (wall {wall:.3f} s); launches in the serving run"
          f" {served}; over the whole path {launches}; pool.avg_batch"
          f" {server.fabric.pool.avg_batch:.4f}; slow-tier batch sizes {slow_t.sizes}")
    prev_t, prev_f, prev_s = t0, 0, 0
    for i, (t, nf, ns) in enumerate(marks):
        f_ms = sum(fast_ms[prev_f:nf])
        s_ms = sum(slow_ms[prev_s:ns])
        round_ms = (t - prev_t) * 1e3
        print(f"  round {i}: wall {round_ms:8.3f} ms = fast tier {f_ms:8.3f} + slow tier {s_ms:8.3f}"
              f" (events) + host rest {round_ms - f_ms - s_ms:8.3f}")
        prev_t, prev_f, prev_s = t, nf, ns

    again = MultiStreamServer(cfg, fast, deit, None, None, n_streams=S, fabric=fabric(),
                              policy="cbo", device="cuda")
    box = []
    busy_ms, traced_ms = traced(lambda: box.append(again.process_streams(frames, labels)),
                                host_ops=False)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / traced_ms:.4f}"
    print(f"  traced repeat: device busy {busy_ms} ms of {traced_ms:.3f} ms wall"
          f" ({metrics.n_frames / traced_ms * 1e3:.2f} frames/s); device idle share {idle};"
          f" same summary as the counted run: {box[0].summary() == metrics.summary()}")
    return launches, fabric


def decode_bound(B, S, KH, G, D, q_bytes):
    """Least time (ms) for the card, and what bounds it: the int8 K and V
    caches, both scales and q read once and the output written once, against
    4·B·H·S·D operations (q·k and p·v) at the f32 peak outside the tensor
    cores."""
    n_bytes = 2 * B * S * KH * D + 2 * B * S * 4 + 2 * B * KH * G * D * q_bytes
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 4 * B * KH * G * S * D / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kv_phase(torch, kv_kernel, decode_attention_ref):
    """Phase 2: the int8-KV decode kernel against its plain version on the
    card, beside ``scaled_dot_product_attention(enable_gqa=True)`` on a bf16
    cache dequantized beforehand (what the reference's non-fold branch
    computes; its time leaves the dequantization pass out)."""
    import torch.nn.functional as F

    cases = [(name, B, S, KH, G, D, getattr(torch, dtype)) for name, B, S, KH, G, D, dtype in KV_CASES]
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(4)
    rows, max_err = [], {"float32": 0.0, "bfloat16": 0.0}
    print("int8_kv_decode vs decode_attention_ref and SDPA on a dequantized bf16 cache (SDPA's time"
          " excludes the dequantization); device time per call from the profiler:")
    for name, B, S, KH, G, D, dtype in cases:
        q = torch.randn(B, KH * G, D, generator=g, device="cuda").to(dtype)
        kq, vq = (torch.randint(-127, 128, (B, S, KH, D), generator=g, device="cuda", dtype=torch.int8)
                  for _ in range(2))
        if name == "extreme scales":
            ks, vs = torch.full((B, S), 1e-8, device="cuda"), torch.full((B, S), 10.0, device="cuda")
        else:
            ks, vs = (torch.rand(B, S, generator=g, device="cuda") * 0.015 + 0.005 for _ in range(2))
        out = kv_kernel.int8_kv_decode(q, kq, ks, vq, vs)
        ref = decode_attention_ref(q, kq, ks, vq, vs)
        torch.cuda.synchronize()
        tname = str(dtype).removeprefix("torch.")
        rtol, atol = DECODE_TOL[tname]
        check(out.dtype == dtype and out.shape == (B, KH * G, D), f"{name}: {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        check(bool((diff <= atol + rtol * ref.float().abs()).all()),
              f"{name} {(B, S, KH, G, D)} {tname}: err {err} beyond rtol {rtol}, atol {atol}")
        if dtype == bf16:
            cut = (q.view(torch.int16) & ~3).view(bf16)  # a faulty q load: 5 of 7 mantissa bits
            fault = (kv_kernel.int8_kv_decode(cut, kq, ks, vq, vs).float() - ref.float()).abs()
            check(not bool((fault <= atol + rtol * ref.float().abs()).all()),
                  f"{name}: the bf16 limit passes q cut to 5 mantissa bits (err {float(fault.max())})")
            print(f"  {name}: q cut to 5 mantissa bits gives err {float(fault.max()):.2e} (median"
                  f" {float(fault.median()):.2e}), which the limit rejects")
        max_err[tname] = max(max_err[tname], err)
        qd = q.to(bf16)[:, :, None, :]  # (B, H, 1, D)
        kd = (kq.float() * ks[:, :, None, None]).to(bf16).transpose(1, 2)  # (B, KH, S, D)
        vd = (vq.float() * vs[:, :, None, None]).to(bf16).transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True)

        sdpa_err = float((sdpa()[:, :, 0].float() - ref.float()).abs().max())
        if name == "StableLM path":  # one kernel a call: the splits merge in the launch
            iters = 10
            events, _ = _profile(lambda: kv_kernel.int8_kv_decode(q, kq, ks, vq, vs), iters, host_ops=False)
            keys = [e.key for e in events]
            # a trace may lose some calls' kernels, never add one
            check(len(events) == 1 and "int8_kv_decode_kernel" in keys[0] and events[0].count <= iters,
                  f"{name}: the profiler shows {[(e.key[:60], e.count) for e in events]} for {iters} calls")
            print(f"  {name}: the profiler shows one kernel, {keys[0][:60]}, {events[0].count} launches"
                  f" in a trace of {iters} calls")
        dev = (device_ms(lambda: kv_kernel.int8_kv_decode(q, kq, ks, vq, vs))
               or cuda_ms(lambda: kv_kernel.int8_kv_decode(q, kq, ks, vq, vs), iters=50, warmup=5))
        plain = (device_ms(lambda: decode_attention_ref(q, kq, ks, vq, vs))
                 or cuda_ms(lambda: decode_attention_ref(q, kq, ks, vq, vs), iters=50, warmup=5))
        lib = device_ms(sdpa) or cuda_ms(sdpa, iters=50, warmup=5)
        bound_ms, bound_by = decode_bound(B, S, KH, G, D, q.element_size())
        rows.append(dict(case=name, shape=(B, S, KH, G, D), dtype=tname, err=err, ms=dev,
                         plain_ms=plain, library_ms=lib, bound_ms=bound_ms, bound_by=bound_by))
        print(f"  {name:14s} {str((B, S, KH, G, D)):22s} {tname:8s} err {err:.2e} | kernel device"
              f" {_us(dev)} | plain device {_us(plain)} | SDPA (bf16 cache) device {_us(lib)}"
              f" (err {sdpa_err:.1e}) | bound {_us(bound_ms)} ({bound_by})")
    print(f"  max |kernel - plain|: float32 {max_err['float32']:.3e}, bfloat16 {max_err['bfloat16']:.3e}"
          f" ((rtol, atol) {DECODE_TOL['float32']} and {DECODE_TOL['bfloat16']})")
    return rows, max(max_err.values())


def traced_kernels(fn, iters: int, names, top: int = 6):
    """Device time per call of ``fn`` (ms) under one ``torch.profiler``
    trace of the card's activity: in all, for the kernels whose names
    contain one of ``names``, and the ``top`` kernels by time as (name, ms)
    pairs; None where the trace records nothing."""
    events, _ = _profile(fn, iters, host_ops=False)
    total = sum(e.self_device_time_total for e in events)
    named = sum(e.self_device_time_total for e in events if any(n in e.key for n in names))
    if total <= 0:
        return None, None, []
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    return (total / 1e3 / iters, named / 1e3 / iters,
            [(e.key[:60], e.self_device_time_total / 1e3 / iters) for e in ranked])


def lm_phase(counted, kernel_names=("int8_kv_decode_kernel",)):
    """Path 4: StableLM-12B FULL on the card, int8 KV cache with the scales
    folded into the decode kernel.  Warm up once at the path's shapes; then,
    with every launch count set to 0, prefill 8 x 2048 tokens and decode 32
    greedy steps (ring slots pos % 2048, so each step overwrites the oldest
    token); then 8 more steps under the profiler for the device time per
    step, the share of the kernels whose names hold one of ``kernel_names``
    and the idle share."""
    import torch

    from repro_torch.configs.stablelm_12b import FULL as STABLELM
    from repro_torch.core.confidence import sequence_confidence
    from repro_torch.models.api import build
    from repro_torch.models.transformer import ParallelPlan, TransformerLM, lm_decode, lm_prefill

    plan = ParallelPlan(kv_cache_dtype="int8", kv_scale_fold=True)
    t0 = time.perf_counter()
    model = TransformerLM(STABLELM, plan, generator=torch.Generator(device="cuda").manual_seed(2),
                          device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == build(STABLELM, plan).n_params(), f"StableLM-12B holds {n_params} parameters")
    prompts = np.random.default_rng(2).integers(0, STABLELM.vocab_size, (LM_BATCH, LM_PROMPT))
    tokens = torch.as_tensor(prompts, device="cuda")
    print(f"set-up: StableLM-12B FULL bf16 weights on the card ({n_params} parameters,"
          f" {sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB)"
          f" {time.perf_counter() - t0:.2f} s")

    def generate(n_steps, start_pos, cache, tok):
        step_events, outs = [], []
        for i in range(n_steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            logits, cache = lm_decode(model, cache, tok, start_pos + i, STABLELM, plan)
            end.record()
            step_events.append((start, end))
            outs.append(logits)
            tok = logits.argmax(-1)
        return outs, step_events, cache, tok

    t0 = time.perf_counter()
    logits, cache = lm_prefill(model, tokens, STABLELM, plan)
    generate(2, LM_PROMPT, cache, logits.argmax(-1))
    del cache, logits
    torch.cuda.synchronize()
    print(f"set-up: path 4 warm-up, one prefill and 2 decode steps at the path's shapes"
          f" {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    p_start, p_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    p_start.record()
    logits, cache = lm_prefill(model, tokens, STABLELM, plan)
    p_end.record()
    prefill_logits = logits
    outs, step_events, cache, tok = generate(LM_STEPS, LM_PROMPT, cache, logits.argmax(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}

    expected = STABLELM.n_layers * LM_STEPS
    check(launches["int8_kv_decode"] == expected,
          f"path 4: int8_kv_decode launched {launches['int8_kv_decode']} times, expected {expected}")
    for name in ("calib_gate", "flash_attention", "int8_matmul"):
        check(launches[name] == 0, f"path 4: {name} launched {launches[name]} times")
    gen = torch.stack(outs, dim=1)  # (B, steps, V)
    check(gen.shape == (LM_BATCH, LM_STEPS, STABLELM.vocab_size), f"path 4: logits {tuple(gen.shape)}")
    check(bool(torch.isfinite(gen).all()) and bool(torch.isfinite(prefill_logits).all()),
          "path 4: non-finite logits")
    check(cache["k"].shape == (STABLELM.n_layers, LM_BATCH, LM_PROMPT, 8, 160)
          and cache["k"].dtype == torch.int8, f"path 4: cache {tuple(cache['k'].shape)} {cache['k'].dtype}")
    prefill_ms = p_start.elapsed_time(p_end)
    step_ms = [s.elapsed_time(e) for s, e in step_events]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    conf = sequence_confidence(gen).cpu().numpy()
    print(f"path 4, StableLM-12B FULL, int8 KV cache with folded scales, on {card_line()}:"
          f" {LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_STEPS} greedy decode steps at pos"
          f" {LM_PROMPT}..{LM_PROMPT + LM_STEPS - 1}; launches {launches}; wall {wall:.3f} s")
    print(f"  prefill {prefill_ms:.3f} ms (events; {LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.1f} tokens/s);"
          f" decode per step mean {np.mean(step_ms):.3f} ms, min {np.min(step_ms):.3f} ms (events);"
          f" decode {LM_BATCH * LM_STEPS / sum(step_ms) * 1e3:.1f} tokens/s;"
          f" peak memory {peak_gb:.2f} GB (max_memory_allocated)")
    print("  sequence_confidence over the 32 generated logits:", " ".join(f"{c:.4f}" for c in conf))

    # more steps under the profiler: device time per step, the kernel's share
    state = {"cache": cache, "tok": tok, "pos": LM_PROMPT + LM_STEPS}

    def step():
        logits, state["cache"] = lm_decode(model, state["cache"], state["tok"], state["pos"], STABLELM, plan)
        state["tok"] = logits.argmax(-1)
        state["pos"] += 1

    dev_ms, kern_ms, ranked = traced_kernels(step, LM_TRACED_STEPS, kernel_names)
    share = "not measured" if dev_ms is None else f"{kern_ms / dev_ms:.4f}"
    busy_ms, traced_ms = traced(step, LM_TRACED_STEPS, host_ops=False)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / traced_ms:.4f}"
    print(f"  decode step device time (profiler, {LM_TRACED_STEPS} steps) {_us(dev_ms)}, of which"
          f" int8_kv_decode {_us(kern_ms)} (share {share}); traced repeat of {LM_TRACED_STEPS} steps:"
          f" device busy {busy_ms} ms of {traced_ms:.3f} ms wall, device idle share {idle}")
    print("  top kernels by device time per decode step:",
          "; ".join(f"{name} {ms * 1e3:.1f} us" for name, ms in ranked))
    return launches


def lm_card_vs_cpu(kv_kernel) -> float:
    """Phase 4d: a float32 model at StableLM-12B's attention and MLP widths
    (d 5120, 32/8 heads of 160, d_ff 13824), cut to 2 layers and vocab 4096
    so the host copy stays small; prefill 2 x 128 tokens, then 4 decode
    steps: the card through the kernel, the CPU through the plain version,
    TF32 off.  Returns the largest logit difference."""
    import dataclasses

    import torch

    from repro_torch.configs.stablelm_12b import FULL as STABLELM
    from repro_torch.models.transformer import ParallelPlan, TransformerLM, lm_decode, lm_prefill

    cfg = dataclasses.replace(STABLELM, name="stablelm-12b-widths-2l", n_layers=2, vocab_size=4096)
    plan = ParallelPlan(kv_cache_dtype="int8", kv_scale_fold=True)
    t0 = time.perf_counter()
    cpu = TransformerLM(cfg, plan, generator=torch.Generator().manual_seed(3), device="cpu",
                        dtype=torch.float32)
    card = TransformerLM(cfg, plan, device="cuda", dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 128)))
    lc, cache_c = lm_prefill(cpu, tokens, cfg, plan)
    lg, cache_g = lm_prefill(card, tokens.cuda(), cfg, plan)
    errs, same = [float((lg.cpu() - lc).abs().max())], [bool(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)))]
    before = kv_kernel.int8_kv_decode.launches
    for pos in range(128, 132):
        tok = lc.argmax(-1)
        lc, cache_c = lm_decode(cpu, cache_c, tok, pos, cfg, plan)
        lg, cache_g = lm_decode(card, cache_g, tok.cuda(), pos, cfg, plan)
        errs.append(float((lg.cpu() - lc).abs().max()))
        same.append(bool(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))))
    check(kv_kernel.int8_kv_decode.launches == before + 4 * cfg.n_layers, "phase 4d: kernel launches")
    check(all(same), f"phase 4d: greedy tokens differ {same}")
    check(max(errs) <= CPU_LM_ATOL, f"phase 4d: card vs CPU logit err {max(errs)} > {CPU_LM_ATOL}")
    print(f"StableLM-12B widths, 2 layers, vocab 4096, float32, TF32 off, card vs CPU: max |logit| err"
          f" per call (prefill, 4 decode steps) {' '.join(f'{e:.2e}' for e in errs)} (atol {CPU_LM_ATOL})"
          f" of |logit| <= {float(lc.abs().max()):.3f}; greedy tokens equal;"
          f" {time.perf_counter() - t0:.2f} s")
    return max(errs)


def warm_up(label, fast, slow, frames, n_fast=BATCH, n_slow=BATCH):
    """cuDNN and cuBLAS set up each new batch shape on its first call (0.1-0.2
    s on an H100); a server warms every batch size it can see before serving:
    the fast tier at ``n_fast`` frames, the slow tier at 1..``n_slow``."""
    import torch

    t0 = time.perf_counter()
    warm = torch.as_tensor(frames[:max(n_fast, n_slow)], device="cuda")
    with torch.inference_mode():
        fast(warm[:n_fast])
        for k in range(1, n_slow + 1):
            slow(warm[:k])
    torch.cuda.synchronize()
    print(f"set-up: {label} warm-up of the fast tier at {n_fast} and the slow tier at 1..{n_slow}"
          f" frames {time.perf_counter() - t0:.2f} s")


def multistream_card_vs_cpu() -> None:
    """Phase 4c: ``MultiStreamServer`` with the synthetic closed-form tiers
    over a live-batching fabric, on the card and on the CPU: the same
    decisions, latencies and accuracies (the tiers are exact sums and a
    resize; the control plane is host numpy either way)."""
    from repro_torch.core.netsim import Uplink, mbps
    from repro_torch.net import EdgeFabric, ReplicaPool
    from repro_torch.serving.engine import MultiStreamServer, ServeConfig
    from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers
    from repro_torch.slowtier import ContinuousBatching, LinearBatch

    imgs, labels = synthetic_streams(12, 64)
    out = {}
    for device in ("cuda", "cpu"):
        cfg = ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), frame_rate=32.0)
        pool = ReplicaPool(2, [cfg.server_time, 1.5 * cfg.server_time],
                           batching=ContinuousBatching(LinearBatch(0.03125, 0.0078125), window_s=0.03125))
        ups = [Uplink(bandwidth_bps=mbps(30.0), latency=0.05, server_time=cfg.server_time, seed=c)
               for c in (0, 1)]
        fast, slow, cal = synthetic_tiers()
        server = MultiStreamServer(cfg, fast, slow, cal, None, n_streams=12, device=device,
                                   fabric=EdgeFabric(ups, pool, n_streams=12, placement="jsq"))
        out[device] = server.process_streams(imgs, labels).summary()
    check(out["cuda"] == out["cpu"], f"multi-stream engine card {out['cuda']} vs CPU {out['cpu']}")
    check(out["cuda"]["offload_frac"] > 0, "multi-stream engine: nothing offloaded")
    print("multi-stream engine, synthetic tiers, card vs CPU: equal summaries", json.dumps(out["cuda"]))


def split_fleet(fast, slow, calibrate, S, device, split, **cfg_kw):
    """Path 5 (c) and phase 4e: ``MultiStreamServer`` over two trace-driven
    cells (an LTE trace at a 6 Mbps mean, a WiFi trace) in front of 2
    serial replicas at T^o = 0.16 s with jsq placement.  With ``split`` the
    planner's grid adds a DeiT-B cut catalog's feature actions; the catalog
    is planning data (bytes, device-prefix time, suffix share), the slow
    tier still answers every escalation with its whole forward."""
    from repro_torch.configs.deit_b import FULL as DEIT_B
    from repro_torch.core.netsim import mbps
    from repro_torch.net import EdgeFabric, lte_trace, wifi_trace
    from repro_torch.serving.engine import MultiStreamServer, ServeConfig
    from repro_torch.split import build_action_table, catalog_for

    cfg = ServeConfig(batch_size=BATCH, acc_server=ACC_SERVER, server_time=SPLIT["server_time"],
                      deadline=SPLIT["deadline"], **cfg_kw)
    if split:
        cfg.actions = build_action_table(catalog_for(DEIT_B, max_cuts=SPLIT["max_cuts"]),
                                         resolutions=cfg.resolutions, size_of=cfg.size_of,
                                         acc_server=cfg.acc_server)
    fabric = EdgeFabric.build(n_streams=S, n_cells=2, n_replicas=2, bandwidth_bps=mbps(6.0),
                              latency=SPLIT["latency"], server_time=SPLIT["server_time"], placement="jsq",
                              traces=[lte_trace(mean_mbps=6.0, seed=0), wifi_trace(seed=1)])
    return MultiStreamServer(cfg, fast, slow, calibrate, None, n_streams=S, fabric=fabric, policy="cbo",
                             device=device)


def offload_mix(server, recs) -> dict:
    """Escalations sent and landed in time, by action kind, from the round records."""
    kind = server.fleet.action_table.kind
    mix = {name: {"sent": 0, "landed": 0} for name in ("frame", "feature")}
    for r in recs:
        k = kind[r["res_idx"]][:, None]  # (S, 1): every escalation of a stream takes its action
        for name, v in (("frame", 0), ("feature", 1)):
            mix[name]["sent"] += int((r["esc"] & (k == v)).sum())
            mix[name]["landed"] += int((r["esc"] & r["ok"] & (k == v)).sum())
    return mix


def evaluation_phase(fast, deit, ms_frames, ms_labels, counted, flash_per_call):
    """Phase 3e, path 5: the paper's evaluation on the card.  (a) Table I:
    ``fit_all`` on the card's fast-tier scores, logits and labels of 256
    frames, held against the same fits on the CPU, scored by ECE and MCE on
    256 more; (b) §V: ``replay_trace`` of every registered policy under
    every calibrator over the card's predictions; (c) the split-offloading
    fleet over trace-driven cells, and the same fleet with frames only.
    ``counted`` maps each kernel's name to its wrapper; every count is set
    to 0 just before (a) and read after (c).  Then (c)'s split run again
    under one trace of the card.  Returns the launches and (a, b)."""
    import torch

    from repro_torch.core.calibration import IsotonicCalibrator, ece, fit_all, mce
    from repro_torch.core.cascade import degrade_resolution, fast_pass
    from repro_torch.core.confidence import max_softmax
    from repro_torch.core.netsim import mbps, png_size_model
    from repro_torch.data.video import VideoDataConfig, make_dataset
    from repro_torch.policy import Env, available_policies, make_policy, replay_trace
    from repro_torch.serving.engine import ServeConfig

    t0 = time.perf_counter()
    data = make_dataset(VideoDataConfig(n_classes=1000, img_res=224, frames_per_video=16), N_EVAL // 16, seed=3)
    frames, labels_np = data["frames"], data["labels"].astype(np.int64)
    check(frames.shape == (N_EVAL, 224, 224, 3), f"path 5 frames {frames.shape}")
    print(f"set-up: path 5, {N_EVAL} frames {time.perf_counter() - t0:.2f} s")
    fit, ev = slice(0, N_EVAL // 2), slice(N_EVAL // 2, N_EVAL)
    for fn in counted.values():
        fn.launches = 0
    t_path = time.perf_counter()

    # (a) Table I: the calibrators fitted where the card's tensors live
    def batches(x):
        return (torch.as_tensor(x[i:i + BATCH], device="cuda") for i in range(0, len(x), BATCH))

    with torch.inference_mode():
        logits = torch.cat([fast(x) for x in batches(frames)])
    labels = torch.as_tensor(labels_np, device="cuda")
    scores = max_softmax(logits)
    correct = logits.argmax(-1) == labels
    t1 = time.perf_counter()
    cals = fit_all(scores[fit], correct[fit], logits[fit], labels[fit])
    fit_s = time.perf_counter() - t1
    host = fit_all(scores[fit].cpu(), correct[fit].cpu(), logits[fit].cpu(), labels[fit].cpu())
    check(sorted(cals) == ["isotonic", "platt", "temperature", "uncalibrated"], f"fit_all keys {sorted(cals)}")
    platt, iso, temp = cals["platt"], cals["isotonic"], cals["temperature"]
    check(abs(platt.a - host["platt"].a) <= CAL_ATOL and abs(platt.b - host["platt"].b) <= CAL_ATOL,
          f"Platt card {platt} vs CPU {host['platt']}")
    check(np.array_equal(iso.thresholds, host["isotonic"].thresholds)
          and np.array_equal(iso.values, host["isotonic"].values), "isotonic knots card vs CPU")
    check(abs(temp.temperature / host["temperature"].temperature - 1) <= CAL_ATOL,
          f"temperature card {temp.temperature} vs CPU {host['temperature'].temperature}")
    # random weights leave ``correct`` nearly constant and the isotonic fit
    # one knot or two; a correctness planted from the scores' rank also
    # exercises the pools, and the card's knot lookup against the CPU's
    rank = scores[fit].argsort().argsort().cpu().numpy() / (N_EVAL // 2)
    planted = IsotonicCalibrator.fit(scores[fit], torch.as_tensor(
        np.random.default_rng(3).uniform(size=N_EVAL // 2) < rank, device="cuda"))
    check(torch.equal(planted(scores[ev]).cpu(), planted(scores[ev].cpu())), "isotonic lookup card vs CPU")
    ab = (platt.a, platt.b)
    correct_ev = correct[ev].cpu().numpy()
    print(f"path 5 on {card_line()}: (a) Table I, ResNet-50 FULL fast tier over {N_EVAL} frames"
          f" (make_dataset seed 3), fast-tier accuracy {float(correct.float().mean()):.4f};"
          f" fit_all on the card's tensors of frames 0-{N_EVAL // 2 - 1} in {fit_s:.3f} s"
          f" (host clock): Platt (a, b) = ({platt.a:.6f}, {platt.b:.6f}), CPU ({host['platt'].a:.6f},"
          f" {host['platt'].b:.6f}); isotonic {len(iso.values)} knots, bit-equal to the CPU fit (planted"
          f" correctness: {len(planted.values)} knots, the card's lookup bit-equal to the CPU's);"
          f" T = {temp.temperature:.6f}, CPU {host['temperature'].temperature:.6f}")

    # (b) §V replay over the card's predictions
    res_ladder = ServeConfig().resolutions
    with torch.inference_mode():
        fused = [fast_pass(fast, None, x, use_fused=True, platt_ab=ab) for x in batches(frames[ev])]
        fast_pred = torch.cat([p for p, _ in fused]).cpu().numpy()
        conf = {"uncalibrated": cals["uncalibrated"](scores[ev]), "platt": torch.cat([c for _, c in fused]),
                "isotonic": iso(scores[ev]), "temperature": temp(scores[ev])}
        slow_pred = np.stack([torch.cat([deit(degrade_resolution(x, r)).argmax(-1) for x in batches(frames[ev])])
                              .cpu().numpy() for r in res_ladder])
    check(slow_pred.shape == (len(res_ladder), N_EVAL // 2), f"slow_pred {slow_pred.shape}")
    conf = {k: v.cpu().numpy() for k, v in conf.items()}
    platt_gap = float(np.abs(conf["platt"] - platt(scores[ev]).cpu().numpy()).max())
    print("  ECE / MCE on frames 256-511:", ", ".join(
        f"{k} {ece(c, correct_ev):.4f} / {mce(c, correct_ev):.4f}" for k, c in conf.items()),
        f"(Platt through calib_gate vs Platt on the plain scores: max |diff| {platt_gap:.3e})")
    gamma = 1.0 / ServeConfig().frame_rate
    env = Env(bandwidth=mbps(REPLAY_NET["bw_mbps"]), latency=REPLAY_NET["latency"],
              server_time=ServeConfig().server_time, deadline=REPLAY_NET["deadline"], acc_server=ACC_SERVER)
    sizes = png_size_model(np.asarray(res_ladder))
    local_acc = float(correct[fit].float().mean())
    make = {"server": lambda: make_policy("server", frame_interval=gamma),
            "greedy-rate": lambda: make_policy("greedy-rate", local_acc=local_acc),
            "cbo": lambda: make_policy("cbo", max_backlog=None)}
    knobs = {"server": dict(local_pred=None), "greedy-rate": dict(local_time=FAST_TIME), "optimal": dict(window=60)}
    policies = available_policies()
    check(len(policies) == 6, f"registered policies {policies}")
    t1 = time.perf_counter()
    table = {}
    for name in policies:
        for cal_name, c in conf.items():
            r = replay_trace(make.get(name, lambda n=name: make_policy(n))(), conf=c, slow_pred=slow_pred,
                             sizes=sizes, env=env, frame_interval=gamma,
                             **{"local_pred": fast_pred, **knobs.get(name, {})})
            acc = r.accuracy(labels_np[ev])
            check(0.0 <= acc <= 1.0 and r.results.shape == (N_EVAL // 2,), f"replay {name}/{cal_name}")
            table[name, cal_name] = (acc, r.n_offloaded, r.n_late)
    replay_s = time.perf_counter() - t1
    check(all(table["local", c][1] == 0 for c in conf), "the local policy offloaded a frame")
    print(f"  (b) replay_trace, {len(policies)} policies x {len(conf)} calibrators over frames 256-511 at"
          f" {REPLAY_NET['bw_mbps']} Mbps, latency {REPLAY_NET['latency']} s, deadline"
          f" {REPLAY_NET['deadline']} s ({replay_s:.3f} s host); accuracy / offloaded / late:")
    for name in policies:
        print(f"    {name:12s}", " | ".join(f"{c} {table[name, c][0]:.4f} / {table[name, c][1]:3d} /"
                                          f" {table[name, c][2]:3d}" for c in conf))

    # (c) the split-offloading fleet, and the same fleet with frames only
    S = ms_frames.shape[0]
    n_rounds = -(-ms_frames.shape[1] // BATCH)
    runs = {}
    for split in (True, False):
        fast_t, slow_t = TimedTier(fast, "fast"), TimedTier(deit, "slow")
        server = split_fleet(fast_t, slow_t, None, S, "cuda", split, use_fused=True, platt_ab=ab)
        recs = []
        server.round_hook = recs.append
        t1 = time.perf_counter()
        metrics = server.process_streams(ms_frames, ms_labels)
        torch.cuda.synchronize()
        runs[split] = dict(server=server, metrics=metrics, wall=time.perf_counter() - t1,
                           mix=offload_mix(server, recs), fast=fast_t, slow=slow_t)
        check(len(fast_t.events) == n_rounds, f"path 5 (c): {len(fast_t.events)} fast-tier calls")
        check(metrics.n_frames == ms_frames.shape[0] * ms_frames.shape[1], f"path 5 (c): {metrics.n_frames}")
    path_s = time.perf_counter() - t_path
    launches = {name: fn.launches for name, fn in counted.items()}
    n_slow = len(res_ladder) * (N_EVAL // 2 // BATCH) + sum(len(r["slow"].events) for r in runs.values())
    n_gate = N_EVAL // 2 // BATCH + 2 * n_rounds
    check(launches["calib_gate"] == n_gate, f"path 5: calib_gate launched {launches['calib_gate']} times,"
          f" expected {n_gate} (16 batches in (b), one a round in (c))")
    check(launches["flash_attention"] == flash_per_call * n_slow,
          f"path 5: flash_attention launched {launches['flash_attention']} times for {n_slow} slow-tier calls")
    check(launches["int8_matmul"] == 0 and launches["int8_kv_decode"] == 0, f"path 5 launches {launches}")
    split_run = runs[True]
    check(split_run["mix"]["feature"]["sent"] > 0, f"path 5 (c): no feature action offloaded {split_run['mix']}")
    check(runs[False]["mix"]["feature"]["sent"] == 0, "path 5 (c): a frames-only fleet sent features")
    print(f"  (c) MultiStreamServer, {S} streams x {ms_frames.shape[1]} frames, {n_rounds} rounds, an LTE"
          f" (6 Mbps mean) and a WiFi trace-driven cell, 2 replicas at T^o = {SPLIT['server_time']} s, jsq,"
          f" deadline {SPLIT['deadline']} s, latency {SPLIT['latency']} s; DeiT-B cut catalog"
          f" ({SPLIT['max_cuts']} cuts) as feature actions:")
    for split, r in runs.items():
        m = r["metrics"]
        print(f"    {'split ' if split else 'frames'}: accuracy {m.accuracy:.4f}, misses {m.n_deadline_miss},"
              f" offloaded {m.n_offloaded}, mix {json.dumps(r['mix'])}, frames/s {m.n_frames / r['wall']:.2f}"
              f" (wall {r['wall']:.3f} s), slow-tier batch sizes {r['slow'].sizes}")
    print(f"  path 5: {path_s:.2f} s; launches {launches} ({n_slow} slow-tier calls)")
    again = split_fleet(fast, deit, None, S, "cuda", True, use_fused=True, platt_ab=ab)
    box = []
    busy_ms, traced_ms = traced(lambda: box.append(again.process_streams(ms_frames, ms_labels)), host_ops=False)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / traced_ms:.4f}"
    n_frames = split_run["metrics"].n_frames
    print(f"  traced repeat of the split fleet: device busy {busy_ms} ms of {traced_ms:.3f} ms wall"
          f" ({n_frames / traced_ms * 1e3:.2f} frames/s); device idle share {idle};"
          f" same summary as the counted run: {box[0].summary() == split_run['metrics'].summary()}")
    return launches


def split_fleet_card_vs_cpu() -> None:
    """Phase 4e: path 5's split fleet with the synthetic closed-form tiers on
    the card and on the CPU: the same decisions round for round, the same
    offload mix and summary."""
    from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers

    imgs, labels = synthetic_streams(N_STREAMS, STREAM_FRAMES)
    out = {}
    for device in ("cuda", "cpu"):
        fast, slow, cal = synthetic_tiers()
        server = split_fleet(fast, slow, cal, N_STREAMS, device, True)
        recs = []
        server.round_hook = recs.append
        summary = server.process_streams(imgs, labels).summary()
        out[device] = (summary, offload_mix(server, recs),
                       [tuple(r[k] for k in ("res_idx", "off_res", "off_kind", "esc", "ok")) for r in recs])
    (sc, mc, dc), (sh, mh, dh) = out["cuda"], out["cpu"]
    check(sc == sh and mc == mh, f"split fleet card {sc} {mc} vs CPU {sh} {mh}")
    check(len(dc) == len(dh) and all(np.array_equal(a, b) for rc, rh in zip(dc, dh) for a, b in zip(rc, rh)),
          "split fleet: decisions differ card vs CPU")
    check(mc["feature"]["sent"] > 0, f"split fleet, synthetic tiers: no feature action offloaded {mc}")
    print("split fleet, synthetic tiers, card vs CPU: equal decisions, summaries and offload mix",
          json.dumps(mc), json.dumps(sc))


def telemetry_phase(fast, deit, frames, labels, fabric, counted, flash_per_call):
    """Phase 3f (a), path 6: path 3's fleet served again with the
    telemetry off, then on (``Telemetry(record, trace, profile)``), on
    fresh fabrics from path 3's factory (the f(batch) fit as the replicas'
    curve).  ``counted`` maps each kernel's name to its wrapper; every
    count is set to 0 just before the telemetry run and read just after.
    Then the telemetry run again under one trace of the card.  Returns the
    launches."""
    import torch

    from repro_torch.obs import Telemetry, relock_lags
    from repro_torch.serving.engine import MultiStreamServer, ServeConfig

    S = frames.shape[0]
    cfg = ServeConfig(batch_size=BATCH, use_fused=True, platt_ab=PLATT, acc_server=ACC_SERVER)
    n_rounds = -(-frames.shape[1] // cfg.batch_size)

    def serve(telemetry):
        fast_t, slow_t = TimedTier(fast, "fast"), TimedTier(deit, "slow")
        server = MultiStreamServer(cfg, fast_t, slow_t, None, None, n_streams=S, fabric=fabric(),
                                   policy="cbo", device="cuda", telemetry=telemetry)
        marks = []
        server.round_hook = lambda rec: marks.append(time.perf_counter())
        t0 = time.perf_counter()
        metrics = server.process_streams(frames, labels)
        torch.cuda.synchronize()
        round_ms = np.diff([t0] + marks) * 1e3
        return server, metrics, slow_t, round_ms

    _, m_off, _, ms_off = serve(None)
    for fn in counted.values():
        fn.launches = 0
    tel = Telemetry(record=True, trace=True, profile=True)
    server, m_on, slow_t, ms_on = serve(tel)
    launches = {name: fn.launches for name, fn in counted.items()}

    n_slow = len(slow_t.events)
    check(m_on.summary() == m_off.summary(), f"path 6 (a): telemetry changed the metrics {m_on.summary()}"
          f" vs {m_off.summary()}")
    for k in ("_frames", "_offloaded", "_missed", "_correct"):
        check(np.array_equal(getattr(m_on, k), getattr(m_off, k)), f"path 6 (a): {k} differs with telemetry")
    rec, tracer, prof = tel.recorder, tel.tracer, tel.profiler
    check(rec.n_rounds == n_rounds, f"path 6 (a): recorder holds {rec.n_rounds} rounds, not {n_rounds}")
    for k, v in (("frames", m_on._frames), ("offloads", m_on._offloaded), ("misses", m_on._missed),
                 ("correct", m_on._correct)):
        check(np.array_equal(rec.series(k)[-1], v), f"path 6 (a): recorder's last {k} {rec.series(k)[-1]} vs {v}")
    check(tracer.n_frames == m_on.n_offloaded + m_on.n_deadline_miss,
          f"path 6 (a): tracer holds {tracer.n_frames} escalations, metrics {m_on.n_offloaded}"
          f" + {m_on.n_deadline_miss}")
    check(sum(f["ok"] for f in tracer.frames) == m_on.n_offloaded, "path 6 (a): tracer's landed escalations")
    trace = tracer.chrome_trace()
    path = ROOT / "build" / "path6_chrome_trace.json"
    path.parent.mkdir(exist_ok=True)
    tracer.export_chrome_trace(str(path))
    with open(path) as fh:
        n_events = len(json.load(fh)["traceEvents"])
    check(n_events == len(trace["traceEvents"]) == 3 + 7 * tracer.n_frames,
          f"path 6 (a): Chrome trace holds {n_events} events")
    check({"plan", "serve", "transmit", "fold"} <= set(prof.totals), f"path 6 (a): profiler phases {prof.totals}")
    check(launches["calib_gate"] == n_rounds, f"path 6 (a): calib_gate launched {launches['calib_gate']} times"
          f" in {n_rounds} rounds")
    check(launches["flash_attention"] == flash_per_call * n_slow, f"path 6 (a): flash_attention launched"
          f" {launches['flash_attention']} times for {n_slow} slow-tier calls")
    check(launches["int8_matmul"] == 0 and launches["int8_kv_decode"] == 0, f"path 6 (a) launches {launches}")
    with np.errstate(all="ignore"):
        lags = relock_lags(rec)
        summary = rec.summary()
    print(f"path 6 on {card_line()}: (a) path 3's fleet ({S} streams x {frames.shape[1]} frames, {n_rounds} rounds,"
          f" 2 cells x 2 replicas, the f(batch) fit as the replicas' curve) with Telemetry(record, trace, profile):"
          f" same AggregateMetrics.summary() as with it off: True; launches {launches} ({n_slow} slow-tier calls)")
    print("  profiler (host wall clock, no synchronize added):", json.dumps(prof.summarize()))
    print(f"  host ms per round, telemetry off: {' '.join(f'{x:.3f}' for x in ms_off)};"
          f" on: {' '.join(f'{x:.3f}' for x in ms_on)} (same call)")
    print(f"  recorder: {rec.n_rounds} rounds, summary {json.dumps(summary)}; relock_lags {lags};"
          f" tracer: {tracer.n_frames} escalations, miss attribution {json.dumps(tracer.miss_attribution())};"
          f" Chrome trace {n_events} events in {path.relative_to(ROOT)}")
    again = MultiStreamServer(cfg, fast, deit, None, None, n_streams=S, fabric=fabric(), policy="cbo",
                              device="cuda", telemetry=Telemetry(record=True, trace=True, profile=True))
    box = []
    busy_ms, traced_ms = traced(lambda: box.append(again.process_streams(frames, labels)), host_ops=False)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / traced_ms:.4f}"
    print(f"  traced repeat with telemetry: device busy {busy_ms} ms of {traced_ms:.3f} ms wall; device idle"
          f" share {idle}; same summary as the counted run: {box[0].summary() == m_on.summary()}")
    return launches


def fleet_backlog(S, mb, seed):
    """``tests/test_fleet_jax.py::fuzz_backlog``: per-stream ascending
    arrivals on the 1/32 grid (exact in float32), confidences uniform in
    [0.05, 0.95], bandwidth estimates uniform in [2e5, 1e7] bytes/s, 80 %
    of the streams active, each planned half a frame after its newest
    arrival."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, mb + 1, size=S)
    stream = np.repeat(np.arange(S), lens)
    t0 = rng.integers(0, 64, size=S) / 32.0
    pos = np.concatenate([np.arange(n) for n in lens]) if lens.sum() else np.zeros(0)
    arrival = t0[stream] + pos / 32.0
    conf = rng.uniform(0.05, 0.95, size=lens.sum())
    now = t0 + (lens + 0.5) / 32.0
    bw = rng.uniform(2e5, 1e7, size=S)
    active = rng.random(S) < 0.8
    now = np.where(active, now, np.inf)
    return stream, arrival, conf, now, bw, active


def planner_phase() -> list:
    """Phase 3f (b), path 6: ``FleetRunner(backend="torch")`` planning
    fleets of 1,024 to 1,048,576 streams on the card against the numpy
    ``FleetRunner`` on the host, on the same backlogs: the integer fields
    equal, theta within 1e-6, gains and base accuracies within 1e-4, no
    frontier overflow or inexact prune.  Prints host ms a call for both,
    the card's device time a call, streams a second and peak card memory;
    one traced call at 131,072 streams gives the idle share.  Returns the
    rows."""
    import torch

    from repro_torch.configs.deit_b import FULL as DEIT_B
    from repro_torch.core.netsim import png_size_model
    from repro_torch.policy.fleet import FleetRunner
    from repro_torch.policy.registry import make_policy
    from repro_torch.split import build_action_table, catalog_for

    split = build_action_table(catalog_for(DEIT_B, max_cuts=SPLIT["max_cuts"]), resolutions=PLAN["resolutions"],
                               size_of=png_size_model, acc_server=PLAN["acc_server"])
    points = ([("cbo", S) for S in PLAN_SIZES]
              + [(p, S) for p in ("threshold", "local", "server", "greedy-rate")
                 for S in (PLAN_SIZES[0], PLAN_SIZES[2])]
              + [("cbo-split", PLAN_SIZES[0])])
    print(f"path 6 on {card_line()}: (b) FleetRunner(backend='torch') on the card against the numpy FleetRunner,"
          f" max_backlog {PLAN['max_backlog']}, resolutions {PLAN['resolutions']}, acc_server {PLAN['acc_server']},"
          f" deadline {PLAN['deadline']} s, L {PLAN['latency']} s, T^o {PLAN['server_time']} s; split: the DeiT-B cut"
          f" catalog ({SPLIT['max_cuts']} cuts, {split.n_actions} actions)")
    rows = []
    for i, (policy, S) in enumerate(points):
        name = policy.split("-split")[0]
        kw = dict(max_backlog=PLAN["max_backlog"], **({"frame_interval": 1.0 / 32.0} if name == "server" else {}))
        common = {k: PLAN[k] for k in ("resolutions", "acc_server", "deadline", "latency", "server_time")}
        actions = split if policy.endswith("split") else None
        stream, arrival, conf, now, bw, active = fleet_backlog(S, PLAN["max_backlog"], 1000 + i)
        runners = {}
        for backend in ("numpy", "torch"):
            r = FleetRunner([make_policy(name, **kw) for _ in range(S)], size_of=png_size_model, bw_init=50e6 / 8,
                            backend=backend, device="cuda" if backend == "torch" else None, actions=actions, **common)
            r.observe_frames(stream, arrival, conf)
            r.bw_est[:] = bw
            runners[backend] = r
        # both backends timed alike: one call to warm up, then the min and
        # mean of 3 (numpy of 1 at 2^20 streams, where a call takes ~15 s)
        n_calls = 1 if S >= 1 << 20 else 3
        pn = runners["numpy"].plan_all(now, active)
        numpy_calls = []
        for _ in range(n_calls):
            t0 = time.perf_counter()
            pn = runners["numpy"].plan_all(now, active)
            numpy_calls.append((time.perf_counter() - t0) * 1e3)
        rt = runners["torch"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        pt = rt.plan_all(now, active)  # the first call: CUDA set-up of this shape
        calls = []
        for _ in range(3):
            t0 = time.perf_counter()
            pt = rt.plan_all(now, active)
            torch.cuda.synchronize()
            calls.append((time.perf_counter() - t0) * 1e3)
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        for k in ("resolution", "n_offloads", "n_frames", "off_stream", "off_pos", "off_res", "off_kind", "planned"):
            check(np.array_equal(getattr(pn, k), getattr(pt, k)), f"path 6 (b) {policy} S={S}: {k} differs")
        check(np.abs(pt.theta - pn.theta).max() <= THETA_ATOL, f"path 6 (b) {policy} S={S}: theta")
        for k in ("total_gain", "base_acc"):
            check(np.abs(getattr(pt, k) - getattr(pn, k)).max() <= 1e-4, f"path 6 (b) {policy} S={S}: {k}")
        check(not rt.last_overflow.any() and not rt.last_inexact.any(),
              f"path 6 (b) {policy} S={S}: overflow {int(rt.last_overflow.sum())}, inexact {int(rt.last_inexact.sum())}")
        dev_ms, _ = traced(lambda: rt.plan_all(now, active), iters=2)
        dev_ms = None if dev_ms is None else dev_ms / 2
        row = dict(policy=policy, streams=S, numpy_ms=min(numpy_calls), numpy_ms_mean=float(np.mean(numpy_calls)),
                   torch_ms=min(calls), torch_ms_mean=float(np.mean(calls)),
                   device_ms=dev_ms, peak_gb=peak_gb, offloads=len(pn.off_stream),
                   features=int((pn.off_kind == 1).sum()))
        rows.append(row)
        print(f"  {policy:12s} S={S:8d}: numpy {row['numpy_ms']:10.3f} ms min, {row['numpy_ms_mean']:10.3f} mean of"
              f" {n_calls} ({S / row['numpy_ms'] * 1e3:12.1f} streams/s);"
              f" torch {row['torch_ms']:9.3f} ms min, {row['torch_ms_mean']:9.3f} mean of 3"
              f" ({S / row['torch_ms'] * 1e3:12.1f} streams/s); device {_us(dev_ms)} a call; peak card memory"
              f" {peak_gb:.3f} GB; offloads {row['offloads']} ({row['features']} feature actions); decisions equal")
        if policy == "cbo" and S == PLAN_SIZES[2]:
            busy_ms, wall_ms = traced(lambda: rt.plan_all(now, active), host_ops=False)
            idle = "not measured" if busy_ms is None else f"{1 - busy_ms / wall_ms:.4f}"
            print(f"  traced call, cbo at S={S}: device busy {busy_ms} ms of {wall_ms:.3f} ms wall; device idle share"
                  f" {idle}")
        if policy == "cbo" and S == PLAN_SIZES[-1]:
            total, sorts, ranked = traced_kernels(lambda: rt.plan_all(now, active), 1, ("sort", "Sort"), top=8)
            print(f"  where cbo's device time goes at S={S}: {total} ms a call, {sorts} ms in sort kernels; top"
                  f" kernels (ms): " + "; ".join(f"{k} {t:.3f}" for k, t in ranked))
        del runners, rt, pt, pn
        torch.cuda.empty_cache()
    return rows


def rounds_equal(ref_recs, recs, label) -> None:
    """``tests/_diff.py``'s ``assert_round_equal`` on two runs' round
    records: ``EXACT_KEYS`` equal, theta, bandwidth estimates and latencies
    within the tolerances, no frontier overflow or inexact prune."""
    check(len(ref_recs) == len(recs) > 0, f"{label}: {len(ref_recs)} vs {len(recs)} rounds")
    for i, (a, b) in enumerate(zip(ref_recs, recs)):
        for k in EXACT_KEYS:
            check(np.array_equal(a[k], b[k]), f"{label}, round {i}: {k} differs: {a[k]!r} vs {b[k]!r}")
        check(np.abs(b["theta"] - a["theta"]).max(initial=0.0) <= THETA_ATOL, f"{label}, round {i}: theta")
        check(bool(np.all(np.abs(b["bw_est"] - a["bw_est"]) <= BW_RTOL * np.abs(a["bw_est"]))),
              f"{label}, round {i}: bw_est")
        check(np.abs(b["lat"] - a["lat"]).max(initial=0.0) <= LAT_ATOL, f"{label}, round {i}: lat")
        for k in ("overflow", "inexact"):
            check(not np.any(b.get(k, False)), f"{label}, round {i}: {k}")


def round_engine_phase(fast, deit, frames, labels, fabric, counted, flash_per_call):
    """Phase 3g (a), path 7: path 3's fleet (its tiers, 2 cells x 2
    replicas, the f(batch) fit as the replicas' continuous-batching curve,
    its coefficients rounded to float32 so both engines share one curve,
    jsq placement) at ``frame_rate=32``, served by ``backend="numpy"``
    and then by ``backend="torch"``: the tiers of every round precomputed
    on the card, then one CUDA-graph replay a round.  The rounds' integer
    fields are equal, floats within the differential tolerances.
    ``counted`` maps each kernel's name to its wrapper; every count is set
    to 0 just before the torch run and read just after.  Then the torch
    run again under one trace of the card.  Returns the launches."""
    import torch

    from repro_torch.core.netsim import Uplink, mbps
    from repro_torch.net import EdgeFabric, ReplicaPool
    from repro_torch.obs import Telemetry
    from repro_torch.serving.engine import MultiStreamServer, ServeConfig
    from repro_torch.slowtier import ContinuousBatching, model_coeffs, model_from_coeffs

    S = frames.shape[0]
    cfg = ServeConfig(batch_size=BATCH, use_fused=True, platt_ab=PLATT, acc_server=ACC_SERVER, frame_rate=32.0)
    m = len(cfg.resolutions)
    n_rounds = -(-frames.shape[1] // cfg.batch_size)
    kind, coeffs = model_coeffs(fabric().pool.batching.model)
    batching = ContinuousBatching(model_from_coeffs(kind, tuple(float(np.float32(c)) for c in coeffs)),
                                  window_s=BATCH_WINDOW_S, max_batch=BATCH)

    def server_of(backend, telemetry=None):
        pool = ReplicaPool(2, [cfg.server_time, 1.5 * cfg.server_time], serial=True, batching=batching)
        ups = [Uplink(bandwidth_bps=mbps(BW_MBPS), latency=0.05, server_time=cfg.server_time, seed=c)
               for c in (0, 1)]
        return MultiStreamServer(cfg, fast, deit, None, None, n_streams=S, policy="cbo", device="cuda",
                                 fabric=EdgeFabric(ups, pool, n_streams=S, placement="jsq"),
                                 backend=backend, telemetry=telemetry)

    def serve(backend, telemetry=None):
        server = server_of(backend, telemetry)
        recs = []
        server.round_hook = recs.append
        t0 = time.perf_counter()
        metrics = server.process_streams(frames, labels)
        torch.cuda.synchronize()
        return server, metrics, recs, time.perf_counter() - t0

    server_np, m_np, r_np, wall_np = serve("numpy")
    for fn in counted.values():
        fn.launches = 0
    tel = Telemetry(record=False, profile=True)
    server, m_t, r_t, wall_t = serve("torch", tel)
    launches = {name: fn.launches for name, fn in counted.items()}

    check(launches["calib_gate"] == n_rounds, f"path 7 (a): calib_gate launched {launches['calib_gate']} times"
          f" in {n_rounds} rounds")
    check(launches["flash_attention"] == flash_per_call * m * n_rounds,
          f"path 7 (a): flash_attention launched {launches['flash_attention']} times, expected"
          f" {flash_per_call} x {m} resolutions x {n_rounds} rounds")
    check(launches["int8_matmul"] == 0 and launches["int8_kv_decode"] == 0, f"path 7 (a) launches {launches}")
    rounds_equal(r_np, r_t, "path 7 (a), numpy vs torch")
    for k in ("_frames", "_offloaded", "_missed", "_correct"):
        check(np.array_equal(getattr(m_np, k), getattr(m_t, k)), f"path 7 (a): {k} differs")
    check(m_t.accuracy == m_np.accuracy and m_t.n_frames == S * frames.shape[1], "path 7 (a): accuracy, frames")
    check(m_t.n_offloaded + m_t.n_deadline_miss > 0, "path 7 (a): no frame escalated")
    prof = tel.profiler.totals
    check({"precompute", "compile", "scan", "fold"} <= set(prof), f"path 7 (a): profiler phases {prof}")
    print(f"path 7 on {card_line()}: (a) path 3's fleet ({S} streams x {frames.shape[1]} frames, {n_rounds} rounds"
          f" at frame_rate 32, 2 cells x {BW_MBPS} Mbps, 2 replicas batching on the f(batch) fit {kind}"
          f" {tuple(float(np.float32(c)) for c in coeffs)}, jsq) served by backend='numpy' and backend='torch':"
          f" every round's integer fields equal, floats within the tolerances; launches in the torch run {launches}")
    print("  numpy AggregateMetrics.summary():", json.dumps(m_np.summary()))
    print("  torch AggregateMetrics.summary():", json.dumps(m_t.summary()))
    print(f"  wall s: numpy backend {wall_np:.3f}, torch backend {wall_t:.3f} = precompute {prof['precompute']:.3f}"
          f" + capture {prof['compile']:.3f} + {n_rounds} rounds {prof['scan']:.6f}"
          f" ({n_rounds / prof['scan']:.1f} rounds/s) + fold {prof['fold']:.3f}; pool.avg_batch"
          f" {server.fabric.pool.avg_batch:.6f} (numpy {server_np.fabric.pool.avg_batch:.6f})")
    again = server_of("torch")
    box = []
    busy_ms, traced_ms = traced(lambda: box.append(again.process_streams(frames, labels)), host_ops=False)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / traced_ms:.4f}"
    print(f"  traced repeat (torch backend): device busy {busy_ms} ms of {traced_ms:.3f} ms wall; device idle share"
          f" {idle}; same summary as the counted run: {box[0].summary() == m_t.summary()}")
    kernels, rows, replay_ms = graph_kernels(again)
    print(f"  the round's graph: {kernels} kernels a replay, {rows} unrolled per-row steps (jsq over"
          f" {S * BATCH} rows, 2 replicas' batch loops), {replay_ms:.3f} ms a replay (events)")
    return launches


def graph_kernels(server):
    """Kernels in one replay of ``server``'s round graph (``backend="torch"``),
    from a trace of the card, its per-row steps unrolled, and its device ms
    a replay (CUDA events, the mean of 10): the graph is static, so one
    synthetic round of its shape has the same kernels."""
    import torch

    from repro_torch.obs import aot_split
    from repro_torch.serving import engine_torch as et

    spec = et.spec_from_server(server)
    params = et.params_from_server(server, spec, device="cuda")
    S, B, R = spec.n_streams, spec.batch, 11
    g = torch.Generator(device="cuda").manual_seed(0)
    arr = (torch.arange(R * B, dtype=torch.float32, device="cuda") / 32.0).reshape(R, 1, B)
    inputs = et.RoundInputs(arr=arr.expand(R, S, B).contiguous(),
                            valid=torch.ones((R, S, B), dtype=torch.bool, device="cuda"),
                            conf=torch.rand((R, S, B), generator=g, device="cuda"),
                            fast_ok=torch.ones((R, S, B), dtype=torch.bool, device="cuda"),
                            slow_ok=torch.ones((R, S, B, spec.m), dtype=torch.bool, device="cuda"))
    loop = et.RoundLoop(spec, params, et.init_carry(spec, params), inputs)
    replay, _ = aot_split(loop.step, *loop.state)
    events, _ = _profile(replay, 1, host_ops=False)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(R - 1):
        replay()
    end.record()
    end.synchronize()
    return sum(e.count for e in events), et.unrolled_rows(spec), start.elapsed_time(end) / (R - 1)


def engine_case(S, device, rounds=ENGINE["rounds"], seed=0):
    """``bench_fleet_control.py::bench_jax_one`` for the round engine: cbo,
    max_backlog 8, batch 8, one cell of 6 Mbps, one replica (T^o = 37 ms),
    arrivals on the 1/32 grid, confidences and correctness drawn on
    ``device`` from ``seed`` (the CPU run of the same case copies the
    card's draws)."""
    import torch

    from repro_torch.core.netsim import mbps, payload_sizes, png_size_model
    from repro_torch.policy.fleet_torch import spec_for_policy
    from repro_torch.policy.registry import make_policy
    from repro_torch.serving import engine_torch as et

    B = ENGINE["batch"]
    sizes = payload_sizes(png_size_model, np.asarray(PLAN["resolutions"]))
    planner = spec_for_policy(make_policy("cbo", max_backlog=ENGINE["max_backlog"]), sizes=sizes,
                              acc_server=PLAN["acc_server"], deadline=0.2, latency=0.05, server_time=0.037)
    spec = et.EngineSpec(n_streams=S, batch=B, n_cells=1, n_replicas=1, planner=planner, collect="none")
    bw = mbps(ENGINE["bw_mbps"])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).float()  # noqa: E731
    params = et.EngineParams(sizes=f(sizes), cell_bw=f([bw]), cell_of=torch.zeros(S, dtype=torch.int64,
                                                                                  device=device),
                             replica_st=f([0.037]), stream_bw=torch.full((S,), bw, device=device),
                             weights=torch.ones(S, device=device), bw_init=torch.full((S,), bw, device=device))
    g = torch.Generator(device=device).manual_seed(seed)
    arr = (torch.arange(rounds * B, dtype=torch.float32, device=device) / 32.0).reshape(rounds, 1, B)
    inputs = et.RoundInputs(arr=arr.expand(rounds, S, B).contiguous(),
                            valid=torch.ones((rounds, S, B), dtype=torch.bool, device=device),
                            conf=torch.rand((rounds, S, B), generator=g, device=device),
                            fast_ok=torch.rand((rounds, S, B), generator=g, device=device) < 0.7,
                            slow_ok=torch.rand((rounds, S, B, 2), generator=g, device=device) < 0.9)
    return spec, params, inputs


def engine_bench_phase() -> list:
    """Phase 3g (b), path 7: the round engine alone on synthetic rounds
    (``engine_case``) at S = 1,000 ... 1,000,000 streams, 8 rounds each:
    capture seconds (warm-up and capture, ``aot_split``), steady seconds
    of the 8 replays (host clock, the device waited for), rounds and
    frames a second, device ms a round (CUDA events around the replays)
    and peak card memory.  At 1,000 streams the card's final carry is held
    against the same rounds on the CPU (integer fields equal); one traced
    repeat at 100,000 gives the idle share.  Returns the rows."""
    import torch

    from repro_torch.obs import aot_split
    from repro_torch.serving import engine_torch as et

    R, B = ENGINE["rounds"], ENGINE["batch"]
    print(f"path 7 on {card_line()}: (b) the round engine on synthetic rounds (cbo, max_backlog"
          f" {ENGINE['max_backlog']}, batch {B}, 1 cell of {ENGINE['bw_mbps']} Mbps, 1 replica, {R} rounds,"
          f" collect='none'), one CUDA-graph replay a round")
    rows = []
    for S in ENGINE_SIZES:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        spec, params, inputs = engine_case(S, "cuda")
        loop = et.RoundLoop(spec, params, et.init_carry(spec, params), inputs)
        saved = [t.clone() for t in loop.state]
        replay, capture_s = aot_split(loop.step, *loop.state)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(R):
            replay()
        end.record()
        end.synchronize()
        steady_s = time.perf_counter() - t0
        round_ms = start.elapsed_time(end) / R
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        c = loop.carry
        check(int(c.frames.sum()) == S * B * R, f"path 7 (b) S={S}: frames {int(c.frames.sum())}")
        check(int(c.offloaded.sum()) > 0 and bool(torch.isfinite(c.bw_est).all()),
              f"path 7 (b) S={S}: offloads {int(c.offloaded.sum())}, bw_est finite")
        note = ""
        if S == ENGINE_SIZES[0]:
            cs, cp, ci = engine_case(S, "cpu")
            ci = et.RoundInputs(*(x.cpu() for x in inputs))
            cc, _ = et.simulate(cs, cp, ci)
            for k in ("frames", "offloaded", "missed", "correct", "cell_n", "rep_n", "rr_next"):
                check(torch.equal(getattr(cc, k), getattr(c, k).cpu()), f"path 7 (b) S={S}: card vs CPU {k}")
            check(torch.equal(cc.fleet.length, c.fleet.length.cpu()), f"path 7 (b) S={S}: card vs CPU backlogs")
            note = "; card vs CPU: integer carry equal"
        if S == ENGINE_SIZES[2]:
            first = [t.clone() for t in loop.state]
            for t, v in zip(loop.state, saved):
                t.copy_(v)
            events, wall_ms = _profile(lambda: [replay() for _ in range(R)], 1, host_ops=False)
            busy_ms = sum(e.self_device_time_total for e in events) / 1e3 or None
            idle = "not measured" if busy_ms is None else f"{1 - busy_ms / wall_ms:.4f}"
            check(all(torch.equal(a, b) for a, b in zip(loop.state, first)),
                  f"path 7 (b) S={S}: the repeat's final state differs from the first run's")
            note = (f"; traced repeat: device busy {busy_ms} ms of {wall_ms:.3f} ms wall, device idle share {idle},"
                    f" {sum(e.count for e in events) / R:.0f} kernels a round; the repeat's final state"
                    f" bit-equal to the first run's")
        row = dict(streams=S, capture_s=capture_s, steady_s=steady_s, rounds_per_s=R / steady_s,
                   frames_per_s=S * B * R / steady_s, round_ms=round_ms, peak_gb=peak_gb,
                   offloaded=int(c.offloaded.sum()))
        rows.append(row)
        print(f"  S={S:8d}: capture {capture_s:.3f} s; {R} rounds {steady_s:.6f} s ({row['rounds_per_s']:.1f}"
              f" rounds/s, {row['frames_per_s']:.4g} frames/s); device {round_ms:.4f} ms a round (events);"
              f" peak card memory {peak_gb:.3f} GB; offloads {row['offloaded']}" + note)
        del loop, replay, saved, inputs, params, c
    return rows


def engine_card_vs_cpu() -> None:
    """Phase 4f: ``MultiStreamServer(backend="torch")`` with the synthetic
    tiers on the card against the same engine on the CPU, over phase 4c's
    live-batching fabric and over a counter-jittered 2-cell fabric: every
    round's integer fields equal, floats within the tolerances, equal
    summaries."""
    from repro_torch.core.netsim import Uplink, mbps
    from repro_torch.net import EdgeFabric, ReplicaPool
    from repro_torch.serving.engine import MultiStreamServer, ServeConfig
    from repro_torch.serving.synthetic import synthetic_streams, synthetic_tiers
    from repro_torch.slowtier import ContinuousBatching, LinearBatch

    for name, S, n, jitter, batching in (
            ("live batching", 12, 64, 0.0,
             ContinuousBatching(LinearBatch(0.03125, 0.0078125), window_s=0.03125)),
            ("counter jitter 0.3", 6, 48, 0.3, None)):
        imgs, labels = synthetic_streams(S, n)
        recs, out = {}, {}
        for device in ("cuda", "cpu"):
            cfg = ServeConfig(resolutions=(4, 8), acc_server=(0.7, 0.99), frame_rate=32.0)
            pool = ReplicaPool(2, [cfg.server_time, 1.5 * cfg.server_time], batching=batching)
            ups = [Uplink(bandwidth_bps=mbps(30.0), latency=0.05, server_time=cfg.server_time, seed=c,
                          jitter=jitter, jitter_mode="counter") for c in (0, 1)]
            fast, slow, cal = synthetic_tiers()
            server = MultiStreamServer(cfg, fast, slow, cal, None, n_streams=S, device=device, backend="torch",
                                       fabric=EdgeFabric(ups, pool, n_streams=S, placement="jsq"))
            recs[device] = []
            server.round_hook = recs[device].append
            out[device] = server.process_streams(imgs, labels).summary()
        rounds_equal(recs["cpu"], recs["cuda"], f"phase 4f, {name}, card vs CPU")
        check(out["cuda"] == out["cpu"], f"phase 4f, {name}: card {out['cuda']} vs CPU {out['cpu']}")
        check(out["cuda"]["offload_frac"] > 0, f"phase 4f, {name}: nothing offloaded")
        print(f"round engine, synthetic tiers, {name}, card vs CPU: rounds equal, equal summaries",
              json.dumps(out["cuda"]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from repro_torch.configs.deit_b import FULL as DEIT_B
    from repro_torch.configs.resnet_50 import FULL
    from repro_torch.core.cascade import fast_pass
    from repro_torch.data.video import VideoDataConfig, make_dataset
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.fused_calib_gate import kernel as cg_kernel
    from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref
    from repro_torch.kernels.int8_kv_decode import kernel as kv_kernel
    from repro_torch.kernels.int8_kv_decode.ref import decode_attention_ref
    from repro_torch.kernels.int8_matmul import kernel as i8_kernel
    from repro_torch.kernels.int8_matmul import ref as i8_ref
    from repro_torch.models.resnet import ResNet
    from repro_torch.models.vit import ViT
    from repro_torch.quant.quantize import qdq_tree

    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - clock[0]:.2f} s")
        clock[0] = now

    # ---- 1. card and build ------------------------------------------------ #
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    build_phase([cg_kernel.LIBRARY, fa_kernel.LIBRARY, i8_kernel.LIBRARY, kv_kernel.LIBRARY])
    flash_sass(fa_kernel.LIBRARY)
    int8_sass(i8_kernel)
    kv_sass(kv_kernel)
    calib_sass(cg_kernel)
    phase_done("1 (build)")

    # ---- 2. kernels vs plain versions ------------------------------------- #
    cg_rows, cg_err = calib_gate_phase(torch, cg_kernel, calib_gate_ref)
    fa_rows, fa_err = flash_phase(torch, fa_kernel.flash_attention, attention_ref)
    i8_rows, i8_err = int8_phase(torch, i8_kernel, i8_ref)
    kv_rows, kv_err = kv_phase(torch, kv_kernel, decode_attention_ref)
    phase_done("2 (kernels vs plain versions)")

    # ---- 3. path 1: ResNet-50 slow tier ----------------------------------- #
    t0 = time.perf_counter()
    fast = ResNet(FULL, generator=torch.Generator().manual_seed(0), device="cuda")
    fast.load_state_dict(qdq_tree(fast.state_dict()))  # int8 per-channel "NPU" weights
    slow = ResNet(FULL, generator=torch.Generator().manual_seed(1), device="cuda")
    data = make_dataset(VideoDataConfig(n_classes=FULL.n_classes, img_res=FULL.img_res,
                                        frames_per_video=16), N_FRAMES // 16, seed=0)
    frames, labels = data["frames"], data["labels"]
    check(frames.shape == (N_FRAMES, 224, 224, 3), f"frames {frames.shape}")
    print(f"set-up: weights and {N_FRAMES} frames {time.perf_counter() - t0:.2f} s")
    warm_up("path 1", fast, slow, frames)
    n_batches = -(-N_FRAMES // BATCH)
    serve_phase("path 1, ResNet-50 FULL fast and slow tiers", fast, slow, frames, labels,
                {"calib_gate": (cg_kernel.calib_gate, n_batches),
                 "flash_attention": (fa_kernel.flash_attention, 0),
                 "int8_matmul": (i8_kernel.int8_matmul, 0),
                 "int8_kv_decode": (kv_kernel.int8_kv_decode, 0)})
    phase_done("3 (path 1)")

    # ---- 3b. path 2: DeiT-B slow tier ------------------------------------- #
    t0 = time.perf_counter()
    deit = ViT(DEIT_B, generator=torch.Generator().manual_seed(1), device="cuda")
    print(f"set-up: DeiT-B FULL weights ({sum(p.numel() for p in deit.parameters())} parameters)"
          f" {time.perf_counter() - t0:.2f} s")
    warm_up("path 2", fast, deit, frames)
    serve_phase("path 2, ResNet-50 FULL fast tier, DeiT-B FULL slow tier", fast, deit,
                frames, labels,
                {"calib_gate": (cg_kernel.calib_gate, n_batches),
                 "flash_attention": (fa_kernel.flash_attention, DEIT_B.n_layers * n_batches),
                 "int8_matmul": (i8_kernel.int8_matmul, 0),
                 "int8_kv_decode": (kv_kernel.int8_kv_decode, 0)})
    phase_done("3b (path 2)")

    # ---- 3c. path 3: f(batch) sweep, multi-stream fabric ------------------ #
    t0 = time.perf_counter()
    n_ms = N_STREAMS * STREAM_FRAMES
    data = make_dataset(VideoDataConfig(n_classes=FULL.n_classes, img_res=FULL.img_res,
                                        frames_per_video=16), n_ms // 16, seed=0)
    ms_frames = data["frames"].reshape(N_STREAMS, STREAM_FRAMES, *data["frames"].shape[1:])
    ms_labels = data["labels"].reshape(N_STREAMS, STREAM_FRAMES)
    print(f"set-up: {n_ms} frames ({ms_frames.nbytes / 1e6:.0f} MB) {time.perf_counter() - t0:.2f} s")
    warm_up("path 3", fast, deit, data["frames"], n_fast=N_STREAMS * BATCH, n_slow=N_STREAMS * BATCH)
    launches, ms_fabric = multistream_phase(fast, deit, ms_frames, ms_labels,
                                 {"calib_gate": cg_kernel.calib_gate,
                                  "flash_attention": fa_kernel.flash_attention,
                                  "int8_matmul": i8_kernel.int8_matmul,
                                  "int8_kv_decode": kv_kernel.int8_kv_decode}, DEIT_B.n_layers)
    check(launches["int8_kv_decode"] == 0,
          f"path 3 launched int8_kv_decode {launches['int8_kv_decode']} times")
    phase_done("3c (path 3)")

    # ---- 3d. path 4: StableLM-12B prefill and int8-KV decode --------------- #
    lm_launches = lm_phase({"calib_gate": cg_kernel.calib_gate, "flash_attention": fa_kernel.flash_attention,
                            "int8_matmul": i8_kernel.int8_matmul,
                            "int8_kv_decode": kv_kernel.int8_kv_decode})
    phase_done("3d (path 4)")

    # ---- 3e. path 5: Table I calibrators, §V replay, split fleet ---------- #
    eval_launches = evaluation_phase(fast, deit, ms_frames, ms_labels,
                                     {"calib_gate": cg_kernel.calib_gate,
                                      "flash_attention": fa_kernel.flash_attention,
                                      "int8_matmul": i8_kernel.int8_matmul,
                                      "int8_kv_decode": kv_kernel.int8_kv_decode}, DEIT_B.n_layers)
    phase_done("3e (path 5)")

    # ---- 3f. path 6: telemetry on path 3's fleet, the planner on the card -- #
    tel_launches = telemetry_phase(fast, deit, ms_frames, ms_labels, ms_fabric,
                                   {"calib_gate": cg_kernel.calib_gate,
                                    "flash_attention": fa_kernel.flash_attention,
                                    "int8_matmul": i8_kernel.int8_matmul,
                                    "int8_kv_decode": kv_kernel.int8_kv_decode}, DEIT_B.n_layers)
    planner_phase()
    phase_done("3f (path 6)")

    # ---- 3g. path 7: the fleet round on the card, one graph a round -------- #
    eng_launches = round_engine_phase(fast, deit, ms_frames, ms_labels, ms_fabric,
                                      {"calib_gate": cg_kernel.calib_gate,
                                       "flash_attention": fa_kernel.flash_attention,
                                       "int8_matmul": i8_kernel.int8_matmul,
                                       "int8_kv_decode": kv_kernel.int8_kv_decode}, DEIT_B.n_layers)
    engine_bench_phase()
    phase_done("3g (path 7)")

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

    # ---- 4b. DeiT-B card against CPU --------------------------------------- #
    deit_cpu = ViT(DEIT_B, device="cpu")
    deit_cpu.load_state_dict(deit.state_dict())
    two = torch.as_tensor(frames[:2])
    before = fa_kernel.flash_attention.launches
    with torch.inference_mode():
        dg, dc = deit(two.cuda()).cpu(), deit_cpu(two)
    check(fa_kernel.flash_attention.launches == before + DEIT_B.n_layers, "DeiT-B forward launches")
    logit_err = float((dg - dc).abs().max())
    check(bool(torch.isfinite(dg).all()) and dg.shape == (2, DEIT_B.n_classes), f"DeiT-B logits {dg.shape}")
    check(logit_err <= CPU_LOGIT_ATOL, f"DeiT-B card vs CPU logit err {logit_err} > {CPU_LOGIT_ATOL}")
    print(f"DeiT-B card vs CPU, two frames, TF32 off: max |logit| err {logit_err:.3e}"
          f" (atol {CPU_LOGIT_ATOL}) of |logit| <= {float(dc.abs().max()):.3f},"
          f" argmax equal {bool((dg.argmax(-1) == dc.argmax(-1)).all())}")

    # ---- 4c. multi-stream engine card against CPU -------------------------- #
    multistream_card_vs_cpu()

    # ---- 4d. StableLM-12B widths card against CPU -------------------------- #
    lm_card_vs_cpu(kv_kernel)

    # ---- 4e. path 5's split fleet card against CPU ------------------------- #
    split_fleet_card_vs_cpu()

    # ---- 4f. the round engine card against CPU ---------------------------- #
    engine_card_vs_cpu()
    phase_done("4 (card against CPU)")

    # ---- 5. result -------------------------------------------------------- #
    cg_row, fa_row = cg_rows[0], fa_rows[0]
    i8_row = max((r for r in i8_rows if r["case"].startswith("sweep")), key=lambda r: r["shape"][0])
    kv_row = next(r for r in kv_rows if r["case"] == "StableLM path")
    kernels = [dict(name="calib_gate", route="cuda",
                    source="src/repro_torch/kernels/fused_calib_gate/csrc/calib_gate.cu",
                    replaces="src/repro/kernels/fused_calib_gate/kernel.py:48",
                    launches=(launches["calib_gate"] + eval_launches["calib_gate"] + tel_launches["calib_gate"]
                              + eng_launches["calib_gate"]),
                    max_abs_err=cg_err,
                    ms=cg_row["ms"], plain_ms=cg_row["plain_ms"],
                    bound_ms=cg_row["bound_ms"], bound_by=cg_row["bound_by"],
                    library_ms=None),
               dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention/kernel.py:62",
                    launches=(launches["flash_attention"] + eval_launches["flash_attention"]
                              + tel_launches["flash_attention"] + eng_launches["flash_attention"]),
                    max_abs_err=fa_err,
                    ms=fa_row["ms"], plain_ms=fa_row["plain_ms"],
                    bound_ms=fa_row["bound_ms"], bound_by=fa_row["bound_by"],
                    library_ms=fa_row["library_ms"]),
               dict(name="int8_matmul", route="cuda",
                    source="src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu",
                    replaces="src/repro/kernels/int8_matmul/kernel.py:43",
                    launches=(launches["int8_matmul"] + eval_launches["int8_matmul"] + tel_launches["int8_matmul"]
                              + eng_launches["int8_matmul"]),
                    max_abs_err=i8_err,
                    ms=i8_row["ms"], plain_ms=i8_row["plain_ms"],
                    bound_ms=i8_row["bound_ms"], bound_by=i8_row["bound_by"],
                    library_ms=i8_row["library_ms"]),
               dict(name="int8_kv_decode", route="cuda",
                    source="src/repro_torch/kernels/int8_kv_decode/csrc/int8_kv_decode.cu",
                    replaces="src/repro/kernels/int8_kv_decode/kernel.py:59",
                    launches=lm_launches["int8_kv_decode"] + eval_launches["int8_kv_decode"]
                    + tel_launches["int8_kv_decode"] + eng_launches["int8_kv_decode"], max_abs_err=kv_err,
                    ms=kv_row["ms"], plain_ms=kv_row["plain_ms"],
                    bound_ms=kv_row["bound_ms"], bound_by=kv_row["bound_by"],
                    library_ms=kv_row["library_ms"])]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
