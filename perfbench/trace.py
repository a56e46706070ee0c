"""Reading one ``torch.profiler`` trace of a slice of whole clips.

The slice is the host range ``perfbench.slice``.  Device time is the union
of the device intervals inside it (kernels, copies and sets; overlapping
ones count once), not a sum of kernel times.  Each idle gap between them
is named by the innermost range the host was in when it opened: a tier,
the planner, the fabric, or else ``serving_loop`` (the engine's own
Python and numpy between them).  A trace with no device events, or in
which a hand-written kernel launched another number of times than the
calls that the slice made require, is not read: ``read`` returns None.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import torch

from perfbench.counts import attention_bound_s

SLICE = "perfbench.slice"
RANGES = {"perfbench.fast": "fast_tier", "perfbench.slow": "slow_tier", "perfbench.plan": "plan",
          "perfbench.transmit": "fabric"}
TOP = 10


@dataclass
class Slice:
    window_s: float
    busy_s: float
    flops: float
    flash_s: float
    attention_bound_s: float
    device_ops: list
    idle_gaps: list


def activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[float, float]], t0: float, t1: float) -> list[tuple[float, float]]:
    out, at = [], t0
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return out


def name_gap(start: float, ranges) -> str:
    inside = [(s, label) for s, e, label in ranges if s <= start < e]
    return max(inside)[1] if inside else "serving_loop"


def read(prof, rounds, calls, expect, flops, slow_tier, slow_cfg) -> Slice | None:
    """``rounds``: the slice's rounds; ``calls``: (name, round, frames,
    start, end) of each tier, planner and fabric call in it; ``expect``:
    {kernel name part: ("round" | "fast" | "slow", launches a round or
    call)}; ``flops``: one frame's operations of each tier."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == SLICE and e.device_type == DeviceType.CPU]
    if not window:
        return None
    t0, t1 = window[0].time_range.start, window[0].time_range.end
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("perfbench.")]
    if not dev:
        return None
    n_calls = {"round": len(rounds), "fast": sum(c[0] == "fast" for c in calls),
               "slow": sum(c[0] == "slow" for c in calls)}
    for part, (unit, each) in expect.items():
        if sum(part in name for name, _, _ in dev) != each * n_calls[unit]:
            return None
    busy = union((max(s, t0), min(e, t1)) for _, s, e in dev if e > t0 and s < t1)
    busy_us = sum(e - s for s, e in busy)
    ranges = [(e.time_range.start, e.time_range.end, RANGES[e.name]) for e in events
              if e.device_type == DeviceType.CPU and e.name in RANGES]
    idle = defaultdict(float)
    for s, e in gaps(busy, t0, t1):
        idle[name_gap(s, ranges)] += (e - s) / 1e6
    by_op = defaultdict(float)
    for name, s, e in dev:
        by_op[name[:120]] += (e - s) / 1e6
    slow_sizes = [c[2] for c in calls if c[0] == "slow"]
    fast_frames = sum(c[2] for c in calls if c[0] == "fast")
    bound = sum(attention_bound_s(*shape) for n in slow_sizes for shape in slow_tier.attention_calls(slow_cfg, n))
    return Slice(window_s=(t1 - t0) / 1e6, busy_s=busy_us / 1e6,
                 flops=float(flops["fast"] * fast_frames + flops["slow"] * sum(slow_sizes)),
                 flash_s=sum(e - s for name, s, e in dev if "flash_attention" in name) / 1e6,
                 attention_bound_s=bound,
                 device_ops=sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:TOP],
                 idle_gaps=sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:TOP])
