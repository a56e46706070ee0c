#!/usr/bin/env python3
"""The serving loop's spans (``obs.PhaseProfiler``) on one benchmark cell.

    python3 scripts/torch_serving_spans.py --workload <cell> --seed <n> --seconds <s>

Needs an NVIDIA GPU.  Builds the cell as ``perfbench/run.py`` does
(``perfbench.harness.Bench``: weights from the seed, the frame pool, the
warm-up) and hands every server it builds the telemetry of the moment,
then, in one process:

1. the spans' cost: four windows of ``--seconds`` each, untimed as the
   benchmark's untraced run, with ``telemetry=None``, then
   ``Telemetry(record=False, profile=True)`` twice, then ``None`` again;
   each window's ``frames_per_s``, mean and p95 round;
2. one window timed as the benchmark's traced run (the tiers' CUDA
   events, host clocks around the planner and the fabric) with the
   spans on: each span's mean ms a round, the ``syncs`` a round (4 + k
   in a round that escalates at k planned resolutions, else 2: the
   frames are staged, and on the card their copy from pinned memory
   does not block), the ``staged`` rounds a round (1), the round's self
   time against its span, ``wall_ms`` less the round span, and
   ``host_rest_ms`` as the benchmark computes it;
3. profiled clips (``Bench.profile``), with the spans off, on, on, off:
   ``perfbench.trace.read``'s slice as it reads today, and read again
   without the device side of the ``serving.*`` ranges, with each idle
   gap outside the benchmark's ranges named after the innermost
   ``serving.*`` range around its start, and cut at those ranges' edges
   with each piece named after the range over it
   (``serving_loop.<span>``);
4. the spans' own host cost a round, without work, with and without a
   recording ``torch.profiler``.

Prints one JSON object and writes it to ``build/spans/<cell>-<seed>.json``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

RANGE = "serving."


def serve_with(holder):
    """Make every ``MultiStreamServer`` built from now on take
    ``holder[0]`` as its telemetry."""
    from repro_torch.serving import engine

    base = engine.MultiStreamServer

    class Served(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, telemetry=holder[0], **kw)

    engine.MultiStreamServer = Served


def window(bench, seconds: float) -> dict:
    """One window of ``Bench.window`` on a fresh record: its rounds."""
    from perfbench import harness

    bench.record = harness.Record()
    bench.window(seconds, 0)
    rounds = bench.record.rounds
    walls = [r["wall_ms"] for r in rounds]
    return {"rounds": len(rounds), "frames_per_s": bench.record.frames / bench.record.window_s,
            "round_ms_mean": statistics.fmean(walls), "round_ms_p95": float(np.percentile(walls, 95)), "_rounds": rounds}


def span_table(prof, rounds) -> dict:
    """Mean ms a round of each span, syncs and staged rounds a round, and
    the round span against the host clock of the benchmark's round marks."""
    from repro_torch.obs.profile import ROUND

    spans, self_s = prof.spans, prof.self_times()
    n = prof.n_rounds
    per = defaultdict(float)
    roots = []
    for i, sp in enumerate(spans):
        if sp.name == ROUND:
            roots.append((sp.end - sp.start, self_s[i]))
        else:
            per[sp.name] += (sp.end - sp.start) * 1e3
    ms = {name: v / n for name, v in per.items()}
    round_ms = statistics.fmean(r for r, _ in roots) * 1e3
    self_ms = statistics.fmean(s for _, s in roots) * 1e3
    walls = [r["wall_ms"] for r in rounds]
    syncs = prof.counters.get("syncs", {})
    out = {"rounds": n, "rounds_marked": len(rounds), "span_ms": ms,
           "slice_ms": ms.get("slice", 0.0), "h2d_ms": ms.get("h2d", 0.0),
           "issue_ms": ms.get("fast", 0.0) + ms.get("slow", 0.0),
           "wait_ms": ms.get("fast_wait", 0.0) + ms.get("slow_wait", 0.0),
           "loop_ms": ms.get("gate", 0.0) + ms.get("fold", 0.0),
           "host_syncs": sum(syncs.values()) / n,
           "staged": sum(prof.counters.get("staged", {}).values()) / n,
           "round_span_ms": round_ms, "round_self_ms": self_ms, "round_self_share": self_ms / round_ms,
           "wall_ms": statistics.fmean(walls), "wall_less_round_ms": statistics.fmean(walls) - round_ms}
    if rounds and "fast_ms" in rounds[0]:
        out["host_rest_ms"] = statistics.fmean(
            r["wall_ms"] - r["fast_ms"] - r["slow_ms"] - r["plan_ms"] - r["fabric_ms"] for r in rounds)
        for k in ("fast_ms", "slow_ms", "plan_ms", "fabric_ms"):
            out[k] = statistics.fmean(r[k] for r in rounds)
    return out


class _Events:
    """A profile whose ``events()`` are the given ones."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def read_spans(prof, rounds, calls, *rest, read, sink: list):
    """``read`` (``perfbench.trace.read``) without the device side of the
    ``serving.*`` ranges; its idle gaps outside the benchmark's ranges
    named after the innermost ``serving.*`` range go to ``sink``: whole,
    by the range around their start (``idle_gaps_by_start``), and cut at
    the ranges' edges, each piece by the range over it (``idle_gaps``)."""
    from torch.autograd import DeviceType

    from perfbench import trace

    events = prof.events()
    kept = [e for e in events if not (e.device_type == DeviceType.CUDA and e.name.startswith(RANGE))]
    sl = read(_Events(kept), rounds, calls, *rest)
    if sl is None:
        return None
    window = [e for e in kept if e.name == trace.SLICE and e.device_type == DeviceType.CPU][0]
    t0, t1 = window.time_range.start, window.time_range.end
    dev = [(e.time_range.start, e.time_range.end) for e in kept
           if e.device_type == DeviceType.CUDA and not e.name.startswith("perfbench.")]
    busy = trace.union((max(s, t0), min(e, t1)) for s, e in dev if e > t0 and s < t1)
    host = [e for e in kept if e.device_type == DeviceType.CPU]
    bench_ranges = [(e.time_range.start, e.time_range.end, trace.RANGES[e.name]) for e in host
                    if e.name in trace.RANGES]
    loop_ranges = [(e.time_range.start, e.time_range.end, "serving_loop." + e.name[len(RANGE):])
                   for e in host if e.name.startswith(RANGE)]
    by_start, split = defaultdict(float), defaultdict(float)
    edges = sorted({t for s, e, _ in loop_ranges for t in (s, e)})
    for s, e in trace.gaps(busy, t0, t1):
        name = trace.name_gap(s, bench_ranges)
        if name != "serving_loop":
            by_start[name] += (e - s) / 1e6
            split[name] += (e - s) / 1e6
            continue
        by_start[trace.name_gap(s, loop_ranges)] += (e - s) / 1e6
        # no range edge lies inside a piece, so the range at its start covers it
        cuts = [s] + edges[bisect.bisect_right(edges, s):bisect.bisect_left(edges, e)] + [e]
        for a, b in zip(cuts, cuts[1:]):
            split[trace.name_gap(a, loop_ranges)] += (b - a) / 1e6
    ranked = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])  # noqa: E731
    sink.append({"idle_gaps": ranked(split), "idle_gaps_by_start": ranked(by_start),
                 "device_annotations": len(events) - len(kept)})
    return sl


def profiled(bench, holder, tel, modes) -> list:
    """``Bench.profile`` once for each mode (``"off"``/``"on"``): the
    slice as ``trace.read`` reads it today, and read by ``read_spans``."""
    from perfbench import harness, trace
    from repro_torch.obs.profile import ROUND

    readers = {name: harness.metric_reader(name) for name in ("idle_share", "mfu", "flash_roofline")}
    original = trace.read
    out = []
    for mode in modes:
        holder[0] = tel if mode == "on" else None
        tel.profiler.reset()
        sink, today = [], []

        def both(prof, *args):
            today.append(original(prof, *args))
            return read_spans(prof, *args, read=original, sink=sink)

        trace.read = both
        try:
            bench.record.slice = None
            sl = bench.profile()
        finally:
            trace.read = original
        row = {"mode": mode}
        if sl is not None:
            row.update(window_s=sl.window_s, busy_s=sl.busy_s, device_ops=sl.device_ops, **sink[-1],
                       **{name: read(bench.record) for name, read in readers.items()})
            if today[-1] is not None:
                row["as_read_today"] = {"busy_s": today[-1].busy_s, "idle_gaps": today[-1].idle_gaps,
                                        "device_ops": [k for k, _ in today[-1].device_ops]}
            if mode == "on":
                row["round_ms"] = statistics.fmean(
                    sp.end - sp.start for sp in tel.profiler.spans if sp.name == ROUND) * 1e3
        out.append(row)
    holder[0] = None
    return out


def span_cost_us(n_rounds: int) -> float:
    """Host microseconds a round of the loop's spans (the round and its 11
    children) and 10 counts take with no work inside them, under a
    ``torch.profiler`` if one records."""
    from repro_torch.obs import PhaseProfiler

    names = ("slice", "h2d", "fast", "fast_wait", "plan", "gate", "slow", "slow_wait", "transmit", "fold", "hook")
    prof = PhaseProfiler()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        prof.open_round()
        prof.open(names[0])
        for name in names[1:]:
            prof.switch(name)
            prof.count("syncs")
        prof.close()
        prof.close()
    return (time.perf_counter() - t0) / n_rounds * 1e6


def span_costs(device) -> dict:
    """``span_cost_us`` without a profiler, and inside one that traces the
    host and ``device``."""
    import torch

    from perfbench import trace

    off = span_cost_us(20000)
    with torch.profiler.profile(activities=trace.activities(device)):
        on = span_cost_us(500)
    return {"span_round_us": off, "span_round_us_profiled": on}


def measure(config, traffic, *, seed: int, seconds: float, device: str = "cuda") -> dict:
    import torch

    from perfbench import harness
    from repro_torch.obs import PhaseProfiler, Telemetry

    holder = [None]
    serve_with(holder)
    bench = harness.Bench(config, traffic, seed, device=device, timing=False)
    bench.setup()
    setup_s = time.perf_counter() - T_START
    tel = Telemetry(record=False, profile=True, profiler=PhaseProfiler())

    cost = []
    for mode in ("off", "on", "on", "off"):
        holder[0] = tel if mode == "on" else None
        if mode == "on":
            tel.profiler.reset()
        w = window(bench, seconds)
        w.pop("_rounds")
        cost.append({"mode": mode, **w})
    frames = {m: statistics.fmean(c["frames_per_s"] for c in cost if c["mode"] == m) for m in ("off", "on")}
    rmean = {m: statistics.fmean(c["round_ms_mean"] for c in cost if c["mode"] == m) for m in ("off", "on")}

    bench.timing = True
    holder[0] = tel
    tel.profiler.reset()
    w = window(bench, seconds)
    spans = span_table(tel.profiler, w.pop("_rounds"))
    clips = profiled(bench, holder, tel, ("off", "on", "on", "off"))
    cuda = torch.device(device).type == "cuda"
    return {"setup_s": setup_s, "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            **span_costs(torch.device(device)), "cost": cost, "cost_round_ms": rmean["on"] - rmean["off"],
            "cost_frames_per_s_share": frames["on"] / frames["off"] - 1.0,
            "traced_window": {**w, **spans}, "profiled_clips": clips}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("torch_serving_spans.py: needs a CUDA device", file=sys.stderr)
        return 2
    _, _, config, traffic = harness.load_cell(args.workload)
    out = {"workload": args.workload, "seed": args.seed,
           **measure(config, traffic, seed=args.seed, seconds=args.seconds)}
    path = ROOT / "build" / "spans" / f"{args.workload}-{args.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
