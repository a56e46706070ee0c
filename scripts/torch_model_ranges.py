#!/usr/bin/env python3
"""Device time under the models' own ranges (``vit.rope``, ``vit.attn``) in
one benchmark cell.

    python3 scripts/torch_model_ranges.py --workload <cell> --seed <n>

Needs an NVIDIA GPU.  Builds the cell as ``perfbench/run.py`` does
(``perfbench.harness.Bench``: weights from the seed, the frame pool, the
warm-up), then serves one clip twice under ``torch.profiler`` (CPU and
CUDA activities): first with no telemetry, as the benchmark's traced run
serves it, then with ``Telemetry(record=False, profile=True)``, whose
``serving.*`` spans switch the models' ranges on
(``obs.profile.model_range``).  For each clip and range: the host ranges,
their device side (the ``record_function``'s CUDA-side interval), the
kernels that lie inside those intervals with their seconds, and ms a
round.  Prints one JSON object and writes it to
``build/ranges/<cell>-<seed>.json``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from torch_serving_spans import serve_with  # noqa: E402  (this script's folder is on sys.path)

RANGES = ("vit.rope", "vit.attn")


def read(prof, n_rounds: int) -> dict:
    """Each range's host count, device intervals and the kernels inside them."""
    from torch.autograd import DeviceType

    events = prof.events()
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in cuda
                     if e.name not in RANGES and not e.name.startswith(("perfbench.", "serving.")))
    starts = [k[0] for k in kernels]
    out = {"kernels_s": sum(e - s for s, e, _ in kernels) / 1e6, "rounds": n_rounds}
    for name in RANGES:
        ivs = sorted((e.time_range.start, e.time_range.end) for e in cuda if e.name == name)
        by_kernel = defaultdict(float)
        for a, b in ivs:
            for s, e, k in kernels[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
                if e <= b:
                    by_kernel[k[:100]] += (e - s) / 1e6
        inside = sum(by_kernel.values())
        out[name] = {"host_ranges": sum(e.device_type == DeviceType.CPU and e.name == name for e in events),
                     "device_ranges": len(ivs), "device_span_s": sum(b - a for a, b in ivs) / 1e6,
                     "kernel_s": inside, "kernel_ms_a_round": inside * 1e3 / max(n_rounds, 1),
                     "kernels": sorted(([k, v] for k, v in by_kernel.items()), key=lambda kv: -kv[1])[:6]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, trace
    from repro_torch.obs import PhaseProfiler, Telemetry

    if not torch.cuda.is_available():
        print("torch_model_ranges.py: needs a CUDA device", file=sys.stderr)
        return 2
    _, _, config, traffic = harness.load_cell(args.workload)
    holder = [None]
    serve_with(holder)
    bench = harness.Bench(config, traffic, args.seed)
    bench.setup()
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0),
           "setup_s": time.perf_counter() - T_START}
    for mode in ("off", "on"):
        holder[0] = Telemetry(record=False, profile=True, profiler=PhaseProfiler()) if mode == "on" else None
        with torch.profiler.profile(activities=trace.activities(bench.device)) as prof:
            rounds, _, _ = bench.serve_clip(0)
            bench.sync()
        out[mode] = read(prof, len(rounds))
    path = ROOT / "build" / "ranges" / f"{args.workload}-{args.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
