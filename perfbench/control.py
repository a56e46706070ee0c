"""Readings for the limits of the output check, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--out FILE]

For each seed, one process-local run of the cell (set-up, a short window
at the cell's own load, the program freed), then the reference's
outputs of the sampled rounds and the readings of two sides against
them: the program's, and the control's (the reference one precision
below the configuration's, in the program's place).  One JSON line a
seed on standard output, and in ``--out`` when given.  The limits in a
configuration lie between the largest program reading and the smallest
control reading.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    _, cell, config, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            bench = harness.Bench(config, traffic, seed)
            bench.setup()
            bench.window(args.seconds, traffic["sample_clips"])
            bench.free_program()
            sides = bench.judge(control=True)
            line = json.dumps({"workload": args.workload, "seed": seed, "rounds": len(bench.sampled_rounds()),
                               "escalated": int(sum(r.esc.sum() for r in bench.sampled_rounds())),
                               "seconds": time.perf_counter() - t0, **sides})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del bench, sides
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
