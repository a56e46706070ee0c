"""Run one cell of the benchmark on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, the traced window and the breakdown), and each number
of the output check beside its limit as the last lines of standard
error.  Exits non-zero without a result where there is no CUDA device, or
fewer than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or
the JAX package has been loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    bench, cell, config, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA device(s); torch.cuda.is_available()"
              f" is {torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    group = "per_layer" if args.trace else "end_to_end"
    result = harness.run(config, traffic, harness.cell_metrics(bench, args.workload, group), seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"run.py: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
