"""Small configurations of the benchmark's cells for the CPU tests: the
program's SMOKE widths at 32 px, 3 streams of 32 frames."""
from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RESOLUTIONS = [8, 12, 18, 24, 32]
SLOW = {"deit": {"kind": "deit", "name": "deit-smoke", "img_res": 32, "patch": 8, "n_layers": 2, "d_model": 64,
                 "n_heads": 4, "d_ff": 128, "n_classes": 10},
        "swin": {"kind": "swin", "name": "swin-smoke", "img_res": 32, "patch": 2, "window": 4, "depths": [1, 2],
                 "dims": [32, 64], "n_classes": 10}}
FAST = {"kind": "resnet", "name": "resnet-smoke", "img_res": 32, "depths": [1, 1], "width": 16, "n_classes": 10,
        "quant_bits": 8}
LIMITS = {"fast_logits": 1e-4, "conf": 1e-6, "slow_logits": 1e-4, "served": 0, "plan": 0, "gate": 0,
          "fabric": 0, "merge": 0}


def config(name: str) -> dict:
    """A configuration file of the benchmark cut to the SMOKE widths."""
    with open(ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["fast"] = dict(FAST)
    cfg["slow"] = dict(SLOW[cfg["slow"]["kind"]])
    cfg["serve"]["resolutions"] = RESOLUTIONS
    cfg["limits"] = dict(LIMITS)
    return cfg


def traffic(name: str, streams: int = 3, frames: int = 64) -> dict:
    with open(ROOT / "perfbench" / "traffic" / f"{name}.json") as f:
        tr = json.load(f)
    tr.update(streams=streams, frames_per_stream=frames)
    return tr
