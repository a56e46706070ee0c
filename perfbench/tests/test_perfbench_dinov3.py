"""The DINOv3 ViT-H+/16 slow tier of the benchmark, on the CPU.

The tier's plain reference (``perfbench/reference/dinov3.py``) against the
program's model at SMOKE widths and at the published widths cut to one
layer, on the benchmark's own weights; one frame's operations against the
analytic count; the configuration found by name at the published widths;
and a whole run of the cascade with this slow tier at SMOKE widths.
``smoke.py`` keys its SMOKE tiers by the first configurations' kinds, so
the DINOv3 SMOKE widths are here.
"""
from __future__ import annotations

import copy

import torch

from perfbench import harness
from perfbench.counts import frame_flops
from perfbench.tests import smoke
from perfbench.tiers import tier_module
from perfbench.weights import draw, sub_seed

CELL = "dinov3h-uplink-40mbps"
SMOKE = {"kind": "dinov3", "name": "dinov3-smoke", "img_res": 32, "patch": 8, "n_layers": 2, "d_model": 64,
         "n_heads": 4, "d_ff": 128, "n_registers": 2, "rope_theta": 100.0, "n_classes": 10}
TIER = tier_module("dinov3")


def _full() -> dict:
    return harness.load_cell(CELL)[2]["slow"]


def _both(cfg: dict, n: int, seed: int):
    state = draw(TIER.leaves(cfg), sub_seed(seed, 2), "cpu")
    model = TIER.port(cfg, "cpu")
    model.load_state_dict(state)
    x = torch.randn(n, cfg["img_res"], cfg["img_res"], 3, generator=torch.Generator().manual_seed(seed % 2**31))
    with torch.inference_mode():
        return model(x), TIER.reference(cfg)(state, x)


def test_reference_matches_port_at_smoke_widths():
    got, ref = _both(SMOKE, 6, 2**33 + 5)
    assert got.shape == ref.shape == (6, 10)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_reference_matches_port_at_published_widths_one_layer():
    got, ref = _both({**_full(), "n_layers": 1}, 1, 7)
    assert got.shape == (1, 1000)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_frame_flops_match_the_analytic_count():
    c = _full()
    d, ff, L, H = c["d_model"], c["d_ff"], c["n_layers"], c["n_heads"]
    S, P = (c["img_res"] // c["patch"]) ** 2 + 1 + c["n_registers"], (c["img_res"] // c["patch"]) ** 2
    products = L * 2 * S * (4 * d * d + 3 * d * ff)  # qkv, o, gate, up, down
    attention = L * 4 * S * S * d
    stem_head = 2 * P * c["patch"] ** 2 * 3 * d + 2 * d * c["n_classes"]
    analytic = products + attention + stem_head
    assert abs(analytic / 344.2e9 - 1) < 1e-3
    assert abs(frame_flops(TIER, c) / analytic - 1) <= 0.01
    assert TIER.attention_calls(c, 10) == [(10, 201, 201, 20, 64)] * 32
    assert TIER.kernels(c) == {"flash_attention": 32}


def test_config_loads_at_published_widths():
    bench, cell, config, traffic = harness.load_cell(CELL)
    assert cell["config"] == config["name"] == "cbo-r50-dinov3h" and cell["chips"] == 1
    assert config["reduced"] == [] and traffic["bw_mbps"] == 40.0
    s = config["slow"]
    assert (s["n_layers"], s["d_model"], s["n_heads"], s["d_ff"], s["n_registers"], s["patch"]) == \
        (32, 1280, 20, 5120, 4, 16)
    deit = harness.load_json(harness.ROOT / "perfbench" / "configs" / "cbo-r50-deitb.json")
    for key in ("fast", "serve", "fabric", "math", "mfu"):
        assert config[key] == deit[key], key
    assert set(config["limits"]) == set(deit["limits"])
    assert set(config["limits_why"]) == set(config["limits"])
    assert {k: v for k, v in config["limits"].items() if k != "slow_logits"} == \
        {k: v for k, v in deit["limits"].items() if k != "slow_logits"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, "per_layer")} == \
        {m["name"] for m in bench["per_layer"]}


def test_a_run_at_smoke_widths_is_correct():
    _, _, config, _ = harness.load_cell(CELL)
    cfg = copy.deepcopy(config)
    cfg.update(fast=dict(smoke.FAST), slow=dict(SMOKE), limits=dict(smoke.LIMITS))
    cfg["serve"]["resolutions"] = smoke.RESOLUTIONS
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    out = harness.run(cfg, smoke.traffic("uplink-40mbps"), bench["per_layer"], seed=2**31 + 99, seconds=1.0,
                      trace=True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["checks"]["slow_logits"]["value"] is not None
    assert {"host_rest_ms", "plan_ms", "fabric_ms", "fast_ms", "slow_ms"} <= set(out["metrics"])
