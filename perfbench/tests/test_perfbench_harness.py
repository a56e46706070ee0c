"""The harness as data, on the CPU: every configuration, traffic mix and
metric found by name; the metric arithmetic on synthetic records; a cell
and a metric added as files; runs at the SMOKE widths; the command with
no card."""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness, trace
from perfbench.counts import PEAK_HBM_BYTES, PEAK_TF32_FLOPS, attention_bound_s
from perfbench.tests import smoke
from perfbench.weights import sub_seed

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    bench, entry, config, traffic = harness.load_cell(cell)
    assert entry["config"] == config["name"]
    assert config["reduced"] == [] and config["limits"]
    assert {"streams", "frames_per_stream", "bw_mbps", "n_cells", "sample_clips"} <= traffic.keys()
    for group in ("end_to_end", "per_layer"):
        metrics = harness.cell_metrics(bench, cell, group)
        assert metrics
        for m in metrics:
            assert callable(harness.metric_reader(m["name"]))


def test_benchmark_file_names_its_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == harness.load_json(ROOT / c["file"])["reduced"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in BENCH["end_to_end"]} == {"frames_per_s", "round_ms_p95", "setup_s"}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "frames_per_s"
        assert set(m["workloads"]) <= set(CELLS)


def _record(walls, extra=None):
    rounds = [{"wall_ms": w, "n_frames": 128, **(extra or {})} for w in walls]
    return harness.Record(setup_s=12.5, window_s=sum(walls) / 1e3, rounds=rounds)


def read(name, rec):
    return harness.metric_reader(name)(rec)


def test_p95_over_every_round_and_rate_over_the_window():
    walls = list(np.arange(1, 201, dtype=float))  # 200 rounds
    rec = _record(walls)
    assert read("round_ms_p95", rec) == pytest.approx(np.percentile(walls, 95))
    assert read("round_ms_p95", rec) > statistics.median(walls)
    assert read("frames_per_s", rec) == pytest.approx(200 * 128 / (sum(walls) / 1e3))
    assert read("setup_s", rec) == 12.5
    assert read("fast_ms", rec) is None and read("idle_share", rec) is None


def test_host_rest_is_wall_less_the_layers():
    rec = _record([100.0, 80.0], {"fast_ms": 28.0, "slow_ms": 10.0, "plan_ms": 2.0, "fabric_ms": 1.0})
    assert read("host_rest_ms", rec) == pytest.approx(90.0 - 41.0)
    assert read("slow_ms", rec) == 10.0 and read("plan_ms", rec) == 2.0 and read("fabric_ms", rec) == 1.0


def test_idle_share_is_a_union_of_intervals():
    busy = trace.union([(0, 10), (5, 20), (30, 40), (35, 36)])  # a kernel and an overlapping copy
    assert busy == [(0, 20), (30, 40)]
    assert trace.gaps(busy, 0, 50) == [(20, 30), (40, 50)]
    sl = trace.Slice(window_s=50e-6, busy_s=30e-6, flops=0.0, flash_s=0.0, attention_bound_s=0.0,
                     device_ops=[], idle_gaps=[])
    rec = harness.Record(slice=sl)
    assert read("idle_share", rec) == pytest.approx(40.0)
    assert read("mfu", rec) is None and read("flash_roofline", rec) is None  # nothing to read, never 0


def test_mfu_and_flash_roofline_formulas():
    sl = trace.Slice(window_s=2.0, busy_s=1.0, flops=0.5 * 2.0 * PEAK_TF32_FLOPS, flash_s=4e-3,
                     attention_bound_s=1e-3, device_ops=[], idle_gaps=[])
    rec = harness.Record(slice=sl)
    assert read("mfu", rec) == pytest.approx(50.0)
    assert read("flash_roofline", rec) == pytest.approx(25.0)
    B, S, H, D = 16, 198, 12, 64
    flops_s = 4 * B * H * S * S * D / PEAK_TF32_FLOPS
    bytes_s = 4 * B * S * H * D * 4 / PEAK_HBM_BYTES
    assert attention_bound_s(B, S, S, H, D) == pytest.approx(max(flops_s, bytes_s))
    assert bytes_s > flops_s  # f32 DeiT-B attention is bound by its bytes


class _Ev(SimpleNamespace):
    pass


def _events(names_and_spans, device_type):
    return [_Ev(name=n, time_range=SimpleNamespace(start=s, end=e), device_type=device_type)
            for n, s, e in names_and_spans]


def test_trace_reader_names_gaps_and_refuses_lost_kernels():
    from torch.autograd import DeviceType

    cpu = _events([(trace.SLICE, 0, 1000), ("perfbench.fast", 0, 300), ("perfbench.plan", 300, 400),
                   ("perfbench.slow", 400, 600)], DeviceType.CPU)
    dev = _events([("void calib_gate_kernel<0, 4>", 280, 310), ("conv", 10, 280), ("Memcpy HtoD", 0, 20),
                   ("flash_attention_kernel<64>", 450, 500), ("flash_attention_kernel<64>", 520, 610),
                   ("perfbench.slow", 400, 700)], DeviceType.CUDA)
    prof = SimpleNamespace(events=lambda: cpu + dev)
    calls = [("fast", 0, 128, 0, 0), ("slow", 0, 10, 0, 0)]
    expect = {"calib_gate": ("round", 1), "flash_attention": ("slow", 2)}
    tier = SimpleNamespace(attention_calls=lambda cfg, n: [(n, 198, 198, 12, 64)] * 2)
    sl = trace.read(prof, [{}], calls, expect, {"fast": 8.0, "slow": 35.0}, tier, {})
    assert sl.window_s == pytest.approx(1e-3) and sl.busy_s == pytest.approx(450e-6)
    assert sl.flash_s == pytest.approx(140e-6) and sl.flops == 8.0 * 128 + 35.0 * 10
    gaps = dict(sl.idle_gaps)  # each gap named by the host range it opened in
    assert gaps["plan"] == pytest.approx(140e-6) and gaps["slow_tier"] == pytest.approx(20e-6)
    assert gaps["serving_loop"] == pytest.approx(390e-6) and "fast_tier" not in gaps
    assert sl.attention_bound_s == pytest.approx(2 * attention_bound_s(10, 198, 198, 12, 64))
    lost = SimpleNamespace(events=lambda: cpu + dev[1:])  # the gate's launch missing
    assert trace.read(prof=lost, rounds=[{}], calls=calls, expect=expect, flops={"fast": 1, "slow": 1},
                      slow_tier=tier, slow_cfg={}) is None
    empty = SimpleNamespace(events=lambda: cpu)
    assert trace.read(empty, [{}], calls, expect, {"fast": 1, "slow": 1}, tier, {}) is None


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    (root / "perfbench" / "traffic" / "uplink-1mbps.json").write_text(json.dumps(
        {**harness.load_json(ROOT / "perfbench" / "traffic" / "uplink-5mbps.json"), "bw_mbps": 1.0}))
    (root / "perfbench" / "metrics" / "rounds_n.py").write_text("def read(rec):\n    return len(rec.rounds)\n")
    bench["workloads"].append({"name": "deitb-uplink-1mbps", "config": "cbo-r50-deitb", "traffic": "uplink-1mbps",
                               "chips": 1, "why": "nearly no slow tier"})
    bench["per_layer"].append({"name": "rounds_n", "unit": "rounds", "better": "higher", "source": "host_clock",
                               "layer": "serving loop", "moves": "frames_per_s", "workloads": ["deitb-uplink-1mbps"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, config, traffic = harness.load_cell("deitb-uplink-1mbps", root=root)
    assert traffic["bw_mbps"] == 1.0 and config["name"] == "cbo-r50-deitb"
    names = [m["name"] for m in harness.cell_metrics(bench, "deitb-uplink-1mbps", "per_layer")]
    assert "rounds_n" in names and "flash_roofline" not in names
    assert harness.metric_reader("rounds_n", root=root)(_record([1.0, 2.0])) == 2
    after = {p.relative_to(root): p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # no file that was there changed


def _run_cmd(cwd, *extra):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", str(2**33),
                           "--seconds", "1", "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_command_exits_nonzero_without_a_card():
    proc = _run_cmd(ROOT)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
    assert "CUDA" in proc.stderr


def test_command_exits_nonzero_beside_only_its_own_files(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run_cmd(tmp_path)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_sub_seeds_take_large_seeds():
    seeds = {sub_seed(s, t) for s in (0, 2**31 + 7, 2**40) for t in (1, 2)}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)


@pytest.mark.parametrize("config,traffic_name,trace_on", [("cbo-r50-deitb", "uplink-40mbps", False),
                                                          ("cbo-r50-swinb", "uplink-40mbps", True),
                                                          ("cbo-r50-deitb", "uplink-5mbps", True)])
def test_a_run_at_smoke_widths_is_correct(config, traffic_name, trace_on):
    group = "per_layer" if trace_on else "end_to_end"
    out = harness.run(smoke.config(config), smoke.traffic(traffic_name), BENCH[group], seed=2**31 + 99,
                      seconds=1.0, trace=trace_on, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and list(out["checks"])[-1] == "merge"
    got = set(out["metrics"])
    if trace_on:
        assert {"host_rest_ms", "plan_ms", "fabric_ms", "fast_ms", "slow_ms"} <= got
        assert not got & {"idle_share", "mfu", "flash_roofline"}  # no device trace on the CPU: left out
    else:
        assert got == {"frames_per_s", "round_ms_p95", "setup_s"}
