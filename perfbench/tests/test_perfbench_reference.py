"""The benchmark's plain reference against the program, on the CPU.

The reference must agree with the program at the SMOKE widths on the
benchmark's own weights, and at the published widths on one frame; its
steps around the models (int8 quantize-dequantize, Platt confidence,
degrade, gate) must agree bit for bit or to float rounding.  The frozen
frame generator equals the program's.  No module of the benchmark
imports JAX or the JAX package, and the reference imports nothing of the
program.
"""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.counts import frame_flops
from perfbench.reference import cascade as ref_cascade
from perfbench.tests import smoke
from perfbench.tiers import tier_module
from perfbench.video import VideoDataConfig, make_dataset
from perfbench.weights import draw, sub_seed

BENCH = Path(__file__).resolve().parents[1]
FULL = {"resnet": dict(name="resnet-50", img_res=224, depths=[3, 4, 6, 3], width=64, n_classes=1000),
        "deit": dict(name="deit-b", img_res=224, patch=16, n_layers=12, d_model=768, n_heads=12, d_ff=3072,
                     n_classes=1000),
        "swin": dict(name="swin-b", img_res=224, patch=4, window=7, depths=[2, 2, 18, 2],
                     dims=[128, 256, 512, 1024], n_classes=1000)}
SMOKE = {"resnet": smoke.FAST, **smoke.SLOW}
# published multiply-adds a 224 px frame (the source papers), times two
PUBLISHED_FLOPS = {"resnet": 2 * 4.1e9, "deit": 2 * 17.6e9, "swin": 2 * 15.4e9}


def _both(kind: str, cfg: dict, n: int, seed: int):
    tier = tier_module(kind)
    state = draw(tier.leaves(cfg), sub_seed(seed, 1), "cpu")
    model = tier.port(cfg, "cpu")
    model.load_state_dict(state)
    x = torch.randn(n, cfg["img_res"], cfg["img_res"], 3, generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        return model(x), tier.reference(cfg)(state, x)


@pytest.mark.parametrize("kind", ["resnet", "deit", "swin"])
def test_reference_matches_port_at_smoke_widths(kind):
    got, ref = _both(kind, SMOKE[kind], 6, 2**33 + 5)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("kind", ["resnet", "deit", "swin"])
def test_reference_matches_port_at_published_widths(kind):
    got, ref = _both(kind, FULL[kind], 1, 7)
    assert got.shape == (1, 1000)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("kind", ["resnet", "deit", "swin"])
def test_frame_flops_near_published(kind):
    flops = frame_flops(tier_module(kind), FULL[kind])
    assert abs(flops / PUBLISHED_FLOPS[kind] - 1) <= 0.10


def test_qdq_bit_equal_to_program():
    from repro_torch.quant.quantize import qdq_tree

    tier = tier_module("resnet")
    state = draw(tier.leaves(smoke.FAST), 11, "cpu")
    mine, theirs = ref_cascade.qdq(state), qdq_tree(state)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
    assert not torch.equal(mine["stem.w"], state["stem.w"])


def test_platt_confidence_matches_calib_gate_plain_version():
    from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref

    logits = torch.randn(64, 1000, generator=torch.Generator().manual_seed(3)) * 3
    conf, _ = calib_gate_ref(logits, -20.0, 5.0, 0.0)
    assert float((ref_cascade.platt_confidence(logits, -20.0, 5.0) - conf.double()).abs().max()) < 1e-6


@pytest.mark.parametrize("res", [45, 90, 134, 179, 224])
def test_degrade_bit_equal_to_program(res):
    from repro_torch.core.cascade import degrade_resolution

    x = torch.randn(3, 224, 224, 3, generator=torch.Generator().manual_seed(res))
    assert torch.equal(ref_cascade.degrade(x, res), degrade_resolution(x, res))


@pytest.mark.parametrize("seed", range(4))
def test_gate_matches_program(seed):
    from repro_torch.serving.events import select_escalations

    rng = np.random.default_rng(seed)
    S, b = 8, 16
    conf = rng.choice(np.linspace(0.1, 0.9, 9), size=(S, b)).astype(np.float32)  # ties
    valid = rng.random((S, b)) < 0.9
    theta = rng.uniform(0, 1, S)
    cap = rng.integers(0, 6, S)
    s_ref, j_ref = ref_cascade.gate(np.where(valid, conf, np.inf), theta, cap, valid)
    s_got, j_got = select_escalations(np.where(valid, conf, np.inf), theta, cap)
    assert np.array_equal(s_ref, s_got) and np.array_equal(j_ref, j_got)


@pytest.mark.parametrize("traffic", ["uplink-40mbps", "uplink-5mbps"])
@pytest.mark.parametrize("seed", [2**32 + 5, 7])
def test_replay_matches_program_planner_and_fabric(traffic, seed):
    """The reference's plan, gate and fabric equal the program's, bit for
    bit, over whole clips of a cell's traffic, on confidences that span
    the ladder (stand-in tiers with random logits, 4 px frames)."""
    from repro_torch.serving import engine
    from perfbench import harness
    from perfbench.reference.fleet import Replay

    cfg = harness.load_json(BENCH / "configs" / "cbo-r50-deitb.json")
    tr = harness.load_json(BENCH / "traffic" / f"{traffic}.json")
    bench = harness.Bench(cfg, tr, seed, device="cpu")
    bench.serve = bench.serve_config()
    S, N, V = tr["streams"], tr["frames_per_stream"], cfg["fast"]["n_classes"]
    g = torch.Generator().manual_seed(seed % 2**31)

    def logits(x):
        return torch.randn(x.shape[0], V, generator=g) * torch.rand(x.shape[0], 1, generator=g) * 12

    for clip in range(2):
        confs, recs = [], []
        fast_pass = engine.fast_pass

        def kept(*a, **kw):
            preds, conf = fast_pass(*a, **kw)
            confs.append(conf.numpy().reshape(S, -1))
            return preds, conf

        server = engine.MultiStreamServer(bench.serve, logits, logits, None, None, n_streams=S,
                                          fabric=bench.fabric(clip), policy="cbo", backend="numpy", device="cpu")
        server.round_hook = recs.append
        engine.fast_pass = kept
        try:
            server.process_streams(np.zeros((S, N, 4, 4, 3), np.float32))
        finally:
            engine.fast_pass = fast_pass
        replay = Replay(cfg, tr, bench.uplink_seeds(clip))
        n_esc = 0
        for rec, conf in zip(recs, confs):
            want = replay.round(rec["start"], rec["valid"], conf)
            for key in ("theta", "cap", "res_idx", "esc", "ok", "lat"):
                assert np.array_equal(rec[key], want[key]), (clip, rec["start"], key)
            n_esc += int(rec["esc"].sum())
        assert n_esc > 0 and len(recs) == N // cfg["serve"]["batch_size"]


def test_frozen_generator_bit_equal_to_program():
    from repro_torch.data import video

    for cfg in (VideoDataConfig(n_classes=1000, img_res=224, frames_per_video=16),
                VideoDataConfig(n_classes=10, img_res=32, frames_per_video=16)):
        mine = make_dataset(cfg, 2, seed=sub_seed(2**40 + 1, 3))
        theirs = video.make_dataset(video.VideoDataConfig(**cfg.__dict__), 2, seed=sub_seed(2**40 + 1, 3))
        for k in mine:
            assert np.array_equal(mine[k], theirs[k]), k


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    modules = sorted(BENCH.rglob("*.py"))
    assert len(modules) > 20
    for path in modules:
        found = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not found, f"{path.relative_to(BENCH)} imports {found}"
        if "reference" in path.relative_to(BENCH).parts:
            assert "repro_torch" not in _imports(path), f"{path.relative_to(BENCH)} imports the program"


def test_import_check_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.models\nfrom repro.core import cascade\nimport jax.numpy as jnp\n")
    assert _imports(p) == {"repro_torch", "repro", "jax"}
