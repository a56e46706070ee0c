"""The output check must fail a broken program.  A run of a cell at the
SMOKE widths on the CPU (the harness's look for a card skipped), with the
timed path broken underneath, must come out not correct: an answer or a
confidence altered where it is produced, half a batch left out, a state
returned unchanged, the gate or the resolution wrong, the planned
threshold or resolution altered, a reply's landing altered, the uplink's
jitter left out, the served count altered.  The control (the reference
one precision down) must fail too; on the card, at the published widths,
``test_control_fails_on_the_card``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import judge
from perfbench.tests import smoke

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def _run():
    return harness.run(smoke.config("cbo-r50-deitb"), smoke.traffic("uplink-40mbps"), BENCH["end_to_end"],
                       seed=2**32 + 17, seconds=1.0, trace=False, device="cpu")


def _altered_row(forward):
    def broken(self, x):
        y = forward(self, x).clone()
        y[0, 0] += 0.05 * float(y.abs().max())
        return y
    return broken


def _half_batch(forward):
    def broken(self, x):
        y = forward(self, x[: -(-x.shape[0] // 2)])  # the first half, its answers given twice
        return torch.cat([y, y])[: x.shape[0]]
    return broken


def _faults():
    from repro_torch.core import cascade
    from repro_torch.core.netsim import Uplink
    from repro_torch.models.resnet import ResNet
    from repro_torch.models.vit import ViT
    from repro_torch.net import EdgeFabric
    from repro_torch.policy.fleet import FleetRunner
    from repro_torch.serving import engine
    from repro_torch.serving.metrics import AggregateMetrics

    stale = {}

    def stale_fast_pass(*a, **kw):
        preds, conf = cascade_fast_pass(*a, **kw)
        if conf.shape in stale:  # the previous round's confidences, returned unchanged
            conf = stale[conf.shape]
        stale[conf.shape] = conf
        return preds, conf

    def highest_first(conf, theta, cap):
        s, j = select(-np.where(np.isfinite(conf), conf, -np.inf), -np.asarray(theta) * 0 + np.inf, cap)
        return s, j

    def wrong_answer(*a, **kw):
        preds, conf = cascade_fast_pass(*a, **kw)
        preds = preds.clone()
        preds[0] = (preds[0] + 1) % 10
        return preds, conf

    def half_res(images, res):
        return degrade(images, max(int(res) // 2, 1))

    def miscounted(self, n_frames, off, miss, correct, lat, valid):
        return update(self, n_frames, off, miss, np.asarray(correct) + 1, lat, valid)

    def scaled_conf(logits, a, b, theta):
        conf, gate = calibrated_gate(logits, a, b, theta)
        return conf * 1.01, gate

    def lower_resolution(self, *a, **kw):
        batch = plan_all(self, *a, **kw)
        batch.resolution = np.maximum(batch.resolution - 1, 0)
        return batch

    def lower_threshold(self, *a, **kw):
        batch = plan_all(self, *a, **kw)
        batch.theta = batch.theta * 0.99
        return batch

    def early_reply(self, *a, **kw):
        lands = transmit(self, *a, **kw)
        return lands - 1e-3 * (np.arange(len(lands)) == 0)

    def steady_uplink(self, t):  # the channel's jitter left out
        return np.full(np.shape(t), self.bandwidth_bps)

    cascade_fast_pass, select = cascade.fast_pass, engine.select_escalations
    plan_all, transmit = FleetRunner.plan_all, EdgeFabric.transmit
    degrade, update, calibrated_gate = cascade.degrade_resolution, AggregateMetrics.update_round, cascade.calibrated_gate
    return {
        "fast answer altered": (ResNet, "forward", _altered_row(ResNet.forward)),
        "slow answer altered": (ViT, "forward", _altered_row(ViT.forward)),
        "fast half batch": (ResNet, "forward", _half_batch(ResNet.forward)),
        "slow half batch": (ViT, "forward", _half_batch(ViT.forward)),
        "confidences unchanged": (cascade, "fast_pass", stale_fast_pass),
        "fast class altered": (cascade, "fast_pass", wrong_answer),
        "confidence altered": (cascade, "calibrated_gate", scaled_conf),
        "gate highest first": (engine, "select_escalations", highest_first),
        "resolution halved": (cascade, "degrade_resolution", half_res),
        "plan resolution lowered": (FleetRunner, "plan_all", lower_resolution),
        "plan threshold lowered": (FleetRunner, "plan_all", lower_threshold),
        "fabric reply early": (EdgeFabric, "transmit", early_reply),
        "fabric jitter left out": (Uplink, "bandwidth_at", steady_uplink),
        "served count altered": (AggregateMetrics, "update_round", miscounted),
    }


FAULTS = list(_faults())


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    owner, attr, broken = _faults()[fault]
    monkeypatch.setattr(owner, attr, broken)
    out = _run()
    assert not out["correct"], out["checks"]
    failed = [k for k, v in out["checks"].items() if v["value"] is None or v["value"] > v["limit"]]
    assert failed


def _control(device, config):
    bench = harness.Bench(config, smoke.traffic("uplink-40mbps", 4, 64), 2**31 + 3, device=device)
    bench.setup()
    bench.window(1.0, 2)
    bench.free_program()
    return bench.judge(control=True)


def test_control_fails_on_the_cpu():
    cfg = smoke.config("cbo-r50-deitb")
    cfg["control"] = {"fast": "bf16", "slow": "bf16"}  # TF32 does not exist on the CPU
    sides = _control("cpu", cfg)
    assert judge.verdict(sides["program"], cfg["limits"])[0]
    assert not judge.verdict(sides["control"], cfg["limits"])[0]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["cbo-r50-deitb", "cbo-r50-swinb"])
def test_control_fails_on_the_card(card, config):
    cfg = harness.load_json(harness.ROOT / "perfbench" / "configs" / f"{config}.json")
    sides = _control("cuda", cfg)
    assert judge.verdict(sides["program"], cfg["limits"])[0], sides["program"]
    assert not judge.verdict(sides["control"], cfg["limits"])[0], sides["control"]
