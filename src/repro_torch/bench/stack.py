"""The paper's two-tier stack on synthetic video (port of the stack half
of ``benchmarks/common.py``).

  * slow tier: the larger ResNet, trained resolution-robust on the
    synthetic video dataset (it plays ResNet-152 on the server);
  * fast tier: the small ResNet, then int4 per-tensor QDQ (it plays
    AlexNet on the NPU: lower capacity and lower precision);
  * both trained with the port's ``Trainer``, with the reference's data,
    learning rates, seeds and step counts.

``build_stack(device)`` trains both tiers, fits Platt on the fast tier's
confidences and measures accuracy by resolution.  It keeps no cache: every
call trains.  Each tier's weights are drawn by a CPU generator seeded as
the reference seeds its init (the draws are the port's, not
``jax.random``'s), so the card and the CPU start from the same weights.
"""
from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ResNetConfig
from repro_torch.core.calibration import PlattCalibrator
from repro_torch.core.cascade import degrade_resolution
from repro_torch.core.confidence import max_softmax
from repro_torch.data.pipeline import DeterministicPipeline, PipelineConfig, image_batch_fn
from repro_torch.data.video import VideoDataConfig, make_dataset
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.transformer import ParallelPlan
from repro_torch.quant.quantize import qdq_tree
from repro_torch.train import optim
from repro_torch.train.trainer import TrainConfig, Trainer

DATA_CFG = VideoDataConfig(
    n_classes=10, img_res=32, frames_per_video=12, noise_floor=0.3,
    class_difficulty=tuple(float(x) for x in np.clip(np.linspace(0.25, 1.05, 10), 0, 1)),
)
FAST_CFG = ResNetConfig(name="fast-tier", img_res=32, depths=(1,), width=6, n_classes=10)
SLOW_CFG = ResNetConfig(name="slow-tier", img_res=32, depths=(2, 2), width=48, n_classes=10)
RESOLUTIONS = (8, 12, 18, 24, 32)  # the paper's 45..224 ladder, scaled to 32 px
# NPU numerics: int4 per-tensor QDQ, the crude low-bit regime of 2019-era
# NPU compilers (per-channel int8 is nearly lossless on this stack)
NPU_QUANT = dict(bits=4, axis=None)
BATCH = 128  # training batch
EVAL_BATCH = 256


@dataclass
class TierStack:
    fast_params: torch.nn.Module  # the int4 fast tier
    slow_params: torch.nn.Module
    platt: PlattCalibrator
    acc_fast: float
    acc_slow: float
    acc_server_by_res: tuple
    calib: dict  # calibration split: conf/correct/logits/labels
    test: dict  # test split: frames/labels/video_id
    fast_params_fp: torch.nn.Module = None  # unquantized fast tier (the Compress baseline)
    train_log: dict = field(default_factory=dict)  # tier -> {"losses", "steps", "seconds"}

    def fast_forward(self, images):
        return self.fast_params(images)

    def slow_forward(self, images):
        return self.slow_params(images)


def init_tier(cfg: ResNetConfig, seed: int, device=None) -> torch.nn.Module:
    """The tier's weights drawn on the CPU from ``seed``, on ``device``."""
    return api.build(cfg, ParallelPlan(remat=False)).init(torch.Generator().manual_seed(seed), device=device)


def res_augment_fn(base_fn):
    """The slow tier sees degraded uploads in deployment (paper Fig. 10): the
    first half of each batch is degraded to one resolution of the ladder,
    drawn from the batch's rng (``common.py:73-84``)."""

    def batch_fn(rng, idx):
        b = base_fn(rng, idx)
        r = RESOLUTIONS[int(rng.integers(len(RESOLUTIONS)))]
        n_aug = len(idx) // 2
        aug = degrade_resolution(torch.as_tensor(b["images"][:n_aug]), r)
        return {"images": np.concatenate([aug.numpy(), b["images"][n_aug:]]), "labels": b["labels"]}

    return batch_fn


def _train_tier(cfg: ResNetConfig, data, n_steps: int, lr: float, seed: int, *, res_augment: bool = False,
                device=None, model=None):
    """Train one tier (``model``, else drawn from ``seed``) for ``n_steps`` at
    batch 128 with AdamW(lr, weight decay 1e-4); returns the trainer, whose
    ``model`` is the trained tier.  The trainer's final checkpoint goes to a
    temporary directory that is removed after."""
    dev = resolve_device(device)
    h = api.build(cfg, ParallelPlan(remat=False))
    model = init_tier(cfg, seed, dev) if model is None else model
    base_fn = image_batch_fn(data)
    batch_fn = res_augment_fn(base_fn) if res_augment else base_fn
    pipe = DeterministicPipeline(PipelineConfig(global_batch=BATCH, seed=seed), batch_fn, len(data["labels"]))
    with tempfile.TemporaryDirectory(prefix=f"ckpt_{cfg.name}_") as tmp:
        tcfg = TrainConfig(n_steps=n_steps, ckpt_every=10**9, ckpt_dir=tmp,
                           log_every=max(n_steps // 4, 1), ocfg=optim.OptimConfig(lr=lr, weight_decay=1e-4))
        trainer = Trainer(tcfg, h.loss, model, pipe, device=dev)
        trainer.run(start_step=0)
    return trainer


@torch.inference_mode()
def _accuracy(forward, model, frames, labels, bs: int = EVAL_BATCH):
    """(accuracy, host logits) of ``forward(model, x)`` over ``frames`` in
    batches of ``bs`` on the model's device."""
    dev = next(model.parameters()).device
    logits = [forward(model, torch.as_tensor(frames[i:i + bs], device=dev)).float().cpu().numpy()
              for i in range(0, len(labels), bs)]
    logits = np.concatenate(logits)
    return int((np.argmax(logits, -1) == labels).sum()) / len(labels), logits


@torch.inference_mode()
def slow_preds_at(model, frames, res: int, bs: int = EVAL_BATCH) -> np.ndarray:
    """The slow tier's predictions on ``frames`` degraded to ``res`` px."""
    dev = next(model.parameters()).device
    return np.concatenate([model(degrade_resolution(torch.as_tensor(frames[i:i + bs], device=dev), res))
                           .argmax(-1).cpu().numpy() for i in range(0, len(frames), bs)])


def quantized_tier(model: torch.nn.Module, cfg: ResNetConfig) -> torch.nn.Module:
    """A copy of ``model`` with ``NPU_QUANT`` QDQ weights."""
    out = api.build(cfg, ParallelPlan(remat=False)).init(None, device=next(model.parameters()).device)
    out.load_state_dict(qdq_tree(model.state_dict(), **NPU_QUANT))
    return out


def build_stack(device=None, verbose: bool = True) -> TierStack:
    """Train both tiers on ``make_dataset(DATA_CFG, 360, seed=0)`` (700
    steps of the slow tier at lr 3e-3, seed 0, resolution-augmented; 500 of
    the fast tier at lr 4e-3, seed 1), quantize the fast tier, fit Platt on
    its confidences over the calibration split (120 videos, seed 1) and
    measure both tiers' accuracy there, the slow tier's at each resolution."""
    dev = resolve_device(device)
    train = make_dataset(DATA_CFG, 360, seed=0)
    calib_d = make_dataset(DATA_CFG, 120, seed=1)
    test = make_dataset(DATA_CFG, 120, seed=2)
    log = {}

    def train_tier(name, *args, **kw):
        if verbose:
            print(f"[stack] training {name} tier ...", flush=True)
        t0 = time.perf_counter()
        trainer = _train_tier(*args, device=dev, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log[name] = {"losses": list(trainer.losses), "steps": args[2], "seconds": time.perf_counter() - t0}
        return trainer.model

    slow = train_tier("slow", SLOW_CFG, train, 700, 3e-3, 0, res_augment=True)
    fast_fp = train_tier("fast", FAST_CFG, train, 500, 4e-3, 1)
    fast = quantized_tier(fast_fp, FAST_CFG)
    fwd = api.build(FAST_CFG).forward

    acc_fast, fast_logits = _accuracy(fwd, fast, calib_d["frames"], calib_d["labels"])
    acc_slow, _ = _accuracy(fwd, slow, calib_d["frames"], calib_d["labels"])
    conf = max_softmax(torch.as_tensor(fast_logits)).numpy()
    correct = (np.argmax(fast_logits, -1) == calib_d["labels"]).astype(float)
    platt = PlattCalibrator.fit(conf, correct)
    acc_by_res = tuple(float((slow_preds_at(slow, calib_d["frames"], r) == calib_d["labels"]).mean())
                       for r in RESOLUTIONS)
    stack = TierStack(
        fast_params=fast, slow_params=slow, platt=platt, acc_fast=acc_fast, acc_slow=acc_slow,
        acc_server_by_res=acc_by_res,
        calib={"conf": conf, "correct": correct, "logits": fast_logits, "labels": calib_d["labels"],
               "frames": calib_d["frames"]},
        test=test, fast_params_fp=fast_fp, train_log=log)
    if verbose:
        print(f"[stack] fast(int4)={acc_fast:.3f} slow={acc_slow:.3f} acc_by_res={np.round(acc_by_res, 3)}",
              flush=True)
    return stack
