"""Training loop with checkpoint/restart fault tolerance (port of
``repro.train.trainer``).

Eager steps on one device: the loss and its gradients through autograd,
AdamW (``train/optim.py``), a deterministic data pipeline (resume = seek
by step), asynchronous atomic checkpoints, failure injection
(``fail_at_step`` simulates a node crash once; ``run_with_restarts``
recovers from the last checkpoint) and gradient accumulation.

``model`` stands for the reference's parameter tree: the trainer turns on
``requires_grad`` for every parameter, and ``loss_fn(model, batch)`` reads
them through the module.  The state saved is ``{"params", "opt",
"data_step"}``, the reference's, with the parameters by name.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import DeterministicPipeline
from repro_torch.device import resolve_device
from repro_torch.train import optim

F32 = torch.float32


class InjectedFailure(RuntimeError):
    """Simulated node failure (fault-tolerance drills)."""


@dataclass
class TrainConfig:
    n_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "build/repro_ckpt"
    log_every: int = 10
    grad_accum: int = 1
    fail_at_step: int = -1  # inject a crash once at this step (drills)
    ocfg: optim.OptimConfig = field(default_factory=optim.OptimConfig)


class Trainer:
    def __init__(self, cfg: TrainConfig, loss_fn: Callable, model: nn.Module,
                 pipeline: DeterministicPipeline, device=None):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.pipeline = pipeline
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.state = {"params": params, "opt": optim.init_state(cfg.ocfg, params),
                      "data_step": torch.zeros((), dtype=torch.int32, device=self.device)}
        self.losses: list[float] = []
        self._failed_once = False

    def _grads(self, batch) -> tuple[torch.Tensor, list]:
        """(loss, the parameters' grads); a parameter the loss does not
        reach gets zeros, as ``jax.grad`` gives."""
        leaves = list(self.state["params"].values())
        loss = self.loss_fn(self.model, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]

    def step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a batch of tensors; returns the loss.  With
        ``grad_accum`` > 1 the batch splits into (accum, -1, ...) micro
        batches whose losses and grads are averaged in float32."""
        accum = self.cfg.grad_accum
        if accum == 1:
            loss, grads = self._grads(batch)
        else:
            div = torch.full((), accum, dtype=F32, device=self.device)
            loss = torch.zeros((), dtype=F32, device=self.device)
            grads = [torch.zeros(p.shape, dtype=F32, device=self.device) for p in self.state["params"].values()]
            for i in range(accum):
                mb = {k: v.reshape(accum, -1, *v.shape[1:])[i] for k, v in batch.items()}
                l, g = self._grads(mb)
                loss = loss + l / div
                for a, b in zip(grads, g):
                    a.add_(b / div.to(b.dtype))
        params = self.state["params"]
        _, opt = optim.apply_updates(self.cfg.ocfg, params, dict(zip(params, grads)), self.state["opt"])
        self.state["opt"] = opt
        self.state["data_step"] = self.state["data_step"] + 1
        return loss

    def to_device(self, batch: dict) -> dict:
        """A pipeline batch as tensors on the trainer's device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------ API
    def resume_if_possible(self) -> int:
        step = self.ckpt.latest_step()
        if step is None:
            return 0
        restored = self.ckpt.restore(step, self.state)
        with torch.no_grad():
            for name, p in self.state["params"].items():
                p.copy_(restored["params"][name])
        self.state["opt"], self.state["data_step"] = restored["opt"], restored["data_step"]
        return step

    def run(self, start_step: Optional[int] = None) -> dict:
        cfg = self.cfg
        step = self.resume_if_possible() if start_step is None else start_step
        t0 = time.time()
        while step < cfg.n_steps:
            if step == cfg.fail_at_step and not self._failed_once:
                self._failed_once = True
                raise InjectedFailure(f"simulated node failure at step {step}")
            loss = self.step(self.to_device(self.pipeline.batch_at(step)))
            step += 1
            if step % cfg.log_every == 0 or step == cfg.n_steps:
                l = float(loss)
                self.losses.append(l)
                print(f"step {step}: loss={l:.4f} ({(time.time() - t0) / max(step, 1):.2f}s/step)", flush=True)
            if step % cfg.ckpt_every == 0 or step == cfg.n_steps:
                self.ckpt.save(step, self.state)
        self.ckpt.wait()
        return {"final_loss": self.losses[-1] if self.losses else None, "steps": step}

    def run_with_restarts(self, max_restarts: int = 2) -> dict:
        """Supervisor loop: restart from the last checkpoint on failure."""
        for _ in range(max_restarts + 1):
            try:
                return self.run()
            except InjectedFailure as e:
                print(f"[supervisor] {e}; restarting from last checkpoint", flush=True)
                self.ckpt.wait()
        raise RuntimeError("exceeded max restarts")
