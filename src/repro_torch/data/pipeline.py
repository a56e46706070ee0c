"""Deterministic sharded data pipeline (port of ``repro.data.pipeline``).

Each step's batch is a pure function of (seed, step): any host can
rebuild any shard of any step, so a checkpoint needs no reader state
beyond the step.  Host numpy, as the reference, and bit-equal to it: the
indices come from ``default_rng((seed, step))`` and each shard's batch
function draws from ``default_rng((seed, step, shard_index))``.  A
background thread prefetches for ``iterate``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seed: int = 0
    prefetch: int = 2


class DeterministicPipeline:
    """batch_fn(rng, indices) -> batch dict of numpy arrays; indices are
    drawn per step."""

    def __init__(self, cfg: PipelineConfig, batch_fn: Callable, dataset_size: int,
                 shard_index: int = 0, shard_count: int = 1):
        if cfg.global_batch % shard_count:
            raise ValueError(f"global_batch {cfg.global_batch} does not split into {shard_count} shards")
        self.cfg = cfg
        self.batch_fn = batch_fn
        self.dataset_size = dataset_size
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.local_batch = cfg.global_batch // shard_count

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.cfg.seed, step))
        idx = rng.integers(0, self.dataset_size, size=self.cfg.global_batch)
        local = idx[self.shard_index * self.local_batch : (self.shard_index + 1) * self.local_batch]
        return self.batch_fn(np.random.default_rng((self.cfg.seed, step, self.shard_index)), local)

    def __iter__(self) -> Iterator[dict]:
        return self.iterate(0)

    def iterate(self, start_step: int) -> Iterator[dict]:
        """Batches from ``start_step`` on, made ``prefetch`` ahead on a
        daemon thread that stops once the generator is closed."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                batch = self.batch_at(s)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def token_batch_fn(vocab_size: int, seq_len: int, *, order: int = 2):
    """Synthetic-language batches: a seeded chain over a zipf vocabulary,
    one stream per index, so training losses move."""

    def fn(rng: np.random.Generator, idx: np.ndarray) -> dict:
        toks = np.empty((len(idx), seq_len + 1), np.int32)
        for i, ix in enumerate(idx):
            r = np.random.default_rng(int(ix))
            base = r.zipf(1.5, size=seq_len + 1).astype(np.int64)
            mix = (base * 2654435761 + np.arange(seq_len + 1) * int(ix + 1)) % vocab_size
            toks[i] = mix.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return fn


def image_batch_fn(dataset: dict):
    def fn(rng: np.random.Generator, idx: np.ndarray) -> dict:
        return {"images": dataset["frames"][idx], "labels": dataset["labels"][idx]}

    return fn
