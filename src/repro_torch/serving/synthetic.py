"""Synthetic planted-signal workload for the serving tests
(port of ``repro.serving.synthetic``).

A weak fast tier reading a signal+noise channel, a near-oracle slow tier,
and planted-signal frame streams.  The tiers are closed-form functions of
torch tensors; the streams are numpy, bit-equal to the reference's.
"""
from __future__ import annotations

import numpy as np


def synthetic_tiers():
    """(fast, slow, calibrate): closed-form tiers over (B, H, W, 4) frames."""

    def fast(images):  # weak: signal + noise channel
        return images[:, 0, 0, :4] + images[:, 1, 1, :4]

    def slow(images):  # near-oracle
        return images[:, 0, 0, :4] * 10.0

    return fast, slow, (lambda s: s)


def synthetic_streams(n_streams: int, n_frames: int, res: int = 8, seed: int = 0):
    """(S, N, res, res, 4) float32 frames + (S, N) labels with planted signal."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, size=(n_streams, n_frames))
    imgs = rng.normal(size=(n_streams, n_frames, res, res, 4)) * 0.8
    s_idx, f_idx = np.meshgrid(np.arange(n_streams), np.arange(n_frames), indexing="ij")
    imgs[s_idx, f_idx, 0, 0, labels] = 2.0
    return imgs.astype(np.float32), labels
