"""Confidence-score calibration (port of ``repro.core.calibration``; Platt only).

Metrics follow the paper: 10 equal-width bins on [0,1],
ECE = sum |B_i|/n * |acc(B_i) - conf(B_i)|, MCE = max_i |acc - conf|.
Platt scaling is the logistic P(y=1|s) = sigmoid(-(A s + B)), fitted by
Newton-Raphson on the binary NLL with the gradient and Hessian from
``torch.func`` — the same objective, start and step as the reference.
The isotonic and temperature calibrators are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad, hessian

F32 = torch.float32


def reliability_bins(conf, correct, n_bins: int = 10):
    """Returns (bin_count, bin_accuracy, bin_mean_conf) per bin."""
    conf = np.asarray(conf, np.float64)
    correct = np.asarray(correct, np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(conf, edges[1:-1]), 0, n_bins - 1)
    count = np.zeros(n_bins)
    acc = np.zeros(n_bins)
    mc = np.zeros(n_bins)
    for b in range(n_bins):
        m = idx == b
        count[b] = m.sum()
        if count[b]:
            acc[b] = correct[m].mean()
            mc[b] = conf[m].mean()
    return count, acc, mc


def ece(conf, correct, n_bins: int = 10) -> float:
    count, acc, mc = reliability_bins(conf, correct, n_bins)
    n = count.sum()
    return float(np.sum(count / max(n, 1) * np.abs(acc - mc)))


def mce(conf, correct, n_bins: int = 10) -> float:
    count, acc, mc = reliability_bins(conf, correct, n_bins)
    gaps = np.abs(acc - mc)[count > 0]
    return float(gaps.max()) if gaps.size else 0.0


@dataclass
class PlattCalibrator:
    a: float = -1.0
    b: float = 0.0

    def __call__(self, s):
        return torch.sigmoid(-(self.a * torch.as_tensor(s, dtype=F32) + self.b))

    @staticmethod
    def fit(scores, correct, n_iter: int = 50) -> "PlattCalibrator":
        s = torch.as_tensor(np.asarray(scores), dtype=F32)
        pos = np.asarray(correct) > 0.5
        # Platt's target smoothing (avoids overconfident saturation)
        n_pos = float(np.sum(pos))
        n_neg = float(len(pos) - n_pos)
        y = torch.where(torch.as_tensor(pos), (n_pos + 1) / (n_pos + 2), 1.0 / (n_neg + 2)).to(F32)

        def nll(ab):
            p = torch.sigmoid(-(ab[0] * s + ab[1]))
            return -torch.mean(y * torch.log(p.clamp(1e-12, 1))
                               + (1 - y) * torch.log((1 - p).clamp(1e-12, 1)))

        ab = torch.tensor([-1.0, 0.0], dtype=F32)
        g_fn, h_fn = grad(nll), hessian(nll)
        for _ in range(n_iter):
            h = h_fn(ab) + 1e-6 * torch.eye(2)
            ab = ab - torch.linalg.solve(h, g_fn(ab))
        return PlattCalibrator(float(ab[0]), float(ab[1]))
