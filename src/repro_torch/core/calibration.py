"""Confidence-score calibration (port of ``repro.core.calibration``):
the paper's Table I set.

Metrics follow the paper: 10 equal-width bins on [0,1],
ECE = sum |B_i|/n * |acc(B_i) - conf(B_i)|, MCE = max_i |acc - conf|.

  * Platt scaling — the logistic P(y=1|s) = sigmoid(-(A s + B)), fitted by
    Newton-Raphson on the binary NLL;
  * isotonic regression — a pool-adjacent-violators fit of a monotone step
    function, looked up with a right ``searchsorted``;
  * temperature scaling — one T on the logits (Guo et al. 2017), Newton on
    log T; ``ScoreTemperatureCalibrator`` applies it to scores.

The Newton fits take their gradients and Hessians from ``torch.func``, in
float32, with the reference's objective, start and step.  A fit runs where
its inputs live: a torch tensor on its own device, anything else (numpy) on
the host.  The isotonic fit is the exception, as in the reference: its
pool-adjacent-violators loop is sequential float64 host code, so it reads a
``.cpu()`` copy of card tensors, and only its lookup runs on the scores'
device.
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


def _f32(x) -> torch.Tensor:
    """A tensor stays on its device; anything else becomes a host tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(F32)
    return torch.as_tensor(np.asarray(x), dtype=F32)


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


@dataclass
class PlattCalibrator:
    a: float = -1.0
    b: float = 0.0

    def __call__(self, s):
        return torch.sigmoid(-(self.a * torch.as_tensor(s, dtype=F32) + self.b))

    @staticmethod
    def fit(scores, correct, n_iter: int = 50) -> "PlattCalibrator":
        s = _f32(scores)
        pos = (correct if isinstance(correct, torch.Tensor)
               else torch.as_tensor(np.asarray(correct))) > 0.5
        # Platt's target smoothing (avoids overconfident saturation)
        n_pos = float(pos.sum())
        n_neg = float(len(pos) - n_pos)
        y = torch.where(pos.to(s.device), (n_pos + 1) / (n_pos + 2), 1.0 / (n_neg + 2)).to(F32)

        def nll(ab):
            p = torch.sigmoid(-(ab[0] * s + ab[1]))
            return -torch.mean(y * torch.log(p.clamp(1e-12, 1))
                               + (1 - y) * torch.log((1 - p).clamp(1e-12, 1)))

        ab = torch.tensor([-1.0, 0.0], dtype=F32, device=s.device)
        eye = torch.eye(2, device=s.device)
        g_fn, h_fn = grad(nll), hessian(nll)
        for _ in range(n_iter):
            h = h_fn(ab) + 1e-6 * eye
            ab = ab - torch.linalg.solve(h, g_fn(ab))
        return PlattCalibrator(float(ab[0]), float(ab[1]))


@dataclass
class IsotonicCalibrator:
    thresholds: np.ndarray | None = None  # sorted score knots (float64)
    values: np.ndarray | None = None  # monotone fitted values (float64)

    def __call__(self, s):
        # the reference looks up in float32 (its knots become f32 arrays)
        s = torch.as_tensor(s, dtype=F32)
        knots = torch.as_tensor(self.thresholds, dtype=F32, device=s.device)
        idx = (torch.searchsorted(knots, s, right=True) - 1).clamp(0, len(self.values) - 1)
        return torch.as_tensor(self.values, dtype=F32, device=s.device)[idx]

    @staticmethod
    def fit(scores, correct) -> "IsotonicCalibrator":
        s, y = _host_f64(scores), _host_f64(correct)
        order = np.argsort(s, kind="stable")
        s, y = s[order], y[order]
        # pool adjacent violators (stack-based); tied scores give duplicate
        # knots, which the right searchsorted resolves to the last
        vals: list[float] = []
        wts: list[float] = []
        starts: list[int] = []
        for i, yi in enumerate(y):
            vals.append(float(yi))
            wts.append(1.0)
            starts.append(i)
            while len(vals) > 1 and vals[-2] >= vals[-1]:
                v = (vals[-2] * wts[-2] + vals[-1] * wts[-1]) / (wts[-2] + wts[-1])
                w = wts[-2] + wts[-1]
                del vals[-1], wts[-1], starts[-1]
                vals[-1], wts[-1] = v, w
        return IsotonicCalibrator(np.array([s[st] for st in starts]), np.asarray(vals))


@dataclass
class TemperatureCalibrator:
    temperature: float = 1.0

    def scale_logits(self, logits):
        return logits / torch.as_tensor(self.temperature, dtype=F32)

    def __call__(self, logits):
        """Calibrated max-softmax straight from logits."""
        return torch.softmax(torch.as_tensor(logits).to(F32) / self.temperature, dim=-1).amax(dim=-1)

    @staticmethod
    def fit(logits, labels, n_iter: int = 50) -> "TemperatureCalibrator":
        lg = _f32(logits)
        lb = (labels if isinstance(labels, torch.Tensor)
              else torch.as_tensor(np.asarray(labels))).to(device=lg.device, dtype=torch.int64)

        def nll(log_t):
            z = lg / torch.exp(log_t)
            gold = z.gather(-1, lb[:, None])[:, 0]
            return torch.mean(torch.logsumexp(z, dim=-1) - gold)

        log_t = torch.zeros((), dtype=F32, device=lg.device)
        g_fn, h_fn = grad(nll), hessian(nll)
        for _ in range(n_iter):
            g, h = g_fn(log_t), h_fn(log_t)
            log_t = log_t - g / h.abs().clamp(min=1e-6) * torch.sign(h + 1e-12)
        return TemperatureCalibrator(float(torch.exp(log_t)))


@dataclass
class ScoreTemperatureCalibrator:
    """Scores -> scores adapter for temperature scaling: the fitted T applied
    to the equivalent two-class logit gap, s = sigmoid(z) => sigmoid(z / T).
    Exact for binary problems, the standard monotone approximation
    otherwise; makes temperature scaling interchangeable with Platt and
    isotonic wherever a score -> score map is expected."""

    temperature: float = 1.0

    def __call__(self, s):
        p = torch.as_tensor(s, dtype=F32).clamp(1e-6, 1.0 - 1e-6)
        z = torch.log(p) - torch.log1p(-p)
        return torch.sigmoid(z / self.temperature)

    @staticmethod
    def fit(logits, labels, n_iter: int = 50) -> "ScoreTemperatureCalibrator":
        return ScoreTemperatureCalibrator(TemperatureCalibrator.fit(logits, labels, n_iter=n_iter).temperature)


def uncalibrated(s) -> torch.Tensor:
    """The identity calibrator: float32 scores on the input's device."""
    return torch.as_tensor(s, dtype=F32)


def fit_all(scores, correct, logits=None, labels=None) -> dict:
    """Fit every calibrator (the paper's Table I set): {name: callable
    mapping confidence scores to calibrated scores}.  Temperature scaling
    is wrapped in ``ScoreTemperatureCalibrator`` so that it takes scores
    like the others."""
    out = {
        "uncalibrated": uncalibrated,
        "platt": PlattCalibrator.fit(scores, correct),
        "isotonic": IsotonicCalibrator.fit(scores, correct),
    }
    if logits is not None and labels is not None:
        out["temperature"] = ScoreTemperatureCalibrator.fit(logits, labels)
    return out
