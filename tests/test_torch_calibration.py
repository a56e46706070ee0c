"""The port's Table I calibrators against ``repro.core.calibration``.

Isotonic regression is host float64 in both packages: its knots, values and
looked-up outputs must be bit-equal, ties included (scores rounded to 2 or
1 decimals give many tied knots; the lookup is a right ``searchsorted``
over float32 knots in both).  The Newton fits run in float32 with
gradients from ``jax.grad`` / ``torch.func`` summed in different orders:
the fitted temperature must agree within 1e-4 relative.  With the same
coefficients, every calibrator's float32 output agrees within 1e-6.
A fit from torch tensors gives what the fit from numpy arrays gives.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro_torch.core import calibration as tcal

SCORE_ATOL = 1e-6
TEMP_RTOL = 1e-4
PLATT_ATOL = 1e-4


def _scores(kind, n=512, seed=0):
    """(scores, correct) with an overconfident, partly tied score profile."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 0.95, n)
    correct = (rng.uniform(size=n) < p).astype(np.float64)
    s = np.clip(0.7 + 0.3 * (p - 0.5) + 0.1 * rng.standard_normal(n), 0.01, 0.999)
    if kind == "ties2":
        s = np.round(s, 2)
    elif kind == "ties1":
        s = np.round(s, 1)
    elif kind == "float32":
        s = s.astype(np.float32)
    return s, correct


def _logits(n=384, v=10, sharp=3.0, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, v, n)
    logits = rng.standard_normal((n, v)) * sharp
    hit = rng.uniform(size=n) < 0.6
    logits[np.arange(n)[hit], labels[hit]] += sharp  # an overconfident classifier
    return logits.astype(np.float32), labels


KINDS = ["continuous", "float32", "ties2", "ties1"]


@pytest.mark.parametrize("kind", KINDS)
def test_isotonic_fit_bit_equal(kind):
    s, c = _scores(kind)
    ref = jcal.IsotonicCalibrator.fit(s, c)
    got = tcal.IsotonicCalibrator.fit(s, c)
    assert got.thresholds.dtype == np.float64 and got.values.dtype == np.float64
    np.testing.assert_array_equal(got.thresholds, ref.thresholds)
    np.testing.assert_array_equal(got.values, ref.values)
    if kind.startswith("ties"):
        assert len(np.unique(s)) < len(s) // 4  # really tie-heavy
    # monotone non-decreasing values (PAVA pools until no violator is left)
    assert np.all(np.diff(got.values) > 0)


@pytest.mark.parametrize("kind", KINDS)
def test_isotonic_outputs_bit_equal(kind):
    s, c = _scores(kind)
    ref = jcal.IsotonicCalibrator.fit(s, c)
    got = tcal.IsotonicCalibrator.fit(s, c)
    # the fitted scores themselves (ties land on knots), the knots' float32
    # images, and values outside and between the knots
    q = np.concatenate([s, ref.thresholds, [-1.0, 0.0, 0.5, 1.0, 2.0],
                        np.random.default_rng(9).uniform(0, 1, 200)]).astype(np.float32)
    out = got(torch.as_tensor(q))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref(jnp.asarray(q))))


def test_isotonic_fit_from_tensors_equals_numpy():
    s, c = _scores("ties2")
    a = tcal.IsotonicCalibrator.fit(s.astype(np.float32), c)
    b = tcal.IsotonicCalibrator.fit(torch.as_tensor(s, dtype=torch.float32), torch.as_tensor(c > 0.5))
    np.testing.assert_array_equal(a.thresholds, b.thresholds)
    np.testing.assert_array_equal(a.values, b.values)


@pytest.mark.parametrize("seed,v,sharp", [(0, 10, 3.0), (1, 100, 2.0), (2, 1000, 4.0), (3, 10, 0.5)])
def test_temperature_fit_matches_reference(seed, v, sharp):
    logits, labels = _logits(v=v, sharp=sharp, seed=seed)
    ref = jcal.TemperatureCalibrator.fit(logits, labels)
    got = tcal.TemperatureCalibrator.fit(logits, labels)
    assert got.temperature == pytest.approx(ref.temperature, rel=TEMP_RTOL)
    assert got.temperature != 1.0  # the Newton steps moved it
    st = tcal.ScoreTemperatureCalibrator.fit(torch.as_tensor(logits), torch.as_tensor(labels))
    assert st.temperature == pytest.approx(ref.temperature, rel=TEMP_RTOL)


@pytest.mark.parametrize("temperature", [0.37, 1.0, 2.9])
def test_temperature_outputs_match_reference(temperature):
    logits, _ = _logits(v=100, seed=4)
    ref = jcal.TemperatureCalibrator(temperature)
    got = tcal.TemperatureCalibrator(temperature)
    np.testing.assert_allclose(got(torch.as_tensor(logits)).numpy(),
                               np.asarray(ref(jnp.asarray(logits))), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got.scale_logits(torch.as_tensor(logits)).numpy(),
                               np.asarray(ref.scale_logits(jnp.asarray(logits))), rtol=0, atol=SCORE_ATOL)
    s = np.concatenate([_scores("continuous")[0], [0.0, 1e-9, 1.0, 1 - 1e-9]]).astype(np.float32)
    np.testing.assert_allclose(tcal.ScoreTemperatureCalibrator(temperature)(torch.as_tensor(s)).numpy(),
                               np.asarray(jcal.ScoreTemperatureCalibrator(temperature)(jnp.asarray(s))),
                               rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("ab", [(-1.0, 0.0), (-20.0, 5.0), (-7.3, 3.1)])
def test_platt_outputs_match_reference(ab):
    s = _scores("float32")[0]
    np.testing.assert_allclose(tcal.PlattCalibrator(*ab)(torch.as_tensor(s)).numpy(),
                               np.asarray(jcal.PlattCalibrator(*ab)(jnp.asarray(s))),
                               rtol=0, atol=SCORE_ATOL)


def test_platt_fit_from_tensors_equals_numpy():
    s, c = _scores("float32", seed=5)
    a = tcal.PlattCalibrator.fit(s, c)
    b = tcal.PlattCalibrator.fit(torch.as_tensor(s), torch.as_tensor(c))
    assert (a.a, a.b) == (b.a, b.b)
    ref = jcal.PlattCalibrator.fit(s, c)
    assert b.a == pytest.approx(ref.a, abs=PLATT_ATOL) and b.b == pytest.approx(ref.b, abs=PLATT_ATOL)


@pytest.mark.parametrize("with_logits", [False, True])
def test_fit_all_matches_reference(with_logits):
    logits, labels = _logits(v=10, seed=6)
    ls = np.asarray(torch.softmax(torch.as_tensor(logits), -1).amax(-1))
    correct = (logits.argmax(-1) == labels).astype(np.float64)
    kw = dict(logits=logits, labels=labels) if with_logits else {}
    ref = jcal.fit_all(ls, correct, **kw)
    got = tcal.fit_all(ls, correct, **kw)
    assert sorted(got) == sorted(ref)
    assert ("temperature" in got) == with_logits
    q = np.random.default_rng(7).uniform(0.1, 1.0, 300).astype(np.float32)
    for name, cal in got.items():
        out = cal(torch.as_tensor(q))
        assert out.dtype == torch.float32, name
        r = np.asarray(ref[name](jnp.asarray(q)))
        if name == "isotonic" or name == "uncalibrated":
            np.testing.assert_array_equal(out.numpy(), r, err_msg=name)
        else:  # fitted parameters agree within 1e-4, the outputs with them
            np.testing.assert_allclose(out.numpy(), r, rtol=0, atol=PLATT_ATOL, err_msg=name)
    # the fitted calibrators lower ECE on the fitting data (paper Table I)
    base = tcal.ece(ls, correct)
    for name in ("platt", "isotonic"):
        assert tcal.ece(got[name](torch.as_tensor(ls)).numpy(), correct) < base, name


def test_uncalibrated_keeps_device_and_casts():
    x = torch.tensor([0.25, 0.5], dtype=torch.float64)
    out = tcal.uncalibrated(x)
    assert out.dtype == torch.float32 and out.device == x.device
    assert tcal.uncalibrated(np.array([0.5])).dtype == torch.float32
