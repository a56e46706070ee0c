"""The port's continuous-batching slow tier against the JAX package's.

``repro_torch.slowtier`` is a numpy copy of ``repro.slowtier``: batch
formation and the curve fits must agree bit for bit on the same samples.
``batch_sweep`` is the port's counterpart of ``bench_kernels.py
--batch-sweep``; on the CPU it times the plain versions by the host clock,
so only its shape and keys are checked here (its times on the card come
from ``chip_smoke.py``).
"""
import numpy as np
import pytest

import repro.slowtier as jst
import repro_torch.slowtier as tst
from repro_torch.slowtier.sweep import BATCH_SIZES, batch_sweep, latency_model_from_fit


def _models(mod):
    return [mod.FlatService(0.02), mod.LinearBatch(0.015, 0.004),
            mod.StepBatch(0.01, 0.008, page_size=4),
            mod.StepBatch(0.01, 0.008, page_size=4, max_pages=2)]


def _fuzz_case(rng, mod):
    """tests/test_slowtier.py::_fuzz_case, built in module ``mod``."""
    n = int(rng.integers(1, 50))
    arr = np.sort(rng.exponential(0.02, size=n).cumsum())
    if rng.random() < 0.3:  # quantize: coincident arrivals + boundary ties
        arr = np.round(arr, 2)
    models = _models(mod)
    cfg = mod.ContinuousBatching(
        models[int(rng.integers(len(models)))],
        window_s=float(rng.choice([0.0, 0.002, 0.01, 0.05])),
        max_batch=int(rng.integers(1, 10)) if rng.random() < 0.5 else None)
    return arr, cfg, float(rng.uniform(0.0, 0.15))


@pytest.mark.parametrize("seed", [7, 8])
def test_form_batches_bit_equal_to_reference_and_looped(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(150):
        arr, jcfg, busy0 = _fuzz_case(rj, jst)
        arr_t, tcfg, busy0_t = _fuzz_case(rt, tst)
        assert np.array_equal(arr, arr_t) and busy0 == busy0_t
        assert tcfg.cap == jcfg.cap and tcfg.degenerate == jcfg.degenerate
        want = jst.form_batches(arr, jcfg, busy0=busy0)
        for got in (tst.form_batches(arr, tcfg, busy0=busy0),
                    tst.form_batches_looped(arr, tcfg, busy0=busy0)):
            for name, g, w in zip(("done", "service", "batch_size", "batch_id"), got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_formation_edge_cases_match_reference():
    w = 0.03125
    for mod in (jst, tst):
        cfg = mod.ContinuousBatching(mod.LinearBatch(0.01, 0.002), window_s=w)
        done, _, bsize, bid = mod.form_batches(np.array([0.0, w, w + 1e-9]), cfg)
        assert list(bid) == [0, 0, 1] and bsize[0] == 2
        assert done[0] == w + float(cfg.model.batch_latency(2))
        capped = mod.ContinuousBatching(mod.StepBatch(0.01, 0.008, page_size=4, max_pages=2),
                                        window_s=10.0)
        assert list(np.bincount(mod.form_batches(np.zeros(20), capped)[3])) == [8, 8, 4]
        assert mod.form_batches(np.zeros(0), cfg)[0].shape == (0,)
    with pytest.raises(ValueError):
        tst.ContinuousBatching(tst.FlatService(0.02), window_s=-0.1)
    with pytest.raises(ValueError):
        tst.StepBatch(0.01, 0.008, page_size=0)


def test_model_coeffs_roundtrip_matches_reference():
    n = np.arange(1, 9, dtype=np.float64)
    for jm, tm in zip(_models(jst), _models(tst)):
        assert tst.model_coeffs(tm) == jst.model_coeffs(jm)
        kind, coeffs = tst.model_coeffs(tm)
        assert np.array_equal(tst.model_from_coeffs(kind, coeffs).batch_latency(n),
                              jm.batch_latency(n))
        assert np.array_equal(tm.per_request(n), jm.per_request(n))


# noiseless curves of each family, and a noisy sample like a timed sweep
SAMPLES = {
    "flat": (np.array([1, 2, 4, 8, 16, 32.0]), 0.0375 * np.array([1, 2, 4, 8, 16, 32.0])),
    "linear": (np.array([1, 2, 4, 8, 16, 32.0]), 0.012 + 0.0031 * np.array([1, 2, 4, 8, 16, 32.0])),
    "noisy": (np.array([1, 2, 4, 8, 16, 32.0]),
              np.array([41.3, 44.9, 52.0, 71.8, 104.6, 181.2]) * 1e-6),
    "negative-base": (np.array([1.0, 2.0, 3.0]), np.array([0.001, 0.0035, 0.006])),
}


@pytest.mark.parametrize("sample", list(SAMPLES))
@pytest.mark.parametrize("kind", ["flat", "linear", "step", "best"])
def test_fits_and_rmse_equal_reference(sample, kind):
    n, y = SAMPLES[sample]
    jm, jr = jst.fit_latency_model(n, y, kind=kind, page_size=4)
    tm, tr = tst.fit_latency_model(n, y, kind=kind, page_size=4)
    assert tr == jr
    assert tst.model_coeffs(tm) == jst.model_coeffs(jm)


def test_batch_sweep_on_cpu_has_the_reference_keys():
    out = batch_sweep(device="cpu", n_timing=1)
    assert set(out) == {"batch_sizes", "rows", "fits", "batch_fit"}
    assert out["batch_sizes"] == list(BATCH_SIZES) == [1, 2, 4, 8, 16, 32]
    assert [r["batch"] for r in out["rows"]] == list(BATCH_SIZES)
    for r in out["rows"]:
        assert set(r) == {"batch", "attn_us", "matmul_us", "total_s"}
        assert r["attn_us"] > 0 and r["matmul_us"] > 0
        assert r["total_s"] == pytest.approx((r["attn_us"] + r["matmul_us"]) * 1e-6, abs=2e-7)
    assert set(out["fits"]) == {"flat", "linear", "step"}
    for kind, fit in out["fits"].items():
        assert fit["kind"] == kind and fit["rmse_us"] >= 0
        assert all(c >= 0 for c in fit["coeffs"])
    assert out["batch_fit"] == min(out["fits"].values(), key=lambda f: f["rmse_us"])


def test_batch_sweep_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_sweep()


@pytest.mark.parametrize("fit", [
    {"kind": "linear", "coeffs": [4.1e-5, 4.4e-6]},
    {"kind": "flat", "coeffs": [5.2e-6]},
    {"kind": "step", "coeffs": [3.0e-5, 2.5e-5, 8.0]},
])
def test_latency_model_from_fit_anchors_f1_on_server_time(fit):
    m = latency_model_from_fit(fit, 0.037)
    assert float(m.batch_latency(1)) == pytest.approx(0.037, rel=1e-12)
    kind, coeffs = tst.model_coeffs(m)
    assert kind == fit["kind"]
    raw = tst.model_from_coeffs(fit["kind"], fit["coeffs"])
    n = np.array([1.0, 4.0, 16.0])
    # the measured shape is kept: f(n) / f(1) as the fit's
    np.testing.assert_allclose(m.batch_latency(n) / m.batch_latency(1),
                               raw.batch_latency(n) / raw.batch_latency(1), rtol=1e-12)
    if kind == "step":
        assert m.page_size == 8  # the page size is a count, not a time
    if kind != "step":  # flat and linear scale exactly as bench_slowtier.py does
        scale = 0.037 / float(raw.batch_latency(1))
        assert coeffs == tuple(c * scale for c in fit["coeffs"])


def test_latency_model_from_fit_rejects_a_zero_curve():
    with pytest.raises(ValueError, match="f\\(1\\)"):
        latency_model_from_fit({"kind": "linear", "coeffs": [0.0, 0.0]}, 0.037)
