"""The paper's two-tier stack (``bench/stack.py``) and the §V approaches
(``bench/approaches.py``) against ``benchmarks/common.py`` and
``benchmarks/approaches.py``.

- The first 3 steps of ``_train_tier(SLOW_CFG, res_augment=True)`` from
  the reference's init (converted): the logged losses within 1e-4
  relative (the degraded half of each batch goes through two resize
  implementations, within 1e-4 of each other), at most 1 in 1,000
  parameter elements more than 1e-4 apart and every element within
  6·lr: AdamW moves a weight by about lr·sign(g) a step, so a gradient
  near 0 whose sign differs between the frameworks moves it by up to
  2·lr (50 of 464,890 elements measured, the largest gap 3.7e-3).
- ``qdq_tree(bits=4, axis=None)`` bit-equal.
- ``build_trace`` and all seven ``APPROACHES`` at 1 and 5 Mbps on a small
  stack whose weights both packages share: every prediction equal, the
  raw and calibrated confidences within 1e-6, every accuracy equal.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import approaches as JA  # noqa: E402
from benchmarks import common as JC  # noqa: E402
from repro.core.calibration import PlattCalibrator as JaxPlatt  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.transformer import ParallelPlan as JPlan  # noqa: E402
from repro.quant.quantize import qdq_tree as jax_qdq_tree  # noqa: E402
from repro_torch.bench import approaches as TA  # noqa: E402
from repro_torch.bench import stack as TC  # noqa: E402
from repro_torch.core.calibration import PlattCalibrator  # noqa: E402
from repro_torch.data.video import make_dataset  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.quant.quantize import qdq_tree  # noqa: E402


def _ref_init(cfg, seed):
    return japi.build(cfg, JPlan(remat=False)).init(jax.random.PRNGKey(seed), dtype=jnp.float32)


def _port_tier(cfg, tree):
    model = TC.api.build(cfg).init(None, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)), strict=True)
    return model


def test_configs_equal_reference():
    assert (TC.DATA_CFG, TC.FAST_CFG.depths, TC.SLOW_CFG.depths) == (
        type(TC.DATA_CFG)(**JC.DATA_CFG.__dict__), JC.FAST_CFG.depths, JC.SLOW_CFG.depths)
    assert (TC.FAST_CFG.width, TC.SLOW_CFG.width, TC.RESOLUTIONS, TC.NPU_QUANT) == (
        JC.FAST_CFG.width, JC.SLOW_CFG.width, JC.RESOLUTIONS, JC.NPU_QUANT)


def test_train_tier_first_steps_match_reference(tmp_path, monkeypatch):
    data = make_dataset(TC.DATA_CFG, 24, seed=0)
    made = []

    class Recording(JC.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(JC, "Trainer", Recording)
    monkeypatch.setattr(JC, "TrainConfig", functools.partial(JC.TrainConfig, ckpt_dir=str(tmp_path / "ref")))
    ref = JC._train_tier(JC.SLOW_CFG, data, n_steps=3, lr=3e-3, seed=0, res_augment=True)
    model = _port_tier(TC.SLOW_CFG, _ref_init(JC.SLOW_CFG, 0))
    tr = TC._train_tier(TC.SLOW_CFG, data, 3, 3e-3, 0, res_augment=True, device="cpu", model=model)
    assert tr.model is model and all(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(tr.losses, made[0].losses, rtol=1e-4, atol=0)
    refp = params_from_jax(jax.tree.map(np.asarray, ref))
    got = model.state_dict()
    n = sum(v.numel() for v in refp.values())
    far = sum(int(((got[k] - refp[k]).abs() > 1e-4).sum()) for k in refp)
    worst = max(float((got[k] - refp[k]).abs().max()) for k in refp)
    assert far <= n // 1000 and worst <= 6 * 3e-3, (far, n, worst)


def test_res_augment_batches_match_reference():
    """The slow tier's training batches: the first half degraded to the
    resolution the batch's rng draws, as ``common.py:73-84`` builds them."""
    data = make_dataset(TC.DATA_CFG, 6, seed=3)
    rng_seed = (0, 5, 0)
    port = TC.res_augment_fn(TC.image_batch_fn(data))(np.random.default_rng(rng_seed), np.arange(10))
    from repro.core.cascade import degrade_resolution as jdeg

    rng = np.random.default_rng(rng_seed)
    imgs = data["frames"][np.arange(10)]
    r = JC.RESOLUTIONS[int(rng.integers(len(JC.RESOLUTIONS)))]
    ref = np.concatenate([np.asarray(jdeg(jnp.asarray(imgs[:5]), r)), imgs[5:]])
    assert np.array_equal(port["labels"], data["labels"][:10])
    np.testing.assert_allclose(port["images"], ref, atol=1e-4, rtol=0)
    assert np.array_equal(port["images"][5:], imgs[5:])


def test_qdq_int4_per_tensor_bit_equal():
    tree = _ref_init(JC.FAST_CFG, 1)
    ref = params_from_jax(jax.tree.map(np.asarray, jax_qdq_tree(tree, **JC.NPU_QUANT)))
    before = params_from_jax(jax.tree.map(np.asarray, tree))
    got = qdq_tree(before, **TC.NPU_QUANT)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    changed = sorted(k for k in ref if not torch.equal(got[k], before[k]))
    # every weight of 64 elements or more: the stem, 3 of the block's 4 convs (c1 holds 36), the head
    assert changed == sorted(k for k in ref if k.endswith(".w") and ref[k].numel() >= 64)
    assert len(changed) == 5


@pytest.fixture(scope="module")
def shared_stack():
    """Both packages' stacks on the same (reference-drawn, untrained)
    weights and the same Platt coefficients; 30 test and 20 calibration
    videos of the reference's data config."""
    fast_fp = _ref_init(JC.FAST_CFG, 1)
    fast = jax_qdq_tree(fast_fp, **JC.NPU_QUANT)
    slow = _ref_init(JC.SLOW_CFG, 0)
    test = make_dataset(TC.DATA_CFG, 30, seed=2)
    calib = make_dataset(TC.DATA_CFG, 20, seed=1)
    fh = japi.build(JC.FAST_CFG, JPlan(remat=False))
    _, logits = JC._accuracy(fh.forward, fast, calib["frames"], calib["labels"])
    conf = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1).max(-1))
    correct = (np.argmax(logits, -1) == calib["labels"]).astype(float)
    jp = JaxPlatt.fit(conf, correct)
    cal = {"conf": conf, "correct": correct, "logits": logits, "labels": calib["labels"], "frames": calib["frames"]}
    jstack = JC.TierStack(fast_params=fast, slow_params=slow, platt=jp, acc_fast=0.0, acc_slow=0.0,
                          acc_server_by_res=(), calib=cal, test=test, fast_params_fp=fast_fp)
    tstack = TC.TierStack(fast_params=_port_tier(TC.FAST_CFG, fast), slow_params=_port_tier(TC.SLOW_CFG, slow),
                          platt=PlattCalibrator(jp.a, jp.b), acc_fast=0.0, acc_slow=0.0, acc_server_by_res=(),
                          calib=cal, test=test, fast_params_fp=_port_tier(TC.FAST_CFG, fast_fp))
    return jstack, tstack


def test_build_trace_matches_reference(shared_stack):
    jstack, tstack = shared_stack
    jt, tt = JA.build_trace(jstack, max_frames=300), TA.build_trace(tstack, max_frames=300)
    assert len(tt) == len(jt) == 300
    for k in ("labels", "fast_pred", "fast_fp_pred"):
        assert np.array_equal(getattr(tt, k), getattr(jt, k)), k
    assert sorted(tt.slow_pred_by_res) == sorted(jt.slow_pred_by_res)
    for r in jt.slow_pred_by_res:
        assert np.array_equal(tt.slow_pred_by_res[r], jt.slow_pred_by_res[r]), r
    np.testing.assert_allclose(tt.conf_raw, jt.conf_raw, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt.conf_cal, jt.conf_cal, atol=1e-6, rtol=0)
    assert tt.sizes == jt.sizes and tt.plan_acc_by_res == jt.plan_acc_by_res
    assert tt.local_acc_mean == jt.local_acc_mean


@pytest.mark.parametrize("bw", [1.0, 5.0])
def test_approaches_equal_reference(shared_stack, bw):
    jstack, tstack = shared_stack
    jt, tt = JA.build_trace(jstack, max_frames=300), TA.build_trace(tstack, max_frames=300)
    assert list(TA.APPROACHES) == list(JA.APPROACHES)
    for name in JA.APPROACHES:
        ref = JA.APPROACHES[name](jt, JA.NetCfg(bandwidth_mbps=bw))
        got = TA.APPROACHES[name](tt, TA.NetCfg(bandwidth_mbps=bw))
        assert got == ref, (name, bw, got, ref)
    assert TA.run_local(tt, TA.NetCfg(bandwidth_mbps=bw)) == float((tt.fast_pred == tt.labels).mean())
