"""Training infrastructure of the port against the JAX reference: the data
pipeline (``data/pipeline.py``), AdamW (``train/optim.py``), checkpoints
(``ckpt/manager.py``) and the ``Trainer`` (``train/trainer.py``), with the
drills of ``tests/test_ckpt_trainer.py``.

Exactness: pipeline batches are bit-equal.  ``apply_updates`` is
bit-equal to the reference's (parameters, moments, bf16 casts, the int8
compression's values and error feedback) whenever the clip factor is the
same: with the clip off, or on with a global norm below ``clip_norm``
(factor 1).  With the factor below 1 the two global norms sum the leaves
in another order: the factors agree within 4 ulps (2.4e-7 relative) and,
given the reference's factor, the update is again bit-equal.  A
checkpoint of the same nested dict of float32 and int32 arrays restores
in either package; a crashed-and-resumed run ends bit-equal to an
uninterrupted one.  A ``grad_accum=2`` step is held to the reference's
within 1e-6 (the loss and grads sum in another order).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as JaxCheckpointManager
from repro.data import pipeline as jpipe
from repro.train import optim as jopt
from repro.train.trainer import TrainConfig as JaxTrainConfig
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.ckpt.manager import CheckpointManager, flatten
from repro_torch.data import pipeline as tpipe
from repro_torch.train import optim as topt
from repro_torch.train.trainer import InjectedFailure, TrainConfig, Trainer

# ------------------------------- pipeline ----------------------------------- #


def _image_data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


def _batch_fns(mod):
    data = _image_data()
    return {"image": (mod.image_batch_fn(data), len(data["labels"])),
            "token": (mod.token_batch_fn(977, 65), 500)}


@pytest.mark.parametrize("kind", ["image", "token"])
@pytest.mark.parametrize("shards", [1, 2])
def test_pipeline_batches_bit_equal(kind, shards):
    jfn, n = _batch_fns(jpipe)[kind]
    tfn, _ = _batch_fns(tpipe)[kind]
    for shard in range(shards):
        jp = jpipe.DeterministicPipeline(jpipe.PipelineConfig(global_batch=8, seed=3), jfn, n, shard, shards)
        tp = tpipe.DeterministicPipeline(tpipe.PipelineConfig(global_batch=8, seed=3), tfn, n, shard, shards)
        assert tp.local_batch == 8 // shards
        for step in (0, 1, 7, 123):
            a, b = jp.batch_at(step), tp.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (kind, shard, step, k)


def test_pipeline_iterate_equals_batch_at():
    fn, n = _batch_fns(tpipe)["token"]
    p = tpipe.DeterministicPipeline(tpipe.PipelineConfig(global_batch=4, seed=1, prefetch=2), fn, n)
    it = p.iterate(5)
    got = [next(it) for _ in range(4)]
    it.close()
    for i, b in enumerate(got):
        ref = p.batch_at(5 + i)
        assert all(np.array_equal(b[k], ref[k]) for k in ref)


def test_pipeline_rejects_uneven_shards():
    with pytest.raises(ValueError):
        tpipe.DeterministicPipeline(tpipe.PipelineConfig(global_batch=6), lambda r, i: {}, 10, 0, 4)


# --------------------------------- AdamW ------------------------------------ #

TREE = {"a": (64, 33), "b": {"c": (17,), "d": (5, 7, 3)}}


def _draw(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _flat(tree, pre=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], pre + k + "."))
        else:
            out[pre + k] = np.asarray(tree[k])
    return out


def _bits(x):
    """A comparable copy: bf16 as float32 (exact), the rest as it is."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_tree_equal(jtree, tdict, what):
    jf = _flat(jax.tree.map(_bits, jtree))
    assert sorted(jf) == sorted(tdict), what
    for k in jf:
        assert np.array_equal(jf[k], _bits(tdict[k])), (what, k, float(np.abs(jf[k] - _bits(tdict[k])).max()))


def _jax_clip(cfg, grads):
    """The reference's clip factor of ``grads`` (``optim.py:79-81``)."""
    gn = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32))) for g in jax.tree.leaves(grads)))
    return float(jnp.minimum(1.0, cfg.clip_norm / jnp.maximum(gn, 1e-9)))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm,grad_scale", [(0.0, 0.1), (1.0, 0.01)])
@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_bit_equal_at_equal_clip(moments, clip_norm, grad_scale, compress):
    """clip off, or on with the global norm below clip_norm (factor 1):
    after steps 1 and 3 every parameter, moment and error-feedback leaf is
    bit-equal to the reference's."""
    kw = dict(lr=1e-2, clip_norm=clip_norm, m_dtype=moments, v_dtype=moments, compress_grads=compress)
    jc, tc = jopt.OptimConfig(**kw), topt.OptimConfig(**kw)
    rng = np.random.default_rng(7)
    p0 = _draw(TREE, rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), {k: torch.tensor(v) for k, v in _flat(p0).items()}
    js, ts = jopt.init_state(jc, jp), topt.init_state(tc, tp)
    for step in (1, 2, 3):
        g = _draw(TREE, rng, grad_scale)
        if clip_norm:  # a norm of ~0.5: below 1 before and after the int8 round trip
            assert _jax_clip(jopt.OptimConfig(clip_norm=0.5), jax.tree.map(jnp.asarray, g)) == 1.0
        jp, js = jopt.apply_updates(jc, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.apply_updates(tc, tp, {k: torch.tensor(v) for k, v in _flat(g).items()}, ts)
        if step in (1, 3):
            assert int(js["step"]) == int(ts["step"]) == step and ts["step"].dtype == torch.int32
            _assert_tree_equal(jp, tp, "params")
            _assert_tree_equal(js["m"], ts["m"], "m")
            _assert_tree_equal(js["v"], ts["v"], "v")
            assert all(ts["m"][k].dtype == getattr(torch, moments) for k in ts["m"])
            if compress:
                _assert_tree_equal(js["err"], ts["err"], "err")
                assert all(e.dtype == torch.bfloat16 for e in ts["err"].values())


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_clipped_within_ulps_and_bit_equal_given_the_factor(moments):
    """A global norm above clip_norm: the two factors agree within 4 ulps;
    each leaf's update taken at the reference's factor is bit-equal."""
    kw = dict(lr=1e-2, clip_norm=1.0, m_dtype=moments, v_dtype=moments)
    jc, tc = jopt.OptimConfig(**kw), topt.OptimConfig(**kw)
    rng = np.random.default_rng(8)
    p0 = _draw(TREE, rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), {k: torch.tensor(v) for k, v in _flat(p0).items()}
    js, ts = jopt.init_state(jc, jp), topt.init_state(tc, tp)
    for step in (1, 2, 3):
        g = _draw(TREE, rng, 1.0)
        jg, tg = jax.tree.map(jnp.asarray, g), {k: torch.tensor(v) for k, v in _flat(g).items()}
        ref_clip = _jax_clip(jc, jg)
        clip = float(topt.clip_factor(tc, tg))
        assert ref_clip < 0.1 and abs(clip - ref_clip) <= 4 * np.spacing(np.float32(ref_clip)), (clip, ref_clip)
        jp, js = jopt.apply_updates(jc, jp, jg, js)
        bc1, bc2 = topt.bias_corrections(tc, ts["step"] + 1)
        at_ref = {k: topt.update_leaf(tc, tp[k], tg[k], ts["m"][k], ts["v"][k], torch.tensor(ref_clip), bc1, bc2)
                  for k in tp}
        _assert_tree_equal(jp, {k: v[0] for k, v in at_ref.items()}, "params at the reference's clip")
        _assert_tree_equal(js["m"], {k: v[1] for k, v in at_ref.items()}, "m at the reference's clip")
        _assert_tree_equal(js["v"], {k: v[2] for k, v in at_ref.items()}, "v at the reference's clip")
        tp, ts = topt.apply_updates(tc, tp, tg, ts)
        gap = max(float(np.abs(_flat(jax.tree.map(np.asarray, jp))[k] - tp[k].numpy()).max()) for k in tp)
        assert gap <= 2 * np.spacing(np.float32(8.0)) * 2, gap  # a few ulps of |p| <= ~5
        # continue from the reference's state so each step starts equal
        tp = {k: torch.tensor(v) for k, v in _flat(jax.tree.map(np.asarray, jp)).items()}
        ts = {"step": ts["step"], "m": {k: torch.tensor(_bits(v)).to(getattr(torch, moments))
                                         for k, v in _flat(js["m"]).items()},
              "v": {k: torch.tensor(_bits(v)).to(getattr(torch, moments)) for k, v in _flat(js["v"]).items()}}


def test_compress_decompress_bit_equal_round_half_even():
    """Values that land exactly on .5 steps of the scale round to even in
    both frameworks; the int8 values and the bf16 error match bit for bit."""
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 100.25, 0.0], np.float32)
    err = np.zeros_like(g)
    jg, je = jopt._compress_decompress(jnp.asarray(g), jnp.asarray(err).astype(jnp.bfloat16))
    tg, te = topt._compress_decompress(torch.tensor(g), torch.tensor(err).bfloat16())
    assert np.array_equal(np.asarray(jg), tg.numpy())
    assert np.array_equal(_bits(je), _bits(te))
    assert tg.numpy()[1:6].tolist() == [0.0, 2.0, 2.0, -0.0, -4.0]
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        g = rng.standard_normal(4096).astype(np.float32)
        e = (rng.standard_normal(4096) * 1e-3).astype(np.float32)
        jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        jg, je = jopt._compress_decompress(jnp.asarray(g).astype(jd), jnp.asarray(e).astype(jnp.bfloat16))
        tg, te = topt._compress_decompress(torch.tensor(g).to(dtype), torch.tensor(e).bfloat16())
        assert tg.dtype == dtype and np.array_equal(_bits(jg), _bits(tg)) and np.array_equal(_bits(je), _bits(te))


def test_init_state_over_a_module():
    model = torch.nn.Linear(4, 3)
    st = topt.init_state(topt.OptimConfig(m_dtype="bfloat16", compress_grads=True), model)
    assert sorted(st["m"]) == ["bias", "weight"] and st["m"]["weight"].dtype == torch.bfloat16
    assert st["v"]["weight"].dtype == torch.float32 and st["err"]["bias"].dtype == torch.bfloat16
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


# ------------------------------ checkpoints --------------------------------- #


def _tstate(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(8, 4, generator=g), "b": torch.zeros(4)}
    return {"params": params, "opt": topt.init_state(topt.OptimConfig(), params)}


def _cross_state(seed=0):
    """A nested dict of float32 and int32 arrays, as both packages hold it."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 4)).astype(np.float32), "b": np.zeros(4, np.float32),
                       "layer": {"scale": rng.standard_normal(3).astype(np.float32)}},
            "opt": {"step": np.int32(7), "m": {"w": rng.standard_normal((8, 4)).astype(np.float32)}},
            "data_step": np.int32(12)}


def _as_torch(tree):
    return {k: _as_torch(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def test_save_restore_roundtrip_with_bf16_and_int32_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _tstate()
    st["extra"] = {"bf": torch.randn(5, 3).bfloat16(), "i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                   "scalar": torch.tensor(3, dtype=torch.int32)}
    mgr.save(10, st, blocking=True)
    like = jax.tree.map(torch.zeros_like, st)
    out = mgr.restore(10, like)
    for (pa, a), (pb, b) in zip(flatten(st), flatten(out)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), pa
    with open(tmp_path / "step_10" / "manifest.json") as f:
        man = json.load(f)
    keys = [k for k, _ in flatten(st)]
    assert man["keys"][keys.index(("extra", "bf"))] == "(DictKey(key='extra'), DictKey(key='bf'))"
    assert man["dtypes"] == {str(keys.index(("extra", "bf"))): "bfloat16"}


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    st = _tstate()
    for s in (1, 2, 3, 4):
        mgr.save(s, st)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_no_tmp_dirs_after_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tstate(), blocking=True)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_save_copies_before_the_write_thread(tmp_path, monkeypatch):
    """An in-place update right after ``save`` returns does not reach the
    checkpoint: the host copy is taken in ``save``."""
    import threading

    gate = threading.Event()
    real_save = np.save

    def slow_save(*a, **k):
        gate.wait(10)
        return real_save(*a, **k)

    monkeypatch.setattr(np, "save", slow_save)
    mgr = CheckpointManager(str(tmp_path))
    st = {"w": torch.ones(4)}
    mgr.save(1, st)
    st["w"].add_(1.0)
    gate.set()
    mgr.wait()
    assert torch.equal(mgr.restore(1, st)["w"], torch.ones(4))


def test_failing_write_leaves_the_previous_step_intact(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    st = _tstate()
    mgr.save(1, st, blocking=True)
    real_save = np.save
    calls = []

    def failing(path, arr, *a, **k):
        calls.append(path)
        if len(calls) == 2:
            raise OSError("disk full")
        return real_save(path, arr, *a, **k)

    monkeypatch.setattr(np, "save", failing)
    st2 = jax.tree.map(lambda t: t + 1 if t.is_floating_point() else t, st)
    mgr.save(2, st2)
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        mgr.wait()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    out = mgr.restore(1, st)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten(st), flatten(out)))
    mgr.wait()  # the error was raised once


def test_checkpoint_restores_across_packages(tmp_path):
    """Port-written restores in the reference and reference-written in the
    port: every float32 and int32 leaf bit-equal, in key order."""
    st = _cross_state(1)
    CheckpointManager(str(tmp_path / "port")).save(3, _as_torch(st), blocking=True)
    out = JaxCheckpointManager(str(tmp_path / "port")).restore(3, jax.tree.map(jnp.asarray, st))
    jf = jax.tree_util.tree_flatten_with_path(out)[0]
    assert [str(p) for p, _ in jf] == json.load(open(tmp_path / "port" / "step_3" / "manifest.json"))["keys"]
    for (_, a), (_, b) in zip(jf, flatten(st)):
        a = np.asarray(a)
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)

    st2 = _cross_state(2)
    JaxCheckpointManager(str(tmp_path / "ref")).save(5, jax.tree.map(jnp.asarray, st2), blocking=True)
    back = CheckpointManager(str(tmp_path / "ref")).restore(5, _as_torch(jax.tree.map(np.zeros_like, st2)))
    for (pa, a), (pb, b) in zip(flatten(st2), flatten(back)):
        assert pa == pb and b.dtype == torch.as_tensor(np.asarray(a)).dtype and np.array_equal(b.numpy(), a)


def test_restore_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)}, blocking=True)
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(1, {"a": torch.zeros(2), "b": torch.zeros(1)})


# -------------------------------- trainer ----------------------------------- #


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(8, 4), requires_grad=False)
        self.b = torch.nn.Parameter(torch.zeros(4), requires_grad=False)


def _problem():
    """Learnable regression-as-classification (``test_ckpt_trainer.py``'s),
    its data drawn with numpy."""
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((8, 4)).astype(np.float32)
    X = rng.standard_normal((512, 8)).astype(np.float32)
    data = {"x": X, "y": np.argmax(X @ w_true, -1).astype(np.int32)}

    def batch_fn(rng, idx):
        return {"x": data["x"][idx], "y": data["y"][idx]}

    def loss_fn(m, batch):
        logits = batch["x"] @ m.w + m.b
        return (torch.logsumexp(logits, -1) - logits.gather(-1, batch["y"][:, None].long())[:, 0]).mean()

    def jax_loss(p, batch):
        logits = batch["x"] @ p["w"] + p["b"]
        gold = jnp.take_along_axis(logits, batch["y"][:, None], -1)[:, 0]
        return jnp.mean(jax.nn.logsumexp(logits, -1) - gold)

    pipe = tpipe.DeterministicPipeline(tpipe.PipelineConfig(global_batch=64, seed=0), batch_fn, 512)
    jpipe_ = jpipe.DeterministicPipeline(jpipe.PipelineConfig(global_batch=64, seed=0), batch_fn, 512)
    return loss_fn, jax_loss, pipe, jpipe_


def _cfg(tmp, **kw):
    base = dict(n_steps=60, ckpt_every=30, ckpt_dir=str(tmp), log_every=30,
                ocfg=topt.OptimConfig(lr=5e-2, weight_decay=0.0))
    return TrainConfig(**{**base, **kw})


def test_trainer_loss_decreases(tmp_path):
    loss_fn, _, pipe, _ = _problem()
    tr = Trainer(_cfg(tmp_path), loss_fn, Linear(), pipe, device="cpu")
    assert all(p.requires_grad for p in tr.model.parameters())
    with torch.no_grad():
        first = float(loss_fn(tr.model, tr.to_device(pipe.batch_at(0))))
    out = tr.run()
    assert out["final_loss"] < first * 0.5 and out["steps"] == 60


def test_trainer_restart_after_injected_failure(tmp_path):
    loss_fn, _, pipe, _ = _problem()
    tr = Trainer(_cfg(tmp_path, n_steps=50, ckpt_every=10, log_every=50, fail_at_step=25), loss_fn, Linear(),
                 pipe, device="cpu")
    out = tr.run_with_restarts(max_restarts=1)
    assert out["steps"] == 50
    assert tr.ckpt.latest_step() == 50


def test_injected_failure_raises_once(tmp_path):
    loss_fn, _, pipe, _ = _problem()
    tr = Trainer(_cfg(tmp_path, n_steps=10, fail_at_step=3), loss_fn, Linear(), pipe, device="cpu")
    with pytest.raises(InjectedFailure):
        tr.run()
    assert tr.run()["steps"] == 10  # injected once


def test_crash_and_resume_bit_equal_to_uninterrupted(tmp_path):
    """A run that crashes at step 25 and resumes from its step-20
    checkpoint ends with the same parameters, moments, step counters and
    logged losses, bit for bit, as one that does not crash."""
    loss_fn, _, pipe, _ = _problem()
    ocfg = topt.OptimConfig(lr=5e-2, weight_decay=1e-3, compress_grads=True, m_dtype="bfloat16")
    a = Trainer(_cfg(tmp_path / "a", n_steps=50, ckpt_every=10, log_every=5, fail_at_step=25, ocfg=ocfg), loss_fn,
                Linear(), pipe, device="cpu")
    b = Trainer(_cfg(tmp_path / "b", n_steps=50, ckpt_every=10, log_every=5, ocfg=ocfg), loss_fn, Linear(), pipe,
                device="cpu")
    a.run_with_restarts(max_restarts=1)
    b.run()
    assert a.ckpt.all_steps() == b.ckpt.all_steps() == [30, 40, 50]
    for (pa, x), (pb, y) in zip(flatten(a.state), flatten(b.state)):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa
    assert int(a.state["data_step"]) == int(a.state["opt"]["step"]) == 50
    # the crashed run logged steps 5..25 twice over: 5..20, then 25..50 again from 20
    assert a.losses[-6:] == b.losses[-6:]


def test_grad_compression_error_feedback_converges(tmp_path):
    loss_fn, _, pipe, _ = _problem()
    tr = Trainer(_cfg(tmp_path, ocfg=topt.OptimConfig(lr=5e-2, weight_decay=0.0, compress_grads=True)), loss_fn,
                 Linear(), pipe, device="cpu")
    with torch.no_grad():
        first = float(loss_fn(tr.model, tr.to_device(pipe.batch_at(0))))
    assert tr.run()["final_loss"] < first * 0.5


@pytest.mark.parametrize("accum", [1, 2])
def test_step_with_grad_accum_matches_reference(tmp_path, accum):
    """Two steps of the reference's jitted ``Trainer`` and the port's, from
    the same weights: losses, parameters and moments within 1e-6."""
    loss_fn, jax_loss, pipe, jp = _problem()
    ocfg = dict(lr=5e-2, weight_decay=1e-2)
    rng = np.random.default_rng(4)
    w0 = {"w": rng.standard_normal((8, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    jt = JaxTrainer(JaxTrainConfig(n_steps=2, ckpt_every=10, ckpt_dir=str(tmp_path / "j"), log_every=1,
                                   grad_accum=accum, ocfg=jopt.OptimConfig(**ocfg)),
                    jax_loss, jax.tree.map(jnp.asarray, w0), jp)
    jt.run(start_step=0)
    model = Linear()
    with torch.no_grad():
        model.w.copy_(torch.tensor(w0["w"]))
        model.b.copy_(torch.tensor(w0["b"]))
    tt = Trainer(_cfg(tmp_path / "t", n_steps=2, ckpt_every=10, log_every=1, grad_accum=accum,
                      ocfg=topt.OptimConfig(**ocfg)), loss_fn, model, pipe, device="cpu")
    tt.run(start_step=0)
    np.testing.assert_allclose(tt.losses, jt.losses, rtol=1e-6, atol=0)
    for name in ("w", "b"):
        np.testing.assert_allclose(tt.state["params"][name].detach().numpy(),
                                   np.asarray(jt.state["params"][name]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt.state["opt"]["m"][name].numpy(), np.asarray(jt.state["opt"]["m"][name]),
                                   rtol=0, atol=1e-6)
    assert int(tt.state["data_step"]) == int(jt.state["data_step"]) == 2
