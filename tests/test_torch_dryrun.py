"""The port's dry run against the JAX reference's, on the CPU.

* ``CostCounter``: FLOPs and bytes exact on a Linear and a conv; the memo
  changes no count; each kernel dispatcher's meta branch returns the
  kernel's shapes and dtypes and reports ``kernels/cost.py``'s formula.
* ResNet-50 ``serve_b1`` counted on meta against the reference's
  ``_ref_flops_per_sample`` (XLA's ``cost_analysis`` of the same forward):
  within 1.5 % (the port's count is 8.178e9 against XLA's 8.106e9: XLA
  counts the convolutions' products alike but not the same elementwise
  ops).
* A 2-layer LM train step (qwen's family at width 256, 8 x 512 tokens)
  against ``jax.jit(step).lower(...).compile().cost_analysis()`` of the
  reference's step with no mesh: the port counts matrix products and
  attention only, XLA every elementwise op too, so the port's FLOPs are
  within [0.95, 1.0] of XLA's (0.966 measured); the port's bytes are the
  unfused eager traffic, within [1.0, 1.3] of XLA's (1.128 measured).
* ``run_cell`` records for a handful of cells, and the 8 skips.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import get_arch as jget_arch
from repro.launch import cells as jcells
from repro.launch import dryrun as jdry
from repro.launch import roofline as jrl
from repro.models import api as japi
from repro.train import optim as joptim
from repro_torch.configs.base import ShapeSpec, get_arch, list_archs
from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.fused_calib_gate.ops import calibrated_gate
from repro_torch.kernels.int8_kv_decode.ops import decode_attention
from repro_torch.kernels.int8_matmul.ops import quantized_matmul
from repro_torch.launch import cells as tcells
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.models import api as tapi
from repro_torch.train import optim as toptim

LM_FLOPS_RATIO = (0.95, 1.0)  # port / XLA on the 2-layer train step; 0.966 measured
LM_BYTES_RATIO = (1.0, 1.3)  # 1.128 measured
RESNET_RTOL = 0.015


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_counter_exact_on_a_linear_and_a_conv():
    x, w, b = _meta(8, 64), _meta(32, 64), _meta(32)
    with rl.CostCounter() as c:
        F.linear(x, w, b)
    assert c.flops == 2 * 8 * 64 * 32
    assert c.bytes == (8 * 64 + 32 * 64 + 32 + 8 * 32) * 4
    x, w = _meta(2, 3, 16, 16, dtype=torch.bfloat16), _meta(8, 3, 3, 3, dtype=torch.bfloat16)
    with rl.CostCounter() as c:
        y = F.conv2d(x, w, padding=1)
    assert c.flops == 2 * 2 * 8 * 16 * 16 * 27
    assert c.bytes == (x.numel() + w.numel() + y.numel()) * 2
    # the same on CPU tensors, values and all
    x, w = torch.ones(2, 3, 16, 16), torch.ones(8, 3, 3, 3)
    with rl.CostCounter() as c2:
        F.conv2d(x, w, padding=1)
    assert c2.flops == c.flops and c2.bytes == 2 * c.bytes


def test_counter_memo_changes_no_count(monkeypatch):
    cell = tcells.build_cell("dit-b2", "train_256", ShapeMesh(("data", "model"), (16, 16)))
    counts = []
    for memo in (False, True):
        if not memo:  # every op runs
            monkeypatch.setattr(rl, "_memo_key", lambda *a: None)
        with torch.device("meta"):
            model = cell.handle.init(None, "meta", cell.param_dtype)
        opt = toptim.state_struct(cell.ocfg, cell.param_struct)
        with rl.CostCounter() as c:
            cell.step(model, *tcells.step_args(cell, model, cell.inputs, opt))
        counts.append((c.flops, c.bytes))
        monkeypatch.undo()
    assert counts[0] == counts[1]


def test_counter_memo_keeps_to_meta_inputs():
    """Ops on CPU tensors, and factory ops with no tensor input, run each
    time: their outputs keep their device and values."""
    with rl.CostCounter() as c:
        for _ in range(2):
            z = torch.arange(4.0)
            y = z * 2
    assert not c.memo
    assert z.device.type == y.device.type == "cpu" and y.tolist() == [0.0, 2.0, 4.0, 6.0]
    with rl.CostCounter() as c:
        for _ in range(2):
            y = torch.ones(4, device="meta") * 2
    assert y.is_meta and len(c.memo) == 1  # the product; ones has no tensor input


def test_dispatchers_on_meta_give_shapes_and_report_the_formula():
    q = _meta(2, 40, 4, 64, dtype=torch.bfloat16)
    with rl.CostCounter() as c:
        o = attention(q, q, q, causal=True)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
    assert (c.flops, c.bytes) == cost.attention_cost(2, 40, 40, 4, 64, True, 2)
    assert c.flops == 4 * 2 * 4 * 64 * (40 * 41 // 2) and dict(c.per_kernel) == {"flash_attention": [1, c.flops, c.bytes]}
    with rl.CostCounter() as c:
        calib, gate = calibrated_gate(_meta(5, 1000), -20.0, 5.0, 0.5)
    assert calib.shape == gate.shape == (5,) and calib.dtype == torch.float32 and gate.dtype == torch.bool
    assert (c.flops, c.bytes) == cost.calib_gate_cost(5, 1000, 4)
    qd = _meta(3, 8, 64, dtype=torch.bfloat16)
    with rl.CostCounter() as c:
        out = decode_attention(qd, _meta(3, 50, 2, 64, dtype=torch.int8), _meta(3, 50),
                               _meta(3, 50, 2, 64, dtype=torch.int8), _meta(3, 50))
    assert out.shape == qd.shape and out.dtype == torch.bfloat16
    assert (c.flops, c.bytes) == cost.decode_cost(3, 50, 2, 4, 64, 2)
    with rl.CostCounter() as c:
        y = quantized_matmul(_meta(16, 32), _meta(32, 24), out_dtype=torch.bfloat16)
    assert y.shape == (16, 24) and y.dtype == torch.bfloat16
    assert c.per_kernel["int8_matmul"] == [1, *cost.int8_matmul_cost(16, 32, 24, 2)]
    # under autograd the kernel cannot go (no backward): meta takes the plain version
    qg = _meta(2, 40, 4, 64).requires_grad_(True)
    with rl.CostCounter() as c:
        o = attention(qg, qg, qg, causal=False)
    assert o.requires_grad and "flash_attention" not in c.per_kernel and c.flops == 4 * 2 * 4 * 64 * 40 * 40


def test_causal_pairs_closed_form():
    for sq, sk in ((1, 1), (7, 7), (5, 9), (9, 5), (64, 3)):
        assert cost.causal_pairs(sq, sk) == sum(min(i + 1, sk) for i in range(sq))


def test_resnet50_serve_b1_within_xla_count():
    port = tdry.flops_per_sample("resnet-50", "serve_b1")
    ref = jdry._ref_flops_per_sample("resnet-50", "serve_b1")
    assert abs(port - ref) <= RESNET_RTOL * ref, (port, ref)


def test_lm_train_step_against_xla_cost_analysis():
    """qwen1.5-32b's family cut to 2 layers at width 256, one train step of
    8 x 512 tokens with float32 masters, AdamW and remat; no mesh."""
    narrow = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_head=64, d_ff=512, vocab_size=1024)
    jcfg = dataclasses.replace(jget_arch("qwen1.5-32b").full, **narrow)
    jshape = JShapeSpec("train_small", "train", seq_len=512, global_batch=8)
    fake = type("M", (), {"axis_names": ("data", "model"), "devices": np.empty((1, 1))})()
    jplan = jcells.make_plan(jcfg, jshape, fake, analysis=True)
    handle = japi.build(jcfg, jplan)
    ocfg = joptim.OptimConfig()
    step, _ = jcells.make_step(handle, jcfg, jshape, ocfg)
    ps = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), handle.struct())
    state = {"params": ps, "opt": joptim.state_struct(ocfg, ps)}
    ref = jrl.cost_summary(jax.jit(step).lower(state, japi.input_specs(jcfg, jshape, jplan)["batch"]).compile())

    tcfg = dataclasses.replace(get_arch("qwen1.5-32b").full, **narrow)
    tshape = ShapeSpec("train_small", "train", seq_len=512, global_batch=8)
    mesh = ShapeMesh(("data", "model"), (1, 1))
    tplan = tcells.make_plan(tcfg, tshape, mesh, analysis=True)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    th = tapi.build(tcfg, tplan)
    with torch.device("meta"):
        model = th.init(None, "meta", torch.float32)
    tstep = tcells.make_step(th, tcfg, tshape, toptim.OptimConfig())
    with rl.CostCounter() as c:
        tstep(model, toptim.state_struct(toptim.OptimConfig(), th.struct(torch.float32)),
              tapi.input_specs(tcfg, tshape, tplan)["batch"])
    lo, hi = LM_FLOPS_RATIO
    assert lo * ref["flops"] <= c.flops <= hi * ref["flops"], c.flops / ref["flops"]
    lo, hi = LM_BYTES_RATIO
    assert lo * ref["bytes"] <= c.bytes <= hi * ref["bytes"], c.bytes / ref["bytes"]


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "stablelm-12b", "deepseek-v2-lite-16b", "arctic-480b"])
def test_long_500k_is_skipped_with_the_reference_reason(arch):
    for mesh in ("single", "multi"):
        rec = tdry.run_cell(arch, "long_500k", mesh)
        assert rec["status"] == "skipped"
        assert rec["reason"] == jget_arch(arch).shapes["long_500k"].skip_reason
    skipped = [(a, s) for a in list_archs() for s, sh in get_arch(a).shapes.items() if sh.skip]
    assert len(skipped) == 4 and all(s == "long_500k" for _, s in skipped)


@pytest.mark.parametrize("arch,shape,mesh", [("resnet-50", "serve_b1", "single"), ("deit-b", "serve_b128", "multi"),
                                             ("qwen1.5-32b", "train_4k", "single"),
                                             ("dit-b2", "gen_fast", "single")])
def test_run_cell_records(arch, shape, mesh):
    rec = tdry.run_cell(arch, shape, mesh)
    spec, jspec = get_arch(arch), jget_arch(arch)
    n_chips = 256 if mesh == "single" else 512
    assert rec["status"] == "ok" and rec["n_chips"] == n_chips
    assert rec["n_params"] == japi.build(jspec.full).n_params()
    assert rec["n_active_params"] == getattr(jspec.full, "active_param_count", rec["n_params"])
    assert rec["flops_per_chip"] == rec["flops_global"] / n_chips > 0
    assert rec["bytes_per_chip"] == rec["bytes_global"] / n_chips > 0
    assert rec["collective_bytes_per_chip"] is None and rec["collective_s"] is None
    assert rec["compute_s"] == rec["flops_per_chip"] / rl.PEAK_FLOPS_BF16
    assert rec["memory_s"] == rec["bytes_per_chip"] / rl.HBM_BW
    assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"])
    mem = rec["memory"]
    assert mem["total_bytes_per_chip"] == sum(mem[f"{k}_bytes_per_chip"] for k in ("params", "opt_state", "inputs"))
    if spec.family in ("lm", "moe-lm"):
        assert rec["cost_method"] == "diff(L=1,2)x64"
        assert rec["model_flops_global"] == 6.0 * rec["n_active_params"] * 256 * 4096
        assert mem["opt_state_bytes_per_chip"] > 0
    else:
        assert rec["cost_method"] == "direct" and mem["opt_state_bytes_per_chip"] == 0
        batch = spec.shapes[shape].batch
        assert rec["model_flops_global"] == rec["ref_fwd_flops_per_sample"] * batch
    if arch in ("deit-b", "dit-b2"):  # the flash kernel's count, at its formula, is in the cell's
        cell = tcells.build_cell(arch, shape, ShapeMesh(("data", "model"), (1, 1)))
        c = tcells.count_cell(cell)
        assert c.per_kernel["flash_attention"][0] == 12


def test_lm_diff_extrapolates_the_depth():
    """The two-point depth diff equals the direct count at full depth for
    stablelm-12b's prefill at 40 layers."""
    rec = tdry.run_cell("stablelm-12b", "prefill_32k", "single")
    cell = tcells.build_cell("stablelm-12b", "prefill_32k", ShapeMesh(("data", "model"), (16, 16)))
    c = tcells.count_cell(cell)
    assert rec["cost_method"] == "diff(L=1,2)x40"
    assert rec["flops_global"] == c.flops and rec["bytes_global"] == c.bytes


def test_cli_analyses_one_cell(capsys):
    import sys

    argv = sys.argv
    sys.argv = ["dryrun", "--arch", "resnet-50", "--shape", "serve_b1", "--mesh", "both"]
    try:
        assert tdry.main() == 0
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "[ok] resnet-50__serve_b1__single" in out and "[ok] resnet-50__serve_b1__multi" in out
    assert "done: ok=2 skipped=0 failed=0" in out


def test_split_costs_take_the_roofline_compute_term():
    from repro_torch.split import costs

    assert rl.roofline_terms(3.94e12, 0.0, 0.0, peak=costs.TPU_V5E_PEAK_FLOPS_BF16).bound_s == 3.94e12 / 197e12
    assert not hasattr(costs, "roofline_compute_s")
    assert (rl.PEAK_FLOPS_BF16, rl.PEAK_FLOPS_INT8, rl.HBM_BW) == (989e12, 1979e12, 3.35e12)
