"""The port's sharding scaffolding against the JAX reference's, on the CPU.

* The reference's ``tests/test_sharding.py`` cases: a non-divisible axis
  dropped, no mesh axis used twice, ``fsdp_spec``, ``pad_heads``, ``shard``
  a no-op off a mesh; and ``shard``/``host_shard`` on a real (1, 1) gloo
  ``DeviceMesh``, placements checked (the case the reference's own mesh
  test cannot run under jax 0.9.0's ``Explicit`` axes).
* For every (arch × shape) that is not skipped, on both production meshes
  (the reference's side is shape-only, so FULL configs cost nothing):
  ``make_plan``, ``make_rules``, ``input_shardings``, ``n_params`` (padded
  heads included), every leaf's spec on the reference's logical dims
  (through the ``params_from_jax`` names), ``tree_fsdp`` for train cells,
  the per-chip parameter and optimizer-state bytes, and the shapes and
  dtypes of ``input_specs`` and ``state_struct``.
* Each leaf's ``order`` moves values as ``params_from_jax`` does, on every
  arch's SMOKE tree.
* Padded heads: qwen-smoke at ``model_axis=3`` (4 -> 6 heads) against the
  reference on converted weights, and against its own crop.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from _ref_tree import draw_tree
from repro.configs.base import get_arch as jget_arch
from repro.configs.qwen15_32b import SMOKE as JAX_QWEN_SMOKE
from repro.launch import cells as jcells
from repro.models import api as japi
from repro.models import transformer as jt
from repro.models.ptree import TensorSpec
from repro.train import optim as joptim
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.configs.qwen15_32b import SMOKE as QWEN_SMOKE
from repro_torch.launch import cells as tcells
from repro_torch.launch.mesh import ShapeMesh, make_local_mesh, make_production_mesh, make_streams_mesh, process_group
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import transformer as tt
from repro_torch.models.layers import LINEAR, QKV, flat, leaf, pad_heads
from repro_torch.models.ptree import leaf_pspec, port_spec, tree_pspec
from repro_torch.sharding.axes import (
    DEFAULT_RULES,
    host_shard,
    logical_axis_multiple,
    placements,
    shard,
    sharding_ctx,
)
from repro_torch.sharding.fsdp import fsdp_spec
from repro_torch.train import optim as toptim
from test_torch_lm import FWD_ATOL, _tokens

MESHES = {"single": ShapeMesh(("data", "model"), (16, 16)),
          "multi": ShapeMesh(("pod", "data", "model"), (2, 16, 16))}
CELLS = [(a, s) for a in list_archs() for s, sh in get_arch(a).shapes.items() if not sh.skip]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32, "int8": torch.int8}


class _FakeMesh:
    """The reference's shape-only mesh (``tests/test_sharding.py:14-19``)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


# --------------------------------------------------------------------------- #
# The reference's cases
# --------------------------------------------------------------------------- #


def test_tree_pspec_drops_non_divisible():
    rules = dict(DEFAULT_RULES, _sizes={"data": 16, "model": 16})
    leaves = {"wq": leaf((512, "embed"), (40, "q_heads"), (128, "head_dim")),  # 40 % 16 != 0
              "wg": leaf((512, "embed"), (1408, "mlp"), order=LINEAR)}
    ps = tree_pspec(leaves, rules)
    assert ps["wq"] == (None, None, None)  # dropped, replicated
    assert ps["wg"] == (None, "model")
    assert port_spec(leaves["wg"], ps["wg"]) == ((1408, 512), ("model", None))


def test_tree_pspec_no_axis_reuse():
    rules = dict(DEFAULT_RULES, _sizes={"model": 16})
    assert leaf_pspec(leaf((64, "q_heads"), (64, "mlp")), rules) == ("model", None)  # first dim wins


def test_fsdp_spec_adds_data_axis():
    for mesh in (_FakeMesh({"data": 16, "model": 16}), ShapeMesh(("data", "model"), (16, 16))):
        assert fsdp_spec((None, "model"), (4096, 1408), mesh) == ("data", "model")
        # a non-divisible first dim falls through to another dim
        assert fsdp_spec((None, None), (30, 4096), mesh) == (None, "data")


def test_pad_heads():
    assert pad_heads(40, 16) == 48
    assert pad_heads(56, 16) == 64
    assert pad_heads(32, 16) == 32
    assert pad_heads(7, 1) == 7


def test_shard_is_noop_without_mesh():
    x = torch.ones(4, 4)
    assert shard(x, "batch", None) is x
    assert host_shard(x, "batch", None) is x
    assert logical_axis_multiple("streams") == 1
    with sharding_ctx(make_production_mesh()):  # a shape-only mesh has no devices to place on
        assert shard(x, "batch", None) is x
        assert logical_axis_multiple("streams") == 16


def test_shard_and_host_shard_on_a_gloo_mesh():
    """A (1, 1) ("data", "model") ``DeviceMesh`` on the CPU: each gives a
    ``DTensor`` whose placements are the resolved spec."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    with process_group("cpu"):
        mesh = make_local_mesh(model_axis=4, data_axis=2, device="cpu")  # clamped to the one process
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="devices"):
            make_streams_mesh(2, device="cpu")
        with sharding_ctx(mesh):
            x = host_shard(torch.arange(32.0).reshape(4, 8), "batch", "mlp_act")
            assert isinstance(x, DTensor) and x.placements == (Shard(0), Shard(1))
            y = shard(x * 2, None, "mlp_act")
            assert y.placements == (Replicate(), Shard(1))
            np.testing.assert_array_equal(y.to_local().numpy(), 2 * np.arange(32.0).reshape(4, 8))
            # a parameter on its port view: wqkv (3·H·Dh, d) shards as (3, H·Dh, d) on dim 1
            w = leaf((3, "stack"), (8, "embed"), (4, "q_heads"), (2, "head_dim"), order=QKV)
            view, spec = port_spec(w, (None, None, "model", None))
            assert view == (3, 8, 8) and spec == (None, "model", None)
            d = distribute_tensor(torch.zeros(w.shape).view(view), mesh, placements(spec, mesh))
            assert d.placements == (Replicate(), Shard(1))


def test_port_spec_splits_a_merged_dim_at_a_sharded_inner_dim():
    """``wq`` (H·Dh, d) with H sharded keeps its shape; ``bqkv`` (3·H·Dh,)
    with H sharded is viewed as (3, H·Dh); an unsharded leaf keeps its own."""
    wq = leaf((512, "embed"), (16, "q_heads"), (64, "head_dim"), order=((1, 2), (0,)))
    assert port_spec(wq, (None, "model", None)) == ((1024, 512), ("model", None))
    bqkv = leaf((3, "stack"), (16, "q_heads"), (64, "head_dim"), order=flat(3), const=True)
    assert port_spec(bqkv, (None, "model", None)) == ((3, 1024), (None, "model"))
    assert port_spec(bqkv, (None, None, None)) == ((3072,), (None,))


# --------------------------------------------------------------------------- #
# Every cell against the reference's
# --------------------------------------------------------------------------- #


def _paths(tree) -> dict:
    leaf = lambda x: isinstance(x, (TensorSpec, PartitionSpec, jax.ShapeDtypeStruct))
    return {tuple(p.key for p in path): v for path, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]}


def _index(x):
    """One layer's part of a stacked reference leaf: its leading dim dropped."""
    if isinstance(x, TensorSpec):
        return TensorSpec(x.shape[1:], x.axes[1:], x.dtype, x.init, x.init_scale, x.fan_in)
    if isinstance(x, PartitionSpec):
        assert not x or x[0] is None, "a stacked layers dim is sharded"
        return PartitionSpec(*x[1:])
    return jax.ShapeDtypeStruct(x.shape[1:], x.dtype)


def _by_port_name(spec_tree, tree) -> dict:
    """{port name: layer value} of ``tree`` (a reference tree shaped like
    the TensorSpec tree ``spec_tree``), named as ``params_from_jax`` names
    the leaves: a stacked ``layers`` group unstacked, ``dense`` first, then
    ``moe``; each stacked value given per layer."""
    specs, vals = _paths(spec_tree), _paths(tree)
    n = {path[1]: s.shape[0] for path, s in specs.items() if path[0] == "layers" and path[1] in ("all", "dense", "moe")}
    offset = {"all": 0, "dense": 0, "moe": n.get("dense", 0)}
    out = {}
    for path, s in specs.items():
        v = vals[path]
        if path[0] == "layers" and path[1] in offset:
            for i in range(s.shape[0]):
                out[f"layers.{offset[path[1]] + i}." + ".".join(path[2:])] = _index(v)
        else:
            out[".".join(path)] = v
    return out


def _ref_cell(arch, shape, mesh_kind):
    mesh = MESHES[mesh_kind]
    return jcells.build_cell(arch, shape, _FakeMesh(dict(zip(mesh.axis_names, mesh.shape))))


def _spec(ps, n):
    return tuple(ps) + (None,) * (n - len(ps))


def _ref_bytes_per_chip(structs, specs, sizes):
    total = 0
    for k, s in structs.items():
        shards = 1
        for e in specs[k]:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    shards *= sizes[a]
        total += math.prod(s.shape) * jnp.dtype(s.dtype).itemsize // shards
    return total


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_matches_reference(arch, shape, mesh_kind):
    ref = _ref_cell(arch, shape, mesh_kind)
    cell = tcells.build_cell(arch, shape, MESHES[mesh_kind])
    # plans, rules, parameter counts (padded heads included)
    assert dataclasses.asdict(cell.plan) == dataclasses.asdict(ref.plan)
    assert cell.rules == ref.rules
    assert cell.n_params == ref.n_params and cell.n_active_params == ref.n_active_params
    assert cell.param_dtype == DTYPES[jnp.dtype(jcells.param_dtype_policy(ref.cfg, ref.shape)).name]

    # every leaf's dims, logical axes and spec on the reference's view
    leaves = cell.handle.leaves()
    jspec = ref.handle.param_spec
    ref_spec = _by_port_name(jspec, jspec)
    ref_ps = _by_port_name(jspec, ref.handle.pspecs(ref.rules))
    assert set(leaves) == set(ref_spec)
    for k, l in leaves.items():
        assert tuple(n for n, _ in l.ref) == ref_spec[k].shape, k
        assert tuple(a for _, a in l.ref) == ref_spec[k].axes, k
        assert l.f32 == (ref_spec[k].dtype == jnp.float32), k
    ports = cell.handle.pspecs(cell.rules)
    for k, l in leaves.items():
        assert ports[k] == _spec(ref_ps[k], len(l.ref)), k

    # inputs: shapes, dtypes, shardings
    jins, tins = japi.input_specs(ref.cfg, ref.shape, ref.plan), cell.inputs
    for path, s in jax.tree_util.tree_flatten_with_path(jins)[0]:
        t = tins
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == s.shape and t.dtype == DTYPES[jnp.dtype(s.dtype).name] and t.is_meta
    jsh = jcells.input_shardings(ref.cfg, ref.shape, None, ref.rules, ref.plan)
    tsh = cell.input_specs
    for path, ps in jax.tree_util.tree_flatten_with_path(jsh, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        t = tsh
        for p in path:
            t = t[p.key]
        assert t == _spec(ps, len(t)), path

    # FSDP for train cells; per-chip bytes of the parameters and the optimizer state
    sizes = cell.sizes
    ref_struct = ref.arg_structs[0]["params"] if ref.shape.kind == "train" else ref.arg_structs[0]
    ref_pspecs = ref.arg_shardings[0]["params"] if ref.shape.kind == "train" else ref.arg_shardings[0]
    flat_specs = jax.tree.leaves(ref_pspecs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    flat_structs = jax.tree.leaves(ref_struct)
    ref_params = _ref_bytes_per_chip(dict(enumerate(flat_structs)),
                                     {i: _spec(p, len(s.shape)) for i, (p, s) in enumerate(zip(flat_specs, flat_structs))},
                                     sizes)
    state = cell.state_bytes_per_chip()
    assert state["params"] == ref_params
    if ref.shape.kind == "train":
        fsdp = _by_port_name(jspec, ref_pspecs)
        for k, l in leaves.items():
            assert cell.param_specs[k] == _spec(fsdp[k], len(l.ref)), k
        ostruct = ref.arg_structs[0]["opt"]
        ref_opt = 4 + sum(_ref_bytes_per_chip(dict(enumerate(jax.tree.leaves(ostruct[key]))),
                                              {i: _spec(p, len(s.shape)) for i, (p, s) in
                                               enumerate(zip(flat_specs, jax.tree.leaves(ostruct[key])))}, sizes)
                          for key in ("m", "v", "err") if key in ostruct)
        assert state["opt_state"] == ref_opt
        # state_struct: each leaf's dtype, and its shape in the port's layout
        m = _by_port_name(jspec, ostruct["m"])
        for k, t in cell.opt_struct["m"].items():
            assert t.dtype == DTYPES[jnp.dtype(m[k].dtype).name] and t.is_meta
            assert tuple(t.shape) == leaves[k].shape and math.prod(t.shape) == math.prod(m[k].shape)
        assert cell.opt_struct["step"].dtype == torch.int32 and set(cell.opt_struct) == set(ostruct)


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_leaf_order_moves_values_as_params_from_jax(arch):
    """On the SMOKE tree, each leaf's ``order`` (reference dims -> port dims)
    gives the layout ``params_from_jax`` gives, value for value."""
    jspec = japi.build(jget_arch(arch).smoke).param_spec
    tree = _by_port_name(jspec, jspec)
    leaves = tapi.build(get_arch(arch).smoke).leaves()
    for k, l in leaves.items():
        x = torch.arange(math.prod(tree[k].shape), dtype=torch.float64).reshape(tree[k].shape)
        parent = k.split(".")[-2] if "." in k else ""
        want = x if parent == "moe" else convert._layout(k.split(".")[-1], x)
        got = x.permute(*[i for g in l.order for i in g]).reshape(l.shape)
        assert torch.equal(got, want), k


def test_state_struct_matches_reference():
    ocfg = toptim.OptimConfig(m_dtype="bfloat16", compress_grads=True)
    struct = tapi.build(QWEN_SMOKE).struct(torch.float32)
    st = toptim.state_struct(ocfg, struct)
    ref = joptim.state_struct(joptim.OptimConfig(m_dtype="bfloat16", compress_grads=True),
                              {"w": jax.ShapeDtypeStruct((3, 4), jnp.float32)})
    assert set(st) == set(ref) == {"step", "m", "v", "err"}
    assert st["step"].shape == () and st["step"].dtype == torch.int32
    for k, t in struct.items():
        assert st["m"][k].shape == t.shape and st["m"][k].dtype == torch.bfloat16 and st["m"][k].is_meta
        assert st["v"][k].dtype == torch.float32 and st["err"][k].dtype == torch.bfloat16


# --------------------------------------------------------------------------- #
# Padded heads
# --------------------------------------------------------------------------- #


def test_padded_head_lm_matches_reference_and_its_crop():
    """qwen-smoke at model axis 3 pads 4 heads to 6 (kv too: MHA).  With
    the dead heads' ``wo`` columns and biases at 0, the padded port model
    matches the reference's padded model on the same converted weights,
    and the port's unpadded model on the crop of those weights."""
    jplan_p = jt.ParallelPlan(model_axis=3, pad_attention_heads=True, remat=False)
    tplan_p = tt.ParallelPlan(model_axis=3, pad_attention_heads=True, remat=False)
    assert jt.effective_heads(JAX_QWEN_SMOKE, jplan_p) == tt.effective_heads(QWEN_SMOKE, tplan_p) == (6, 6)
    assert tt.cache_spec(QWEN_SMOKE, tplan_p, 2, 8)["k"][0] == jt.cache_spec(JAX_QWEN_SMOKE, jplan_p, 2, 8)["k"].shape
    tree = draw_tree(jt.lm_param_spec(JAX_QWEN_SMOKE, jplan_p), seed=5)
    attn = tree["layers"]["all"]["attn"]
    attn["wo"][:, 4:] = 0.0
    for k in ("bq", "bk", "bv"):
        attn[k][:, 4:] = 0.0
    padded = tt.TransformerLM(QWEN_SMOKE, tplan_p, device="cpu", dtype=torch.float32)
    padded.load_state_dict(convert.params_from_jax(tree), strict=True)
    assert tapi.build(QWEN_SMOKE, tplan_p).n_params() == japi.build(JAX_QWEN_SMOKE, jplan_p).n_params()

    toks = _tokens(2, 8, QWEN_SMOKE.vocab_size, seed=3)
    jf, _ = jt.lm_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), JAX_QWEN_SMOKE, jplan_p)
    tf, _ = tt.lm_forward(padded, torch.as_tensor(toks), QWEN_SMOKE, tplan_p)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)

    Dh = QWEN_SMOKE.d_head
    crop = {}
    for k, v in padded.state_dict().items():
        key = k.split(".")[-1]
        if key in ("wq", "wk", "wv", "bq", "bk", "bv"):
            v = v[:4 * Dh]
        elif key == "wo" and ".attn." in k:
            v = v[:, :4 * Dh]
        crop[k] = v
    unpadded = tt.TransformerLM(QWEN_SMOKE, tt.ParallelPlan(remat=False), device="cpu", dtype=torch.float32)
    unpadded.load_state_dict(crop, strict=True)
    tc, _ = tt.lm_forward(unpadded, torch.as_tensor(toks), QWEN_SMOKE, tt.ParallelPlan(remat=False))
    np.testing.assert_allclose(tf.numpy(), tc.numpy(), rtol=0, atol=FWD_ATOL)
