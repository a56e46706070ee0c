"""Dry run and roofline of every (arch × shape × mesh) cell (port of
``repro.launch.dryrun``).

Analytic mode, for one cell on a production mesh (shape-only; nothing is
allocated): the cell's step is counted on the meta device
(``cells.count_cell``; ``roofline.CostCounter``), and the record gives
the FLOPs and bytes, globally and per chip (global / chips: with no SPMD
partitioner there are no collective bytes, and the collective term is
left out), the parameter counts, each chip's parameter, optimizer-state
and input bytes from the resolved specs (FSDP for train; a lower bound on
its memory, not a peak), the roofline terms at the H100's peaks, and the
'useful' model FLOPs.  Deep LM train and prefill cells take the
reference's two-point depth diff: count depth L_a and L_a + 1, and
extrapolate total = cost(L_a) + (L - L_a)·delta.

Card mode, for one cell on a (1, 1) ``DeviceMesh`` over the card: the
cell's FULL step runs at the cell's own shape on weights drawn from a
seed, its inputs placed through ``host_shard``; the record adds ms per
step (CUDA events: a warm-up, then the median of 5), peak card memory,
the FLOPs counted on the card (a run under the counter, which must equal
the meta count), the achieved TFLOP/s and the fraction of the roofline
bound.  The train cells of attention models are skipped there: the flash
kernel has no backward.

Usage:
  python -m repro_torch.launch.dryrun --all --mesh both            (analytic, any machine)
  python -m repro_torch.launch.dryrun --arch resnet-50 --shape serve_b128 --mesh card
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import statistics
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import torch

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.launch import roofline as rl
from repro_torch.launch.cells import build_cell, count_cell, step_args
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models.transformer import ParallelPlan

NO_COLLECTIVES = "no SPMD partitioner: no collective bytes are counted, so the collective term is left out"
STATE_NOTE = ("parameters + optimizer state + inputs per chip from the resolved specs: a lower bound on "
              "memory (no activation or temporary is counted), not a compiler's peak")
NO_BACKWARD = ("train cell of an attention model: the flash-attention kernel has no backward and its "
               "wrapper refuses autograd")


@functools.cache
def flops_per_sample(arch_id: str, shape_name: str) -> float:
    """The batch-1 forward of a vision or diffusion cell, counted on meta
    at the shape's resolution with no mesh (``_ref_flops_per_sample``).
    It depends on its arguments only, so each process counts it once."""
    spec = get_arch(arch_id)
    shape = dataclasses.replace(spec.shapes[shape_name], batch=1, global_batch=1)
    cfg = api.config_for_shape(spec.full, shape)
    handle = api.build(cfg, ParallelPlan(model_axis=1, analysis_unroll=True, remat=False))
    ins = api.input_specs(cfg, shape, handle.plan)
    ins = ins.get("batch", ins)
    args = (ins["images"],) if "images" in ins else (ins["latents"], ins["t"], ins["cond"])
    with torch.device("meta"):
        model = handle.init(None, "meta", None)
    with torch.no_grad(), rl.CostCounter() as c:
        handle.forward(model, *args)
    return float(c.flops)


def _analysis(arch_id: str, shape_name: str, mesh) -> tuple[dict, object]:
    """(the cost fields of a record, the FULL-depth cell)."""
    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    full = spec.full
    out: dict = {}
    if spec.family in ("lm", "moe-lm") and shape.kind in ("train", "prefill"):
        fkd = full.moe.first_k_dense if full.moe is not None else 0
        la, lb = fkd + 1, fkd + 2
        ca, cb = (count_cell(build_cell(arch_id, shape_name, mesh, analysis=True,
                                        cfg_override=dataclasses.replace(full, n_layers=n))) for n in (la, lb))
        n_extra = full.n_layers - la
        flops, bytes_ = ca.flops + n_extra * (cb.flops - ca.flops), ca.bytes + n_extra * (cb.bytes - ca.bytes)
        out["cost_method"] = f"diff(L={la},{lb})x{full.n_layers}"
        cell = build_cell(arch_id, shape_name, mesh)
    else:
        cell = build_cell(arch_id, shape_name, mesh, analysis=True)
        c = count_cell(cell)
        flops, bytes_ = c.flops, c.bytes
        out["cost_method"] = "direct"
    out.update(flops_global=float(flops), bytes_global=float(bytes_))
    return out, cell


def run_cell(arch_id: str, shape_name: str, mesh_kind: str) -> dict:
    """The analytic record of one cell on the ``single`` (16, 16) or
    ``multi`` (2, 16, 16) production mesh."""
    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind}
    if shape.skip:
        rec.update(status="skipped", reason=shape.skip_reason)
        return rec
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size
    cost, cell = _analysis(arch_id, shape_name, mesh)
    rec.update(cost)
    rec["count_s"] = round(time.time() - t0, 3)

    full = spec.full
    n_params = api.build(full).n_params()
    n_active = getattr(full, "active_param_count", n_params)
    flops, bytes_ = cost["flops_global"] / n_chips, cost["bytes_global"] / n_chips
    terms = rl.roofline_terms(flops, bytes_, 0.0)
    tokens = shape.global_batch * shape.seq_len if shape.seq_len else 0
    batch = shape.global_batch or shape.batch
    if spec.family in ("lm", "moe-lm"):
        decode_attn = 0.0
        if shape.kind == "decode":
            hd = full.n_heads * (full.v_head_dim or full.d_head)
            decode_attn = 4.0 * shape.seq_len * hd * full.n_layers * batch
        mf = rl.model_flops(spec.family, shape.kind, n_active=n_active, tokens=tokens, batch=batch,
                            decode_attn=decode_attn)
    else:
        ref = flops_per_sample(arch_id, shape_name)
        mf = ref * batch * (3.0 if shape.kind == "train" else 1.0)  # bwd ≈ 2x fwd
        rec["ref_fwd_flops_per_sample"] = ref
    state = cell.state_bytes_per_chip()
    rec.update(
        status="ok",
        n_chips=n_chips,
        n_params=n_params,
        n_active_params=int(n_active),
        flops_per_chip=flops,
        bytes_per_chip=bytes_,
        collective_bytes_per_chip=None,
        collectives=NO_COLLECTIVES,
        memory={**{f"{k}_bytes_per_chip": v for k, v in state.items()}, "hbm_bytes": rl.hbm_bytes(),
                "note": STATE_NOTE},
        compute_s=terms.compute_s,
        memory_s=terms.memory_s,
        collective_s=None,
        dominant=terms.dominant,
        bound_s=terms.bound_s,
        model_flops_global=mf,
        model_flops_per_chip=mf / n_chips,
        useful_ratio=(mf / n_chips) / max(flops, 1e-30),
        roofline_fraction=(mf / n_chips / rl.PEAK_FLOPS_BF16) / max(terms.bound_s, 1e-30),
    )
    return rec


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in list_archs() for s in get_arch(a).shapes]


def _run_arch(arch_id: str, meshes: tuple) -> list[dict]:
    """Every cell of one arch on ``meshes`` (one worker's share)."""
    return [_safe(arch_id, s, mk) for s in get_arch(arch_id).shapes for mk in meshes]


def _safe(arch_id, shape_name, mesh_kind) -> dict:
    t0 = time.time()
    try:
        rec = run_cell(arch_id, shape_name, mesh_kind)
    except Exception as e:  # record the failure; the sweep continues
        rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind, "status": "error",
               "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
    rec["wall_s"] = round(time.time() - t0, 3)
    return rec


def run_all(meshes=("single", "multi"), workers: int = 1) -> list[dict]:
    """Every (arch × shape) record on ``meshes``, arch by arch across
    ``workers`` spawned processes (each process counts on the CPU's meta
    device only)."""
    archs = list_archs()
    if workers <= 1:
        recs = [r for a in archs for r in _run_arch(a, tuple(meshes))]
    else:
        # the slowest arch (the UNet's train cells) first
        order = sorted(archs, key=lambda a: a != "unet-sdxl")
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
            by_arch = dict(zip(order, pool.map(_run_arch, order, [tuple(meshes)] * len(order))))
        recs = [r for a in archs for r in by_arch[a]]
    return recs


# --------------------------------------------------------------------------- #
# Card mode
# --------------------------------------------------------------------------- #


def _host_inputs(cell, seed: int) -> dict:
    """The cell's inputs drawn on the host from ``seed``: normal images,
    latents and text context, token and class ids uniform, timesteps
    spread over [0, 1000)."""
    g = torch.Generator().manual_seed(seed)

    def draw(name, t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=g).to(t.dtype)
        if name == "t":
            return torch.randint(0, 1000, t.shape, generator=g, dtype=t.dtype)
        cfg = cell.cfg
        hi = getattr(cfg, "vocab_size", None) or getattr(cfg, "n_classes", 2)
        return torch.randint(0, hi, t.shape, generator=g, dtype=t.dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v) for k, v in tree.items()}

    return walk(cell.inputs)


def _placed(cell, host: dict) -> tuple[dict, dict]:
    """Each input through ``host_shard`` on its logical axes (a ``DTensor``
    on the cell's mesh), then its local shard; and each one's placements."""
    from repro_torch.launch.cells import input_axes
    from repro_torch.sharding.axes import host_shard, sharding_ctx

    axes_tree = input_axes(cell.cfg, cell.shape, cell.plan)
    placements = {}

    def walk(tree, axes, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, axes[k], f"{prefix}{k}.")
            else:
                d = host_shard(v, *axes[k])
                placements[prefix + k] = tuple(str(p) for p in d.placements)
                out[k] = d.to_local()
        return out

    with sharding_ctx(cell.mesh, cell.rules):
        return walk(host, axes_tree), placements


def uses_attention(cfg) -> bool:
    """Whether the model's attention goes to the flash-attention kernel."""
    from repro_torch.configs.base import DiTConfig, UNetConfig, ViTConfig

    return isinstance(cfg, (ViTConfig, DiTConfig, UNetConfig))


def run_card_cell(arch_id: str, shape_name: str, mesh, *, seed: int = 0, reps: int = 5) -> dict:
    """One cell's FULL step on the card of ``mesh`` (a (1, 1) ``DeviceMesh``).

    The step runs once under a ``CostCounter`` (which also warms it up),
    then ``reps`` times, each between two CUDA events; ms is their median.
    The meta count of the same cell is taken beside it."""
    from repro_torch.train import optim

    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": "card", "kind": shape.kind}
    cell = build_cell(arch_id, shape_name, mesh)
    if shape.kind == "train" and uses_attention(cell.cfg):
        rec.update(status="skipped", reason=NO_BACKWARD)
        return rec
    meta = count_cell(cell)
    state = cell.state_bytes_per_chip()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = cell.handle.init(torch.Generator(device="cuda").manual_seed(seed), "cuda", cell.param_dtype)
    inputs, placements = _placed(cell, _host_inputs(cell, seed + 1))
    opt = optim.init_state(cell.ocfg, model) if shape.kind == "train" else None
    args = step_args(cell, model, inputs, opt)

    def step():
        nonlocal args
        out = cell.step(model, *args)
        if shape.kind == "train":  # the new optimizer state feeds the next step
            args = (out[1], args[1])
        return out

    with rl.CostCounter() as counter:
        out = step()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    first = out[0] if isinstance(out, tuple) else out
    finite = bool(torch.isfinite(first.float()).all())
    ms = statistics.median(times)
    terms = rl.roofline_terms(counter.flops, counter.bytes, 0.0)
    rec.update(
        status="ok", ms=ms, times_ms=times, peak_bytes=int(torch.cuda.max_memory_allocated()),
        state_bytes=state["total"], flops_card=counter.flops, bytes_card=counter.bytes, flops_meta=meta.flops,
        bytes_meta=meta.bytes, tflops=counter.flops / (ms * 1e-3) / 1e12, bound_ms=terms.bound_s * 1e3,
        dominant=terms.dominant, fraction_of_bound=terms.bound_s * 1e3 / ms, placements=placements,
        kernels={k: v[0] for k, v in counter.per_kernel.items()}, finite=finite,
        n_params=cell.n_params, param_dtype=str(cell.param_dtype).replace("torch.", ""))
    del model, inputs, args, out, opt
    torch.cuda.empty_cache()
    return rec


def run_card(cells, *, seed: int = 0) -> list[dict]:
    """``run_card_cell`` for each (arch, shape) on a (1, 1) mesh over the card."""
    from repro_torch.launch.mesh import make_local_mesh, process_group

    with process_group("cuda"):
        mesh = make_local_mesh(device="cuda")
        return [run_card_cell(a, s, mesh, seed=seed + i) for i, (a, s) in enumerate(cells)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "card"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--workers", type=int, default=1, help="processes for the analytic pass")
    ap.add_argument("--out", default="", help="write the records here as JSON")
    args = ap.parse_args()

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    t0 = time.time()
    if args.mesh == "card":
        recs = run_card(cells)
    else:
        meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
        if args.all:
            recs = run_all(meshes, workers=args.workers)
        else:
            recs = [_safe(args.arch, args.shape, mk) for mk in meshes]
    for r in recs:
        line = f"[{r['status']}] {r['arch']}__{r['shape']}__{r['mesh']}"
        if r["status"] == "ok" and "ms" in r:
            line += (f" {r['ms']:.3f} ms {r['tflops']:.1f} TFLOP/s bound {r['bound_ms']:.3f} ms"
                     f" peak {r['peak_bytes'] / 1e9:.2f} GB")
        elif r["status"] == "ok":
            line += (f" flops/chip {r['flops_per_chip']:.4e} state/chip {r['memory']['total_bytes_per_chip']:.4e}"
                     f" {r['dominant']} bound {r['bound_s'] * 1e3:.3f} ms")
        elif r["status"] == "error":
            line += f" {r['error'][:160]}"
        print(line, flush=True)
    n = {s: sum(r["status"] == s for r in recs) for s in ("ok", "skipped", "error")}
    print(f"done: ok={n['ok']} skipped={n['skipped']} failed={n['error']} in {time.time() - t0:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1, default=str)
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
