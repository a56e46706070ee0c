#!/usr/bin/env python3
"""Design variants of the port's calib-gate kernel, timed in one process.

    python3 scripts/torch_calib_gate_variants.py [--old-source FILE]

Needs an NVIDIA GPU and ``nvcc``.  At every calib-gate shape of
``chip_smoke.py``'s phase 2 (``chip_smoke.calib_gate_cases``) each variant
is checked against ``calib_gate_ref`` (calib within ``CALIB_ATOL``, gates
equal; a design variant that misses is reported, the shipped and old
kernels raise) and timed by device time from the profiler
(``chip_smoke.device_ms``), in the order shipped, variants, old, then
reversed: two readings each.

Variants of the launch plan run the shipped library under a forced
``split_plan``: ``vpt1`` … ``vpt8`` force the vectors a thread (threads
recomputed to cover the slice), ``splits1`` … ``splits16`` the blocks a
row.  At the small shapes the ``vpt`` variants are also the choice
between one warp a row (the plan's) and a block of 2-8 warps a row.
Variants of the source are the shipped ``csrc/calib_gate.cu`` with text
patches, built into ``build/calib_gate_variants/<name>/`` (one ``nvcc``
each, all started together), under the shipped plan:
  lastblock    the cluster merge replaced by the int8-KV decode kernel's:
               each block's warp 0 writes (m, s) to a global slab, and the
               last block of a row to bump an atomic counter merges
               (launched without clusters);
  allwarps     every warp of every block in both cluster barriers, both
               with release / acquire semantics (the first design built);
  nohint       plain ``ld.global.nc`` vector loads, without
               ``L1::no_allocate``;
  fence1       the first cluster barrier relaxed too, after a
               ``fence.acq_rel.cluster`` by the lane that wrote (m, s);
  exp2f        ``exp2f`` (with its denormal fix-up) in place of
               ``ex2.approx.ftz``;
  expf         ``expf(x - m)`` in place of it;
  shfl_max     the warp max by five shuffles, not one ``redux.sync``;
  prefetch     each thread issues the next chunk's loads before it reduces
               the current one;
  probe_empty  every block returns at once (the launch's floor);
  probe_noload no vector is loaded (values made from the indices);
  probe_timeline  thread 0 of each block stamps clock64 at each stage and
               globaltimer at entry and exit (printed for split plans).
The probes compute a wrong result on purpose or time themselves, and are
not checked.  ``torch.amax`` over the same logits, timed last, is a
yardstick of the read rate a library reduction reaches (it computes
another function).

``--old-source FILE`` adds the kernel this design replaced (one block a
row, 4-byte loads, f32 only), built from FILE, e.g. the output of
``git show 3d6c22f:src/repro_torch/kernels/fused_calib_gate/csrc/calib_gate.cu``
saved under ``build/``; it runs on an f32 copy of bf16 and f16 logits (the
cast pass that route needs is not timed).
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/fused_calib_gate/csrc/calib_gate.cu"
OUT = ROOT / "build" / "calib_gate_variants"

LASTBLOCK = [
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n"
     "__device__ float2 g_parts[1 << 16];  // (m, s) a block, B * splits <= 65536\n"
     "__device__ unsigned g_count[1 << 12];  // arrivals a row, B <= 4096, left zero\n"),
    ("""  if (lane == 0) part = make_float2(m, s);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // releases each block's part to rank 0
  if (rank == 0) {
    const float2 p = lane < splits ? *cluster.map_shared_rank(&part, lane) : make_float2(NEG, 0.f);
""", """  unsigned is_last = 0;
  if (lane == 0) {
    g_parts[blockIdx.x] = make_float2(m, s);
    __threadfence();
    is_last = atomicAdd(&g_count[row], 1u) == (unsigned)splits - 1;
    if (is_last) g_count[row] = 0;
  }
  if (__shfl_sync(FULL, is_last, 0)) {
    __threadfence();
    const float2 p = lane < splits ? __ldcg(&g_parts[row * splits + lane]) : make_float2(NEG, 0.f);
"""),
    ("  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\\tbarrier.cluster.wait.aligned;\" ::: \"memory\");\n", ""),
    ("  attr->val.clusterDim.x = splits;", "  attr->val.clusterDim.x = 1;"),
]
ALLWARPS = [("  if (warp != 0) return;  // warp 0 holds the block's (m, s) in every lane\n", ""),
            ("    if (lane == 0) finish(s, row, calib, gate, a, b, theta);\n    return;",
             "    if (tid == 0) finish(s, row, calib, gate, a, b, theta);\n    return;"),
            ("  if (lane == 0) part = make_float2(m, s);", "  if (tid == 0) part = make_float2(m, s);"),
            ("  if (rank == 0) {\n", "  if (rank == 0 && warp == 0) {\n"),
            ("  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\\tbarrier.cluster.wait.aligned;\" ::: \"memory\");\n",
             "  cluster.sync();\n")]
NOHINT = [("ld.global.nc.L1::no_allocate.v4.u32", "ld.global.nc.v4.u32")]
EXP2F = [("""  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((x - m) * LOG2E));
  return y;""", "  return exp2f((x - m) * LOG2E);")]
EXPF = [("""  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((x - m) * LOG2E));
  return y;""", "  return expf(x - m);")]
SHFL_MAX = [("  const float wm = __int_as_float(ordered(__reduce_max_sync(FULL, ordered(__float_as_int(m)))));\n",
             "  float wm = m;\n#pragma unroll\n"
             "  for (int off = 16; off > 0; off >>= 1) wm = fmaxf(wm, __shfl_xor_sync(FULL, wm, off));\n")]
FENCE1 = [("  cluster.sync();  // releases each block's part to rank 0\n",
           "  if (lane == 0) asm volatile(\"fence.acq_rel.cluster;\" ::: \"memory\");\n"
           "  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\\tbarrier.cluster.wait.acquire.aligned;\" ::: \"memory\");\n")]
PREFETCH = [("""  for (int64_t t0 = lo; t0 < hi; t0 += step) {
    uint4 v[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) v[k] = load_vec(body + min64(t0 + k * blockDim.x + tid, hi - 1));
""", """  uint4 nxt[VPT];
  if (lo < hi) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) nxt[k] = load_vec(body + min64(lo + k * blockDim.x + tid, hi - 1));
  }
  for (int64_t t0 = lo; t0 < hi; t0 += step) {
    uint4 v[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) v[k] = nxt[k];
    if (t0 + step < hi) {  // the next chunk's loads in flight while this one is reduced
#pragma unroll
      for (int k = 0; k < VPT; ++k) nxt[k] = load_vec(body + min64(t0 + step + k * blockDim.x + tid, hi - 1));
    }
""")]
EMPTY = [("  constexpr int N = VPT * VE;  // elements a chunk\n",
          "  constexpr int N = VPT * VE;  // elements a chunk\n  if (V > 0) return;\n")]
NOLOAD = [("v[k] = load_vec(body + min64(t0 + k * blockDim.x + tid, hi - 1));",
           "v[k] = make_uint4((uint32_t)t0 + k, tid, (uint32_t)hi, 0u);")]
STAMPS = 8  # clock64 at entry, after the loads, the block merge, barrier 1, rank 0's merge,
#             barrier 2; globaltimer (ns) at entry and exit; thread 0 of each block
TIMELINE = [
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n__device__ long long g_stamp[1 << 12][8];\n"
     "__device__ __forceinline__ long long gtimer() {\n  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
    ("  const bool edge_ok = rank == 0 && e < V;\n",
     "  const bool edge_ok = rank == 0 && e < V;\n  long long t_[8];\n  t_[6] = gtimer();\n  t_[0] = clock64();\n"),
    ("  warp_merge(m, s);\n  __shared__ float warp_m[32]", "  t_[1] = clock64();\n  warp_merge(m, s);\n  __shared__ float warp_m[32]"),
    ("  if (warp != 0) return;  // warp 0", "  t_[2] = clock64();\n  if (warp != 0) return;  // warp 0"),
    ("  cluster.sync();  // releases each block's part to rank 0\n",
     "  cluster.sync();  // releases each block's part to rank 0\n  t_[3] = clock64();\n"),
    ("  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\\tbarrier.cluster.wait.aligned;\" ::: \"memory\");\n",
     "  t_[4] = clock64();\n"
     "  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\\tbarrier.cluster.wait.aligned;\" ::: \"memory\");\n"
     "  t_[5] = clock64();\n  t_[7] = gtimer();\n"
     "  if (lane == 0 && blockIdx.x < (1 << 12)) {\n    for (int i = 0; i < 8; ++i) g_stamp[blockIdx.x][i] = t_[i];\n  }\n"),
    ("// How many clusters of `splits` blocks",
     "extern \"C\" int calib_gate_stamps(void* host, int blocks) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_stamp, (size_t)blocks * 8 * sizeof(long long));\n}\n\n"
     "// How many clusters of `splits` blocks"),
]

SOURCE_VARIANTS = {"lastblock": LASTBLOCK, "allwarps": ALLWARPS, "fence1": FENCE1, "nohint": NOHINT,
                   "exp2f": EXP2F, "expf": EXPF, "shfl_max": SHFL_MAX, "prefetch": PREFETCH,
                   "probe_empty": EMPTY, "probe_noload": NOLOAD, "probe_timeline": TIMELINE}
PLAN_VARIANTS = {**{f"vpt{v}": {"vpt": v} for v in (1, 2, 4, 8)},
                 **{f"splits{s}": {"splits": s} for s in (1, 2, 4, 8, 16)}}
FENCE_OPS = ("MEMBAR.ALL.GPU", "MEMBAR.ALL.CTA", "MEMBAR.SC.GPU", "MEMBAR.SC.CTA", "CCTL.IVALL", "UCGABAR_ARV",
             "UCGABAR_WAIT", "ERRBAR", "CGAERRBAR")
PROBES = {"probe_empty", "probe_noload", "probe_timeline"}


def variant_source(patches) -> str:
    src = SOURCE.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def old_kernel(lib):
    """The replaced kernel's C interface (logits, calib, gate, B, V, a, b,
    theta, threads, stream) with its thread rule, on an f32 copy."""
    import torch

    def call(x, a, b, theta):
        B, V = x.shape
        calib = torch.empty(B, dtype=torch.float32, device=x.device)
        gate = torch.empty(B, dtype=torch.bool, device=x.device)
        threads = min(1024, max(32, (-(-V // 8) + 31) // 32 * 32))
        err = lib.load().calib_gate_launch(x.data_ptr(), calib.data_ptr(), gate.data_ptr(), B, V,
                                           a, b, theta, threads, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old calib_gate launch failed with cudaError {err}")
        return calib, gate

    return call


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.build import CudaLibrary, build_all
    from repro_torch.kernels.fused_calib_gate import kernel as k
    from repro_torch.kernels.fused_calib_gate.ref import calib_gate_ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    libs = {}
    for name, patches in SOURCE_VARIANTS.items():
        path = OUT / name / "calib_gate.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(variant_source(patches))
        libs[name] = CudaLibrary(path, k.LIBRARY.symbols)
    old = None
    if args.old_source is not None:
        _P, _F = ctypes.c_void_p, ctypes.c_float
        old = CudaLibrary(args.old_source.resolve(),
                          {"calib_gate_launch": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                                                 _F, _F, _F, ctypes.c_int, _P]})
    build_all([k.LIBRARY, *libs.values()] + ([old] if old else []))
    for name, lib in [("shipped", k.LIBRARY), *libs.items()]:
        fences = {fn: {op: n for op, n in c.items() if n}
                  for fn, c in chip_smoke.sass_counts(lib, FENCE_OPS).items() if "ILi0ELi4E" in fn}
        print(f"  {name:15s} f32 vpt=4 SASS fences and barriers: {list(fences.values())}")
    shipped_lib, shipped_plan = k.LIBRARY, k.split_plan
    old_fn = old_kernel(old) if old else None

    def use(name):
        """The call for variant ``name``: (logits, a, b, theta) -> (calib, gate)."""
        k.LIBRARY, k.split_plan = shipped_lib, shipped_plan
        if name == "old":
            return lambda x, *p: old_fn(x.float() if x.dtype != torch.float32 else x, *p)
        if name in libs:
            k.LIBRARY = libs[name]
        elif name in PLAN_VARIANTS:
            k.split_plan = functools.partial(shipped_plan, **PLAN_VARIANTS[name])
        return k.calib_gate

    names = ["shipped", *PLAN_VARIANTS, *SOURCE_VARIANTS] + (["old"] if old else [])
    order = names + names[::-1]
    for case, x in chip_smoke.calib_gate_cases(torch):
        B, V = x.shape
        xo = x.float() if x.dtype != torch.float32 else x
        want = calib_gate_ref(x, -20.0, 5.0, 0.3)
        times = {name: [] for name in names}
        for name in order:
            fn = use(name)
            xi = xo if name == "old" else x
            if name not in ("shipped", "old"):
                try:
                    fn(xi, -20.0, 5.0, 0.3)
                except RuntimeError as e:  # a forced plan the card cannot launch
                    if not times[name]:
                        print(f"  LAUNCH FAILED: {name} at {case} {(B, V)}: {e}")
                    times[name].append(None)
                    continue
            if name not in PROBES:
                calib, gate = fn(xi, -20.0, 5.0, 0.3)
                torch.cuda.synchronize()
                err = float((calib - want[0]).abs().max())
                ok = err <= chip_smoke.CALIB_ATOL and torch.equal(gate, want[1])
                if name in ("shipped", "old"):
                    chip_smoke.check(ok, f"{name} at {case} {(B, V)}: err {err}")
                elif not ok and not times[name]:
                    print(f"  WRONG RESULT: {name} at {case} {(B, V)}: err {err}")
            times[name].append(chip_smoke.device_ms(lambda: fn(xi, -6.0, 2.0, 0.5)))
        use("shipped")
        times["torch.amax"] = [chip_smoke.device_ms(lambda: torch.amax(x)) for _ in range(2)]
        bound, by = chip_smoke.calib_bound(B, V, x.element_size())
        plan = k.plan_for(x)
        dtype = str(x.dtype).removeprefix("torch.")
        print(f"{case} {(B, V)} {dtype}, base {'aligned' if x.data_ptr() % 16 == 0 else 'misaligned'}:"
              f" plan {plan.splits} x {plan.threads} x {plan.vpt}, bound {chip_smoke._us(bound)} ({by})")
        for name, ts in times.items():
            forced = ""
            if name in PLAN_VARIANTS:
                p = shipped_plan(B, V, x.element_size(), k._sm_count(0), **PLAN_VARIANTS[name])
                forced = f" ({p.splits} x {p.threads} x {p.vpt})"
            print(f"  {name + forced:24s} device " + " / ".join(chip_smoke._us(t) for t in ts))
        if plan.splits > 1:
            timeline(use("probe_timeline"), libs["probe_timeline"], x, B * plan.splits, plan.splits)
            use("shipped")
    return 0


def timeline(fn, lib, x, blocks, splits):
    """Where a split launch's time goes: thread 0 of each block stamps
    clock64 at its stages and globaltimer at entry and exit."""
    import numpy as np
    import torch

    for _ in range(3):  # the last of three back-to-back calls
        fn(x, -6.0, 2.0, 0.5)
    torch.cuda.synchronize()
    out = np.zeros((blocks, STAMPS), np.int64)
    stamps = lib.load().calib_gate_stamps
    stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if stamps(out.ctypes.data, blocks) != 0:
        raise RuntimeError("calib_gate_stamps failed")
    d = np.diff(out[:, :6], axis=1)
    r0 = out[::splits]
    stages = ("loads", "block merge", "barrier 1", "rank 0 merge", "barrier 2")
    print("  probe_timeline, thread 0 of each block, clock64 cycles median / max: " +
          "; ".join(f"{n} {int(np.median(d[:, i]))} / {int(d[:, i].max())}" for i, n in enumerate(stages)) +
          f"; rank 0 merge in rank 0 {int(np.median(r0[:, 4] - r0[:, 3]))};"
          f" globaltimer: blocks start within {int(out[:, 6].max() - out[:, 6].min())} ns,"
          f" first entry to last exit {int(out[:, 7].max() - out[:, 6].min())} ns,"
          f" a block's own span median {int(np.median(out[:, 7] - out[:, 6]))} ns")


if __name__ == "__main__":
    sys.exit(main())
