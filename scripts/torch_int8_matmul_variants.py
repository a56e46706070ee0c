#!/usr/bin/env python3
"""Design variants of the port's int8 matmul kernel, timed in one process.

    python3 scripts/torch_int8_matmul_variants.py [--old-source FILE] [--plans] [--sweep]

Needs an NVIDIA GPU and ``nvcc``.  Each variant is the shipped source
``src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu`` with the text
patches listed below, built into ``build/int8_matmul_variants/<name>/``
(one ``nvcc`` each, all started together).  At the shapes of
``chip_smoke.int8_phase`` (the f(batch) sweep's, one row, ragged,
``bench_kernels``'s and DeiT-B's projections), each variant is checked
against ``int8_matmul_ref`` bit for bit (a design variant that misses is
reported, the shipped and old kernels raise) and timed by device time from
the profiler (``chip_smoke.device_ms``, float32 output), in the order
shipped, variants, old, then reversed, beside ``torch._int_mm`` (the int32
product alone).  The patches are written against the source as it stands;
if it changes, a patch that no longer applies raises.

``--old-source FILE`` adds the kernel this design replaced (one 64 x 64
tile a block of 4 warps, 32-byte K steps loaded by plain loads between two
barriers, B transposed byte by byte while staging), built from FILE, e.g.
the output of
``git show f0574dc:src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu``
saved under ``build/``.  ``--plans`` times the shipped kernel under every
block tile at each shape, the data that ``kernel.tile_plan``'s choice is
held to.  ``--sweep`` runs path 3's
f(batch) sweep (``slowtier.sweep.batch_sweep``, 5 timed calls a batch size)
with the shipped kernel, the old one and the shipped one again, for its
``matmul_us`` before and after in one process.

Variants (the probes compute a wrong result on purpose, to split the time,
and are not checked):
  shipped         rings of 4 stages of 64-byte K tiles filled by cp.async,
                  B's fragments built in registers by PRMT from the [k][n]
                  staging, the plan's tile;
  ring3           3 stages;
  ring8           8 stages;
  bk128           K tiles of 128 bytes (the plan recomputed for them);
  transpose_pass  B transposed once a K tile into an [n][k] copy in shared
                  memory (one 4 x 4 PRMT block a thread, then a second
                  barrier), fragments read from the copy;
  kw_swap         the warps along K the other way round: 32 x 64 with 2
                  (8 warps, each finishing one row half), 16 x 32 with 1;
  late_scales     32 x 64 loads x_scale and w_scale in the epilogue, as
                  the other tiles do, not before the K loop;
  early_scales    16 x 32 loads them before the K loop too;
  large_1blk      128 x 128 without the 2-blocks-a-SM register cap;
  probe_empty     every block returns at once (the launch's floor);
  probe_noload    no tile is copied (the shared memory is multiplied as it
                  lies);
  probe_nomma     no products (fragments loaded and folded into the
                  accumulators by XOR);
  probe_nostore   no output stored.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu"
OUT = ROOT / "build" / "int8_matmul_variants"

RING3 = [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")]
RING8 = [("constexpr int STAGES = 4;", "constexpr int STAGES = 8;")]
BK128 = [("constexpr int BK = 64; ", "constexpr int BK = 128;")]
TRANSPOSE = [
    ("  static constexpr int SMEM = STAGES * STAGE;",
     "  static constexpr int SMEM = STAGES * STAGE + BN * 68;"),
    ("    const unsigned char* sb = sa + T::A_BYTES;\n",
     """    const unsigned char* sb = sa + T::A_BYTES;
    unsigned char* sT = smem + STAGES * T::STAGE;  // [n][k], rows of 68 bytes
#pragma unroll
    for (int q = 0; q < (BK / 4) * (BN / 4) / THREADS; ++q) {
      const int blk = tid + q * THREADS, a4 = blk / (BN / 4), b4 = blk % (BN / 4);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const uint32_t*>(sb + b_off<BN>(4 * a4 + j, 4 * b4));
      const uint32_t lo01 = __byte_perm(w[0], w[1], PRMT_PAIR_LO), hi01 = __byte_perm(w[0], w[1], PRMT_PAIR_HI);
      const uint32_t lo23 = __byte_perm(w[2], w[3], PRMT_PAIR_LO), hi23 = __byte_perm(w[2], w[3], PRMT_PAIR_HI);
      const uint32_t o[4] = {__byte_perm(lo01, lo23, PRMT_HALF_LO), __byte_perm(lo01, lo23, PRMT_HALF_HI),
                             __byte_perm(hi01, hi23, PRMT_HALF_LO), __byte_perm(hi01, hi23, PRMT_HALF_HI)};
#pragma unroll
      for (int c = 0; c < 4; ++c) *reinterpret_cast<uint32_t*>(sT + (4 * b4 + c) * 68 + 4 * a4) = o[c];
    }
    __syncthreads();
"""),
    ("""      b_frags<BN>(b[0], sb, 32 * s, wn, g, t);
      b_frags<BN>(b[1], sb, 32 * s + 16, wn, g, t);""",
     """#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          b[h][ni] = *reinterpret_cast<const int*>(sT + (wn + 4 * g + ni) * 68 + 32 * s + 16 * h + 4 * t);"""),
]
KW_SWAP = [("using Tile32x64 = Tile<1, 2, 2, 1>;", "using Tile32x64 = Tile<1, 2, 2, 2>;"),
           ("using Tile16x32 = Tile<1, 1, 1, 2>;", "using Tile16x32 = Tile<1, 1, 1, 1>;")]
LATE_SCALES = [("constexpr bool EARLY = MODE != OUT_RAW && MI == 1 && T::KW == 1;", "constexpr bool EARLY = false;")]
EARLY_SCALES = [("constexpr bool EARLY = MODE != OUT_RAW && MI == 1 && T::KW == 1;",
                 "constexpr bool EARLY = MODE != OUT_RAW && MI == 1;"),
                # with two K warps a thread finishes row half kw, held in slot 0
                ("        const int row = m0 + wm + 16 * mi + g + 8 * half;\n        xs_e[mi][half]",
                 "        const int row = m0 + wm + 16 * mi + g + 8 * (T::KW == 2 ? kw : half);\n        xs_e[mi][half]")]
LARGE_1BLK = [("__launch_bounds__(T::THREADS, T::THREADS >= 256 ? 2 : 1)",
               "__launch_bounds__(T::THREADS, T::MI == 2 ? 2 : 1)")]
EMPTY = [("  extern __shared__ __align__(128) unsigned char smem[];\n",
          "  extern __shared__ __align__(128) unsigned char smem[];\n  if (M > 0) return;\n")]
NOLOAD = [("    if (i < n_k) {\n      unsigned char* sa", "    if (i < 0) {\n      unsigned char* sa")]
NOMMA = [("for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a, b[0][ni], b[1][ni]);",
          "for (int ni = 0; ni < 4; ++ni) acc[mi][ni][ni & 3] ^= a[ni] ^ b[0][ni] ^ b[1][ni];")]
NOSTORE = [("      if (row >= M) continue;\n      int v[8];",
            "      if (row >= M || acc[mi][0][0] != 0x7f123456) continue;\n      int v[8];")]

VARIANTS = {
    "shipped": [],
    "ring3": RING3,
    "ring8": RING8,
    "bk128": BK128,
    "transpose_pass": TRANSPOSE,
    "kw_swap": KW_SWAP,
    "late_scales": LATE_SCALES,
    "early_scales": EARLY_SCALES,
    "large_1blk": LARGE_1BLK,
    "probe_empty": EMPTY,
    "probe_noload": NOLOAD,
    "probe_nomma": NOMMA,
    "probe_nostore": NOSTORE,
}
PROBES = {"probe_empty", "probe_noload", "probe_nomma", "probe_nostore"}
SETTINGS = {"ring3": {"STAGES": 3}, "ring8": {"STAGES": 8}, "bk128": {"BK": 128},
            "kw_swap": {"threads": (256, 256, 32)}}


def variant_source(patches) -> str:
    src = SOURCE.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def cases():
    from repro_torch.slowtier.sweep import BATCH_SIZES, SWEEP_K, SWEEP_N, SWEEP_ROWS

    out = [(f"sweep b={b}", SWEEP_ROWS * b, SWEEP_K, SWEEP_N) for b in BATCH_SIZES]
    return out + [("one row", 1, SWEEP_K, SWEEP_N), ("ragged", 37, 100, 77), ("misaligned", 37, 100, 77),
                  ("bench_kernels", 1024, 4096, 4096), ("DeiT-B qkv x16", 3168, 768, 2304),
                  ("DeiT-B fc1 x16", 3168, 768, 3072), ("DeiT-B fc2 x16", 3168, 3072, 768)]


def old_kernel(lib):
    """A wrapper for the replaced kernel's C interface (x_q, x_scale, w_q,
    w_scale, out, mode, M, N, K, vec_a, vec_b, stream), float32 output."""
    import torch

    def call(xq, xs, wq, ws):
        M, K = xq.shape
        N = wq.shape[1]
        out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
        err = lib.load().int8_matmul_launch(
            xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(), 0, M, N, K,
            int(K % 16 == 0 and xq.data_ptr() % 16 == 0), int(N % 16 == 0 and wq.data_ptr() % 16 == 0),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old int8_matmul launch failed with cudaError {err}")
        call.launches += 1
        return out

    call.launches = 0
    return call


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.build import CudaLibrary, build_all
    from repro_torch.kernels.int8_matmul import kernel as k
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.kernels.int8_matmul import ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source", type=Path, default=None)
    ap.add_argument("--plans", nargs="?", const="shipped", default=None,
                    help="time every plan with these variants (comma-separated; default shipped)")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    libs = {}
    for name, patches in VARIANTS.items():
        path = OUT / name / "int8_matmul.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(variant_source(patches))
        libs[name] = CudaLibrary(path, k.LIBRARY.symbols)
    old = None
    if args.old_source is not None:
        _P, _I = ctypes.c_void_p, ctypes.c_int
        old = CudaLibrary(args.old_source.resolve(), {"int8_matmul_launch": [_P] * 5 + [_I] * 6 + [_P]})
    build_all(list(libs.values()) + ([old] if old else []))
    for name, lib in list(libs.items()) + ([("old", old)] if old else []):
        entry = None
        for line in lib.ptxas_log.splitlines():
            if "Compiling entry" in line:  # the float32 kernel: 128 x 128, 16-byte copies
                entry = ("ILi0EE" in line if name == "old"
                         else "Li4ELi2ELi4E" in line and "ELi0ELb1E" in line)
            elif entry and ("registers" in line or "spill" in line):
                print(f"  {name:15s} f32 ptxas: {line.strip()}")
    old_fn = old_kernel(old) if old else None
    defaults = {"BK": k.BK, "STAGES": k.STAGES, "threads": tuple(c.threads for c in k.CONFIGS)}
    configs = k.CONFIGS
    shipped_plan = k.tile_plan

    def use(name):
        if name == "old":
            return old_fn
        k.LIBRARY = libs[name]
        settings = {**defaults, **SETTINGS.get(name, {})}
        k.BK, k.STAGES = settings["BK"], settings["STAGES"]
        k.CONFIGS = tuple(c._replace(threads=n) for c, n in zip(configs, settings["threads"]))
        k.tile_plan = shipped_plan
        k.tile_plan.cache_clear()
        k.launch_plan.cache_clear()
        return k.int8_matmul

    names = list(libs) + (["old"] if old else [])
    order = names + names[::-1]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(2)
    data = {}
    for case, M, K, N in cases():
        xq, xs = ref.quantize_rows(torch.randn(M, K, generator=g, device="cuda"))
        wq, ws = ref.quantize_cols(torch.randn(K, N, generator=g, device="cuda"))
        if case == "misaligned":  # one byte past an aligned base: the byte-load copies
            xq, wq = (torch.empty(t.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(t.shape).copy_(t)
                      for t in (xq, wq))
        data[case] = (M, K, N, xq, xs, wq, ws, ref.int8_matmul_ref(xq, xs, wq, ws))
    for case, (M, K, N, xq, xs, wq, ws, want) in data.items():
        times = {name: [] for name in names}
        for name in order:
            fn = use(name)
            if name not in PROBES:
                ok = torch.equal(fn(xq, xs, wq, ws), want)
                if name in ("shipped", "old"):
                    chip_smoke.check(ok, f"{name} at {(M, K, N)}: not bit-equal")
                elif not ok and not times[name]:
                    print(f"  WRONG RESULT: {name} at {(M, K, N)}")
            times[name].append(chip_smoke.device_ms(lambda: fn(xq, xs, wq, ws)))
        use("shipped")
        lib_ms = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            lib_ms = chip_smoke.device_ms(lambda: torch._int_mm(xq, wq))
        plan = k.tile_plan(M, N, K, n_sms)
        bound, by = chip_smoke.int8_bound(M, K, N)
        print(f"{case} {(M, K, N)}: plan {plan.bm}x{plan.bn}, {plan.n_tiles} blocks;"
              f" _int_mm device {chip_smoke._us(lib_ms)}, bound {chip_smoke._us(bound)} ({by})")
        for name, ts in times.items():
            print(f"  {name:15s} device " + " / ".join(chip_smoke._us(t) for t in ts))

    for pv in (args.plans.split(",") if args.plans else []):
        use(pv)
        print(f"plans: the {pv} kernel under every block tile (device us; * = tile_plan's choice)")
        for case, (M, K, N, xq, xs, wq, ws, want) in data.items():
            aligned = K % 16 == 0 and N % 16 == 0 and case != "misaligned"
            chosen = shipped_plan(M, N, K, n_sms, aligned)
            row = []
            for c, cfg in enumerate(k.CONFIGS):
                if not aligned and c != k.NARROW:
                    continue
                plan = k.TilePlan(c, cfg.bm, cfg.bn, -(-M // cfg.bm) * -(-N // cfg.bn))
                k.tile_plan = lambda *a, _p=plan, **kw: _p
                ok = torch.equal(k.int8_matmul(xq, xs, wq, ws), want)
                chip_smoke.check(ok or pv in PROBES, f"{pv} {case}: plan {plan} not bit-equal")
                t = chip_smoke.device_ms(lambda: k.int8_matmul(xq, xs, wq, ws))
                star = "*" if plan == chosen else ""
                row.append(f"{cfg.name}{star} {chip_smoke._us(t).strip()}")
                k.tile_plan = shipped_plan
            print(f"  {case} {(M, K, N)}: " + "; ".join(row))

    if args.sweep and old_fn is not None:
        from repro_torch.slowtier.sweep import batch_sweep

        for name in ("shipped", "old", "shipped"):
            fn = use(name)
            i8_ops.int8_matmul = (lambda xq, xs, wq, ws, out_dtype=torch.float32, _f=fn: _f(xq, xs, wq, ws)) \
                if name == "old" else fn
            out = batch_sweep(device="cuda")
            print(f"sweep with the {name} kernel: matmul_us " +
                  ", ".join(f"b={r['batch']} {r['matmul_us']:.3f}" for r in out["rows"]) +
                  f"; fit {out['batch_fit']['kind']}")
        i8_ops.int8_matmul = k.int8_matmul
    return 0


if __name__ == "__main__":
    sys.exit(main())
