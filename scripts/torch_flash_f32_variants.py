#!/usr/bin/env python3
"""Design variants of the port's f32 flash-attention kernel, timed in one process.

    python3 scripts/torch_flash_f32_variants.py

Needs an NVIDIA GPU and ``nvcc``.  Each variant is the shipped source
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`` with the
text patches listed below, built into ``build/flash_f32_variants/<name>/``
(one ``nvcc`` each, all started together).  At DeiT-B's attention, f32
(K, 198, 12, 64) for K = 16 and 3 frames, each variant is checked against
``attention_ref`` (within 2e-5) and timed by device time from the profiler
(``chip_smoke.device_ms``), in the order shipped, variants, variants
reversed, shipped, beside ``scaled_dot_product_attention``.  The patches
are written against the source as it stands; if it changes, a patch that
no longer applies raises.

Variants (the probes compute a wrong result on purpose, to split the time,
and are not checked):
  shipped   each warp reads q, K and V fragments from shared memory and
            splits them into TF32 big and small parts itself (every warp of
            a block splits the same K/V tile); 32-key tiles;
  q_regs    q split once into registers before the key loop, 64-key tiles
            (the first design: more registers, fewer blocks a SM);
  presplit  the block splits each K/V tile once into (big, small) pairs in
            shared memory, between two barriers, and the warps read the
            pairs with 64-bit loads: a quarter of the split instructions,
            one loaded stage beside one split stage;
  bk64      64-key tiles;
  probe_nosplit  no split instructions (each operand passed whole as both
            parts), the three products kept;
  probe_1x  one TF32 product per product, big * big.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
OUT = ROOT / "build" / "flash_f32_variants"

PRESPLIT = [
    ("  return (BQ + 4 * BK_F32) * (D + 4) * (int)sizeof(float);",
     "  return (BQ * (D + 4) + 4 * BK_F32 * (D + 4) + 2 * BK_F32 * (D + 2)) * (int)sizeof(float);"),
    ("// Fragment ownership of m16n8k8 TF32",
     """__device__ __forceinline__ void mma_3xtf32_pre(float (&d)[4], const unsigned (&a_big)[4],
                                               const unsigned (&a_small)[4], uint2 b0, uint2 b1) {
  mma_tf32(d, a_small, b0.x, b1.x);
  mma_tf32(d, a_big, b0.y, b1.y);
  mma_tf32(d, a_big, b0.x, b1.x);
}

// Fragment ownership of m16n8k8 TF32"""),
    ("  float* const q_tile = smem_f32 + 2 * STAGE;  // q, after the two stages\n",
     """  constexpr int PV = D + 2;  // row of the split V tile, in pairs
  uint2* const kp = reinterpret_cast<uint2*>(smem_f32 + STAGE);  // [BKF][LD] (big, small)
  uint2* const vp = kp + BKF * LD;                                // [BKF][PV] (big, small)
  float* const q_tile = smem_f32 + 2 * STAGE + 2 * BKF * PV;
"""),
    ("""    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) {
      float* next = smem_f32 + (j + 1) % 2 * STAGE;
      load_tile<D, BKF>(next, kb, ks.s, k0 + BKF, Sk, tid);
      load_tile<D, BKF>(next + BKF * LD, vb, vs.s, k0 + BKF, Sk, tid);
      cp_async_commit();
    }
    if (!active) continue;
    const float* k_lane = smem_f32 + j % 2 * STAGE + g * LD + t;
    const float* v_lane = smem_f32 + j % 2 * STAGE + BKF * LD + 2 * t * LD + g;""",
     """    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < BKF * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = i % (D / 4) * 4;
      const float4 x = *reinterpret_cast<const float4*>(smem_f32 + r * LD + c);
      const float4 y = *reinterpret_cast<const float4*>(smem_f32 + BKF * LD + r * LD + c);
      uint4 a, b;
      split_tf32(x.x, a.x, a.y);
      split_tf32(x.y, a.z, a.w);
      split_tf32(x.z, b.x, b.y);
      split_tf32(x.w, b.z, b.w);
      *reinterpret_cast<uint4*>(kp + r * LD + c) = a;
      *reinterpret_cast<uint4*>(kp + r * LD + c + 2) = b;
      split_tf32(y.x, a.x, a.y);
      split_tf32(y.y, a.z, a.w);
      split_tf32(y.z, b.x, b.y);
      split_tf32(y.w, b.z, b.w);
      *reinterpret_cast<uint4*>(vp + r * PV + c) = a;
      *reinterpret_cast<uint4*>(vp + r * PV + c + 2) = b;
    }
    __syncthreads();
    if (j + 1 < n_tiles) {
      load_tile<D, BKF>(smem_f32, kb, ks.s, k0 + BKF, Sk, tid);
      load_tile<D, BKF>(smem_f32 + BKF * LD, vb, vs.s, k0 + BKF, Sk, tid);
      cp_async_commit();
    }
    if (!active) continue;
    const uint2* k_lane = kp + g * LD + t;
    const uint2* v_lane = vp + 2 * t * PV + g;"""),
    ("""            mma_3xtf32(s[n], a_big, a_small, k_lane[n * 8 * LD + kd * 8],""",
     """            mma_3xtf32_pre(s[n], a_big, a_small, k_lane[n * 8 * LD + kd * 8],"""),
    ("""          mma_3xtf32(acc[n], p_big, p_small, v_lane[kk * 8 * LD + n * 8],
                     v_lane[(kk * 8 + 1) * LD + n * 8]);""",
     """          mma_3xtf32_pre(acc[n], p_big, p_small, v_lane[kk * 8 * PV + n * 8],
                         v_lane[(kk * 8 + 1) * PV + n * 8]);"""),
]
BK64 = [("constexpr int BK_F32 = 32;", "constexpr int BK_F32 = 64;")]
Q_REGS = BK64 + [
    ("""  const float* q_lane = q_tile + (w0 + g) * LD + t;
""", """  const float* q_lane = q_tile + (w0 + g) * LD + t;
  cp_async_wait<0>();
  __syncthreads();
  unsigned q_big[KD][4], q_small[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(q_lane[(i % 2) * 8 * LD + kd * 8 + (i / 2) * 4], q_big[kd][i], q_small[kd][i]);
"""),
    ("""        for (int i = 0; i < 4; ++i)
          split_tf32(q_lane[(i % 2) * 8 * LD + kd * 8 + (i / 2) * 4], a_big[i], a_small[i]);""",
     """        for (int i = 0; i < 4; ++i) {
          a_big[i] = q_big[kd][i];
          a_small[i] = q_small[kd][i];
        }"""),
]
NOSPLIT = [("""  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));""", "  big = small = __float_as_uint(x);")]
ONE_X = [("""  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
""", "")]

VARIANTS = {
    "shipped": [],
    "q_regs": Q_REGS,
    "presplit": PRESPLIT,
    "bk64": BK64,
    "probe_nosplit": NOSPLIT,
    "probe_1x": ONE_X,
}
PROBES = {"probe_nosplit", "probe_1x"}
CASES = [(16, 198, 12, 64), (3, 198, 12, 64)]


def variant_source(patches) -> str:
    src = SOURCE.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels.build import CudaLibrary, build_all
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    libs = {}
    for name, patches in VARIANTS.items():
        path = OUT / name / "flash_attention.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(variant_source(patches))
        libs[name] = CudaLibrary(path, fa.LIBRARY.symbols)
    build_all(list(libs.values()))
    for name, lib in libs.items():
        entry = None
        for line in lib.ptxas_log.splitlines():
            if "Compiling entry" in line:
                entry = "flash_attention_kernelILi64" in line
            elif entry and ("registers" in line or "spill" in line):
                print(f"  {name:11s} f32 D=64 ptxas: {line.strip()}")
    order = list(libs) + list(libs)[::-1]
    g = torch.Generator(device="cuda").manual_seed(1)
    for B, S, H, D in CASES:
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda") for _ in range(3))
        ref = attention_ref(q, k, v, causal=False)
        times = {name: [] for name in libs}
        for name in order:
            fa.LIBRARY = libs[name]
            err = float((fa.flash_attention(q, k, v, causal=False) - ref).abs().max())
            if name not in PROBES:
                chip_smoke.check(err <= 2e-5, f"{name} at {(B, S, H, D)}: err {err}")
            times[name].append(chip_smoke.device_ms(lambda: fa.flash_attention(q, k, v, causal=False)))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = chip_smoke.device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        print(f"f32 {(B, S, H, D)}: SDPA device {chip_smoke._us(sdpa)}")
        for name, ts in times.items():
            print(f"  {name:11s} device " + " / ".join(chip_smoke._us(t) for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
