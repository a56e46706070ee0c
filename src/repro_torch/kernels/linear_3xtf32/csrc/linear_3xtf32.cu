// The f32 dense product y = x·Wᵀ + b of F.linear, on the tensor cores in three
// TF32 products a product ("3xTF32"), for Hopper (sm_90a).
//
// A port-only kernel: the JAX package leaves dense products to XLA, so there
// is no Pallas kernel to port.  With TF32 off, PyTorch's f32 F.linear runs
// cuBLAS's SIMT GEMM on the CUDA cores (67 TFLOP/s at most); this kernel takes
// the same product to the TF32 tensor cores (494.7 TFLOP/s), at f32-level
// error.  x is (M, K) with unit inner stride and a row stride `ldx`, W is
// (N, K) contiguous (F.linear's layout), b is (N,) or absent, y is (M, N)
// contiguous; every one f32.
//
// Arithmetic (ref.py emulates it on the CPU): every operand v is split into
// two TF32 values, big = v rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32: add half a TF32 step to the bits, clear the 13 low
// ones) and small = v - big (exact in f32) rounded likewise, which leaves
// big + small within 2^-22 of v; each product takes small·big' + big·small'
// first, then big·big'.  small·small' (at most 2^-22 of the product) is
// left out, so a term is off by at most 3·2^-22 of |x||w|.  Both halves are
// rounded in the kernel, so the result does not rest on how the tensor cores
// read a TF32 register's low bits.  The tensor cores sum a wgmma's products
// into its accumulators cutting toward zero, so an accumulator that sums
// many k-steps drifts: over all of K it left 2-5e-6 of sum |x||w| at
// K = 768-5120 on an H100, ten times cuBLAS's f32 SIMT product, and 64 of K
// summed before each FADD still left 3-5 times cuBLAS's mean error at
// K = 32-128 (an f32 MLA decode drifted past its card-against-CPU bound).
// So each stage (32 of K) is summed from zero into `part`, its eight
// small-term wgmmas before its four big·big' ones (the small terms' sums
// stay small, so cutting them costs little; the big terms are cut four
// times, against sums of 8 to 32 of K), and the f32 accumulators take
// part's sums by FADD, rounding to nearest.  A k-step summed alone was
// barely more exact (1.2 times cuBLAS's mean error at K = 32-64) and cost
// 27 % of the time at DINOv3's products.
// An infinite input, or one within half a TF32 step of f32's largest
// value, gives NaN (inf - inf in its split) where F.linear may give ±inf;
// no model of the port feeds one.
//
// Bound: operations at the products the port makes (M in the thousands, N
// and K >= 768): 3 · 2MNK at 494.7 TFLOP/s, so at most ~165 TFLOP/s of f32
// products counted once.  Shared memory is the next limit: wgmma reads W's
// tiles from it three times a k-step, and the split of W passes over them.
//
// Design:
//   - A block computes a 128 x BN tile of y in three warpgroups.  Warpgroup
//     0 loads and splits; warpgroups 1 and 2 each multiply 64 rows.  The
//     loader gives up registers (setmaxnreg 40) and the multipliers take
//     them (232), for the 2 x BN/2 accumulators a thread.
//   - K streams through a ring of STAGES stages of 32 f32 (128 bytes, one
//     128-byte swizzle row).  One thread of warp 0 keeps TMA loads of the x
//     and W tiles in flight, each stage completing on its `full` mbarrier.
//     Both operands are K-major as they lie (x rows, W rows), so nothing is
//     transposed.  TMA fills rows past M or N and columns past K with zeros;
//     the epilogue masks the store.
//   - W's split is made in shared memory, once a tile, by warps 1-3: big in
//     place, small into a plane of the same swizzled layout, then the
//     `ready` mbarrier.  Splitting once a weight ahead of time and caching
//     both halves would cost 3.37 GB more for DINOv3 ViT-H+ and read twice
//     the weight bytes every call; the shared-memory pass costs two stores
//     and a load a W element a stage, which the tensor cores' time hides.
//   - x's split is made in registers: each multiplier thread loads its A
//     fragments (m64nNk8's layout, from the swizzled tile, without bank
//     conflicts) and issues wgmma.mma_async with A from registers and W's
//     halves from shared memory by descriptor: 12 a stage.  It waits for
//     them before it frees the stage's ring slot (`empty`) and loads the
//     next stage's fragments into the same registers; the other multiplier
//     warpgroup's wgmmas keep the tensor cores busy meanwhile.  (Two
//     register sets and one stage in flight measured no faster.)
//   - The epilogue adds the bias and stores each accumulator pair as one
//     8-byte store: 32 bytes a row segment, whole sectors.
//   - BN is 64, 96, 128 or 160 (kernel.py::tile_plan picks it from M and N
//     to fill the SMs' waves); the block count is the output's tiles, the
//     row tiles fastest so that one wave shares W's columns through L2.
// One launch, no workspace, no state: calls may run on two streams at once
// and a call can be captured in a CUDA graph.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows a block: two multiplier warpgroups of 64
constexpr int BK = 32;  // f32 of K a stage: 128 bytes, one swizzle row
constexpr int THREADS = 384;  // warpgroup 0 loads and splits, 1 and 2 multiply
constexpr int SPLIT_WARPS = 3;  // warps 1-3 of warpgroup 0
constexpr int SMEM_LIMIT = 232448;  // a block's dynamic shared memory on an H100
constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent, 10 mantissa bits
constexpr uint32_t TF32_HALF = 0x1000u;  // half a TF32 step, in the bits: rounds to nearest, ties away

template <int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int A_BYTES = BM * BK * 4;  // one x tile
  static constexpr int B_BYTES = BN * BK * 4;  // one W plane (big or small)
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int BAR_BYTES = 3 * 8 * 8;  // full, ready, empty for up to 8 stages
  static constexpr int FIT = (SMEM_LIMIT - 1024 - BAR_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + BAR_BYTES;  // 1024: alignment slack
  static_assert(BN % 32 == 0 && BN <= 256 && STAGES >= 2, "tile");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// A 2-D TMA load of the box at (column c0, row c1) into dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy stores to shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// wgmmas (no instruction is emitted).
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The wgmma descriptor of a K-major tile in 128-byte swizzle: rows 128 bytes
// apart, 8-row groups 1024 bytes apart (SBO), the start address in 16-byte
// units; the leading offset is unused in this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// v rounded to TF32 (cvt.rna.tf32.f32's result), and the small half of v
// whose big half is `big`.
__device__ __forceinline__ uint32_t tf32_round(float v) { return (__float_as_uint(v) + TF32_HALF) & TF32_MASK; }
__device__ __forceinline__ uint32_t tf32_small(float v, uint32_t big) { return tf32_round(v - __uint_as_float(big)); }

// d (64 x N f32, the warpgroup's accumulators) += a (64 x 8 tf32, registers)
// · b (8 x N tf32, shared memory, K-major) for N = BN.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int scale_d, float (&d)[32], const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(int scale_d, float (&d)[48], const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int scale_d, float (&d)[64], const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<160> {
  static __device__ __forceinline__ void mma(int scale_d, float (&d)[80], const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// One block: the 128 x BN output tile (blockIdx.x: row tile, blockIdx.y:
// column tile).
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    linear_3xtf32_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                         const float* __restrict__ bias, float* __restrict__ y, int M, int N, int K) {
  using T = Tile<BN>;
  constexpr int S = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-byte aligned tiles
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t bars = base + S * T::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto ready = [&](int s) { return bars + 8u * (S + s); };
  auto empty = [&](int s) { return bars + 8u * (2 * S + s); };

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), SPLIT_WARPS);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = tid / 32, lane = tid % 32;
    if (warp == 0) {
      if (lane == 0) {  // the loader: the ring's next stage as soon as it is free
        for (int kb = 0; kb < nk; ++kb) {
          const int s = kb % S;
          if (kb >= S) mbar_wait(empty(s), ((kb / S) - 1) & 1);
          const uint32_t a = base + s * T::STAGE_BYTES;
          mbar_expect_tx(full(s), T::A_BYTES + T::B_BYTES);
          tma_load(a, &x_map, full(s), kb * BK, m0);
          tma_load(a + T::A_BYTES, &w_map, full(s), kb * BK, n0);
        }
      }
    } else {  // the splitters: W's tile into big (in place) and small planes
      const int sid = tid - 32;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % S;
        mbar_wait(full(s), (kb / S) & 1);
        uint4* big = reinterpret_cast<uint4*>(smem + s * T::STAGE_BYTES + T::A_BYTES);
        uint4* small = big + T::B_BYTES / 16;
        for (int i = sid; i < T::B_BYTES / 16; i += 32 * SPLIT_WARPS) {
          const uint4 v = big[i];
          uint4 b, l;
          b.x = tf32_round(__uint_as_float(v.x));
          b.y = tf32_round(__uint_as_float(v.y));
          b.z = tf32_round(__uint_as_float(v.z));
          b.w = tf32_round(__uint_as_float(v.w));
          l.x = tf32_small(__uint_as_float(v.x), b.x);
          l.y = tf32_small(__uint_as_float(v.y), b.y);
          l.z = tf32_small(__uint_as_float(v.z), b.z);
          l.w = tf32_small(__uint_as_float(v.w), b.w);
          big[i] = b;
          small[i] = l;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(ready(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = 64 * (wg - 1) + 16 * warp + g;  // this thread's first row in the tile; r0 % 8 == g
    // acc: the f32 sums, added to in round-to-nearest; part: a stage's
    // products, summed from zero by the tensor cores (which cut their sums
    // toward zero).
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;
    uint32_t ab[16], as[16];  // this stage's A fragments, big and small
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % S;
      mbar_wait(full(s), (kb / S) & 1);  // x's tile, read here by plain loads
      mbar_wait(ready(s), (kb / S) & 1);  // W's halves
      const unsigned char* a_tile = smem + s * T::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
          const int r = r0 + 8 * (i % 2), chunk = 2 * kk + i / 2;
          const float v = *reinterpret_cast<const float*>(a_tile + r * 128 + ((chunk ^ g) << 4) + 4 * t);
          ab[4 * kk + i] = tf32_round(v);
          as[4 * kk + i] = tf32_small(v, ab[4 * kk + i]);
        }
      }
      const uint32_t b_big = base + s * T::STAGE_BYTES + T::A_BYTES;
      const uint64_t d_big = sw128_desc(b_big), d_small = sw128_desc(b_big + T::B_BYTES);
      fence_operands(part);
      wgmma_fence();  // part was read by the last fold's FADDs, the A fragments just written
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k-steps of 8: 32 bytes, 2 in the descriptor's units
        Wgmma<BN>::mma(kk > 0, part, &as[4 * kk], d_big + 2 * kk);  // the small terms first, from zero
        Wgmma<BN>::mma(1, part, &ab[4 * kk], d_small + 2 * kk);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<BN>::mma(1, part, &ab[4 * kk], d_big + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(part);
      if (tid == 0) mbar_arrive(empty(s));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }

    const int row = m0 + r0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;  // N is a multiple of 4, so col < N means col + 1 < N
      if (col < N) {
        const float b0 = bias ? bias[col] : 0.0f, b1 = bias ? bias[col + 1] : 0.0f;
        if (row < M)
          *reinterpret_cast<float2*>(y + (size_t)row * N + col) = make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
        if (row + 8 < M)
          *reinterpret_cast<float2*>(y + (size_t)(row + 8) * N + col) =
              make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up from libcuda through the CUDA runtime's
// entry-point query: the library links no libcuda of its own.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rows x cols f32, row stride `ld` elements, boxes of box_rows x 32 in
// 128-byte swizzle; out-of-bounds elements read as zero.
int make_map(CUtensorMap* map, const float* ptr, int rows, int cols, long long ld, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

constexpr int MAX_DEVICES = 64;

template <int BN>
int run(const float* x, const float* w, const float* b, float* y, int M, int N, int K, long long ldx,
        int device, cudaStream_t stream) {
  using T = Tile<BN>;
  static bool attr_set[MAX_DEVICES] = {};  // the shared-memory opt-in, once a device
  if (!attr_set[device]) {
    cudaError_t e = cudaFuncSetAttribute(linear_3xtf32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set[device] = true;
  }
  CUtensorMap x_map, w_map;
  int err = make_map(&x_map, x, M, K, ldx, BM);
  if (err == 0) err = make_map(&w_map, w, N, K, K, BN);
  if (err != 0) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  linear_3xtf32_kernel<BN><<<grid, THREADS, T::SMEM_BYTES, stream>>>(x_map, w_map, b, y, M, N, K);
  return (int)cudaGetLastError();
}

// {bm, bn, bk, stages, threads, dynamic smem bytes, registers, local bytes,
// blocks a SM} of the BN instantiation.
template <int BN>
int plan(int* r) {
  using T = Tile<BN>;
  cudaError_t e = cudaFuncSetAttribute(linear_3xtf32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       T::SMEM_BYTES);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, linear_3xtf32_kernel<BN>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, linear_3xtf32_kernel<BN>, THREADS, T::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int out[9] = {BM, BN, BK, T::STAGES, THREADS, T::SMEM_BYTES, fa.numRegs, (int)fa.localSizeBytes, blocks};
  for (int i = 0; i < 9; ++i) r[i] = out[i];
  return 0;
}

}  // namespace

// {bm, bn, bk, stages, threads, smem, registers, local bytes, blocks a SM}
// of the instantiation with BN = bn.
extern "C" int linear_3xtf32_plan(int bn, int* result) {
  switch (bn) {
    case 64: return plan<64>(result);
    case 96: return plan<96>(result);
    case 128: return plan<128>(result);
    case 160: return plan<160>(result);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y (M, N) = x (M, K; row stride ldx) · w (N, K)ᵀ + b (N,; null: none), all
// f32 on CUDA device `device`, with the BN = bn tile.  M, N, K >= 1; K, N
// and ldx multiples of 4 and x, w 16-byte aligned (TMA's strides and
// addresses); y contiguous.  One launch on `stream` (a stream of `device`),
// with `device` current for it; returns the cudaError (0 on success).
extern "C" int linear_3xtf32_launch(const void* x, const void* w, const void* b, void* y, int M, int N, int K,
                                    long long ldx, int bn, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || K % 4 || ldx % 4 || ldx < K) return (int)cudaErrorInvalidValue;
  if ((N + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;  // the grid's y: column tiles
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float *xf = (const float*)x, *wf = (const float*)w, *bf = (const float*)b;
  float* yf = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaErrorInvalidValue;
  switch (bn) {
    case 64: err = run<64>(xf, wf, bf, yf, M, N, K, ldx, device, s); break;
    case 96: err = run<96>(xf, wf, bf, yf, M, N, K, ldx, device, s); break;
    case 128: err = run<128>(xf, wf, bf, yf, M, N, K, ldx, device, s); break;
    case 160: err = run<160>(xf, wf, bf, yf, M, N, K, ldx, device, s); break;
  }
  if (current != device) cudaSetDevice(current);
  return err;
}
