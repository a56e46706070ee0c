// W8A8 int8 matmul with a per-row / per-column dequant epilogue, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul/kernel.py
// (int8_matmul -> pallas_call).  For x_q (M, K) int8 row-major, x_scale
// (M,) f32, w_q (K, N) int8 row-major and w_scale (N,) f32:
//   acc[m, n] = sum_k x_q[m, k] * w_q[k, n]               (exact int32)
//   out[m, n] = (float(acc[m, n]) * x_scale[m]) * w_scale[n]
// cast once to f32 or bf16; mode RAW stores acc itself.  The multiplies
// run left to right with no contraction, as the plain version computes
// them, so the f32 output is bit-equal to it.
//
// Bound: at large M, N, K the int8 tensor cores (2*M*N*K operations at
// 1,979 TOP/s dense); at the serving sweep's small M, the bytes (M*K +
// K*N + 4*M + 4*N + M*N*4) over 3.35 TB/s.
//
// Design, simple and right first: one block of four warps per 64 x 64
// output tile.  K is staged in steps of 32 through shared memory (A as
// [m][k], B transposed to [n][k] while staging, so that both MMA operands
// read K-contiguous words); the int32 accumulators stay in registers.
// Each warp owns a 32 x 32 sub-tile: 2 x 4 mma.sync.m16n8k32 s8.s8.s32
// per K step.  The TPU kernel asserts exact tiling; here any M, N and K
// are accepted: rows, columns and the K tail outside the matrices are
// zero-filled in shared memory, which adds exactly 0 to the sums.  Rows
// are padded to 48 bytes so the fragment loads of a warp hit 32 distinct
// banks.  Not done: wgmma, TMA, multi-stage pipelining, larger tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 16;  // padded shared-memory row, bytes
constexpr int THREADS = 128;

enum OutMode { OUT_F32 = 0, OUT_BF16 = 1, OUT_RAW = 2 };

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lds32(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ wq, const float* __restrict__ ws,
    void* __restrict__ out, int M, int N, int K, bool vec_a, bool vec_b) {
  __shared__ __align__(16) int8_t sA[BM][LDS];
  __shared__ __align__(16) int8_t sB[BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // staging: A row a_row, 16 bytes of K from a_k; B row (k) b_k, 16 bytes of N from b_n
  const int a_row = tid >> 1, a_k = (tid & 1) * 16;
  const int b_k = tid >> 2, b_n = (tid & 3) * 16;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int m = m0 + a_row, k = k0 + a_k;
      int8_t* dst = &sA[a_row][a_k];
      if (vec_a && m < M && k + 16 <= K) {
        *reinterpret_cast<int4*>(dst) =
            *reinterpret_cast<const int4*>(xq + (size_t)m * K + k);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          dst[i] = (m < M && k + i < K) ? xq[(size_t)m * K + k + i] : (int8_t)0;
        }
      }
    }
    {
      const int k = k0 + b_k, n = n0 + b_n;
      __align__(16) int8_t v[16];
      if (vec_b && k < K && n + 16 <= N) {
        *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(wq + (size_t)k * N + n);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          v[i] = (k < K && n + i < N) ? wq[(size_t)k * N + n + i] : (int8_t)0;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) sB[b_n + i][b_k] = v[i];
    }
    __syncthreads();

    int a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + g;
      a[mi][0] = lds32(&sA[r][t * 4]);
      a[mi][1] = lds32(&sA[r + 8][t * 4]);
      a[mi][2] = lds32(&sA[r][16 + t * 4]);
      a[mi][3] = lds32(&sA[r + 8][16 + t * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn + ni * 8 + g;
      b[ni][0] = lds32(&sB[c][t * 4]);
      b[ni][1] = lds32(&sB[c][16 + t * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    __syncthreads();
  }

  // epilogue: accumulator register r of an m16n8 tile holds
  // row g + 8 * (r / 2), column 2 * t + r % 2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float xs_r = MODE == OUT_RAW ? 0.f : xs[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn + ni * 8 + t * 2 + j;
          if (col >= N) continue;
          const int v = acc[mi][ni][half * 2 + j];
          const size_t o = (size_t)row * N + col;
          if (MODE == OUT_RAW) {
            static_cast<int*>(out)[o] = v;
          } else {
            const float y = __fmul_rn(__fmul_rn(__int2float_rn(v), xs_r), ws[col]);
            if (MODE == OUT_F32) {
              static_cast<float*>(out)[o] = y;
            } else {
              static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
            }
          }
        }
      }
    }
  }
}

}  // namespace

// mode: 0 = f32 output, 1 = bf16 output, 2 = the raw int32 accumulator
// (scales unused).  vec_a / vec_b: the wrapper found x_q / w_q rows 16-byte
// aligned (K % 16 == 0 / N % 16 == 0 and aligned base pointers), so whole
// in-range 16-byte pieces load as one int4.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int int8_matmul_launch(const void* xq, const void* xs, const void* wq,
                                  const void* ws, void* out, int mode, int M, int N,
                                  int K, int vec_a, int vec_b, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* a = (const int8_t*)xq;
  const int8_t* b = (const int8_t*)wq;
  const float* sa = (const float*)xs;
  const float* sb = (const float*)ws;
  if (mode == OUT_F32) {
    int8_matmul_kernel<OUT_F32><<<grid, THREADS, 0, s>>>(a, sa, b, sb, out, M, N, K, vec_a, vec_b);
  } else if (mode == OUT_BF16) {
    int8_matmul_kernel<OUT_BF16><<<grid, THREADS, 0, s>>>(a, sa, b, sb, out, M, N, K, vec_a, vec_b);
  } else {
    int8_matmul_kernel<OUT_RAW><<<grid, THREADS, 0, s>>>(a, sa, b, sb, out, M, N, K, vec_a, vec_b);
  }
  return (int)cudaGetLastError();
}
