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
// K*N + 4*M + 4*N + M*N*4) over 3.35 TB/s.  At the sweep's shapes a call
// is a few memory round trips long, so the design keeps loads in flight
// and cuts a small product into small tiles, one block each.
//
// Design:
//  * A block of WM x WN warps computes a BM x BN output tile; each warp a
//    (16*MI) x 32 slice of it with mma.sync.m16n8k32 s8.s8.s32 (MI x 4
//    products per 32 bytes of K).  In the smallest tile KW = 2 warps share
//    the slice along K (each takes every other k32 step; at the end each
//    finishes one row half, the halves' sums swapped through shared
//    memory), which halves a warp's serial chain and its epilogue.  Three
//    block tiles (kernel.py CONFIGS, chosen per call by kernel.py
//    tile_plan): 128 x 128 with 8 warps for large shapes; 32 x 64 with 4
//    warps and 16 x 32 with 1 x 2 for the serving sweep's small M.
//  * Loads run ahead of the products: K goes in tiles of BK = 64 bytes
//    through a ring of STAGES = 4 shared-memory stages (8 measured slower)
//    filled by 16-byte cp.async.cg copies with commit/wait groups, so
//    tiles t+1 .. t+3 are in flight while tile t is multiplied; one
//    barrier a K tile.  Rows past M, columns past N and K past its end are
//    zero-filled by the copy (src-size 0, nothing read), so they add
//    exactly 0.
//  * A is staged [m][k] as it lies and read by ldmatrix.x4: the b16 view
//    of four 8 x 16-byte matrices is exactly m16n8k32's A fragment.
//  * B is staged [k][n] as it lies, with no transpose pass: inside a
//    warp's 32 columns, logical column n of its ni-th m16n8 tile is
//    physical column 4n + ni.  Lane (g, t) then needs physical columns
//    4g .. 4g+3 at rows 4t .. 4t+3 for all four tiles at once: four 32-bit
//    shared loads and one 4 x 4 byte transpose by eight PRMT, for each 16
//    bytes of K.  Its accumulators land on the contiguous physical columns
//    8t .. 8t+7, so the epilogue stores 16-byte vectors.  (A transpose pass
//    in shared memory, once a K tile, measured slower at every shape.)
//  * Both stagings are swizzled by 16-byte chunk (XOR of the chunk index
//    by row bits), so that every ldmatrix phase and every warp-wide B load
//    reaches 32 distinct banks, and every cp.async destination stays
//    16-byte aligned.
//  * Operands whose rows are not 16-byte aligned (K or N not a multiple of
//    16, or a misaligned base pointer) take the 16 x 32 tile with byte
//    loads into the same staged layout: the same ring, fragments and
//    epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;      // bytes of K a tile
constexpr int STAGES = 4;   // K tiles in the cp.async ring
constexpr int CHUNKS_A = BK / 16;  // 16-byte chunks of a staged A row
static_assert(BK % 32 == 0 && CHUNKS_A <= 8, "BK: whole k32 steps, A rows of at most 128 bytes");

// The 4 x 4 byte transpose of lane (g, t)'s words w_j = B[4t + j][4g .. 4g+3]:
// pairs first (w0/w1 and w2/w3 interleaved by byte), then halves.
constexpr unsigned PRMT_PAIR_LO = 0x5140u;  // x.b0 y.b0 x.b1 y.b1
constexpr unsigned PRMT_PAIR_HI = 0x7362u;  // x.b2 y.b2 x.b3 y.b3
constexpr unsigned PRMT_HALF_LO = 0x5410u;  // x.h0 y.h0
constexpr unsigned PRMT_HALF_HI = 0x7632u;  // x.h1 y.h1

enum OutMode { OUT_F32 = 0, OUT_BF16 = 1, OUT_RAW = 2 };

// A block tile: WM x WN warps, each (16 * MI) x 32 of the output, times KW
// warps along K (warp kw takes the k32 steps kw, kw + KW, ... of each K
// tile; each finishes one row half at the end).
template <int MI_, int WM_, int WN_, int KW_>
struct Tile {
  static constexpr int MI = MI_, WM = WM_, WN = WN_, KW = KW_;
  static constexpr int BM = 16 * MI * WM, BN = 32 * WN;
  static constexpr int LEADS = 32 * WM * WN;  // threads of the kw = 0 warps
  static constexpr int THREADS = LEADS * KW;
  static constexpr int A_BYTES = BM * BK, STAGE = BM * BK + BK * BN;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert((BK / 32) % KW == 0, "the K warps share a tile's k32 steps evenly");
  static_assert(KW == 1 || (KW == 2 && BM * BN * 4 <= SMEM), "the K warps' halves fit in the ring");
};
using Tile128x128 = Tile<4, 2, 4, 1>;  // 8 warps, 64 KB of ring
using Tile32x64 = Tile<1, 2, 2, 1>;    // 4 warps, 24 KB
using Tile16x32 = Tile<1, 1, 1, 2>;    // 1 warp x 2 along K, 12 KB

// Byte offset of chunk c of row r in a staged A tile ([BM][BK]): the
// chunk index is XORed with the row's index among the rows that share
// 128-byte lines, so eight consecutive rows' chunk c lie in eight
// different 16-byte bank groups (an ldmatrix phase).
__device__ __forceinline__ int a_off(int r, int c) {
  constexpr int rows_a_line = 8 / CHUNKS_A;
  return r * BK + ((c ^ ((r / rows_a_line) % CHUNKS_A)) << 4);
}

// Byte offset of byte n of row (k) r in a staged B tile ([BK][BN]): bits
// 5-6 of the linear offset (a 16-byte chunk's position in its 128-byte
// line, less its low bit) are XORed with bits 2-3 of r.  The rows 4t + j
// (t = 0..3) that a warp reads in one load then put their 32 bytes in four
// different quarter-lines: 32 banks.  The mask depends on bits of r that
// the XOR never changes, so the map is a bijection of the tile for any BN.
template <int BN>
__device__ __forceinline__ int b_off(int r, int n) {
  return (r * BN + n) ^ (((r >> 2) & 3) << 5);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; copies `bytes` (0..16) and
// zero-fills the rest (0: reads nothing).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of a row into shared memory: `bytes` (<= 0: none) of
// it from src, zeros after.  VEC: src is 16-byte aligned, by cp.async;
// otherwise by 16 byte loads, all issued before any is used (a load
// under a branch would be waited for at the branch's end): byte b reads
// src[min(b, bytes - 1)] (src itself when bytes <= 0, a valid address) and
// is zeroed past `bytes`; then one 16-byte shared store.
template <bool VEC>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const int8_t* src, int bytes) {
  bytes = bytes < 0 ? 0 : bytes > 16 ? 16 : bytes;
  if (VEC) {
    cp_async_16(dst, src, bytes);
  } else {
    uint32_t v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) v[b] = (uint8_t)__ldg(src + min(b, max(bytes - 1, 0)));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) w[b >> 2] |= (b < bytes ? v[b] : 0u) << (8 * (b & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(int (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane (g, t)'s B fragments for 16 bytes of K (rows k0 + 4t .. k0 + 4t + 3)
// of the warp's 32 columns from wn: b[ni] holds B[k0 + 4t + j][wn + 4g + ni],
// j = 0..3, as bytes 0..3 (m16n8k32's B layout for logical column g).
template <int BN>
__device__ __forceinline__ void b_frags(int (&b)[4], const unsigned char* sb, int k0, int wn, int g,
                                        int t) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = *reinterpret_cast<const uint32_t*>(sb + b_off<BN>(k0 + 4 * t + j, wn + 4 * g));
  }
  const uint32_t lo01 = __byte_perm(w[0], w[1], PRMT_PAIR_LO), hi01 = __byte_perm(w[0], w[1], PRMT_PAIR_HI);
  const uint32_t lo23 = __byte_perm(w[2], w[3], PRMT_PAIR_LO), hi23 = __byte_perm(w[2], w[3], PRMT_PAIR_HI);
  b[0] = (int)__byte_perm(lo01, lo23, PRMT_HALF_LO);
  b[1] = (int)__byte_perm(lo01, lo23, PRMT_HALF_HI);
  b[2] = (int)__byte_perm(hi01, hi23, PRMT_HALF_LO);
  b[3] = (int)__byte_perm(hi01, hi23, PRMT_HALF_HI);
}

// grid: one block an output tile, column tiles fastest; each block walks
// the whole of K.
template <class T, int MODE, bool VEC>
__global__ void __launch_bounds__(T::THREADS, T::THREADS >= 256 ? 2 : 1)
int8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const int8_t* __restrict__ wq, const float* __restrict__ ws, void* __restrict__ out,
                   int M, int N, int K, int n_tiles_n, bool vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int MI = T::MI, BM = T::BM, BN = T::BN, THREADS = T::THREADS, LEADS = T::LEADS;
  // the 32 x 64 tile loads its scales before the K loop, off the tail's
  // path (measured 0.3-0.4 us faster there; in the 16 x 32 tile, whose two
  // K warps hold them through the loop, 0.1 us slower)
  constexpr bool EARLY = MODE != OUT_RAW && MI == 1 && T::KW == 1;

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment coordinates
  const int lt = tid % LEADS, kw = tid / LEADS;  // thread of the kw = 0 warps it matches; K warp
  const int wm = (lt / 32 / T::WN) * 16 * MI, wn = (lt / 32 % T::WN) * 32;
  const int tile = blockIdx.x;
  const int m0 = (tile / n_tiles_n) * BM, n0 = (tile % n_tiles_n) * BN;
  const int n_k = K / BK + (K % BK != 0);

  // K tile i into stage i % STAGES; one commit group a call, empty past
  // K's end, so every thread counts groups alike
  auto issue = [&](int i) {
    if (i < n_k) {
      unsigned char* sa = smem + (i % STAGES) * T::STAGE;
      unsigned char* sb = sa + T::A_BYTES;
      const int k0 = i * BK;
#pragma unroll
      for (int q = 0; q < (BM * CHUNKS_A + THREADS - 1) / THREADS; ++q) {
        const int c = tid + q * THREADS, r = c / CHUNKS_A, ch = c % CHUNKS_A;
        if (BM * CHUNKS_A % THREADS != 0 && c >= BM * CHUNKS_A) break;  // warp-uniform
        const int m = m0 + r, k = k0 + 16 * ch;
        const bool in = m < M && k < K;
        stage_chunk<VEC>(sa + a_off(r, ch), in ? xq + (long long)m * K + k : xq, in ? K - k : 0);
      }
#pragma unroll
      for (int q = 0; q < (BK * (BN / 16) + THREADS - 1) / THREADS; ++q) {
        const int c = tid + q * THREADS, r = c / (BN / 16), n = 16 * (c % (BN / 16));
        if (BK * (BN / 16) % THREADS != 0 && c >= BK * (BN / 16)) break;  // warp-uniform
        const int k = k0 + r;
        const bool in = k < K && n0 + n < N;
        stage_chunk<VEC>(sb + b_off<BN>(r, n), in ? wq + (long long)k * N + n0 + n : wq,
                         in ? N - n0 - n : 0);
      }
    }
    cp_async_commit();
  };

  const int col0 = n0 + wn + 8 * t;  // this thread's 8 output columns
  float xs_e[MI][2], ws_e[8];  // EARLY only: one K warp, so both row halves
  if (EARLY) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + 16 * mi + g + 8 * half;
        xs_e[mi][half] = row < M ? __ldg(xs + row) : 0.f;
      }
#pragma unroll
    for (int c = 0; c < 8; ++c) ws_e[c] = col0 + c < N ? __ldg(ws + col0 + c) : 0.f;
  }

  int acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i have landed
    __syncthreads();              // everyone's have; everyone is done with tile i - 1
    issue(i + STAGES - 1);        // into tile i - 1's stage
    const unsigned char* sa = smem + (i % STAGES) * T::STAGE;
    const unsigned char* sb = sa + T::A_BYTES;
#pragma unroll
    for (int s0 = 0; s0 < BK / 32; s0 += T::KW) {
      const int s = s0 + kw;
      int b[2][4];
      b_frags<BN>(b[0], sb, 32 * s, wn, g, t);
      b_frags<BN>(b[1], sb, 32 * s + 16, wn, g, t);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        // lanes 0-15 give rows 0-15 of k bytes 0-15, lanes 16-31 of 16-31
        int a[4];
        ldmatrix_x4(a, sa + a_off(wm + 16 * mi + (lane & 15), 2 * s + (lane >> 4)));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a, b[0][ni], b[1][ni]);
      }
    }
  }

  // With KW = 2 each warp finishes one row half of its slice (rows g + 8 kw
  // of each m16 tile, accumulator registers 2 kw and 2 kw + 1) and hands
  // the other half to its partner through the ring; the kw = 1 warp then
  // moves its half into registers 0 and 1.  So registers 2j, 2j + 1 of
  // tile (mi, ni) hold row half half_of(j), j < HALVES, in every thread.
  constexpr int HALVES = 2 / T::KW;
  auto half_of = [&](int j) { return T::KW == 2 ? kw : j; };
  if (T::KW == 2) {
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    int2* red = reinterpret_cast<int2*>(smem);  // [writer's kw][MI * 4][LEADS]
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        red[(kw * MI * 4 + mi * 4 + ni) * LEADS + lt] = kw == 0 ? make_int2(acc[mi][ni][2], acc[mi][ni][3])
                                                                : make_int2(acc[mi][ni][0], acc[mi][ni][1]);
      }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int2 v = red[((1 - kw) * MI * 4 + mi * 4 + ni) * LEADS + lt];
        acc[mi][ni][0] = (kw == 0 ? acc[mi][ni][0] : acc[mi][ni][2]) + v.x;
        acc[mi][ni][1] = (kw == 0 ? acc[mi][ni][1] : acc[mi][ni][3]) + v.y;
      }
  }

  // epilogue: register r of tile (mi, ni) holds row g + 8 * (r / 2) and
  // logical column 2t + r % 2, physical column 4 * (2t + r % 2) + ni; so
  // physical column 8t + c of a row is tile ni = c % 4, r % 2 = c / 4
  if (col0 >= N) return;
  const bool full = vec_out && col0 + 8 <= N;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int j = 0; j < HALVES; ++j) {
      const int row = m0 + wm + 16 * mi + g + 8 * half_of(j);
      if (row >= M) continue;
      int v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = acc[mi][c & 3][2 * j + (c >> 2)];
      const long long o = (long long)row * N + col0;
      if (MODE == OUT_RAW) {
        int* dst = static_cast<int*>(out) + o;
        if (full) {
          reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (col0 + c < N) dst[c] = v[c];
        }
      } else {
        const float xs_r = EARLY ? xs_e[mi][j] : __ldg(xs + row);
        float y[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float ws_c = EARLY ? ws_e[c] : col0 + c < N ? __ldg(ws + col0 + c) : 0.f;
          y[c] = __fmul_rn(__fmul_rn(__int2float_rn(v[c]), xs_r), ws_c);
        }
        if (MODE == OUT_F32) {
          float* dst = static_cast<float*>(out) + o;
          if (full) {
            reinterpret_cast<float4*>(dst)[0] = make_float4(y[0], y[1], y[2], y[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(y[4], y[5], y[6], y[7]);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (col0 + c < N) dst[c] = y[c];
          }
        } else {
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
          if (full) {
            uint32_t p[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              p[c] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[2 * c])) |
                     ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y[2 * c + 1])) << 16);
            }
            *reinterpret_cast<uint4*>(dst) = make_uint4(p[0], p[1], p[2], p[3]);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (col0 + c < N) dst[c] = __float2bfloat16_rn(y[c]);
          }
        }
      }
    }
  }
}

struct Args {
  const int8_t* xq;
  const float* xs;
  const int8_t* wq;
  const float* ws;
  void* out;
  int M, N, K, n_tiles, n_tiles_n;
  bool vec_out;
};

template <class T, int MODE, bool VEC>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = int8_matmul_kernel<T, MODE, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)a.n_tiles, T::THREADS, T::SMEM, stream>>>(a.xq, a.xs, a.wq, a.ws, a.out, a.M, a.N,
                                                                 a.K, a.n_tiles_n, a.vec_out);
  return (int)cudaGetLastError();
}

template <class T, int MODE, bool VEC>
int plan(int* result) {
  auto kernel = int8_matmul_kernel<T, MODE, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, T::THREADS, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  result[0] = T::BM;
  result[1] = T::BN;
  result[2] = BK;
  result[3] = STAGES;
  result[4] = T::THREADS;
  result[5] = T::SMEM;
  result[6] = attr.numRegs;
  result[7] = (int)attr.localSizeBytes;
  result[8] = blocks;
  return 0;
}

template <class T, int MODE, bool VEC>
struct Run {
  static int call(const Args& a, cudaStream_t s) { return launch<T, MODE, VEC>(a, s); }
};

template <class T, int MODE, bool VEC>
struct Report {
  static int call(int* r) { return plan<T, MODE, VEC>(r); }
};

template <class T, bool VEC, template <class, int, bool> class F, class... P>
int by_mode(int mode, P... p) {
  switch (mode) {
    case OUT_F32: return F<T, OUT_F32, VEC>::call(p...);
    case OUT_BF16: return F<T, OUT_BF16, VEC>::call(p...);
    case OUT_RAW: return F<T, OUT_RAW, VEC>::call(p...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// F's call for block tile `config` (0: 128 x 128, 1: 32 x 64, 2: 16 x 32),
// output mode and copy width; the byte-load copies exist for 16 x 32 only.
template <template <class, int, bool> class F, class... P>
int by_config(int config, int mode, int vec, P... p) {
  if (config == 0 && vec) return by_mode<Tile128x128, true, F>(mode, p...);
  if (config == 1 && vec) return by_mode<Tile32x64, true, F>(mode, p...);
  if (config == 2 && vec) return by_mode<Tile16x32, true, F>(mode, p...);
  if (config == 2) return by_mode<Tile16x32, false, F>(mode, p...);
  return (int)cudaErrorInvalidValue;
}

int config_dims(int config, int* bm, int* bn) {
  switch (config) {
    case 0: *bm = Tile128x128::BM; *bn = Tile128x128::BN; return 0;
    case 1: *bm = Tile32x64::BM; *bn = Tile32x64::BN; return 0;
    case 2: *bm = Tile16x32::BM; *bn = Tile16x32::BN; return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch configuration of block tile `config` (0: 128 x 128, 1: 32 x
// 64, 2: 16 x 32) for output `mode` and copy width `vec` (1: 16-byte
// cp.async, 0: byte loads; 16 x 32 only): result[0..8] = BM, BN, BK,
// STAGES, threads a block, dynamic shared memory a block (bytes),
// registers a thread, local memory a thread (bytes; spills), resident
// blocks a SM from the occupancy calculator.
extern "C" int int8_matmul_plan(int config, int mode, int vec, int* result) {
  return by_config<Report>(config, mode, vec, result);
}

// mode: 0 = f32 output, 1 = bf16 output, 2 = the raw int32 accumulator
// (scales unused).  x_q (M, K), w_q (K, N) int8 and out (M, N) contiguous;
// vec: x_q and w_q rows are 16-byte aligned (K % 16 == 0, N % 16 == 0 and
// aligned base pointers); vec_out: out's rows are (N a multiple of 16
// bytes' worth of elements, aligned base).  The grid is the output tiles of
// `config`, one block each.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int int8_matmul_launch(const void* xq, const void* xs, const void* wq, const void* ws,
                                  void* out, int mode, int M, int N, int K, int config, int vec,
                                  int vec_out, void* stream) {
  int bm = 0, bn = 0;
  if (config_dims(config, &bm, &bn) != 0 || M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const long long n_tiles_n = ((long long)N + bn - 1) / bn;
  const long long n_tiles = ((long long)M + bm - 1) / bm * n_tiles_n;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{(const int8_t*)xq, (const float*)xs, (const int8_t*)wq, (const float*)ws, out,
               M, N, K, (int)n_tiles, (int)n_tiles_n, vec_out != 0};
  return by_config<Run>(config, mode, vec, a, (cudaStream_t)stream);
}
