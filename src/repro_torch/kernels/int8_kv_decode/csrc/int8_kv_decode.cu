// Flash-decode over an int8 KV cache with per-token scales folded in, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_kv_decode/kernel.py
// (int8_kv_decode -> pallas_call).  One new query token per sequence,
// q (B, H, D), against int8 caches k_q, v_q (B, S, KH, D) with per-token
// f32 scales k_s, v_s (B, S); query head h = kh*G + g reads KV head kh
// (G = H/KH).  For each (b, h):
//   s_j  = (q . k_q[b, j, kh]) * k_s[b, j] / sqrt(D)
//   out  = sum_j softmax_j(s) * v_s[b, j] * v_q[b, j, kh]
// in f32, rounded once to q's dtype.  The cache is read as int8 and never
// dequantized into a float copy in device memory; the K scale multiplies
// the scores and the V scale the probabilities, as in the TPU kernel.
//
// Bound: about 8 operations per cache byte (4*B*H*S*D FMA-operations
// against 2*B*S*KH*D bytes at G = 4), so the card's memory, not its f32
// units, sets the pace: at (B, S, KH, G, D) = (8, 2048, 8, 4, 160) the
// kernel must read 42 MB, >= 12.6 us at 3.35 TB/s.
//
// Design (split-K flash-decode, two kernels):
//  * decode_split: one block of 128 threads per (b*KH + kh, split of S).
//    B*KH is only 64 at the path's shape, fewer than the 132 SMs, so S is
//    split until there are about four blocks per SM.  The block stages its
//    G query rows in shared memory as f32, then loops over tiles of 128
//    tokens: the tile's K and V rows (D int8 each, at stride KH*D in the
//    cache, read in place) are copied into shared memory 16 bytes a thread,
//    rows padded so that 16-byte reads of 8 neighbouring rows fall in
//    distinct banks; thread j scores token j against all G query rows
//    (16 int8 of K per shared-memory read, the q values broadcast); the
//    block reduces each row's max and exp-sum by warp shuffles and a
//    4-warp exchange, carries (m, l) in registers and rescales its
//    accumulators by exp(m_old - m_new), as the TPU kernel carries its
//    VMEM scratch across sequence blocks; then each thread accumulates
//    out[g][d] += p[g][j] * v_s[j] * v[j][d] for its one or two columns d.
//    The split writes its (m, l, acc) to an f32 workspace.
//  * decode_merge: one block per (b*KH + kh) combines the splits:
//    M = max m_i, L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) /
//    max(L, 1e-30), in q's dtype.
// m starts at -1e30 and l is floored at 1e-30, as in the TPU kernel.  Any
// S >= 1 is taken: tokens past S in the last tile get p = 0 and zero rows.
// D is any multiple of 16 up to 256; G up to 8.  No attention mask: the
// reference attends to every slot of the ring.  Not done: cp.async or TMA
// double buffering of the tiles, a single-kernel merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 128;  // 4 warps; one token of the tile per thread
constexpr int BS = 128;       // tokens per shared-memory tile
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr int COLS = MAX_D / THREADS;  // output columns a thread may own

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

// Padded row of a K or V tile in bytes: a multiple of 16 whose count of
// 16-byte units is odd, so the 16-byte reads of 8 neighbouring rows (one
// quarter-warp) hit 8 distinct 4-bank groups.
__host__ __device__ __forceinline__ int tile_ld(int D) {
  return ((D / 16) % 2 == 0) ? D + 16 : D + 32;
}

struct Shapes {
  int H, KH, S, D, G;
  int n_splits, tiles_per_split;
  float scale;
};

// Shared memory: Ks, Vs (BS x ld bytes each), q (GM x D f32), p*v_s
// (GM x BS f32), ks and vs of the tile (BS f32 each), the warps' partial
// max and sum (WARPS x GM f32 each).
template <int GM>
__host__ __device__ constexpr int smem_floats(int D) {
  return GM * D + GM * BS + 2 * BS + 2 * WARPS * GM;
}

template <int GM>
int smem_bytes(int D) {
  return 2 * BS * tile_ld(D) + smem_floats<GM>(D) * (int)sizeof(float);
}

template <int GM, typename T>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const int8_t* __restrict__ kq, const float* __restrict__ ks,
             const int8_t* __restrict__ vq, const float* __restrict__ vs, float* __restrict__ m_ws,
             float* __restrict__ l_ws, float* __restrict__ acc_ws, Shapes sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = sh.D, G = sh.G, KH = sh.KH, S = sh.S;
  const int ld = tile_ld(D);
  int8_t* Ks = reinterpret_cast<int8_t*>(smem);
  int8_t* Vs = Ks + BS * ld;
  float* Qs = reinterpret_cast<float*>(Vs + BS * ld);  // (GM, D)
  float* Ps = Qs + GM * D;                             // (GM, BS): p * v_s
  float* ks_t = Ps + GM * BS;
  float* vs_t = ks_t + BS;
  float* red_max = vs_t + BS;  // (WARPS, GM)
  float* red_sum = red_max + WARPS * GM;

  const int bk = blockIdx.x;  // b * KH + kh
  const int b = bk / KH, kh = bk % KH;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_tiles_total = (S + BS - 1) / BS;
  const int tile0 = split * sh.tiles_per_split;
  const int tile1 = min(tile0 + sh.tiles_per_split, n_tiles_total);

  // the G query rows of this KV head, as f32
  const T* qb = q + ((long long)b * sh.H + (long long)kh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) Qs[i] = to_f32(qb[i]);

  float m[GM], l[GM], acc[GM][COLS];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[g][c] = 0.f;
  }

  const int chunks = D / 16;            // 16-byte units in a row
  const long long row_stride = (long long)KH * D;  // bytes between tokens
  const int8_t* kbase = kq + (long long)b * S * row_stride + (long long)kh * D;
  const int8_t* vbase = vq + (long long)b * S * row_stride + (long long)kh * D;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int s0 = tile * BS;
    const int n_valid = min(BS, S - s0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BS * chunks; i += THREADS) {
      const int r = i / chunks, c = i % chunks;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (r < n_valid) {
        const long long off = (long long)(s0 + r) * row_stride + 16 * c;
        kv = __ldg(reinterpret_cast<const int4*>(kbase + off));
        vv = __ldg(reinterpret_cast<const int4*>(vbase + off));
      }
      *reinterpret_cast<int4*>(Ks + r * ld + 16 * c) = kv;
      *reinterpret_cast<int4*>(Vs + r * ld + 16 * c) = vv;
    }
    {
      const bool in = tid < n_valid;
      ks_t[tid] = in ? ks[(long long)b * S + s0 + tid] : 0.f;
      vs_t[tid] = in ? vs[(long long)b * S + s0 + tid] : 0.f;
    }
    __syncthreads();

    // scores of token `tid` against the G query rows
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    const int8_t* krow = Ks + tid * ld;
    for (int c = 0; c < chunks; ++c) {
      const int4 raw = *reinterpret_cast<const int4*>(krow + 16 * c);
      const int words[4] = {raw.x, raw.y, raw.z, raw.w};
      float kf[16];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int e = 0; e < 4; ++e) kf[4 * w + e] = (float)(int8_t)(words[w] >> (8 * e));
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float4* qv = reinterpret_cast<const float4*>(Qs + g * D + 16 * c);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float4 qq = qv[w];
            s[g] = fmaf(qq.x, kf[4 * w + 0], s[g]);
            s[g] = fmaf(qq.y, kf[4 * w + 1], s[g]);
            s[g] = fmaf(qq.z, kf[4 * w + 2], s[g]);
            s[g] = fmaf(qq.w, kf[4 * w + 3], s[g]);
          }
        }
      }
    }
    const bool valid = tid < n_valid;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      s[g] = valid ? s[g] * ks_t[tid] * sh.scale : NEG;
      const float wm = warp_max(s[g]);
      if (lane == 0) red_max[warp * GM + g] = wm;
    }
    __syncthreads();
    float p[GM], corr[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float tmax = red_max[g];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) tmax = fmaxf(tmax, red_max[w * GM + g]);
      const float m_new = fmaxf(m[g], tmax);
      p[g] = valid ? expf(s[g] - m_new) : 0.f;
      corr[g] = expf(m[g] - m_new);
      m[g] = m_new;
      Ps[g * BS + tid] = p[g] * vs_t[tid];
      const float ws = warp_sum(p[g]);
      if (lane == 0) red_sum[warp * GM + g] = ws;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float tsum = red_sum[g];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) tsum += red_sum[w * GM + g];
      l[g] = l[g] * corr[g] + tsum;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[g][c] *= corr[g];
    }

    // P.V: this thread's columns d = tid + THREADS * c
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = tid + THREADS * c;
      if (d < D) {
        for (int j = 0; j < n_valid; ++j) {
          const float v = (float)Vs[j * ld + d];
#pragma unroll
          for (int g = 0; g < GM; ++g) acc[g][c] = fmaf(Ps[g * BS + j], v, acc[g][c]);
        }
      }
    }
  }

  const long long base = (long long)bk * sh.n_splits + split;
  if (tid < G) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g == tid) {
        m_ws[base * G + g] = m[g];
        l_ws[base * G + g] = l[g];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = tid + THREADS * c;
        if (d < D) acc_ws[(base * G + g) * D + d] = acc[g][c];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_merge(const float* __restrict__ m_ws, const float* __restrict__ l_ws,
             const float* __restrict__ acc_ws, T* __restrict__ out, Shapes sh) {
  const int bk = blockIdx.x;
  const int b = bk / sh.KH, kh = bk % sh.KH;
  const int G = sh.G, D = sh.D, n = sh.n_splits;
  T* ob = out + ((long long)b * sh.H + (long long)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = NEG;
    for (int sp = 0; sp < n; ++sp) M = fmaxf(M, m_ws[((long long)bk * n + sp) * G + g]);
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < n; ++sp) {
      const long long idx = ((long long)bk * n + sp) * G + g;
      const float w = expf(m_ws[idx] - M);
      L = fmaf(l_ws[idx], w, L);
      A = fmaf(acc_ws[idx * D + d], w, A);
    }
    ob[g * D + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <int GM, typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           void* out, void* m_ws, void* l_ws, void* acc_ws, int B, const Shapes& sh,
           cudaStream_t stream) {
  auto split = decode_split<GM, T>;
  const int smem = smem_bytes<GM>(sh.D);
  cudaError_t err = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * sh.KH), (unsigned)sh.n_splits);
  split<<<grid, THREADS, smem, stream>>>((const T*)q, (const int8_t*)kq, (const float*)ks,
                                         (const int8_t*)vq, (const float*)vs, (float*)m_ws,
                                         (float*)l_ws, (float*)acc_ws, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge<T><<<(unsigned)(B * sh.KH), THREADS, 0, stream>>>(
      (const float*)m_ws, (const float*)l_ws, (const float*)acc_ws, (T*)out, sh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_g(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
               void* out, void* m_ws, void* l_ws, void* acc_ws, int B, const Shapes& sh,
               cudaStream_t stream) {
  if (sh.G == 1) return launch<1, T>(q, kq, ks, vq, vs, out, m_ws, l_ws, acc_ws, B, sh, stream);
  if (sh.G == 2) return launch<2, T>(q, kq, ks, vq, vs, out, m_ws, l_ws, acc_ws, B, sh, stream);
  if (sh.G <= 4) return launch<4, T>(q, kq, ks, vq, vs, out, m_ws, l_ws, acc_ws, B, sh, stream);
  return launch<8, T>(q, kq, ks, vq, vs, out, m_ws, l_ws, acc_ws, B, sh, stream);
}

}  // namespace

// q and out (B, H, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// k_q, v_q (B, S, KH, D) int8 contiguous, 16-byte aligned; k_s, v_s (B, S)
// float32 contiguous.  D a multiple of 16 up to 256, H = G*KH with G <= 8.
// Workspaces: m_ws, l_ws (B*KH*n_splits, G) and acc_ws (B*KH*n_splits, G,
// D) float32; split i covers tiles [i*tiles_per_split, (i+1)*tiles_per_split)
// of 128 tokens.  Launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int int8_kv_decode_launch(const void* q, const void* kq, const void* ks,
                                     const void* vq, const void* vs, void* out, void* m_ws,
                                     void* l_ws, void* acc_ws, int dtype, int B, int H, int KH,
                                     int S, int D, int n_splits, int tiles_per_split,
                                     float scale, void* stream) {
  const int n_tiles = (S + BS - 1) / BS;
  if (B <= 0 || KH <= 0 || S <= 0 || H % KH != 0 || H / KH > 8 || D <= 0 || D % 16 != 0 ||
      D > MAX_D || n_splits <= 0 || n_splits > 65535 || tiles_per_split <= 0 ||
      (long long)n_splits * tiles_per_split < n_tiles ||
      (long long)(n_splits - 1) * tiles_per_split >= n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const Shapes sh{H, KH, S, D, H / KH, n_splits, tiles_per_split, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_g<float>(q, kq, ks, vq, vs, out, m_ws, l_ws, acc_ws, B, sh, s);
  if (dtype == 1) return dispatch_g<__nv_bfloat16>(q, kq, ks, vq, vs, out, m_ws, l_ws, acc_ws, B, sh, s);
  return (int)cudaErrorInvalidValue;
}
