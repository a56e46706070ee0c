// Flash attention (online softmax over key tiles), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention -> pallas_call).  For q, k, v of shape (B, S, H, D):
//   o[b, i, h] = sum_j softmax_j(q[b,i,h] . k[b,j,h] / sqrt(D)) v[b,j,h]
// with the causal mask j <= i (aligned top-left when Sq != Sk) if asked.
// The (Sq, Sk) score matrix is never stored: each block keeps a running
// max m, sum l and accumulator acc per query row in f32 registers and
// rescales them by corr = exp(m_prev - m_new) at each key tile, as the TPU
// kernel does with its VMEM scratch.  m starts at -1e30, masked scores are
// -1e30 and the output is acc / max(l, 1e-30), as there.
//
// Bound: at the serving shape (16, 198, 12, 64) f32 the work is
// 4*B*H*S^2*D = 1.93 GFLOP against 38.9 MB of q, k, v and o, so it is bound
// by operations (28.8 us at 67 TFLOP/s of f32 FMA) rather than bytes
// (11.6 us at 3.35 TB/s).  This first kernel computes in f32 on the CUDA
// cores; wgmma, TMA and tensor cores are later work.
//
// Design: one block of 128 threads per (batch*head, tile of 64 query rows).
// The TPU kernel's sequential KV grid axis becomes a loop inside the block
// over 64-key tiles staged in shared memory (f32, rows padded to D+1 so
// that the rows a warp reads fall in different banks).  The threads form
// 16 row groups of 8 lanes: a group owns 4 query rows; each lane computes
// the scores of those rows against 8 of the tile's keys and owns D/8
// columns of their output.  Row max and row sum merge across the 8 lanes
// by warp shuffles; the probabilities go through shared memory to the
// P.V product, read only by the warp that wrote them.  q, k and v are read
// in their (B, S, H, D) layout through their strides (inner stride 1), so
// a view into a fused qkv projection needs no copy.  Any Sq and Sk are
// masked: rows past Sq are not stored, keys past Sk score -1e30.  In
// causal mode the key loop stops after the tile that holds the block's
// last row, skipping tiles wholly above the diagonal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per shared-memory tile
constexpr int THREADS = 128;
constexpr int RM = 4;        // query rows per row group
constexpr int CN = 8;        // lanes per row group
constexpr int KC = BK / CN;  // keys per lane in a tile
constexpr int LP = BK + 1;   // padded row of the probability tile

struct Strides {
  long long b, s, h;
};

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

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < CN; off <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < CN; off <<= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LP) * (int)sizeof(float);
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H, int Sq, int Sk,
                       Strides qs, Strides ks, Strides vs, Strides os, float scale,
                       int causal) {
  constexpr int LD = D + 1;    // padded row of the q, k and v tiles
  constexpr int DC = D / CN;   // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row0 = (tid / CN) * RM;  // first of this lane's 4 rows in the tile
  const int tc = tid % CN;           // keys tc + CN*j, output columns tc + CN*j

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? to_f32(qb[qi * qs.s + d]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int kj = k0 + r;
      const bool in = kj < Sk;
      Ks[r * LD + d] = in ? to_f32(kb[kj * ks.s + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f32(vb[kj * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[RM][KC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RM], kk[KC];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(row0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < KC; ++j) kk[j] = Ks[(tc + CN * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + row0 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kj = k0 + tc + CN * j;
        float x = s[i][j] * scale;
        if (kj >= Sk || (causal && kj > qi)) x = NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(row0 + i) * LP + tc + CN * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row group's probabilities are read by its own warp only

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[RM], vv[DC];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = Ps[(row0 + i) * LP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * LD + tc + CN * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + row0 + i;
    if (qi < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c) ob[qi * os.s + tc + CN * c] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
           const long long* st, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_attention_kernel<D, T>;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, H, Sq, Sk,
                                        qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128 (the reference's head
// dims), or 16 (the deit-smoke configuration's).  strides: 12 element
// strides (batch, seq, head) of q, k, v and o, whose inner stride is 1.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int H, int Sq, int Sk, int D,
                                      const long long* strides, float scale, int causal,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (Sq + BQ - 1) / BQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 16) return launch<16, float>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 0 && D == 64) return launch<64, float>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 0 && D == 128) return launch<128, float>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 1 && D == 16) return launch<16, __nv_bfloat16>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 1 && D == 64) return launch<64, __nv_bfloat16>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 1 && D == 128) return launch<128, __nv_bfloat16>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
