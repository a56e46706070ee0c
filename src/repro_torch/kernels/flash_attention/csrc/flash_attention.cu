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
// -1e30 and the output is acc / max(l, 1e-30), as there.  Two kernels:
// float32 runs on the CUDA cores, bfloat16 on the tensor cores.
//
// Both: one block of 128 threads per (batch*head, tile of 64 query rows).
// The TPU kernel's sequential KV grid axis becomes a loop inside the block
// over 64-key tiles staged in shared memory.  q, k and v are read in their
// (B, S, H, D) layout through their strides (inner stride 1), so a view
// into a fused qkv projection needs no copy.  Any Sq and Sk are masked:
// rows past Sq are not stored, keys past Sk score -1e30.  In causal mode
// the key loop stops after the tile that holds the block's last row,
// skipping tiles wholly above the diagonal.
//
// float32 (flash_attention_kernel).  Bound: at the serving shape
// (16, 198, 12, 64) the work is 4*B*H*S^2*D = 1.93 GFLOP against 38.9 MB of
// q, k, v and o, so it is bound by operations (28.8 us at 67 TFLOP/s of
// f32 FMA) rather than bytes (11.6 us at 3.35 TB/s).  It computes in f32
// on the CUDA cores.  Tiles are f32 in shared memory, rows padded to D+1
// so that the rows a warp reads fall in different banks.  The threads form
// 16 row groups of 8 lanes: a group owns 4 query rows; each lane computes
// the scores of those rows against 8 of the tile's keys and owns D/8
// columns of their output.  Row max and row sum merge across the 8 lanes
// by warp shuffles; the probabilities go through shared memory to the
// P.V product, read only by the warp that wrote them.
//
// bfloat16 (flash_attention_bf16_kernel), FlashAttention-2's structure on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Bound: at the f(batch)
// sweep's (32, 256, 4, 64) causal shape, called as attention(q, q, q), the
// work is 1.08 GFLOP against 8.39 MB (q read once, o written once), so it
// is bound by bytes: 2.504 us at 3.35 TB/s against 1.09 us of operations
// at 989 TFLOP/s.  At such sizes latency and occupancy decide, so the
// design overlaps every load with compute:
//   - each of the 4 warps owns 16 query rows; q is copied once into shared
//     memory with cp.async (16 bytes a thread) and kept in registers as
//     mma A fragments (ldmatrix);
//   - K and V tiles of 64 keys are double-buffered in shared memory with
//     cp.async.cg: tile j+1 is in flight while tile j is multiplied, with
//     one barrier a tile.  Rows are padded by 16 bytes, so the 8 rows an
//     ldmatrix phase reads fall in 8 different groups of 4 banks;
//   - S = QK^T on K fragments from ldmatrix; the mask and the online
//     softmax stay in f32 registers, on the raw scores, with the scale
//     folded into one base-2 exponent, p = 2^((s - m) log2(e) / sqrt(D))
//     (one FFMA and one ex2.approx a score; the same function); row max
//     and row sum are reduced across the 4 lanes that share a row, and l
//     sums the f32 probabilities;
//   - P is rounded to bf16 straight from the S accumulators into A
//     fragments (the C and A layouts of m16n8k16 line up) and multiplied
//     by V fragments from ldmatrix.trans, as SDPA's flash backend does;
//     the reference multiplies f32 P, which differs by at most 2^-8 of
//     each term;
//   - only the tile on a warp's diagonal or past Sk pays for the mask;
//     keys past Sk are zero-filled by cp.async (src-size 0), so no stale
//     shared memory reaches a product.
// cp.async needs 16-byte aligned global addresses: the wrapper checks that
// every bf16 base pointer and (B, S, H) stride is a multiple of 8 elements.

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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int H, int Sq, int Sk,
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? qb[qi * qs.s + d] : 0.f;
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
      Ks[r * LD + d] = in ? kb[kj * ks.s + d] : 0.f;
      Vs[r * LD + d] = in ? vb[kj * vs.s + d] : 0.f;
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
      for (int c = 0; c < DC; ++c) ob[qi * os.s + tc + CN * c] = acc[i][c] / denom;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
           const long long* st, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_attention_kernel<D>;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, (float*)o,
                                        H, Sq, Sk, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

// ---- bfloat16 on the tensor cores ---------------------------------------- //

constexpr int PAD = 8;  // bf16 elements (16 bytes) of padding per shared-memory row
static_assert(BQ == BK, "the bf16 kernel loads q tiles with the key-tile loader");

template <int D>
constexpr int bf16_smem_bytes() {  // a q tile and two K and two V tiles
  return (BQ + 4 * BK) * (D + PAD) * (int)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 2^x in one MUFU instruction (a result below 2^-126 flushes to 0; p is
// divided by a row sum >= 1, so nothing it keeps is lost).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronous; zero-fills when `in` is false
// (src-size 0 reads nothing from `src`).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared-memory address `a`; lanes 8i..8i+7 give
// the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Rows [row0, row0 + BK) of a (S, D) slice with row stride `stride` into
// a padded shared-memory tile; rows at or past `n_rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int n_rows, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks in a row
  static_assert(BK * CH % THREADS == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < BK * CH / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = row0 + r < n_rows;
    cp_async_16(dst + r * (D + PAD) + c, src + (in ? (row0 + r) * stride : 0) + c, in);
  }
}

// Fragment ownership of m16n8k16 (g = lane / 4, t = lane % 4): A register
// i holds row g + 8 (i % 2), columns 2t, 2t + 1 (+ 8 for i >= 2); B register
// i holds rows 2t, 2t + 1 (+ 8 for i = 1) of column g; C element e holds row
// g + 8 (e / 2), column 2t + e % 2.  So a thread owns rows g and g + 8 of
// its warp's 16.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                            float scale, int causal) {
  constexpr int LD = D + PAD;  // padded row of every tile
  constexpr int KD = D / 16;   // 16-deep slices of the head dim (QK^T)
  constexpr int NS = BK / 8;   // 8-key column tiles of S
  constexpr int NO = D / 8;    // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;      // two buffers
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // two buffers

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int w0 = (tid / 32) * 16;  // the warp's first row in the tile
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = scale * 1.4426950408889634f;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<D>(Qs, qb, qs.s, q0, Sq, tid);
  cp_async_commit();
  load_tile<D>(Ks, kb, ks.s, 0, Sk, tid);
  load_tile<D>(Vs, vb, vs.s, 0, Sk, tid);
  cp_async_commit();
  cp_async_wait<1>();  // q has landed; key tile 0 may still be in flight
  __syncthreads();
  unsigned qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldmatrix_x4(qf[kd], smem_addr(Qs + (w0 + lane % 16) * LD + kd * 16 + (lane / 16) * 8));
  // This lane's ldmatrix row address in K and V buffer 0, in shared-memory
  // bytes (2 a bf16); each product below adds a constant offset to it.
  const unsigned k_lane = smem_addr(Ks + (lane % 8 + (lane / 16) * 8) * LD + (lane / 8 % 2) * 8);
  const unsigned v_lane = smem_addr(Vs + (lane % 8 + (lane / 8 % 2) * 8) * LD + (lane / 16) * 8);

  float acc[NO][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    // Tile j was started one step ago (or in the prologue).  Once it has
    // landed and every warp is past step j-1, tile j+1 goes into the buffer
    // that step j-1 read, and loads while tile j is multiplied.
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) {
      load_tile<D>(Ks + (j + 1) % 2 * BK * LD, kb, ks.s, k0 + BK, Sk, tid);
      load_tile<D>(Vs + (j + 1) % 2 * BK * LD, vb, vs.s, k0 + BK, Sk, tid);
      cp_async_commit();
    }
    const unsigned kt = k_lane + j % 2 * BK * LD * 2;
    const unsigned vt = v_lane + j % 2 * BK * LD * 2;

    // S = Q K^T: one ldmatrix.x4 gives the B fragments of two 8-key tiles.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        unsigned kf[4];
        ldmatrix_x4(kf, kt + (n * 8 * LD + kd * 16) * 2);
        mma_bf16(s[n], qf[kd], kf[0], kf[1]);
        mma_bf16(s[n + 1], qf[kd], kf[2], kf[3]);
      }

    // Online softmax in f32 on the raw scores q.k (m too); the scale is
    // folded into the exponent, p = 2^(s * scale_log2 - m * scale_log2).
    // Only a tile on the warp's causal diagonal or past Sk masks.  Element
    // e of s[n] is row g + 8 (e / 2).
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + w0);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int kj = k0 + n * 8 + 2 * t + e % 2;
          const int qi = q0 + w0 + g + (e / 2) * 8;
          if (kj >= Sk || (causal && kj > qi)) s[n][e] = NEG;
        }
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float corr[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2((m[r] - m_new) * scale_log2);
      m[r] = m_new;
      neg_m[r] = -m_new * scale_log2;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[n][e], scale_log2, neg_m[e / 2]));
        s[n][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(FULL_MASK, sum[r], 1);
      sum[r] += __shfl_xor_sync(FULL_MASK, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

    // O += P V: the S tiles of keys 16kk..16kk+15 are the A fragment of step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 * LD + n * 8) * 2);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + w0 + g + r * 8;
    if (qi < Sq) {
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + qi * os.s + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
                const long long* st, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_attention_bf16_kernel<D>;
  constexpr int smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, stream>>>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                        (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, Sq, Sk, qs, ks,
                                        vs, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; 16-byte
// aligned pointers and strides); D: 64 or 128 (the reference's head
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
  if (dtype == 0 && D == 16) return launch<16>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 0 && D == 64) return launch<64>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 0 && D == 128) return launch<128>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 1 && D == 16) return launch_bf16<16>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  if (dtype == 1 && D == 128) return launch_bf16<128>(q, k, v, o, B, H, Sq, Sk, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
