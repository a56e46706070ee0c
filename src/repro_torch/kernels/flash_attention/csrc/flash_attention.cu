// Flash attention (online softmax over key tiles), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention -> pallas_call).  For q, k, v of shape (B, S, H, D):
//   o[b, i, h] = sum_j softmax_j(q[b,i,h] . k[b,j,h] / sqrt(D)) v[b,j,h]
// with the causal mask j <= i (aligned top-left when Sq != Sk) if asked.
// The (Sq, Sk) score matrix is never stored: each warp keeps a running
// max m, sum l and accumulator acc per query row in f32 registers and
// rescales them by corr = exp(m_prev - m_new) at each key tile, as the TPU
// kernel does with its VMEM scratch.  m starts at -1e30, masked scores are
// -1e30 and the output is acc / max(l, 1e-30), as there.  Two kernels, both
// on the tensor cores: float32 in three TF32 products per product
// ("3xTF32"), bfloat16 in bf16 products; both sum in f32.
//
// Both follow FlashAttention-2: one block of 4 warps per (batch*head, tile
// of 64 query rows), each warp owning 16 rows.  The TPU kernel's sequential
// KV grid axis becomes a loop inside the block over key tiles that
// cp.async.cg double-buffers in shared memory: tile j+1 is in flight while
// tile j is multiplied, with one barrier a tile.  q, k and v are read in
// their (B, S, H, D) layout through their strides (inner stride 1), so a
// view into a fused qkv projection needs no copy; cp.async copies 16 bytes,
// so the wrapper checks that every base pointer and (B, S, H) stride is a
// multiple of 16 bytes.  Rows of every tile are padded by 16 bytes, which
// keeps them 16-byte aligned and puts the rows a fragment load reads in
// different banks.  Any Sq and Sk are masked: rows past Sq are not stored;
// keys past Sk are zero-filled by cp.async (src-size 0), so no stale shared
// memory reaches a product, and score -1e30.  In causal mode the key loop
// stops after the tile that holds the block's last row, and only a tile on
// a warp's diagonal or past Sk pays for the mask.  The online softmax runs
// in f32 registers on the raw scores, with the scale folded into one
// base-2 exponent, p = 2^((s - m) log2(e) / sqrt(D)): one FFMA and one
// ex2.approx a score.  Row max and row sum are reduced across the 4 lanes
// that share a row, and l sums the f32 probabilities.
//
// float32 (flash_attention_kernel), on mma.sync.m16n8k8 TF32.  Bound: at
// DeiT-B's (16, 198, 12, 64) the work is 4*B*H*S^2*D = 1.93 GFLOP against
// 38.9 MB of q, k, v and o.  In three TF32 products that is 11.69 us at
// 494.7 TFLOP/s against 11.62 us of bytes at 3.35 TB/s, so the two bounds
// meet; on the CUDA cores it would be 28.8 us at 67 TFLOP/s of f32 FMA.
//   - Every f32 operand x is split into two TF32 values, big = x rounded to
//     TF32 (to nearest, as cvt.rna) and small = x - big (exact in f32,
//     which the tensor cores cut to TF32), and each product takes
//     small*big' + big*small' first, then big*big'.  small*small' (at most
//     2^-22 of the product) is dropped, so each product is within ~2^-20
//     of f32's: the scheme of CUTLASS's OpMultiplyAddFastF32, written out
//     here.
//   - Each warp reads its q, K and V fragments with 32-bit shared loads
//     (there is no ldmatrix for 32-bit elements) and splits them itself,
//     q's at each use: q is copied once into shared memory and not held in
//     registers, and key tiles are 32 long.  That keeps the kernel near 126
//     registers at D = 64, so that 4 blocks fit on a SM and hide the
//     latency of each product's chain of three dependent mma better than
//     q held split in registers with 64-key tiles (238 registers, 2 blocks
//     a SM).  Splitting each K/V tile once per block into big and small
//     planes in shared memory saves three quarters of the split
//     instructions but costs a second barrier a tile and more shared
//     memory, and was slower (PERF.md; scripts/torch_flash_f32_variants.py).
//   - O += P V: the C fragment of S holds columns 2t and 2t + 1 of each
//     8-key slice, the A fragment of P wants columns t and t + 4.  The
//     summation index of a slice may be relabelled, so A's columns t and
//     t + 4 stand for keys 2t and 2t + 1, and V's B fragment is read from
//     key rows 2t and 2t + 1: P goes from the S accumulators to A
//     fragments with no shuffle and no trip through shared memory.
//   - Banks: with rows of D + 4 floats, the K (and q) word a lane (g, t)
//     reads falls in bank 4g + t (D = 64, 128) or 20g + t (D = 16), and the
//     V word of key row 2t, column g in bank 8t + g: 32 different banks.
//   - The warps of a block's last tile that hold no row below Sq only load
//     and wait, and in a key tile that reaches past Sk the 8-key slices
//     wholly past Sk are skipped.
//
// bfloat16 (flash_attention_bf16_kernel), on mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  Bound: at the f(batch) sweep's (32, 256, 4, 64) causal
// shape, called as attention(q, q, q), the work is 1.08 GFLOP against 8.39
// MB (q read once, o written once), so it is bound by bytes: 2.504 us at
// 3.35 TB/s against 1.09 us of operations at 989 TFLOP/s.  At such sizes
// latency and occupancy decide:
//   - q is kept in registers as A fragments (ldmatrix), K is read with
//     ldmatrix and V with ldmatrix.trans;
//   - P is rounded to bf16 straight from the S accumulators into A
//     fragments (the C and A layouts of m16n8k16 line up), as SDPA's flash
//     backend does; the reference multiplies f32 P, which differs by at
//     most 2^-8 of each term.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per shared-memory tile of the bf16 kernel
constexpr int THREADS = 128;

struct Strides {
  long long b, s, h;
};

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

// Rows [row0, row0 + ROWS) of a (S, D) slice with row stride `stride` into
// a shared-memory tile whose rows are padded by 16 bytes; rows at or past
// `n_rows` are zero-filled.
template <int D, int ROWS = BK, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int row0, int n_rows,
                                          int tid) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements in a 16-byte chunk
  constexpr int CH = D / EPC;               // chunks in a row
  static_assert(ROWS * CH % THREADS == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int r = i / CH, c = (i % CH) * EPC;
    const bool in = row0 + r < n_rows;
    cp_async_16(dst + r * (D + EPC) + c, src + (in ? (row0 + r) * stride : 0) + c, in);
  }
}

// ---- float32 on the tensor cores: 3xTF32 --------------------------------- //

constexpr int BK_F32 = 32;  // keys per tile of the f32 kernel

template <int D>
constexpr int f32_smem_bytes() {  // q, and two stages of a K and a V tile
  return (BQ + 4 * BK_F32) * (D + 4) * (int)sizeof(float);
}

// x = big + small, two TF32 operands.  big is x rounded to TF32 to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds (written as two integer
// instructions: cvt takes three and a compare on sm_90a), with the 13 low
// bits cleared.  small = x - big is exact in f32 and is passed whole: the
// tensor cores read the upper 19 bits of a TF32 register, so it is cut to
// TF32, which leaves big + small within 2^-21 of x.
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], unsigned (&big)[N], unsigned (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], big[i], small[i]);
}

// d (16x8 f32) += a (16x8 tf32, row-major) * b (8x8 tf32, column-major).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, a given split and b = (b0, b1) split here: the
// cross products first, while they are not yet lost beside big * big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&a_big)[4],
                                           const unsigned (&a_small)[4], float b0, float b1) {
  unsigned b_big[2], b_small[2];
  split_tf32(b0, b_big[0], b_small[0]);
  split_tf32(b1, b_big[1], b_small[1]);
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

// Fragment ownership of m16n8k8 TF32 (g = lane / 4, t = lane % 4): A register
// i holds row g + 8 (i % 2), column t + 4 (i / 2); B register i holds row
// t + 4i of column g; C element e holds row g + 8 (e / 2), column 2t + e % 2.
// So a thread owns rows g and g + 8 of its warp's 16.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int H, int Sq, int Sk,
                       Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
  constexpr int BKF = BK_F32;
  constexpr int LD = D + 4;            // padded row of every tile
  constexpr int KD = D / 8;            // 8-deep slices of the head dim (QK^T)
  constexpr int NS = BKF / 8;          // 8-key tiles of S, 8-key slices of P.V
  constexpr int NO = D / 8;            // 8-wide column tiles of O
  constexpr int STAGE = 2 * BKF * LD;  // a K tile, then a V tile
  extern __shared__ __align__(16) float smem_f32[];
  float* const q_tile = smem_f32 + 2 * STAGE;  // q, after the two stages

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int w0 = (tid / 32) * 16;  // the warp's first row in the tile
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = scale * 1.4426950408889634f;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + BKF - 1) / BKF;
  const bool active = q0 + w0 < Sq;  // the warp holds a row to compute

  load_tile<D, BQ>(q_tile, qb, qs.s, q0, Sq, tid);
  load_tile<D, BKF>(smem_f32, kb, ks.s, 0, Sk, tid);
  load_tile<D, BKF>(smem_f32 + BKF * LD, vb, vs.s, 0, Sk, tid);
  cp_async_commit();
  // A fragment i of q's slice kd: q_lane[(i % 2) * 8 * LD + kd * 8 + (i / 2) * 4].
  const float* q_lane = q_tile + (w0 + g) * LD + t;

  float acc[NO][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BKF;
    // Tile j was started one step ago (q and tile 0 in the prologue).  Once
    // it has landed and every warp is past step j-1, tile j+1 goes into the
    // stage that step j-1 read, and loads while tile j is multiplied.
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) {
      float* next = smem_f32 + (j + 1) % 2 * STAGE;
      load_tile<D, BKF>(next, kb, ks.s, k0 + BKF, Sk, tid);
      load_tile<D, BKF>(next + BKF * LD, vb, vs.s, k0 + BKF, Sk, tid);
      cp_async_commit();
    }
    if (!active) continue;
    const float* k_lane = smem_f32 + j % 2 * STAGE + g * LD + t;
    const float* v_lane = smem_f32 + j % 2 * STAGE + BKF * LD + 2 * t * LD + g;
    // Only a tile that reaches past Sk skips its 8-key slices wholly past
    // Sk; the test stays out of the other tiles, where a branch around
    // each slice's products would keep their chains from interleaving.
    const int n_live = min(NS, (Sk - k0 + 7) / 8);
    const bool ragged = n_live < NS;

    // S = Q K^T.  Element e of s[n] is row g + 8 (e / 2), key 8n + 2t + e % 2.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    auto qk = [&](auto skip) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        unsigned a_big[4], a_small[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(q_lane[(i % 2) * 8 * LD + kd * 8 + (i / 2) * 4], a_big[i], a_small[i]);
#pragma unroll
        for (int n = 0; n < NS; ++n)
          if (!decltype(skip)::value || n < n_live)
            mma_3xtf32(s[n], a_big, a_small, k_lane[n * 8 * LD + kd * 8],
                       k_lane[n * 8 * LD + kd * 8 + 4]);
      }
    };
    if (ragged) {
      qk(std::true_type{});
    } else {
      qk(std::false_type{});
    }

    // Online softmax on the raw scores, as in the bf16 kernel below.
    const bool edge = k0 + BKF > Sk || (causal && k0 + BKF - 1 > q0 + w0);
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

    // O += P V over the 8-key slices, A's columns t and t + 4 relabelled as
    // keys 2t and 2t + 1: the A fragment is (s[0], s[2], s[1], s[3]) and V's
    // B fragment comes from key rows 2t and 2t + 1, column g.
    auto pv = [&](auto skip) {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        if (decltype(skip)::value && kk >= n_live) continue;
        const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        unsigned p_big[4], p_small[4];
        split_tf32(pa, p_big, p_small);
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma_3xtf32(acc[n], p_big, p_small, v_lane[kk * 8 * LD + n * 8],
                     v_lane[(kk * 8 + 1) * LD + n * 8]);
      }
    };
    if (ragged) {
      pv(std::true_type{});
    } else {
      pv(std::false_type{});
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + w0 + g + r * 8;
    if (qi < Sq) {
      const float denom = fmaxf(l[r], 1e-30f);
      float* orow = ob + qi * os.s + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(orow + n * 8) =
            make_float2(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
           const long long* st, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_attention_kernel<D>;
  constexpr int smem = f32_smem_bytes<D>();
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

// dtype: 0 = float32 (3xTF32), 1 = bfloat16, both on the tensor cores with
// 16-byte aligned pointers and strides; D: 64 or 128 (the reference's head
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
