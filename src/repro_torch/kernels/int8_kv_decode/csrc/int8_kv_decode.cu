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
// Design (split-K flash-decode in one launch):
//  * One block of 128 threads per (b*KH + kh, split of S).  B*KH is only
//    64 at the path's shape, so S is split until the grid fills one wave
//    of the blocks that fit on the card (kernel.py split_plan, from
//    int8_kv_decode_plan's occupancy).
//  * Loads run ahead of compute: each split's tiles of 64 tokens stream
//    through a ring of STAGES shared-memory stages filled by cp.async with
//    commit/wait groups (16-byte copies of the K and V rows, read in place
//    at stride KH*D in the cache; 4-byte copies of the tile's scales;
//    zero-fill past S), so tiles t+1 .. t+STAGES-1 are in flight while
//    tile t is computed.
//  * int8 without the I2F pipe: four int8 of a word become two exact fp16
//    pairs by one LOP3 (flip the sign bits: x + 128 as an unsigned byte),
//    two PRMT (each byte under the fp16 exponent of 1024: 1024 + x + 128)
//    and two f16x2 subtractions of 1152.  Every int8 is an fp16, and fp16 x
//    int8 products are exact in f32.
//  * Scores on the tensor cores: warp w computes S^T = K q^T for tokens
//    16w .. 16w + 15 of the tile with mma.sync m16n8k16 (fp16 operands, f32
//    sums): A is the K rows, B the G query rows (N = 8, rows past G zero),
//    scaled by a power of 2 into fp16's range and split into fp16 parts
//    that sum to q (one part for a bf16 q, three for f32), held in shared
//    memory as fragments.  A chunk's dims are permuted alike in A and B so
//    that a lane's A pairs come from one 32-bit word of a K row; K rows are
//    padded to 16 mod 32 bytes, so a warp's fragment reads hit 32 banks.
//    The block's running max per query row is exchanged once a tile.
//  * P.V on the tensor cores: warp w adds its 16 tokens' P' = p*v_s*2^k
//    times V into out^T (dims x query rows), fp16 products again: A is V^T
//    (a lane gathers its pairs from one 32-bit word of each of 4 token rows
//    by a PRMT), B is P'^T, passed from the scores' accumulator layout
//    through the warp's own shared memory and split into three fp16 parts
//    that sum to the f32 P', so P is not rounded below f32.  2^k holds the
//    warp's running max of v_s in [2^14, 2^15) (p <= 1); when it falls, the
//    accumulators are scaled by the exact power of 2 with the softmax
//    rescale.  The warps' sums and the exp-sums are added once a split, in
//    a fixed order.  Two barriers a tile: the ring and the running max.
//  * Merge in the same launch: with more than one split, each block
//    writes its (m, l, acc) partials and counts itself in on a per-(b*KH +
//    kh) counter (one release-acquire atomic after a barrier); the block
//    that arrives last reads every split's partials, combines them (M =
//    max m_i, L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) /
//    max(L, 1e-30)) and
//    resets the counter to 0, so it is zero between calls and the launch
//    can be captured in a CUDA graph.  The result does not depend on which
//    block merges.
// m starts at -1e30 and l is floored at 1e-30, as in the TPU kernel.  Any
// S >= 1 is taken: tokens past S get p = 0 and zero rows.  D is any
// multiple of 16 up to 256; G up to 8, every G on one code path (the score
// product's 8 query rows, those past G zero and never read).  No attention
// mask: the reference attends to every slot of the ring.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 128;  // 4 warps; each scores 16 tokens of a tile
constexpr int WARPS = THREADS / 32;
constexpr int BS = 64;        // tokens per shared-memory tile
constexpr int QR = 8;         // query rows of the score product (its N), G padded
constexpr int STAGES = 3;     // tiles in the cp.async ring
constexpr int MAX_D = 256;
constexpr int MAX_SPLITS = 256;  // the merge keeps m_i and l_i per (split, g) in the ring
static_assert(THREADS == 2 * BS, "each thread copies one scale of a tile");
static_assert(WARPS * 16 == BS, "each warp scores 16 tokens (the product's M)");

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, asynchronous; zero-fills when `in` is
// false (src-size 0 reads nothing from `src`).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four int8 of a 32-bit word -> two fp16 pairs, exactly, without I2F: the
// sign bits flipped (x + 128 as an unsigned byte), PRMT puts each byte under
// the fp16 exponent of 1024 (0x64xx, the value 1024 + x + 128), and one
// f16x2 subtraction of 1152 leaves x.  lo holds bytes 0, 1 and hi bytes 2, 3,
// the first of each pair in the low half.
__device__ __forceinline__ void i8x4_to_h2x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t x = __byte_perm(u, 0x6464u, 0x4140u), y = __byte_perm(u, 0x6464u, 0x4342u);
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(x), "r"(0x64806480u));
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(y), "r"(0x64806480u));
}

// d += a * b on the tensor cores: m16n8k16, fp16 operands, f32 sums.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as three fp16 pairs (hi, mid, lo, each rounded to nearest)
// whose sums are the floats: 3 x 11 bits hold f32's 24 (for values whose
// parts stay in fp16's normal range).
__device__ __forceinline__ void split_f16x3(float x, float y, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float rx = x - __low2float(h), ry = y - __high2float(h);
  const __half2 m = __floats2half2_rn(rx, ry);
  const __half2 l = __floats2half2_rn(rx - __low2float(m), ry - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// atomicAdd with release and acquire semantics at GPU scope.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Pitch of a K row in the tile, in bytes: 16 mod 32, so a warp's 32-bit
// reads of A fragments (8 rows x 4 neighbouring words) hit 32 banks.
__host__ __device__ __forceinline__ int k_ld(int D) { return D % 32 == 0 ? D + 16 : D; }

// q's B fragments in shared memory: (parts, D/16 chunks, 32 lanes) x 8 bytes.
__host__ __device__ __forceinline__ int q_frag_bytes(int parts, int D) { return parts * (D / 16) * 32 * 8; }

// One ring stage: the K tile and the V tile (rows padded to k_ld), then the
// tile's k_s and v_s.
__host__ __device__ __forceinline__ int stage_bytes(int D) { return BS * (2 * k_ld(D) + 8); }

// The ring, which the split's closing sum over the warps reuses (WARPS x
// QR x D f32), and then the merge: every split's m_i and l_i (2 x
// MAX_SPLITS x QR f32) and at least one split's acc (QR x D f32).
int ring_bytes(int D) {
  const int ring = STAGES * stage_bytes(D);
  const int red = WARPS * QR * D * (int)sizeof(float);
  const int merge = (2 * MAX_SPLITS * QR + QR * D) * (int)sizeof(float);
  const int most = ring > red ? ring : red;
  return most > merge ? most : merge;
}

// Shared memory: the ring, q's fragments, each warp's p*v_s (QR x 20 f32:
// 16 tokens, padded), the warps' partial max and exp-sum (WARPS x QR f32
// each), the merge flag.
int smem_bytes(int parts, int D) {
  return ring_bytes(D) + q_frag_bytes(parts, D) +
         (WARPS * QR * 20 + 2 * WARPS * QR) * (int)sizeof(float) + 16;
}

// q's split into fp16 parts: three for float32 (33 bits of mantissa hold
// f32's 24), one for bfloat16 (fp16's 11 bits hold bf16's 8).
template <typename T>
__host__ __device__ constexpr int q_parts() { return std::is_same<T, float>::value ? 3 : 1; }

// n / d for 0 <= n, d < 2^16, as (n * ceil(2^32 / d)) >> 32: a runtime
// integer division would compile to I2F and F2I, which the kernel avoids.
__host__ __device__ __forceinline__ int div_by(int n, unsigned long long magic) {
  return (int)(((unsigned long long)n * magic) >> 32);
}

unsigned long long magic_of(int d) { return ((1ull << 32) + d - 1) / d; }

struct Shapes {
  int H, KH, S, D, G;
  int n_splits, tiles_per_split;
  float scale;
  int ring;   // ring bytes (ring_bytes)
  int chunk;  // splits whose acc the merge copies into the ring at once
  unsigned long long chunk_magic, d_magic;  // for division by D/16 and D
};

// MB: 16-dim blocks of the accumulator, D / 16 rounded up to 4, 8, 10 or
// 16 (registers: 4 a block); up to 10 blocks, 3 blocks a SM fit.
template <int MB, typename T>
__global__ void __launch_bounds__(THREADS, MB <= 10 ? 3 : 1)
int8_kv_decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                      const float* __restrict__ ks, const int8_t* __restrict__ vq,
                      const float* __restrict__ vs, T* __restrict__ out, float* __restrict__ ws,
                      int* __restrict__ counters, Shapes sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = sh.D, G = sh.G, KH = sh.KH, S = sh.S;
  constexpr int NPART = q_parts<T>();
  const int kld = k_ld(D), stage = stage_bytes(D), nch = D / 16;
  uint2* Qf = reinterpret_cast<uint2*>(smem + sh.ring);     // (NPART, nch, 32) B fragments
  float* Pw = reinterpret_cast<float*>(Qf + NPART * nch * 32);  // (WARPS, QR, 20): p * v_s
  float* red_max = Pw + WARPS * QR * 20;                    // (WARPS, QR)
  float* red_l = red_max + WARPS * QR;                      // (WARPS, QR)
  int* last = reinterpret_cast<int*>(red_l + WARPS * QR);

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int bk = b * KH + kh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile0 = split * sh.tiles_per_split;
  const int n_tiles = min(sh.tiles_per_split, (S + BS - 1) / BS - tile0);

  const long long row_stride = (long long)KH * D;  // bytes between tokens
  const int8_t* kbase = kq + (long long)b * S * row_stride + (long long)kh * D;
  const int8_t* vbase = vq + (long long)b * S * row_stride + (long long)kh * D;
  const float* ksb = ks + (long long)b * S;
  const float* vsb = vs + (long long)b * S;

  // tile i of the split into stage i % STAGES; one commit group a call,
  // empty past the split's end, so every thread counts groups alike
  auto issue = [&](int i) {
    if (i < n_tiles) {
      unsigned char* st = smem + (i % STAGES) * stage;
      const int s0 = (tile0 + i) * BS;
      const int chunks = D / 16;
      for (int u = tid; u < BS * chunks; u += THREADS) {
        const int r = div_by(u, sh.chunk_magic), c = u - r * chunks;
        const bool in = s0 + r < S;
        const long long off = in ? (long long)(s0 + r) * row_stride + 16 * c : 0;
        cp_async_16(st + r * kld + 16 * c, kbase + off, in);
        cp_async_16(st + BS * kld + r * kld + 16 * c, vbase + off, in);
      }
      const int j = tid % BS;
      const bool in = s0 + j < S;
      float* scales = reinterpret_cast<float*>(st + 2 * BS * kld);
      cp_async_4(scales + tid, (tid < BS ? ksb : vsb) + (in ? s0 + j : 0), in);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // q's B fragments: row n = g (zero for g >= G) of the score product
  // S^T = K q^T, scaled by 2^e so that max |q| lies in [2^14, 2^15) (fp16's
  // range; 2^-e multiplies the scores back, exactly), split into NPART fp16
  // parts.  The chunk's dims are permuted (fragment column 2t + i <-> dim
  // 4t + i, 2t + 8 + i <-> 4t + 2 + i), as in the A fragments, so that a
  // thread's A pair comes from one 32-bit word of a K row.
  constexpr int OUTS = QR * MAX_D / THREADS;  // (g, d) entries a thread may own
  const T* qb = q + ((long long)b * sh.H + (long long)kh * G) * D;
  float qmax = 0.f;
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int i = tid + k * THREADS;
    const float x = to_f32(qb[i < G * D ? i : 0]);
    qmax = fmaxf(qmax, i < G * D ? fabsf(x) : 0.f);
  }
  qmax = warp_max(qmax);
  if (lane == 0) red_max[warp] = qmax;
  __syncthreads();
  qmax = fmaxf(fmaxf(red_max[0], red_max[1]), fmaxf(red_max[2], red_max[3]));
  const int ex = (int)((__float_as_uint(qmax) >> 23) & 0xff) - 127;  // -127: zero or subnormal
  const int e2 = ex == -127 ? 0 : min(max(14 - ex, -126), 126);
  const float up = __uint_as_float((unsigned)(127 + e2) << 23);
  const float down = __uint_as_float((unsigned)(127 - e2) << 23);
  for (int u = tid; u < nch * 32; u += THREADS) {
    const int c = u >> 5, ln = u & 31, gq = ln >> 2, t = ln & 3;
    const int base = gq < G ? gq * D + 16 * c + 4 * t : 0;
    uint32_t h[NPART][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float r = gq < G ? to_f32(qb[base + e]) * up : 0.f;
#pragma unroll
      for (int part = 0; part < NPART; ++part) {
        const __half hp = __float2half_rn(r);
        r -= __half2float(hp);
        const uint32_t bits = __half_as_ushort(hp);
        h[part][e >> 1] = (e & 1) ? (h[part][e >> 1] | bits << 16) : bits;
      }
    }
#pragma unroll
    for (int part = 0; part < NPART; ++part) {
      Qf[(part * nch + c) * 32 + ln] = make_uint2(h[part][0], h[part][1]);
    }
  }

  // scores: warp w multiplies tokens 16w .. 16w + 15 of the tile (the A
  // rows) by q (the B columns): this lane gets tokens 16w + g8 and
  // 16w + g8 + 8 of query rows 2*t4 and 2*t4 + 1
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tokA = warp * 16 + g8, tokB = tokA + 8;
  // P.V: warp w adds P' (its 16 tokens) times V into out^T: A = V^T, 16
  // dims a product (row g8 <-> dim d0 = 4*(g8 >> 1) + 2*(g8 & 1) of the
  // block, row g8 + 8 <-> d0 + 1), K = the warp's tokens, B = P'^T.  The
  // lane accumulates dims d0, d0 + 1 of each block for query rows 2*t4,
  // 2*t4 + 1.
  const int dsel = 2 * (g8 & 1);  // byte of d0 in its word
  const unsigned gather = dsel | (4 + dsel) << 4 | (dsel + 1) << 8 | (5 + dsel) << 12;
  const int vp = kld / 4;  // V row pitch in 32-bit words
  float* pw = Pw + warp * QR * 20;

  // running max and exp-sum of this lane's query rows 2*t4, 2*t4 + 1
  float m0 = NEG, m1 = NEG, ls0 = 0.f, ls1 = 0.f, acc[MB][4];
  float vmax = 0.f;  // the warp's running max of v_s
  int kv = 126;      // acc is in units of 2^-kv
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) acc[mb][0] = acc[mb][1] = acc[mb][2] = acc[mb][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i have landed
    __syncthreads();              // everyone's have; everyone is done with tile i - 1
    issue(i + STAGES - 1);        // into tile i - 1's stage
    const unsigned char* st = smem + (i % STAGES) * stage;
    const int8_t* Ks = reinterpret_cast<const int8_t*>(st);
    const uint32_t* Vw = reinterpret_cast<const uint32_t*>(st + BS * kld);  // (BS, vp)
    const float* ks_t = reinterpret_cast<const float*>(st + 2 * BS * kld);
    const float* vs_t = ks_t + BS;
    const int n_valid = min(BS, S - (tile0 + i) * BS);

    // two chunks a step into two accumulators, so that two chains of
    // products are in flight (an odd last chunk reloads its own and skips)
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, sd[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t* kA = reinterpret_cast<const uint32_t*>(Ks + tokA * kld) + t4;
    const uint32_t* kB = reinterpret_cast<const uint32_t*>(Ks + tokB * kld) + t4;
    for (int c = 0; c < nch; c += 2) {
      const int c1 = min(c + 1, nch - 1);
      uint32_t a[4], a1[4];
      i8x4_to_h2x2(kA[4 * c], a[0], a[2]);
      i8x4_to_h2x2(kB[4 * c], a[1], a[3]);
      i8x4_to_h2x2(kA[4 * c1], a1[0], a1[2]);
      i8x4_to_h2x2(kB[4 * c1], a1[1], a1[3]);
      uint2 bq[NPART], bq1[NPART];
#pragma unroll
      for (int part = 0; part < NPART; ++part) {
        bq[part] = Qf[(part * nch + c) * 32 + lane];
        bq1[part] = Qf[(part * nch + c1) * 32 + lane];
      }
#pragma unroll
      for (int part = NPART - 1; part >= 0; --part) {  // the small parts first
        mma_f16(sc, a, bq[part].x, bq[part].y);
        if (c + 1 < nch) mma_f16(sd, a1, bq1[part].x, bq1[part].y);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] += sd[e];
    const bool vA = tokA < n_valid, vB = tokB < n_valid;
    float s[4];  // (token A, row 2t4), (A, 2t4 + 1), (B, 2t4), (B, 2t4 + 1)
    s[0] = vA ? sc[0] * down * ks_t[tokA] * sh.scale : NEG;
    s[1] = vA ? sc[1] * down * ks_t[tokA] * sh.scale : NEG;
    s[2] = vB ? sc[2] * down * ks_t[tokB] * sh.scale : NEG;
    s[3] = vB ? sc[3] * down * ks_t[tokB] * sh.scale : NEG;
    float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, off));
    }
    if (g8 == 0) {
      red_max[warp * QR + 2 * t4] = mx0;
      red_max[warp * QR + 2 * t4 + 1] = mx1;
    }
    __syncthreads();
    // the rows' new max over the block (rows past G see scores of 0: their
    // values are finite and never read)
    float t0 = red_max[2 * t4], t1 = red_max[2 * t4 + 1];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      t0 = fmaxf(t0, red_max[w * QR + 2 * t4]);
      t1 = fmaxf(t1, red_max[w * QR + 2 * t4 + 1]);
    }
    t0 = fmaxf(m0, t0);
    t1 = fmaxf(m1, t1);
    const float c0 = expf(m0 - t0), c1 = expf(m1 - t1);
    m0 = t0;
    m1 = t1;
    const float p0 = vA ? expf(s[0] - m0) : 0.f, p1 = vA ? expf(s[1] - m1) : 0.f;
    const float p2 = vB ? expf(s[2] - m0) : 0.f, p3 = vB ? expf(s[3] - m1) : 0.f;
    ls0 = ls0 * c0 + (p0 + p2);
    ls1 = ls1 * c1 + (p1 + p3);
    // P' = p*v_s*2^k in fp16 range: 2^k puts the warp's running max of v_s
    // (p <= 1) in [2^14, 2^15); when that max grows, k falls and the
    // accumulators, kept in units of 2^-k, are scaled by the exact power of
    // 2 with the softmax rescale
    float tv = vs_t[warp * 16 + (lane & 15)];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) tv = fmaxf(tv, __shfl_xor_sync(FULL_MASK, tv, off));
    vmax = fmaxf(vmax, tv);
    const int kv_new = min(max(14 - ((int)((__float_as_uint(vmax) >> 23) & 0xff) - 127), -126), 126);
    const float up = __uint_as_float((unsigned)(127 + kv_new) << 23);
    const float shrink = kv_new - kv < -126 ? 0.f : __uint_as_float((unsigned)(127 + kv_new - kv) << 23);
    kv = kv_new;
    // P'^T's B fragments through the warp's own shared memory (this lane
    // holds tokens g8, g8 + 8 of rows 2*t4, 2*t4 + 1; it needs row g8 of
    // tokens 2*t4, 2*t4 + 1, 2*t4 + 8, 2*t4 + 9), split into three fp16
    // parts that sum to the f32 P'
    pw[2 * t4 * 20 + g8] = p0 * vs_t[tokA] * up;
    pw[(2 * t4 + 1) * 20 + g8] = p1 * vs_t[tokA] * up;
    pw[2 * t4 * 20 + g8 + 8] = p2 * vs_t[tokB] * up;
    pw[(2 * t4 + 1) * 20 + g8 + 8] = p3 * vs_t[tokB] * up;
    __syncwarp();
    const float2 x01 = *reinterpret_cast<const float2*>(pw + g8 * 20 + 2 * t4);
    const float2 x89 = *reinterpret_cast<const float2*>(pw + g8 * 20 + 2 * t4 + 8);
    uint32_t bp[3][2];
    split_f16x3(x01.x, x01.y, bp[0][0], bp[1][0], bp[2][0]);
    split_f16x3(x89.x, x89.y, bp[0][1], bp[1][1], bp[2][1]);
    const float s0 = c0 * shrink, s1 = c1 * shrink;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      acc[mb][0] *= s0, acc[mb][1] *= s1, acc[mb][2] *= s0, acc[mb][3] *= s1;
    }
    // tokens 2*t4, 2*t4 + 1, 2*t4 + 8, 2*t4 + 9 of the warp, word g8 >> 1 of
    // each 16-dim block (a uniform branch skips the blocks past D)
    const uint32_t* v0 = Vw + (warp * 16 + 2 * t4) * vp + (g8 >> 1);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      if (mb < nch) {
        const uint32_t* w = v0 + 4 * mb;
        uint32_t a[4];  // (d0, d1) x (two tokens), exact in fp16
        i8x4_to_h2x2(__byte_perm(w[0], w[vp], gather), a[0], a[1]);
        i8x4_to_h2x2(__byte_perm(w[8 * vp], w[9 * vp], gather), a[2], a[3]);
#pragma unroll
        for (int part = 2; part >= 0; --part) mma_f16(acc[mb], a, bp[part][0], bp[part][1]);
      }
    }
  }

  // the split's sums: exp-sums over lanes and warps, acc over warps
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* red = reinterpret_cast<float*>(smem);  // (WARPS, QR, D)
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    ls0 += __shfl_xor_sync(FULL_MASK, ls0, off);
    ls1 += __shfl_xor_sync(FULL_MASK, ls1, off);
  }
  if (g8 == 0) {
    red_l[warp * QR + 2 * t4] = ls0;
    red_l[warp * QR + 2 * t4 + 1] = ls1;
  }
  {
    const float unit = __uint_as_float((unsigned)(127 - kv) << 23);  // 2^-kv, exact
    float* rw = red + (warp * QR + 2 * t4) * D + 4 * (g8 >> 1) + dsel;  // row 2*t4, dim d0
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      if (mb < nch) {
        rw[16 * mb] = acc[mb][0] * unit;
        rw[16 * mb + 1] = acc[mb][2] * unit;
        rw[D + 16 * mb] = acc[mb][1] * unit;
        rw[D + 16 * mb + 1] = acc[mb][3] * unit;
      }
    }
  }
  __syncthreads();

  // this thread's entries i = tid + k*THREADS of the (G, D) output
  const int n = sh.n_splits;
  T* ob = out + ((long long)b * sh.H + (long long)kh * G) * D;
  float a[OUTS];
  int gk[OUTS], dk[OUTS];
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int i = tid + k * THREADS, ic = i < G * D ? i : 0;
    gk[k] = div_by(ic, sh.d_magic);
    dk[k] = ic - gk[k] * D;
    a[k] = 0.f;
  }
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
#pragma unroll
    for (int k = 0; k < OUTS; ++k) a[k] += red[(w * QR + gk[k]) * D + dk[k]];
  }
  if (n == 1) {
#pragma unroll
    for (int k = 0; k < OUTS; ++k) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) l += red_l[w * QR + gk[k]];
      const int i = tid + k * THREADS;
      if (i < G * D) ob[i] = from_f32<T>(a[k] / fmaxf(l, 1e-30f));
    }
    return;
  }
  // this split's partials: acc (G, D) in one array, m and l (2 x QR) in
  // another, both 16-byte aligned for the merge's copies
  const int per = G * D;
  float* acc_part = ws + ((long long)bk * n + split) * per;
  float* ml_part = ws + (long long)gridDim.z * KH * n * per + ((long long)bk * n + split) * 2 * QR;
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int i = tid + k * THREADS;
    if (i < per) acc_part[i] = a[k];
  }
  if (tid < QR) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += red_l[w * QR + tid];
    ml_part[QR + tid] = l;
  }
  if (warp == 0 && g8 == 0) {  // m of rows 2*t4, 2*t4 + 1, as every lane holds it
    ml_part[2 * t4] = m0;
    ml_part[2 * t4 + 1] = m1;
  }

  // the last split of this (b, kh) to finish merges them all: the barrier
  // puts the block's partials before thread 0's count, whose release makes
  // them visible and whose acquire makes the others' visible to the copies
  // after the next barrier
  __syncthreads();
  if (tid == 0) *last = atomic_add_acq_rel(counters + bk, 1) == n - 1;
  __syncthreads();
  if (!*last) return;
  // every split's m and l, and as many splits' acc as the free ring holds,
  // copied from L2 (cp.async.cg) at once: one round trip for the path's
  // 6 splits; M = max m_i, the weights e^(m_i - M), L = sum l_i e^(m_i - M)
  const float* acc_parts = ws + (long long)bk * n * per;
  const float* ml_parts = ws + (long long)gridDim.z * KH * n * per + (long long)bk * n * 2 * QR;
  float* Wm = reinterpret_cast<float*>(smem);  // (n, QR): m_i, then e^(m_i - M)
  float* Wl = Wm + MAX_SPLITS * QR;            // (n, QR): l_i
  float* Ac = Wl + MAX_SPLITS * QR;            // (chunk, G*D): acc_i
  const int chunk = sh.chunk;
  auto copy_acc = [&](int c0) {
    const int quads = min(chunk, n - c0) * per / 4;
    for (int u = tid; u < quads; u += THREADS) cp_async_16(Ac + 4 * u, acc_parts + c0 * per + 4 * u, true);
    cp_async_commit();
  };
  for (int u = tid; u < 4 * n; u += THREADS) {  // 64 bytes a split: m (QR), l (QR)
    const int sp = u >> 2, q4 = u & 3;
    cp_async_16((q4 < 2 ? Wm : Wl) + sp * QR + 4 * (q4 & 1), ml_parts + sp * 2 * QR + 4 * q4, true);
  }
  copy_acc(0);
  cp_async_wait<0>();
  __syncthreads();
  float mx[QR], ls[QR];
#pragma unroll
  for (int g = 0; g < QR; ++g) mx[g] = NEG, ls[g] = 0.f;
  for (int sp = tid; sp < n; sp += THREADS) {
#pragma unroll
    for (int g = 0; g < QR; ++g) mx[g] = fmaxf(mx[g], Wm[sp * QR + g]);
  }
#pragma unroll
  for (int g = 0; g < QR; ++g) {
    const float wm = warp_max(mx[g]);
    if (lane == 0) red_max[warp * QR + g] = wm;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < QR; ++g) {
    mx[g] = red_max[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx[g] = fmaxf(mx[g], red_max[w * QR + g]);
  }
  for (int sp = tid; sp < n; sp += THREADS) {
#pragma unroll
    for (int g = 0; g < QR; ++g) {
      const float w = g < G ? expf(Wm[sp * QR + g] - mx[g]) : 0.f;
      Wm[sp * QR + g] = w;
      ls[g] = fmaf(Wl[sp * QR + g], w, ls[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < QR; ++g) {
    const float t = warp_sum(ls[g]);
    if (lane == 0) red_l[warp * QR + g] = t;
  }
  __syncthreads();
  // out = sum acc_i e^(m_i - M) / max(L, 1e-30), the splits added in order
  float A[OUTS];
#pragma unroll
  for (int k = 0; k < OUTS; ++k) A[k] = 0.f;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    if (c0 > 0) {  // the next chunk, once every thread is done with this one
      __syncthreads();
      copy_acc(c0);
      cp_async_wait<0>();
      __syncthreads();
    }
    const int cnt = min(chunk, n - c0);
    for (int j = 0; j < cnt; ++j) {
#pragma unroll
      for (int k = 0; k < OUTS; ++k) {
        if (k * THREADS < per) {  // uniform: entries past G*D are skipped
          A[k] = fmaf(Ac[j * per + gk[k] * D + dk[k]], Wm[(c0 + j) * QR + gk[k]], A[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) L += red_l[w * QR + gk[k]];
    const int i = tid + k * THREADS;
    if (i < per) ob[i] = from_f32<T>(A[k] / fmaxf(L, 1e-30f));
  }
  if (tid == 0) counters[bk] = 0;  // zero again for the next call
}


// The accumulator's 16-dim blocks for head dim D (kernel template MB).
int mb_of(int D) { return D <= 64 ? 4 : D <= 128 ? 8 : D <= 160 ? 10 : 16; }

template <int MB, typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           void* out, void* ws, void* counters, int B, const Shapes& sh, cudaStream_t stream) {
  auto kernel = int8_kv_decode_kernel<MB, T>;
  const int smem = smem_bytes(q_parts<T>(), sh.D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)sh.n_splits, (unsigned)sh.KH, (unsigned)B);
  kernel<<<grid, THREADS, smem, stream>>>((const T*)q, (const int8_t*)kq, (const float*)ks,
                                          (const int8_t*)vq, (const float*)vs, (T*)out, (float*)ws,
                                          (int*)counters, sh);
  return (int)cudaGetLastError();
}

template <int MB, typename T>
int plan(int D, int* result) {
  auto kernel = int8_kv_decode_kernel<MB, T>;
  const int smem = smem_bytes(q_parts<T>(), D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  result[0] = blocks;
  result[1] = smem;
  result[2] = BS;
  result[3] = STAGES;
  result[4] = stage_bytes(D) - 8 * BS;  // K and V bytes of one tile
  return 0;
}

template <typename T>
int dispatch_d(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
               void* out, void* ws, void* counters, int B, const Shapes& sh, cudaStream_t stream) {
  switch (mb_of(sh.D)) {
    case 4: return launch<4, T>(q, kq, ks, vq, vs, out, ws, counters, B, sh, stream);
    case 8: return launch<8, T>(q, kq, ks, vq, vs, out, ws, counters, B, sh, stream);
    case 10: return launch<10, T>(q, kq, ks, vq, vs, out, ws, counters, B, sh, stream);
    default: return launch<16, T>(q, kq, ks, vq, vs, out, ws, counters, B, sh, stream);
  }
}

template <typename T>
int plan_d(int D, int* result) {
  switch (mb_of(D)) {
    case 4: return plan<4, T>(D, result);
    case 8: return plan<8, T>(D, result);
    case 10: return plan<10, T>(D, result);
    default: return plan<16, T>(D, result);
  }
}

}  // namespace

// The launch configuration for q's dtype (0 = float32, 1 = bfloat16) and
// head dim D: result[0] blocks a SM (the occupancy calculator's), [1] shared
// memory a block in bytes, [2] tokens a tile, [3] ring stages, [4] K and V
// bytes a tile.  Sets the kernel's shared-memory attribute on the current
// device.
extern "C" int int8_kv_decode_plan(int dtype, int D, int* result) {
  if (D <= 0 || D % 16 != 0 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return plan_d<float>(D, result);
  if (dtype == 1) return plan_d<__nv_bfloat16>(D, result);
  return (int)cudaErrorInvalidValue;
}

// q and out (B, H, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// k_q, v_q (B, S, KH, D) int8 contiguous, 16-byte aligned; k_s, v_s (B, S)
// float32 contiguous.  D a multiple of 16 up to 256, H = G*KH with G <= 8,
// B and KH at most 65535.  Split i covers tiles [i*tiles_per_split,
// (i+1)*tiles_per_split) of 64 tokens; n_splits is at most 256.  With
// n_splits > 1, ws holds B*KH*n_splits*(G*D + 16) float32 partials (acc,
// then m and l) and counters B*KH int32 zeros, which the kernel leaves zero; with one split
// neither is touched.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int int8_kv_decode_launch(const void* q, const void* kq, const void* ks,
                                     const void* vq, const void* vs, void* out, void* ws,
                                     void* counters, int dtype, int B, int H, int KH, int S, int D,
                                     int n_splits, int tiles_per_split, float scale, void* stream) {
  const int n_tiles = (S + BS - 1) / BS;
  if (B <= 0 || B > 65535 || KH <= 0 || KH > 65535 || S <= 0 || H % KH != 0 || H / KH > 8 ||
      D <= 0 || D % 16 != 0 || D > MAX_D || n_splits <= 0 || n_splits > MAX_SPLITS ||
      tiles_per_split <= 0 ||
      (long long)n_splits * tiles_per_split < n_tiles ||
      (long long)(n_splits - 1) * tiles_per_split >= n_tiles ||
      (n_splits > 1 && (ws == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int G = H / KH, ring = ring_bytes(D);
  const int chunk = min(n_splits, (ring / (int)sizeof(float) - 2 * MAX_SPLITS * QR) / (G * D));
  const Shapes sh{H, KH, S, D, G, n_splits, tiles_per_split, scale, ring, chunk, magic_of(D / 16),
                  magic_of(D)};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(q, kq, ks, vq, vs, out, ws, counters, B, sh, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(q, kq, ks, vq, vs, out, ws, counters, B, sh, s);
  return (int)cudaErrorInvalidValue;
}
