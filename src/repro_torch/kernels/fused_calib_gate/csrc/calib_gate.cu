// Fused max-softmax -> Platt -> threshold gate, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_calib_gate/kernel.py
// (calib_gate -> pallas_call).  For each row of (B, V) logits, f32, bf16 or
// f16 (widened to f32 in registers, which is exact):
//   conf  = 1 / sum_j exp(x_j - max_j x_j)      (the max softmax)
//   calib = sigmoid(-(a * conf + b))
//   gate  = calib < theta
// The softmax vector is never stored.
//
// Bound: memory.  The kernel reads B*V*elem bytes once and writes B*5; its
// arithmetic (one exp per element) is far below the card's rate, so the
// least time is B*V*elem / 3.35 TB/s.  At the serving shape (16, 1000) f32
// that is 19 ns, under one launch: there it is bound by the launch and one
// memory round trip, so everything a row needs is requested at once.
//
// Design:
// - Loads.  A row is a scalar head up to its first 16-byte boundary, a body
//   of 16-byte vectors and a scalar tail (any base address, any V).  Each
//   thread issues VPT vector loads (ld.global.nc.L1::no_allocate: every
//   logit is read once) before it uses any of them, neighbouring threads on
//   neighbouring vectors; past the end a load is clamped to the last vector
//   and its value masked to -inf, so no load waits under a branch.  The
//   head and tail (at most 2 * (16 / elem - 1) elements) are one clamped,
//   masked scalar load for each of rank 0's first threads, issued with the
//   first vectors.
// - Exponentials.  For each chunk in registers: the chunk's max first (no
//   exp), the running sum rescaled once, then one exp2 per element.  Across
//   lanes, warps and blocks the max is reduced first (one redux.sync a
//   warp), each partial sum is rescaled once, and the sums reduce by plain
//   adds.
// - Splits.  The body of a row is cut into `splits` contiguous ranges, one
//   block each (split_plan in kernel.py picks splits, threads and VPT so
//   that B * splits fills about one wave while each block reads a few KB).
//   The blocks of a row form one thread-block cluster: each reduces its
//   range to (m, s) in its own shared memory, its other warps leave, and
//   warp 0 of each block meets the others at a cluster barrier (release /
//   acquire); rank 0 reads the others' pairs through distributed shared
//   memory, merges them and writes calib and gate, and a second, relaxed
//   cluster barrier keeps every block resident until rank 0 has read it.
//   No workspace, no counter, one
//   launch: two calls may run at once on two streams, and a call can be
//   captured in a CUDA graph.
// Numerics follow the plain version: the max starts at NEG = -1e30 and the
// sum is floored at 1e-30, so a row of -inf gives conf = 1e30 and a finite
// calib, not NaN.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int VEC_BYTES = 16;  // one vector load
constexpr int MAX_SPLITS = 16;  // blocks a row: one cluster, at most 16 (non-portable above 8)
constexpr int MAX_THREADS = 512;  // a block
constexpr unsigned FULL = 0xffffffffu;

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

__host__ __device__ constexpr int elem_bytes(int dt) { return dt == F32 ? 4 : 2; }

// -inf in every element of a 32-bit word
template <int DT>
__host__ __device__ constexpr uint32_t neg_inf_word() {
  return DT == F32 ? 0xff800000u : DT == BF16 ? 0xff80ff80u : 0xfc00fc00u;
}

// Element `half` (0 low, 1 high) of a 32-bit word, widened to f32; an f32
// word holds one element.
template <int DT>
__device__ __forceinline__ float widen(uint32_t w, int half) {
  if constexpr (DT == F32) {
    return __uint_as_float(w);
  } else if constexpr (DT == BF16) {
    return __uint_as_float(half ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __half2float(__ushort_as_half((unsigned short)(half ? w >> 16 : w & 0xffffu)));
  }
}

// Element i of a 16-byte vector (16 / elem_bytes elements), widened to f32.
template <int DT>
__device__ __forceinline__ float vec_elem(const uint4& v, int i) {
  constexpr int PER_WORD = 4 / elem_bytes(DT);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return widen<DT>(w[i / PER_WORD], i % PER_WORD);
}

__device__ __forceinline__ uint4 load_vec(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

template <int DT>
__device__ __forceinline__ float load_elem(const char* row, int64_t j) {
  if constexpr (DT == F32) {
    return __ldg(reinterpret_cast<const float*>(row) + j);
  } else {
    return widen<DT>(__ldg(reinterpret_cast<const unsigned short*>(row) + j), 0);
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// exp(x - m) as 2^((x - m) log2 e) on the SFU; a result below 2^-126 is
// flushed to 0 (a term that small cannot move a sum that holds 1)
__device__ __forceinline__ float exp_diff(float x, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((x - m) * LOG2E));
  return y;
}

// A float's bits as an int whose order is the floats' (negatives' magnitude
// bits flipped), and back: the warp max is one integer redux.sync.
__device__ __forceinline__ int ordered(int k) { return k >= 0 ? k : k ^ 0x7fffffff; }

// (m, s) of the warp in every lane: the max first, then each lane's sum
// rescaled once to it and the sums added by shuffles.
__device__ __forceinline__ void warp_merge(float& m, float& s) {
  const float wm = __int_as_float(ordered(__reduce_max_sync(FULL, ordered(__float_as_int(m)))));
  s *= exp_diff(m, wm);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  m = wm;
}

__device__ __forceinline__ void finish(float s, int64_t row, float* calib, uint8_t* gate,
                                       float a, float b, float theta) {
  const float conf = 1.f / fmaxf(s, 1e-30f);
  const float c = 1.f / (1.f + expf(a * conf + b));  // sigmoid(-(a*conf + b))
  calib[row] = c;
  gate[row] = c < theta ? 1 : 0;
}

// grid: B * splits blocks, clusters of `splits` along x; block
// (row * splits + rank) reduces range `rank` of row `row`.
template <int DT, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
    calib_gate_kernel(const void* __restrict__ logits, float* __restrict__ calib,
                      uint8_t* __restrict__ gate, int64_t V, int splits, float a, float b,
                      float theta) {
  constexpr int EB = elem_bytes(DT);
  constexpr int VE = VEC_BYTES / EB;  // elements a vector
  constexpr int N = VPT * VE;  // elements a chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int log_splits = __ffs(splits) - 1;  // splits is a power of two
  const int rank = blockIdx.x & (splits - 1);
  const int64_t row = blockIdx.x >> log_splits;
  const char* x = static_cast<const char*>(logits) + row * V * EB;

  // head | body of n_vec vectors | tail; the body cut into `splits` ranges
  const int64_t head = min64((int64_t)((-(uintptr_t)x & (VEC_BYTES - 1)) / EB), V);
  const int64_t n_vec = (V - head) / VE;
  const int64_t tail = head + n_vec * VE;  // the tail's first element
  const uint4* body = reinterpret_cast<const uint4*>(x + head * EB);
  const int64_t per = (n_vec + splits - 1) >> log_splits;
  const int64_t lo = min64(rank * per, n_vec), hi = min64(lo + per, n_vec);

  // head and tail: element e for rank 0's thread e < head + (V - tail)
  const int64_t e = tid < head ? tid : tail + (tid - head);
  const float edge = load_elem<DT>(x, min64(e, V - 1));
  const bool edge_ok = rank == 0 && e < V;

  float m = NEG, s = 0.f;
  const int64_t step = (int64_t)VPT * blockDim.x;
  for (int64_t t0 = lo; t0 < hi; t0 += step) {
    uint4 v[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) v[k] = load_vec(body + min64(t0 + k * blockDim.x + tid, hi - 1));
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (t0 + k * blockDim.x + tid >= hi) {
        constexpr uint32_t NI = neg_inf_word<DT>();
        v[k] = make_uint4(NI, NI, NI, NI);
      }
    }
    // the chunk's max and exp-sum, each in 4 independent chains
    float xs[N], cm[4] = {NEG, NEG, NEG, NEG}, cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xs[i] = vec_elem<DT>(v[i / VE], i % VE);
      cm[i % 4] = fmaxf(cm[i % 4], xs[i]);
    }
    const float mn = fmaxf(m, fmaxf(fmaxf(cm[0], cm[1]), fmaxf(cm[2], cm[3])));
#pragma unroll
    for (int i = 0; i < N; ++i) cs[i % 4] += exp_diff(xs[i], mn);
    s = s * exp_diff(m, mn) + ((cs[0] + cs[1]) + (cs[2] + cs[3]));
    m = mn;
  }
  {
    const float xe = edge_ok ? edge : -INFINITY;
    const float mn = fmaxf(m, xe);
    s = s * exp_diff(m, mn) + exp_diff(xe, mn);
    m = mn;
  }

  warp_merge(m, s);
  __shared__ float warp_m[32], warp_s[32];
  __shared__ float2 part;
  if (n_warps > 1) {
    if (lane == 0) {
      warp_m[warp] = m;
      warp_s[warp] = s;
    }
    __syncthreads();
    m = lane < n_warps ? warp_m[lane] : NEG;
    s = lane < n_warps ? warp_s[lane] : 0.f;
    warp_merge(m, s);
  }
  if (warp != 0) return;  // warp 0 holds the block's (m, s) in every lane
  if (splits == 1) {
    if (lane == 0) finish(s, row, calib, gate, a, b, theta);
    return;
  }
  // The row's blocks merge in rank 0 through distributed shared memory.
  // Only warp 0 of each block is left to take part in the cluster barriers
  // (they wait for the cluster's threads that have not exited).
  if (lane == 0) part = make_float2(m, s);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // releases each block's part to rank 0
  if (rank == 0) {
    const float2 p = lane < splits ? *cluster.map_shared_rank(&part, lane) : make_float2(NEG, 0.f);
    m = p.x;
    s = p.y;
    warp_merge(m, s);
    if (lane == 0) finish(s, row, calib, gate, a, b, theta);
  }
  // No block leaves while rank 0 may still read it.  Rank 0 has used what
  // it read before it arrives, so this barrier orders no memory.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

using Kernel = void (*)(const void*, float*, uint8_t*, int64_t, int, float, float, float);

template <int DT>
Kernel by_vpt(int v) {
  switch (v) {
    case 0: return calib_gate_kernel<DT, 1>;
    case 1: return calib_gate_kernel<DT, 2>;
    case 2: return calib_gate_kernel<DT, 4>;
    default: return calib_gate_kernel<DT, 8>;
  }
}
constexpr int MAX_DEVICES = 64;

// The kernel for (dtype, vpt), allowed clusters of 16 on the current
// device (once a device); nullptr for a dtype or vpt it does not take.
Kernel kernel_for(int dtype, int vpt, cudaError_t* err) {
  *err = cudaSuccess;
  const int v = vpt == 1 ? 0 : vpt == 2 ? 1 : vpt == 4 ? 2 : vpt == 8 ? 3 : -1;
  if (dtype < 0 || dtype > 2 || v < 0) return nullptr;
  const Kernel k = dtype == F32 ? by_vpt<F32>(v) : dtype == BF16 ? by_vpt<BF16>(v) : by_vpt<F16>(v);
  static bool allowed[3][4][MAX_DEVICES] = {};
  int dev = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return nullptr;
  if (dev < MAX_DEVICES && !allowed[dtype][v][dev]) {
    *err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (*err != cudaSuccess) return nullptr;
    allowed[dtype][v][dev] = true;
  }
  return k;
}

cudaLaunchConfig_t config(long long blocks, int splits, int threads, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid(int splits, int threads) {
  return splits >= 1 && splits <= MAX_SPLITS && (splits & (splits - 1)) == 0 && threads >= 32 &&
         threads <= MAX_THREADS && threads % 32 == 0;
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16; splits a power of two <= 16 (blocks a row,
// one cluster); threads a multiple of 32 up to 512;
// vpt 1, 2, 4 or 8 vectors a thread a chunk.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int calib_gate_launch(const void* logits, void* calib, void* gate, long long B,
                                 long long V, int dtype, int splits, int threads, int vpt,
                                 float a, float b, float theta, void* stream) {
  if (B <= 0 || V <= 0 || !valid(splits, threads) || B * splits > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  const Kernel k = kernel_for(dtype, vpt, &err);
  if (k == nullptr) return (int)(err == cudaSuccess ? cudaErrorInvalidValue : err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(B * splits, splits, threads, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, k, logits, (float*)calib, (uint8_t*)gate, (int64_t)V, splits,
                           a, b, theta);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of `splits` blocks of `threads` threads can be resident
// at once on the current device (cudaOccupancyMaxActiveClusters), in *out.
extern "C" int calib_gate_max_clusters(int dtype, int vpt, int splits, int threads, int* out) {
  if (!valid(splits, threads)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const Kernel k = kernel_for(dtype, vpt, &err);
  if (k == nullptr) return (int)(err == cudaSuccess ? cudaErrorInvalidValue : err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(splits, splits, threads, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, k, &cfg);
}
