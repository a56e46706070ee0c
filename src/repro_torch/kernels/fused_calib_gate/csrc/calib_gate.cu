// Fused max-softmax -> Platt -> threshold gate, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_calib_gate/kernel.py
// (calib_gate -> pallas_call).  For each row of (B, V) f32 logits:
//   conf  = 1 / sum_j exp(x_j - max_j x_j)      (the max softmax)
//   calib = sigmoid(-(a * conf + b))
//   gate  = calib < theta
// The softmax vector is never stored.
//
// Bound: memory.  The kernel reads B*V*4 bytes once and writes B*5; its
// arithmetic (one exp per element) is far below the card's rate, so the
// least time is B*V*4 / 3.35 TB/s.  At the serving shape (B=16, V=1000)
// that is 19 ns, well under one launch, so there it is launch-bound.
//
// Design: one block per row (the TPU kernel's sequential vocab grid
// becomes a loop inside the block).  Each thread walks a strided slice of
// the row, neighbouring threads on neighbouring addresses, and keeps its
// own running (max, exp-sum) with the rescale of the TPU kernel
// (s <- s * exp(m_old - m_new) + ...).  The partials merge by warp
// shuffles, then across warps through shared memory; the first thread
// applies the Platt/gate epilogue.  Any B and V are accepted: the strided
// loop masks the ragged edge.  Numerics follow the reference: the max
// starts at NEG = -1e30 and the sum is floored at 1e-30, so a row of -inf
// gives conf = 1e30 and a finite calib, not NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_WARPS = 32;

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
}

__global__ void calib_gate_kernel(const float* __restrict__ logits,
                                  float* __restrict__ calib,
                                  uint8_t* __restrict__ gate,
                                  int64_t V, float a, float b, float theta) {
  const int64_t row = blockIdx.x;
  const float* x = logits + row * V;

  float m = NEG, s = 0.f;
  for (int64_t j = threadIdx.x; j < V; j += blockDim.x) {
    const float v = x[j];
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
  warp_merge(m, s);

  __shared__ float sm[MAX_WARPS];
  __shared__ float ss[MAX_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (warp != 0) return;
  m = lane < n_warps ? sm[lane] : NEG;
  s = lane < n_warps ? ss[lane] : 0.f;
  warp_merge(m, s);
  if (lane == 0) {
    const float conf = 1.f / fmaxf(s, 1e-30f);
    const float c = 1.f / (1.f + expf(a * conf + b));  // sigmoid(-(a*conf + b))
    calib[row] = c;
    gate[row] = c < theta ? 1 : 0;
  }
}

}  // namespace

// threads: a multiple of 32 in [32, 1024].  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int calib_gate_launch(const void* logits, void* calib, void* gate,
                                 long long B, long long V, float a, float b,
                                 float theta, int threads, void* stream) {
  if (B <= 0 || V <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  calib_gate_kernel<<<(unsigned int)B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (float*)calib, (uint8_t*)gate, (int64_t)V, a, b, theta);
  return (int)cudaGetLastError();
}
