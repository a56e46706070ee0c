// What runs between one ResNet convolution and the next conv or pool, in one
// pass, for Hopper (sm_90a): the frozen-BN affine, an optional residual add,
// the ReLU and the SAME pad the consumer needs.
//
// A port-only kernel (the TPU's XLA fuses this epilogue into the conv; there
// is no Pallas counterpart).  For the conv output acc (N, C, H, W), f32, bf16
// or f16, per-channel f32 scale and bias, an optional residual idn of acc's
// shape and dtype, it writes one contiguous (N, C, H+top+bottom, W+left+right)
// tensor, border and interior.  The interior is the eager sequence bit for bit
// (ref.py; models/resnet.py before the kernel):
//   t = fadd_rn(fmul_rn(acc, s), b)                 two roundings, no FMA
//   no residual:   y = cast(act ? relu(t) : t)
//   with residual: y = cast(cast(t) + idn); y = act ? relu(y) : y
// where relu(x) = isnan(x) ? x : max(x, 0), torch's clamp_min on the card,
// and cast rounds to nearest even (cvt.rn, as torch's Half and BFloat16 do on
// the card).  The border holds `fill` in the dtype (0, or -inf before a pool).
//
// Bound: memory.  It reads acc (and idn) once and writes the output once, with
// 2-4 operations an element, so the least time is those bytes / 3.35 TB/s.
//
// Design: a flat map over the output's elements, EPT a thread strided by
// the block, so a warp reads and writes consecutive elements (128 bytes an
// instruction in float32).  An element's plane, row and column come from
// three multiply-high divisions; interior elements load (predicated, all EPT
// issued before any is used) and border elements store fill; scale and bias
// are read from L1.  On an H100 80GB HBM3 (700 W), in float32, this map
// took 3.82 ms over a ResNet-50 forward's unpadded calls at 128 frames
// against 3.93 ms for 16-byte vector loads and stores, so it is the only
// path; bfloat16 and float16 move 2 bytes an access and reach about half
// the bytes bound.
// One launch, no workspace, no state: calls may run on two streams at once
// and a call can be captured in a CUDA graph.  Indices are 32-bit: the
// wrapper refuses an output of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // a block
constexpr int EPT = 8;  // elements a thread

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

template <int DT>
using Raw = typename std::conditional<DT == F32, uint32_t, uint16_t>::type;

// n / d for n < 2^31 as (umulhi(n, m) + n) >> s (Granlund and Montgomery;
// torch's IntDivider): d >= 1, s = ceil(log2 d), m = 2^32 (2^s - d) / d + 1.
struct Div {
  uint32_t d, m, s;
};

Div make_div(uint32_t d) {
  uint32_t s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return Div{d, (uint32_t)m, s};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, const Div& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

template <int DT>
__device__ __forceinline__ float widen(Raw<DT> r) {
  if constexpr (DT == F32) {
    return __uint_as_float(r);
  } else if constexpr (DT == BF16) {
    return __uint_as_float((uint32_t)r << 16);
  } else {
    return __half2float(__ushort_as_half(r));
  }
}

template <int DT>
__device__ __forceinline__ Raw<DT> narrow(float x) {
  if constexpr (DT == F32) {
    return __float_as_uint(x);
  } else if constexpr (DT == BF16) {
    return __bfloat16_as_ushort(__float2bfloat16(x));
  } else {
    return __half_as_ushort(__float2half(x));
  }
}

// torch's relu on the card: clamp_min(x, 0) = isnan(x) ? x : ::max(x, 0)
__device__ __forceinline__ float relu(float x) { return isnan(x) ? x : fmaxf(x, 0.f); }

// One output element from acc's, its channel's scale and bias, and idn's.
template <int DT, bool RES>
__device__ __forceinline__ Raw<DT> epilogue(Raw<DT> a, float s, float b, Raw<DT> r, bool act) {
  const float t = __fadd_rn(__fmul_rn(widen<DT>(a), s), b);
  if constexpr (RES) {
    const Raw<DT> y = narrow<DT>(__fadd_rn(widen<DT>(narrow<DT>(t)), widen<DT>(r)));
    return act ? narrow<DT>(relu(widen<DT>(y))) : y;
  } else {
    return narrow<DT>(act ? relu(t) : t);
  }
}

struct PadGeom {
  Div plane;  // Ho * Wo
  Div row;  // Wo
  Div ch;  // C
  uint32_t H, W, top, left;
};

// n_out output elements, EPT a thread strided by the block.
template <int DT, bool RES>
__global__ void __launch_bounds__(THREADS)
    conv_epilogue_kernel(const Raw<DT>* __restrict__ acc, const Raw<DT>* __restrict__ idn,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         Raw<DT>* __restrict__ out, uint32_t n_out, PadGeom g, float fill, int act) {
  const uint32_t base = blockIdx.x * (THREADS * EPT) + threadIdx.x;
  Raw<DT> a[EPT], r[EPT];
  uint32_t plane[EPT];
  bool inside[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) {  // every load in flight before any is used
    const uint32_t o = base + j * THREADS;
    const uint32_t p = divide(o, g.plane);
    const uint32_t rem = o - p * g.plane.d;
    const uint32_t ho = divide(rem, g.row);
    const uint32_t hi = ho - g.top, wi = rem - ho * g.row.d - g.left;  // wrap below 0
    inside[j] = o < n_out && hi < g.H && wi < g.W;
    plane[j] = p;
    a[j] = 0;
    r[j] = 0;
    if (inside[j]) {
      const uint32_t i = (p * g.H + hi) * g.W + wi;
      a[j] = __ldg(acc + i);
      if constexpr (RES) r[j] = __ldg(idn + i);
    }
  }
  const Raw<DT> border = narrow<DT>(fill);
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const uint32_t o = base + j * THREADS;
    if (o >= n_out) break;
    Raw<DT> y = border;
    if (inside[j]) {
      const uint32_t c = plane[j] - divide(plane[j], g.ch) * g.ch.d;
      y = epilogue<DT, RES>(a[j], __ldg(scale + c), __ldg(bias + c), r[j], act);
    }
    out[o] = y;
  }
}

template <int DT>
cudaError_t launch(const void* acc, const void* idn, const float* scale, const float* bias,
                   void* out, uint32_t planes, uint32_t C, uint32_t H, uint32_t W, uint32_t top,
                   uint32_t bottom, uint32_t left, uint32_t right, bool act, float fill,
                   cudaStream_t stream) {
  const uint32_t Ho = H + top + bottom, Wo = W + left + right;
  const uint32_t n_out = planes * Ho * Wo;
  const PadGeom g{make_div(Ho * Wo), make_div(Wo), make_div(C), H, W, top, left};
  const dim3 grid((n_out + THREADS * EPT - 1) / (THREADS * EPT));
  if (idn != nullptr) {
    conv_epilogue_kernel<DT, true><<<grid, THREADS, 0, stream>>>(
        (const Raw<DT>*)acc, (const Raw<DT>*)idn, scale, bias, (Raw<DT>*)out, n_out, g, fill, act);
  } else {
    conv_epilogue_kernel<DT, false><<<grid, THREADS, 0, stream>>>(
        (const Raw<DT>*)acc, nullptr, scale, bias, (Raw<DT>*)out, n_out, g, fill, act);
  }
  return cudaGetLastError();
}

}  // namespace

// acc (N, C, H, W) and idn (the same, or null) in `dtype` (0 f32, 1 bf16,
// 2 f16), contiguous; scale and bias f32 (C,); out (N, C, H + top + bottom,
// W + left + right), contiguous, of fewer than 2^31 elements.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int conv_epilogue_launch(const void* acc, const void* idn, const void* scale,
                                    const void* bias, void* out, long long N, long long C,
                                    long long H, long long W, int top, int bottom, int left,
                                    int right, int dtype, int act, float fill, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || top < 0 || bottom < 0 || left < 0 || right < 0 ||
      dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_out = N * C * (H + top + bottom) * (W + left + right);
  if (n_out >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const float* s = (const float*)scale;
  const float* b = (const float*)bias;
  const uint32_t planes = (uint32_t)(N * C);
  cudaError_t err;
  switch (dtype) {
    case F32:
      err = launch<F32>(acc, idn, s, b, out, planes, C, H, W, top, bottom, left, right, act, fill,
                        (cudaStream_t)stream);
      break;
    case BF16:
      err = launch<BF16>(acc, idn, s, b, out, planes, C, H, W, top, bottom, left, right, act, fill,
                         (cudaStream_t)stream);
      break;
    default:
      err = launch<F16>(acc, idn, s, b, out, planes, C, H, W, top, bottom, left, right, act, fill,
                        (cudaStream_t)stream);
  }
  return (int)err;
}
