// Helpers shared by the attention kernels (bsd_attention.cuh,
// split_attention.cu, flash_attention.cu): element conversions, raw vector
// loads for staging K/V in shared memory, the padded K-row layout of the
// CUDA-core bodies (fp32, and bf16 below a head dim of 16), warp reductions,
// the card's shared-memory limits and the head-dim dispatch.  The tensor-core bodies of bsd and split-heads
// attention in bf16 (mma.sync over cp.async-staged, swizzled K/V tiles) are
// in attention_mma.cuh, which builds on this header.  Each .cu file that
// includes it is its own shared library, so the anonymous namespace gives
// every library its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back to fp32 (what .astype(T) does to an fp32 value)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Raw vector of N bytes, for 8/4/2-byte staging and shared-memory loads.
template <int N> struct RawVec;
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<4> { using type = uint32_t; };
template <> struct RawVec<2> { using type = uint16_t; };

// N consecutive elements at p (aligned to N elements) as fp32.  bf16 is the
// high half of an fp32, so the conversion is a shift of the raw bits.
template <typename T, int N> __device__ __forceinline__ void load_f32(const T* p, float* out);
template <> __device__ __forceinline__ void load_f32<float, 2>(const float* p, float* out) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
}
template <> __device__ __forceinline__ void load_f32<float, 1>(const float* p, float* out) {
  out[0] = *p;
}
template <> __device__ __forceinline__ void load_f32<__nv_bfloat16, 4>(const __nv_bfloat16* p,
                                                                       float* out) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(r.x << 16);
  out[1] = __uint_as_float(r.x & 0xffff0000u);
  out[2] = __uint_as_float(r.y << 16);
  out[3] = __uint_as_float(r.y & 0xffff0000u);
}
template <> __device__ __forceinline__ void load_f32<__nv_bfloat16, 2>(const __nv_bfloat16* p,
                                                                       float* out) {
  const uint32_t r = *reinterpret_cast<const uint32_t*>(p);
  out[0] = __uint_as_float(r << 16);
  out[1] = __uint_as_float(r & 0xffff0000u);
}
template <> __device__ __forceinline__ void load_f32<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                                       float* out) {
  out[0] = __bfloat162float(*p);
}

template <typename T, int DH>
struct Shape {
  // elements per 8-byte vector, but never more than a head row
  static constexpr int kVec = (8 / (int)sizeof(T)) < DH ? (8 / (int)sizeof(T)) : DH;
  static constexpr int kVecBytes = kVec * (int)sizeof(T);
  static constexpr int kKStride = DH + kVec;  // padded K row (elements)
  static constexpr int kVStride = DH;
  // output columns per lane in PV
  static constexpr int kCols = DH >= 32 ? DH / 32 : 1;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The card's shared memory: what a block may have, what an SM has, and
// what the runtime reserves for each block (all 0 if they cannot be read).
struct SmemLimits {
  int block = 0, sm = 0, reserved = 0;
};

inline SmemLimits smem_limits() {
  SmemLimits m;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&m.block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) ||
      cudaDeviceGetAttribute(&m.sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) ||
      cudaDeviceGetAttribute(&m.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev))
    return SmemLimits{};
  return m;
}

// f(std::integral_constant<int, DH>{}) for a head dim that is a power of two
// up to 128; `otherwise` for any other.
template <typename R, typename F>
R with_head_dim(int head_dim, R otherwise, F&& f) {
  switch (head_dim) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return otherwise;
  }
}

}  // namespace
