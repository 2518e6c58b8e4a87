// Multi-head encoder attention straight from [B, S, D] projections.
//
// Replaces the TPU kernel mcm_tpu/ops/attention.py::_bsd_attention_kernel
// (called through _pallas_bsd_attention): unmasked
// softmax(q·kᵀ·Dh^-½)·v per (image, head), where head h is the column slice
// [h·Dh, (h+1)·Dh) of the projections' natural [B, S, D] layout, so no
// [B, H, S, Dh] transpose is ever stored.  Numerics are the TPU kernel's:
//   * q is scaled in fp32, then rounded back to the input type;
//   * logits accumulate in fp32 from input-type products;
//   * max, exp and sum are fp32; the division is on the probabilities;
//   * p is rounded to the input type before PV;
//   * PV accumulates in fp32; the output is cast to the input type.
//
// Bound on an H100 at the main-path shape (B = 512, S = 197, D = 768,
// 12 heads, bf16): 61.0 GFLOP (62 µs at 989 TFLOP/s) against 620 MB of
// q/k/v/o traffic (185 µs at 3.35 TB/s), so the function is memory-bound,
// about 0.185 ms per launch.
//
// Design (simple and right first; wgmma and TMA are later work):
//   * one block per (image, head, tile of QTILE query rows), flattened into
//     gridDim.x so that the tiles of one head run next to each other and
//     share its K/V through L2 (and no grid dimension is capped at 65535);
//   * the head's whole K and V are staged in dynamic shared memory (65.8 KB
//     at S = 257, Dh = 64 in bf16), K rows padded by one 8-byte vector so
//     that 32 lanes reading 32 different keys hit different banks;
//   * one warp per query row: q lives in registers, each lane computes the
//     logits of keys lane, lane+32, ... into a per-warp shared row, then
//     warp shuffles reduce the max and the sum;
//   * in PV each lane owns Dh/32 output columns (or one, for Dh < 32) and
//     walks all S keys;
//   * ragged tail rows (S = 197 and 257 are not multiples of 32 or of the
//     tile) are skipped per warp; only the staging needs __syncthreads.
// Built without --use_fast_math: expf and the division are IEEE.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bsd_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int S, int heads, int n_tiles, long long in_stride,
                     long long out_stride, float scale) {
  using Sh = Shape<T, DH>;
  using Vec = typename RawVec<Sh::kVecBytes>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)S * Sh::kKStride;
  // fp32 rows start on a 16-byte boundary
  size_t kv_bytes = ((size_t)S * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
  float* rows = reinterpret_cast<float*>(smem + kv_bytes);

  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int h = bh % heads;
  const long long b = bh / heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const long long head_off = b * S * in_stride + (long long)h * DH;

  // -- stage this head's K and V -------------------------------------------
  constexpr int kVecPerRow = DH / Sh::kVec;
  for (int i = threadIdx.x; i < S * kVecPerRow; i += kThreads) {
    const int j = i / kVecPerRow;
    const int c = (i % kVecPerRow) * Sh::kVec;
    const long long g = head_off + j * in_stride + c;
    *reinterpret_cast<Vec*>(ks + (size_t)j * Sh::kKStride + c) =
        *reinterpret_cast<const Vec*>(k + g);
    *reinterpret_cast<Vec*>(vs + (size_t)j * Sh::kVStride + c) =
        *reinterpret_cast<const Vec*>(v + g);
  }
  __syncthreads();

  float* row = rows + (size_t)warp * S;
  const int r_end = min(S, (tile + 1) * kQTile);
  for (int r = tile * kQTile + warp; r < r_end; r += kWarps) {
    // q row in registers: scaled in fp32, rounded to T like the TPU kernel
    float qr[DH];
    const T* qrow = q + head_off + (long long)r * in_stride;
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = to_f32(from_f32<T>(to_f32(qrow[d]) * scale));

    // logits of keys lane, lane + 32, ...
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const T* krow = ks + (size_t)j * Sh::kKStride;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += Sh::kVec) {
        float kv[Sh::kVec];
        load_f32<T, Sh::kVec>(krow + c, kv);
#pragma unroll
        for (int e = 0; e < Sh::kVec; ++e) acc = fmaf(qr[c + e], kv[e], acc);
      }
      row[j] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);

    float z = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      z += e;
    }
    z = warp_sum(z);
    for (int j = lane; j < S; j += 32) row[j] = to_f32(from_f32<T>(row[j] / z));
    __syncwarp();

    // PV: lane owns columns [lane * kCols, lane * kCols + kCols)
    const int c0 = lane * Sh::kCols;
    if (c0 < DH) {
      float acc[Sh::kCols];
#pragma unroll
      for (int e = 0; e < Sh::kCols; ++e) acc[e] = 0.f;
      for (int j = 0; j < S; ++j) {
        const float p = row[j];
        const T* vrow = vs + (size_t)j * Sh::kVStride + c0;
#pragma unroll
        for (int e = 0; e < Sh::kCols; ++e) acc[e] = fmaf(p, to_f32(vrow[e]), acc[e]);
      }
      T* orow = o + b * S * out_stride + (long long)r * out_stride + (long long)h * DH + c0;
#pragma unroll
      for (int e = 0; e < Sh::kCols; ++e) orow[e] = from_f32<T>(acc[e]);
    }
    __syncwarp();  // the next row reuses this warp's logits row
  }
}

template <typename T, int DH>
size_t smem_bytes(int S) {
  using Sh = Shape<T, DH>;
  size_t kv = ((size_t)S * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
  return kv + (size_t)kWarps * S * sizeof(float);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int heads, long long in_stride, long long out_stride,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>(S);
  cudaError_t err = cudaFuncSetAttribute(bsd_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + kQTile - 1) / kQTile;
  const long long blocks = (long long)B * heads * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh^-½ rounded once
  bsd_attention_kernel<T, DH><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, heads, n_tiles, in_stride, out_stride, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int S,
             int heads, int head_dim, long long in_stride, long long out_stride,
             cudaStream_t stream) {
  switch (head_dim) {
    case 1: return launch<T, 1>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
    case 2: return launch<T, 2>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
    case 4: return launch<T, 4>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
    case 8: return launch<T, 8>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
    case 16: return launch<T, 16>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (0 for an unsupported
// head_dim or dtype).  dtype: 0 = float32, 1 = bfloat16.
size_t mcm_bsd_attention_smem_bytes(int S, int head_dim, int dtype) {
  if (dtype == 0) {
    switch (head_dim) {
      case 1: return smem_bytes<float, 1>(S);
      case 2: return smem_bytes<float, 2>(S);
      case 4: return smem_bytes<float, 4>(S);
      case 8: return smem_bytes<float, 8>(S);
      case 16: return smem_bytes<float, 16>(S);
      case 32: return smem_bytes<float, 32>(S);
      case 64: return smem_bytes<float, 64>(S);
      case 128: return smem_bytes<float, 128>(S);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 1: return smem_bytes<__nv_bfloat16, 1>(S);
      case 2: return smem_bytes<__nv_bfloat16, 2>(S);
      case 4: return smem_bytes<__nv_bfloat16, 4>(S);
      case 8: return smem_bytes<__nv_bfloat16, 8>(S);
      case 16: return smem_bytes<__nv_bfloat16, 16>(S);
      case 32: return smem_bytes<__nv_bfloat16, 32>(S);
      case 64: return smem_bytes<__nv_bfloat16, 64>(S);
      case 128: return smem_bytes<__nv_bfloat16, 128>(S);
    }
  }
  return 0;
}

// q, k, v: head h of token (b, s) at element b·S·in_stride + s·in_stride +
// h·head_dim; o likewise with out_stride.  A packed [B, S, 3D] projection
// is served by passing q, q + D, q + 2D with in_stride = 3D.  Returns the
// cudaError_t of the launch (0 = success).
int mcm_bsd_attention(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int heads, int head_dim,
                      long long in_stride, long long out_stride, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return 0;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, heads, head_dim, in_stride, out_stride, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, heads, head_dim, in_stride, out_stride, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcm_bsd_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
