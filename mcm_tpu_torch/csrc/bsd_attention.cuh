// Multi-head encoder attention straight from [B, S, D] projections: the
// kernel body of bsd_attention.cu (mode kFull) and of the timing probes in
// bsd_probe.cu (the other modes).
//
// Replaces the TPU kernel mcm_tpu/ops/attention.py::_bsd_attention_kernel
// (called through _pallas_bsd_attention): unmasked
// softmax(q·kᵀ·Dh^-½)·v per (image, head), where head h is the column slice
// [h·Dh, (h+1)·Dh) of the projections' natural [B, S, D] layout, so no
// [B, H, S, Dh] transpose is ever stored.  Numerics of kFull are the TPU
// kernel's:
//   * q is scaled in fp32, then rounded back to the input type;
//   * logits accumulate in fp32 from input-type products;
//   * max, exp and sum are fp32; the division is on the probabilities;
//   * p is rounded to the input type before PV;
//   * PV accumulates in fp32; the output is cast to the input type.
// The other modes change only the softmax between the two products, each as
// tools/bsd_probe.py::_kernel does in that mode:
//   kNoSoftmax  p = logits (no max, exp, sum or division);
//   kNoExp      p = (logits − m) / Σ(logits − m) (exp taken out);
//   kBf16Sm     logits, m, logits − m, e and p rounded to bf16 after each op,
//               the sum in fp32 and its divisor rounded to bf16;
//   kDeferDiv   e = exp(logits − m) rounded to the input type into PV, the
//               fp32 output divided by the fp32 row sum.
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

#pragma once

#include "attention_common.cuh"

namespace {

constexpr int kQTile = 64;

enum BsdMode : int { kFull = 0, kNoSoftmax = 1, kNoExp = 2, kBf16Sm = 3, kDeferDiv = 4 };

__device__ __forceinline__ float round_bf16(float x) { return round_to<__nv_bfloat16>(x); }

template <typename T, int DH, int MODE>
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
    for (int d = 0; d < DH; ++d) qr[d] = round_to<T>(to_f32(qrow[d]) * scale);

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
      if constexpr (MODE == kBf16Sm) acc = round_bf16(acc);
      row[j] = acc;
      m = fmaxf(m, acc);
    }

    float z = 0.f;
    if constexpr (MODE == kNoSoftmax) {
      for (int j = lane; j < S; j += 32) row[j] = round_to<T>(row[j]);
    } else {
      m = warp_max(m);
      for (int j = lane; j < S; j += 32) {
        float e;
        if constexpr (MODE == kNoExp) {
          e = row[j] - m;
        } else if constexpr (MODE == kBf16Sm) {
          e = round_bf16(expf(round_bf16(row[j] - m)));
        } else {
          e = expf(row[j] - m);
        }
        row[j] = e;
        z += e;
      }
      z = warp_sum(z);
      if constexpr (MODE == kDeferDiv) {
        for (int j = lane; j < S; j += 32) row[j] = round_to<T>(row[j]);
      } else if constexpr (MODE == kBf16Sm) {
        const float zb = round_bf16(z);
        for (int j = lane; j < S; j += 32) row[j] = round_to<T>(round_bf16(row[j] / zb));
      } else {
        for (int j = lane; j < S; j += 32) row[j] = round_to<T>(row[j] / z);
      }
    }
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
      for (int e = 0; e < Sh::kCols; ++e) {
        if constexpr (MODE == kDeferDiv) {
          orow[e] = from_f32<T>(acc[e] / z);
        } else {
          orow[e] = from_f32<T>(acc[e]);
        }
      }
    }
    __syncwarp();  // the next row reuses this warp's logits row
  }
}

template <typename T, int DH>
size_t bsd_smem_bytes(int S) {
  using Sh = Shape<T, DH>;
  size_t kv = ((size_t)S * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
  return kv + (size_t)kWarps * S * sizeof(float);
}

template <typename T, int DH, int MODE>
int bsd_launch(const void* q, const void* k, const void* v, void* o, int B, int S,
               int heads, long long in_stride, long long out_stride,
               cudaStream_t stream) {
  const size_t smem = bsd_smem_bytes<T, DH>(S);
  cudaError_t err = cudaFuncSetAttribute(bsd_attention_kernel<T, DH, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + kQTile - 1) / kQTile;
  const long long blocks = (long long)B * heads * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh^-½ rounded once
  bsd_attention_kernel<T, DH, MODE><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, heads, n_tiles, in_stride, out_stride, scale);
  return (int)cudaGetLastError();
}

// Launch mode MODE at head_dim DH in dtype (0 = float32, 1 = bfloat16).
template <int MODE, int DH>
int bsd_dispatch(const void* q, const void* k, const void* v, void* o, int B, int S,
                 int heads, long long in_stride, long long out_stride, int dtype,
                 cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  if (dtype == 0)
    return bsd_launch<float, DH, MODE>(q, k, v, o, B, S, heads, in_stride, out_stride, stream);
  if (dtype == 1)
    return bsd_launch<__nv_bfloat16, DH, MODE>(q, k, v, o, B, S, heads, in_stride,
                                               out_stride, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
