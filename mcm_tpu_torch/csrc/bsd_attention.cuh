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
// Bound on an H100: bytes.  At the main-path shape of a B = 128 score batch
// (S = 197, D = 768, 12 heads, bf16) q/k/v/o are 155 MB (0.046 ms at
// 3.35 TB/s) against 15.3 GFLOP (0.015 ms at 989 TFLOP/s).
//
// Two designs, chosen by dtype and head dim at compile time (never on a
// failed build or launch):
//   * bf16 at Dh ≥ 16 — tensor cores (attention_mma.cuh): one block per
//     (image, head), so the head's K and V are read from device memory once
//     (the CUDA-core design below restaged them for each of its 64-row
//     tiles).  cp.async stages K, then V, into swizzled shared-memory tiles
//     (52 KB at S = 197, Dh = 64), V landing while the warps' first pass
//     runs on K.  The 8 warps walk the head's ⌈S/16⌉ 16-row tiles; each
//     computes QKᵀ and PV with mma.sync over ldmatrix fragments, in the two
//     passes over the keys that attention_mma.cuh describes.  The products
//     that held the CUDA-core design to 33× its bound (one shared-memory
//     load per FMA) leave the critical path.
//   * fp32 (parity mode: IEEE fp32 products, which the tensor cores offer
//     only as TF32) and bf16 at Dh < 16 — CUDA cores: one block per (image,
//     head, tile of 64 query rows), flattened into gridDim.x so that the
//     tiles of one head run next to each other and share its K/V through
//     L2; the head's whole K and V in dynamic shared memory, K rows padded
//     by one 8-byte vector so that 32 lanes reading 32 different keys hit
//     different banks; one warp per query row (q in registers, the logits
//     of keys lane, lane + 32, ... in a per-warp shared row, warp shuffles
//     for the max and the sum); in PV each lane owns Dh/32 output columns
//     (or one, for Dh < 32).
// Built without --use_fast_math: expf is IEEE, and so is the division of
// the CUDA-core bodies; the tensor-core bodies round each quotient
// correctly from one reciprocal per row (attention_mma.cuh).

#pragma once

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

constexpr int kQTile = 64;

__device__ __forceinline__ float round_bf16(float x) { return round_to<__nv_bfloat16>(x); }

template <int DH, int MODE>
__global__ void __launch_bounds__(kThreads)
bsd_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int S, int heads,
                         long long in_stride, long long out_stride, float scale, bool vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  attend_pairs<DH, MODE, 1, kWarps>(q, k, v, o, S, S, blockIdx.x, 1, 0, S,
                                    PairLayout{in_stride, out_stride, heads}, scale, vec16,
                                    smem);
}

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
  if constexpr (kTensorCores<T, DH>) {
    return mma_stage_bytes<DH>(S);
  } else {
    using Sh = Shape<T, DH>;
    size_t kv = ((size_t)S * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
    return kv + (size_t)kWarps * S * sizeof(float);
  }
}

template <typename T, int DH, int MODE>
int bsd_launch(const void* q, const void* k, const void* v, void* o, int B, int S,
               int heads, long long in_stride, long long out_stride,
               cudaStream_t stream) {
  const size_t smem = bsd_smem_bytes<T, DH>(S);
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh^-½ rounded once
  if constexpr (kTensorCores<T, DH>) {
    cudaError_t err = cudaFuncSetAttribute(bsd_attention_mma_kernel<DH, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)B * heads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    // every K/V row starts on 16 bytes: the bases, and the row stride (the
    // head offset h·Dh·2 is a multiple of 32)
    const bool vec16 = ((uintptr_t)k | (uintptr_t)v) % 16 == 0 && in_stride * sizeof(T) % 16 == 0;
    bsd_attention_mma_kernel<DH, MODE><<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), S, heads, in_stride, out_stride, scale, vec16);
  } else {
    cudaError_t err = cudaFuncSetAttribute(bsd_attention_kernel<T, DH, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = (S + kQTile - 1) / kQTile;
    const long long blocks = (long long)B * heads * n_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    bsd_attention_kernel<T, DH, MODE><<<(unsigned)blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), S, heads, n_tiles, in_stride, out_stride, scale);
  }
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
