// Unmasked softmax attention on [B, H, S, Dh] heads, flash-style: K and V
// stream through shared memory in key tiles with a running max, a running
// sum and an fp32 accumulator, so no [S, S] row is ever stored.
//
// Replaces mcm_tpu/ops/attention.py::_flash_attention, which calls jax's
// library TPU kernel (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel_single_batch and its single-step twin).  JAX pads
// S to a multiple of 128 and masks the tail keys through segment ids; here
// the C entry takes kv_len and the kernel skips keys at or past it, so no
// padding is stored.  Numerics are JAX's:
//   * s = (q·kᵀ, fp32 FMAs on input-type values) · Dh^-½, the scale after
//     the product;
//   * one key tile (kv_len ≤ kKTile): p = exp(s − max) and l = Σp in fp32,
//     p / l rounded to the input type into PV, as JAX's single-step kernel;
//   * several tiles, JAX's block update (flash_attention.py:439-473):
//       m_next = max(m, rowmax(s));  p = exp(s − m_next)
//       l_corr = exp(m − m_next)·l;  l_next = Σp + l_corr
//       acc = acc·(l_corr·l_inv) + (p rounded to the input type)·v · l_inv
//     with l_inv = 1 / l_next (1 where l_next = 0);
//   * the output is acc cast to the input type.
// kKTile is 128, JAX's key block past S_pad = 512, so at S > 512 the tiles
// are JAX's blocks.  For 128 < S ≤ 512 JAX takes one whole-sequence block
// and this kernel several tiles: the results differ in where p is rounded
// (ROADMAP.md, Queue 3).
//
// Bound on an H100: bytes.  4·B·H·S·Dh elements of q/k/v/o traffic against
// 4·B·H·S²·Dh FLOP; at (B, H, S, Dh) = (128, 12, 197, 64) in bf16 that is
// 155 MB (0.046 ms at 3.35 TB/s) against 15.3 GFLOP (0.015 ms at
// 989 TFLOP/s).
//
// Design (CUDA cores; mma/wgmma and TMA are later work):
//   * one block per ((b·h), tile of kQTile = 64 query rows), flattened into
//     gridDim.x so that the tiles of one head run next to each other and
//     share its K/V through L2;
//   * per key tile, the block stages kKTile rows of K (padded by one 8-byte
//     vector against bank conflicts) and V in dynamic shared memory;
//   * each warp owns 8 query rows and keeps their running max, running sum
//     and fp32 accumulator in its shared scratch across the tiles; for each
//     row it loads q into registers, each lane computes the logits of keys
//     lane, lane + 32, lane + 64 and lane + 96 in registers, warp shuffles
//     reduce the max and the sum, and the probabilities go through a
//     per-warp shared row into PV, where each lane owns Dh/32 output
//     columns (or one, for Dh < 32).
// Built without --use_fast_math: expf and the division are IEEE, and the
// accumulator update is written with __fmul_rn/__fadd_rn so that it is
// not contracted into FMAs.

#include "attention_common.cuh"

namespace {

constexpr int kQTile = 64;
constexpr int kKTile = 128;
constexpr int kRowsPerWarp = kQTile / kWarps;
constexpr int kKeysPerLane = kKTile / 32;
// fp32 scratch of one warp: probability row, accumulators, running max/sum
template <int DH>
constexpr int kWarpFloats = kKTile + kRowsPerWarp * (DH + 2);

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int kv_len,
                       int n_qtiles, float scale) {
  using Sh = Shape<T, DH>;
  using Vec = typename RawVec<Sh::kVecBytes>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)kKTile * Sh::kKStride;
  // fp32 scratch starts on a 16-byte boundary: per warp, one probability
  // row, then each of its rows' accumulator, running max and running sum
  size_t kv_bytes =
      ((size_t)kKTile * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + kv_bytes) + (size_t)warp * kWarpFloats<DH>;
  float* row = scratch;
  float* acc = row + kKTile;                    // [kRowsPerWarp][DH]
  float* m_run = acc + kRowsPerWarp * DH;       // [kRowsPerWarp]
  float* l_run = m_run + kRowsPerWarp;          // [kRowsPerWarp]

  const int qtile = blockIdx.x % n_qtiles;
  const long long off = (long long)(blockIdx.x / n_qtiles) * S * DH;
  const int c0 = lane * Sh::kCols;

  for (int i = lane; i < kRowsPerWarp * DH; i += 32) acc[i] = 0.f;
  if (lane < kRowsPerWarp) {
    m_run[lane] = -INFINITY;
    l_run[lane] = 0.f;
  }

  const int n_ktiles = (kv_len + kKTile - 1) / kKTile;
  const bool single = n_ktiles == 1;
  constexpr int kVecPerRow = DH / Sh::kVec;
  for (int t = 0; t < n_ktiles; ++t) {
    const int k0 = t * kKTile;
    const int kn = min(kKTile, kv_len - k0);

    // -- stage this key tile of K and V --------------------------------------
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kn * kVecPerRow; i += kThreads) {
      const int j = i / kVecPerRow;
      const int c = (i % kVecPerRow) * Sh::kVec;
      const long long g = off + (long long)(k0 + j) * DH + c;
      *reinterpret_cast<Vec*>(ks + (size_t)j * Sh::kKStride + c) =
          *reinterpret_cast<const Vec*>(k + g);
      *reinterpret_cast<Vec*>(vs + (size_t)j * Sh::kVStride + c) =
          *reinterpret_cast<const Vec*>(v + g);
    }
    __syncthreads();

    // this warp's rows: qtile·kQTile + warp + i·kWarps
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = qtile * kQTile + warp + i * kWarps;
      if (r >= S) break;  // warp-uniform; rows grow with i
      float qr[DH];
      const T* qrow = q + off + (long long)r * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) qr[d] = to_f32(qrow[d]);

      // logits of keys lane + 32·c of the tile, scaled after the product
      float s[kKeysPerLane];
      float m_tile = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int j = lane + 32 * c;
        s[c] = -INFINITY;
        if (j < kn) {
          const T* krow = ks + (size_t)j * Sh::kKStride;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; d += Sh::kVec) {
            float kv[Sh::kVec];
            load_f32<T, Sh::kVec>(krow + d, kv);
#pragma unroll
            for (int e = 0; e < Sh::kVec; ++e) dot = fmaf(qr[d + e], kv[e], dot);
          }
          s[c] = dot * scale;
          m_tile = fmaxf(m_tile, s[c]);
        }
      }
      const float m_prev = m_run[i];
      const float m_next = fmaxf(m_prev, warp_max(m_tile));
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        s[c] = lane + 32 * c < kn ? expf(s[c] - m_next) : 0.f;
        psum += s[c];
      }
      const float l_corr = expf(m_prev - m_next) * l_run[i];
      const float l_next = warp_sum(psum) + l_corr;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int j = lane + 32 * c;
        if (j < kn) row[j] = round_to<T>(single ? s[c] / l_next : s[c]);
      }
      __syncwarp();  // row complete; every lane has read m_run[i], l_run[i]
      if (lane == 0) {
        m_run[i] = m_next;
        l_run[i] = l_next;
      }

      // PV over the tile: lane owns columns [c0, c0 + kCols)
      if (c0 < DH) {
        float pv[Sh::kCols];
#pragma unroll
        for (int e = 0; e < Sh::kCols; ++e) pv[e] = 0.f;
        for (int j = 0; j < kn; ++j) {
          const float p = row[j];
          const T* vrow = vs + (size_t)j * Sh::kVStride + c0;
#pragma unroll
          for (int e = 0; e < Sh::kCols; ++e) pv[e] = fmaf(p, to_f32(vrow[e]), pv[e]);
        }
        float* a = acc + i * DH + c0;
        if (single) {
#pragma unroll
          for (int e = 0; e < Sh::kCols; ++e) a[e] = pv[e];
        } else {
          const float l_inv = l_next == 0.f ? 1.f : 1.f / l_next;
          const float f = __fmul_rn(l_corr, l_inv);
#pragma unroll
          for (int e = 0; e < Sh::kCols; ++e)
            a[e] = __fadd_rn(__fmul_rn(a[e], f), __fmul_rn(pv[e], l_inv));
        }
      }
      __syncwarp();  // the next row reuses this warp's probability row
    }
  }

  if (c0 < DH) {
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = qtile * kQTile + warp + i * kWarps;
      if (r >= S) break;
      T* orow = o + off + (long long)r * DH + c0;
#pragma unroll
      for (int e = 0; e < Sh::kCols; ++e) orow[e] = from_f32<T>(acc[i * DH + c0 + e]);
    }
  }
}

template <typename T, int DH>
size_t smem_bytes() {
  using Sh = Shape<T, DH>;
  size_t kv = ((size_t)kKTile * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
  return kv + (size_t)kWarps * kWarpFloats<DH> * sizeof(float);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, long long BH, int S, int kv_len,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh^-½ rounded once
  flash_attention_kernel<T, DH><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, kv_len, n_qtiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (0 for an unsupported
// head_dim or dtype).  dtype: 0 = float32, 1 = bfloat16.
size_t mcm_flash_attention_smem_bytes(int head_dim, int dtype) {
  return with_head_dim(head_dim, (size_t)0, [&](auto dh) -> size_t {
    constexpr int DH = decltype(dh)::value;
    if (dtype == 0) return smem_bytes<float, DH>();
    if (dtype == 1) return smem_bytes<__nv_bfloat16, DH>();
    return 0;
  });
}

// q, k, v, o: contiguous [B, H, S, head_dim], 8-byte aligned.  Every query
// row attends to keys [0, kv_len), 1 ≤ kv_len ≤ S.  Returns the cudaError_t
// of the launch (0 = success).
int mcm_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                        int H, int S, int head_dim, int kv_len, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (kv_len < 1 || kv_len > S) return (int)cudaErrorInvalidValue;
  const long long BH = (long long)B * H;
  return with_head_dim(head_dim, (int)cudaErrorInvalidValue, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    if (dtype == 0) return launch<float, DH>(q, k, v, o, BH, S, kv_len, s);
    if (dtype == 1) return launch<__nv_bfloat16, DH>(q, k, v, o, BH, S, kv_len, s);
    return (int)cudaErrorInvalidValue;
  });
}

const char* mcm_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
