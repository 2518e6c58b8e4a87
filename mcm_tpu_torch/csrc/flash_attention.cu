// Unmasked softmax attention on [B, H, S, Dh] heads with the numerics of
// jax's TPU flash kernel, every query row over keys [0, kv_len).
//
// Replaces mcm_tpu/ops/attention.py::_flash_attention, which calls jax's
// library TPU kernel (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel_single_batch and its single-step twin).  JAX pads
// S to a multiple of 128 (S_pad) and masks the tail keys through segment
// ids; here the C entry takes kv_len and the kernel skips keys at or past
// it, so no padding is stored.  Numerics are JAX's, by its branch
// (mcm_tpu/ops/attention.py:283):
//   * s = (q·kᵀ, fp32 sums of input-type products) · Dh^-½, the scale after
//     the product;
//   * S_pad ≤ 512, jax's single whole-sequence block: p = exp(s − max) / l
//     in fp32 (l = Σ exp(s − max)), rounded to the input type into PV;
//   * S_pad > 512, jax's 128-key block loop (flash_attention.py:439-473):
//       m_next = max(m, rowmax(s));  p = exp(s − m_next)
//       l_corr = exp(m − m_next)·l;  l_next = Σp + l_corr
//       acc = acc·(l_corr·l_inv) + (p rounded to the input type)·v · l_inv
//     with l_inv = 1 / l_next (1 where l_next = 0);
//   * the output is the fp32 result cast to the input type.
//
// Bound on an H100: bytes.  4·B·H·S·Dh elements of q/k/v/o traffic against
// 4·B·H·S²·Dh FLOP; at (B, H, S, Dh) = (128, 12, 197, 64) in bf16 that is
// 155 MB (0.046 ms at 3.35 TB/s) against 15.3 GFLOP (0.015 ms at
// 989 TFLOP/s).
//
// Two designs, chosen on the host before the launch by dtype, head dim and
// the shared memory a pair's keys need (never on a failed build or launch):
//   * bf16 at Dh ≥ 16 whose pair K/V ([kv_len rounded to 16, Dh] each) fit
//     in a block's shared memory (kv_len ≤ 896 at Dh = 64, ≤ 448 at 128) —
//     tensor cores, the tile of attention_mma.cuh that the bsd and
//     split-heads bodies run: one block per (b·h) pair, its K and V staged
//     once by cp.async into swizzled tiles (52 KB at S = 197, Dh = 64), 8
//     warps over the pair's 16-row query tiles, QKᵀ and PV by mma.sync over
//     ldmatrix fragments.  The tile takes raw q and scales the fp32 logits
//     (TileNumerics).  S_pad ≤ 512: its two passes over the keys (running
//     max and sum, then the same logits bit for bit, p / l correctly rounded
//     and rounded to bf16 into PV) compute jax's single step up to the order
//     of the sums.  S_pad > 512: one pass over 128-key blocks, each block's
//     logits in registers while its max is formed (MmaTile::output_blocks).
//   * fp32 (parity mode: IEEE fp32 products, which the tensor cores offer
//     only as TF32), bf16 at Dh < 16, and keys too many for shared memory —
//     CUDA cores: one block per ((b·h), tile of kQTile = 64 query rows),
//     flattened into gridDim.x so that the tiles of one head share its K/V
//     through L2; K and V stream through shared memory in kKTile = 128-key
//     tiles (K rows padded by one 8-byte vector against bank conflicts);
//     each warp owns 8 query rows, keeps their running max, running sum and
//     fp32 accumulator in shared scratch, computes the logits of keys lane,
//     lane + 32, lane + 64 and lane + 96 from q in registers, and sends the
//     probabilities through a per-warp shared row into PV.  S_pad ≤ 512
//     walks the tiles twice (the row's max and sum, then p / l into PV),
//     S_pad > 512 once with jax's block update (the tiles are its blocks).
// Built without --use_fast_math: expf and the division are IEEE, and the
// block update is written with __fmul_rn/__fadd_rn so that it is not
// contracted into FMAs.

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

constexpr int kQTile = 64;
constexpr int kKTile = 128;
constexpr int kRowsPerWarp = kQTile / kWarps;
constexpr int kKeysPerLane = kKTile / 32;
// fp32 scratch of one warp: probability row, accumulators, running max/sum
template <int DH>
constexpr int kWarpFloats = kKTile + kRowsPerWarp * (DH + 2);

// jax takes one whole-sequence block while S padded to 128 is at most 512
bool single_step(int S) { return (S + 127) / 128 * 128 <= 512; }

// -- tensor cores (bf16, Dh ≥ 16) ------------------------------------------------

template <int DH, int NUM>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int S, int kv_len,
                           float scale, bool vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  attend_pairs<DH, kFull, 1, kWarps, NUM>(q, k, v, o, S, kv_len, blockIdx.x, 1, 0, S,
                                          PairLayout{DH, DH, 1}, scale, vec16, smem);
}

template <int DH, int NUM>
int launch_mma(const void* q, const void* k, const void* v, void* o, long long BH, int S,
               int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = mma_stage_bytes<DH>(kv_len);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_mma_kernel<DH, NUM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // rows are Dh·2 ≥ 32 bytes: 16-byte aligned wherever the bases are
  const bool vec16 = ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  flash_attention_mma_kernel<DH, NUM><<<(unsigned)BH, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, kv_len, scale, vec16);
  return (int)cudaGetLastError();
}

// -- CUDA cores (fp32; bf16 at Dh < 16 or past the shared memory) -----------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int kv_len,
                       int n_qtiles, float scale, bool two_pass) {
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
  constexpr int kVecPerRow = DH / Sh::kVec;

  // key tile t of K and V into shared memory (kn keys)
  auto stage = [&](int t, int kn) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kn * kVecPerRow; i += kThreads) {
      const int j = i / kVecPerRow;
      const int c = (i % kVecPerRow) * Sh::kVec;
      const long long g = off + (long long)(t * kKTile + j) * DH + c;
      *reinterpret_cast<Vec*>(ks + (size_t)j * Sh::kKStride + c) =
          *reinterpret_cast<const Vec*>(k + g);
      *reinterpret_cast<Vec*>(vs + (size_t)j * Sh::kVStride + c) =
          *reinterpret_cast<const Vec*>(v + g);
    }
    __syncthreads();
  };
  // logits of query row r against keys lane + 32·c of the staged tile,
  // scaled after the product; −inf past its kn keys
  auto logits = [&](int r, int kn, float (&s)[kKeysPerLane]) {
    float qr[DH];
    const T* qrow = q + off + (long long)r * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = to_f32(qrow[d]);
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
        s[c] = __fmul_rn(dot, scale);  // rounded: both passes see one s
      }
    }
  };
  // pv[e] = Σ_j row[j] · v[j][c0 + e] over the staged tile's kn keys
  auto pv_row = [&](int kn, float (&pv)[Sh::kCols]) {
#pragma unroll
    for (int e = 0; e < Sh::kCols; ++e) pv[e] = 0.f;
    for (int j = 0; j < kn; ++j) {
      const float p = row[j];
      const T* vrow = vs + (size_t)j * Sh::kVStride + c0;
#pragma unroll
      for (int e = 0; e < Sh::kCols; ++e) pv[e] = fmaf(p, to_f32(vrow[e]), pv[e]);
    }
  };

  if (two_pass) {
    // pass 1: each row's max and sum over all its keys
    for (int t = 0; t < n_ktiles; ++t) {
      const int kn = min(kKTile, kv_len - t * kKTile);
      stage(t, kn);
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = qtile * kQTile + warp + i * kWarps;
        if (r >= S) break;  // warp-uniform; rows grow with i
        float s[kKeysPerLane];
        logits(r, kn, s);
        float m_tile = -INFINITY;
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) m_tile = fmaxf(m_tile, s[c]);
        const float m_prev = m_run[i];
        const float m_next = fmaxf(m_prev, warp_max(m_tile));
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c)
          psum += lane + 32 * c < kn ? expf(s[c] - m_next) : 0.f;
        const float l_next = __fadd_rn(__fmul_rn(expf(m_prev - m_next), l_run[i]),
                                       warp_sum(psum));
        __syncwarp();  // every lane has read m_run[i], l_run[i]
        if (lane == 0) {
          m_run[i] = m_next;
          l_run[i] = l_next;
        }
        __syncwarp();
      }
    }
    // pass 2: p = exp(s − max) / l rounded to T, accumulated through PV
    for (int t = 0; t < n_ktiles; ++t) {
      const int kn = min(kKTile, kv_len - t * kKTile);
      stage(t, kn);
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = qtile * kQTile + warp + i * kWarps;
        if (r >= S) break;
        float s[kKeysPerLane];
        logits(r, kn, s);
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          const int j = lane + 32 * c;
          if (j < kn) row[j] = round_to<T>(expf(s[c] - m_run[i]) / l_run[i]);
        }
        __syncwarp();  // row complete
        if (c0 < DH) {
          float pv[Sh::kCols];
          pv_row(kn, pv);
          float* a = acc + i * DH + c0;
#pragma unroll
          for (int e = 0; e < Sh::kCols; ++e) a[e] += pv[e];
        }
        __syncwarp();  // the next row reuses this warp's probability row
      }
    }
  } else {
    for (int t = 0; t < n_ktiles; ++t) {
      const int kn = min(kKTile, kv_len - t * kKTile);
      stage(t, kn);
      // this warp's rows: qtile·kQTile + warp + i·kWarps
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = qtile * kQTile + warp + i * kWarps;
        if (r >= S) break;  // warp-uniform; rows grow with i
        float s[kKeysPerLane];
        logits(r, kn, s);
        float m_tile = -INFINITY;
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) m_tile = fmaxf(m_tile, s[c]);
        const float m_prev = m_run[i];
        const float m_next = fmaxf(m_prev, warp_max(m_tile));
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          s[c] = lane + 32 * c < kn ? expf(s[c] - m_next) : 0.f;
          psum += s[c];
        }
        const float l_corr = __fmul_rn(expf(m_prev - m_next), l_run[i]);
        const float l_next = __fadd_rn(warp_sum(psum), l_corr);
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          const int j = lane + 32 * c;
          if (j < kn) row[j] = round_to<T>(s[c]);
        }
        __syncwarp();  // row complete; every lane has read m_run[i], l_run[i]
        if (lane == 0) {
          m_run[i] = m_next;
          l_run[i] = l_next;
        }

        // PV over the tile: lane owns columns [c0, c0 + kCols)
        if (c0 < DH) {
          float pv[Sh::kCols];
          pv_row(kn, pv);
          float* a = acc + i * DH + c0;
          const float l_inv = l_next == 0.f ? 1.f : 1.f / l_next;
          const float f = __fmul_rn(l_corr, l_inv);
#pragma unroll
          for (int e = 0; e < Sh::kCols; ++e)
            a[e] = __fadd_rn(__fmul_rn(a[e], f), __fmul_rn(pv[e], l_inv));
        }
        __syncwarp();  // the next row reuses this warp's probability row
      }
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
int launch_simt(const void* q, const void* k, const void* v, void* o, long long BH, int S,
                int kv_len, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (S + kQTile - 1) / kQTile;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_kernel<T, DH><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, kv_len, n_qtiles, scale, single_step(S));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, long long BH, int S, int kv_len,
           cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh^-½ rounded once
  if constexpr (kTensorCores<T, DH>) {
    if (mma_stage_bytes<DH>(kv_len) <= (size_t)smem_limits().block) {
      if (BH > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
      if (single_step(S))
        return launch_mma<DH, kFlashSingle>(q, k, v, o, BH, S, kv_len, scale, stream);
      return launch_mma<DH, kFlashBlocks>(q, k, v, o, BH, S, kv_len, scale, stream);
    }
  }
  return launch_simt<T, DH>(q, k, v, o, BH, S, kv_len, scale, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the CUDA-core design takes
// (0 for an unsupported head_dim or dtype).  A bf16 launch at head_dim ≥ 16
// whose 2·⌈kv_len/16⌉·16·head_dim·2 bytes of K/V fit in a block runs on the
// tensor-core design instead, with that many.  dtype: 0 = float32,
// 1 = bfloat16.
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
