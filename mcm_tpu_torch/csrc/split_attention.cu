// Multi-head encoder attention over pre-split [B, H, S, Dh] heads, with the
// three blockings of the JAX package's split-heads TPU kernels.
//
// Replaces, in mcm_tpu/ops/attention.py:
//   mode 0  _attention_kernel (through _pallas_attention): one program per
//           (b·h) pair and tile of block_q query rows;
//   mode 1  _mh_attention_kernel (through _pallas_mh_attention): one
//           program per (image, group of block_h heads), looping over the
//           group's heads;
//   mode 2  _batched_attention_kernel (through _pallas_batched_attention):
//           one program per group of block_bh (b·h) pairs.
// All three compute unmasked softmax(q·kᵀ·Dh^-½)·v with the numerics of the
// TPU kernels (and of csrc/bsd_attention.cu):
//   * q is scaled in fp32, then rounded back to the input type;
//   * logits accumulate in fp32 from input-type products;
//   * max, exp and sum are fp32; the division is on the probabilities;
//   * p is rounded to the input type before PV;
//   * PV accumulates in fp32; the output is cast to the input type.
//
// Bound on an H100: bytes.  4·B·H·S·Dh elements of q/k/v/o traffic against
// 4·B·H·S²·Dh FLOP; at (B, H, S, Dh) = (128, 12, 197, 64) in bf16 that is
// 155 MB (0.046 ms at 3.35 TB/s) against 15.3 GFLOP (0.015 ms at
// 989 TFLOP/s).
//
// Design: one kernel body, three launch shapes.  A block owns a list of
// (b·h) pairs and a range of query rows (mode 0: one pair, one query tile;
// modes 1 and 2: every row of each pair of its group).  For each pair it
//   * stages the pair's whole K and V in dynamic shared memory (65.8 KB at
//     S = 257, Dh = 64 in bf16; above 48 KB after cudaFuncSetAttribute), K
//     rows padded by one 8-byte vector so that 32 lanes reading 32
//     different keys hit different banks;
//   * gives each warp one query row at a time: q in registers, the logits
//     of keys lane, lane + 32, ... in a per-warp shared row, warp shuffles
//     for the max and the sum; in PV each lane owns Dh/32 output columns;
//   * loops warps over rows, since S = 197 and 257 are not multiples of 32
//     and exceed one warp per row under the 1024-thread cap;
//   * clamps the last group to the pairs that exist: the tail head group of
//     mode 1 (H = 16 in groups of 6 gives 6, 6 and 4) and the tail pair
//     group of mode 2 (B·H % block_bh ≠ 0) write nothing past them.
// Mode 2 at B·H = 1536 and block_bh = 16 launches 96 blocks for 132 SMs,
// as the TPU grid does: 36 SMs stay idle.  The blocking is what this mode
// names, so it is kept.
// Built without --use_fast_math: expf and the division are IEEE.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

template <int N> struct RawVec;
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<4> { using type = uint32_t; };
template <> struct RawVec<2> { using type = uint16_t; };

// N consecutive elements at p (aligned to N elements) as fp32.
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
  static constexpr int kVec = (8 / (int)sizeof(T)) < DH ? (8 / (int)sizeof(T)) : DH;
  static constexpr int kVecBytes = kVec * (int)sizeof(T);
  static constexpr int kKStride = DH + kVec;  // padded K row (elements)
  static constexpr int kVStride = DH;
  static constexpr int kCols = DH >= 32 ? DH / 32 : 1;  // PV columns per lane
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

// mode 0: p1 = block_q, p2 = query tiles per pair
// mode 1: p1 = block_h, p2 = heads
// mode 2: p1 = block_bh
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
split_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       long long n_pairs, int mode, int p1, int p2, float scale) {
  using Sh = Shape<T, DH>;
  using Vec = typename RawVec<Sh::kVecBytes>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)S * Sh::kKStride;
  size_t kv_bytes = ((size_t)S * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
  float* rows = reinterpret_cast<float*>(smem + kv_bytes);

  const long long bid = blockIdx.x;
  long long pair_begin, pair_end;
  int r_begin = 0, r_end = S;
  if (mode == 0) {
    pair_begin = bid / p2;
    pair_end = pair_begin + 1;
    const int tile = (int)(bid % p2);
    r_begin = tile * p1;
    r_end = min(S, r_begin + p1);
  } else if (mode == 1) {
    const int groups = (p2 + p1 - 1) / p1;
    const long long b = bid / groups;
    const int g = (int)(bid % groups);
    pair_begin = b * p2 + (long long)g * p1;
    pair_end = b * p2 + min(p2, (g + 1) * p1);
  } else {
    pair_begin = bid * p1;
    pair_end = min(n_pairs, pair_begin + p1);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* row = rows + (size_t)warp * S;
  constexpr int kVecPerRow = DH / Sh::kVec;

  for (long long pair = pair_begin; pair < pair_end; ++pair) {
    const long long off = pair * S * DH;

    // -- stage this pair's K and V ------------------------------------------
    for (int i = threadIdx.x; i < S * kVecPerRow; i += kThreads) {
      const int j = i / kVecPerRow;
      const int c = (i % kVecPerRow) * Sh::kVec;
      const long long g = off + (long long)j * DH + c;
      *reinterpret_cast<Vec*>(ks + (size_t)j * Sh::kKStride + c) =
          *reinterpret_cast<const Vec*>(k + g);
      *reinterpret_cast<Vec*>(vs + (size_t)j * Sh::kVStride + c) =
          *reinterpret_cast<const Vec*>(v + g);
    }
    __syncthreads();

    for (int r = r_begin + warp; r < r_end; r += kWarps) {
      float qr[DH];
      const T* qrow = q + off + (long long)r * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) qr[d] = to_f32(from_f32<T>(to_f32(qrow[d]) * scale));

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
        T* orow = o + off + (long long)r * DH + c0;
#pragma unroll
        for (int e = 0; e < Sh::kCols; ++e) orow[e] = from_f32<T>(acc[e]);
      }
      __syncwarp();  // the next row reuses this warp's logits row
    }
    __syncthreads();  // the next pair restages K and V
  }
}

template <typename T, int DH>
size_t smem_bytes(int S) {
  using Sh = Shape<T, DH>;
  size_t kv = ((size_t)S * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
  return kv + (size_t)kWarps * S * sizeof(float);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
           int mode, int block, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>(S);
  cudaError_t err = cudaFuncSetAttribute(split_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_pairs = (long long)B * H;
  long long blocks;
  int p1 = block, p2 = 0;
  if (mode == 0) {
    p2 = (S + block - 1) / block;
    blocks = n_pairs * p2;
  } else if (mode == 1) {
    p2 = H;
    blocks = (long long)B * ((H + block - 1) / block);
  } else if (mode == 2) {
    blocks = (n_pairs + block - 1) / block;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh^-½ rounded once
  split_attention_kernel<T, DH><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, n_pairs, mode, p1, p2, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
             int head_dim, int mode, int block, cudaStream_t stream) {
  switch (head_dim) {
    case 1: return launch<T, 1>(q, k, v, o, B, H, S, mode, block, stream);
    case 2: return launch<T, 2>(q, k, v, o, B, H, S, mode, block, stream);
    case 4: return launch<T, 4>(q, k, v, o, B, H, S, mode, block, stream);
    case 8: return launch<T, 8>(q, k, v, o, B, H, S, mode, block, stream);
    case 16: return launch<T, 16>(q, k, v, o, B, H, S, mode, block, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, S, mode, block, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, S, mode, block, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, S, mode, block, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
size_t smem_for(int S, int head_dim) {
  switch (head_dim) {
    case 1: return smem_bytes<T, 1>(S);
    case 2: return smem_bytes<T, 2>(S);
    case 4: return smem_bytes<T, 4>(S);
    case 8: return smem_bytes<T, 8>(S);
    case 16: return smem_bytes<T, 16>(S);
    case 32: return smem_bytes<T, 32>(S);
    case 64: return smem_bytes<T, 64>(S);
    case 128: return smem_bytes<T, 128>(S);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (0 for an unsupported
// head_dim or dtype).  dtype: 0 = float32, 1 = bfloat16.
size_t mcm_split_attention_smem_bytes(int S, int head_dim, int dtype) {
  if (dtype == 0) return smem_for<float>(S, head_dim);
  if (dtype == 1) return smem_for<__nv_bfloat16>(S, head_dim);
  return 0;
}

// q, k, v, o: contiguous [B, H, S, head_dim], 8-byte aligned.  mode: 0 =
// pallas (block = block_q), 1 = pallas_mh (block = block_h), 2 =
// pallas_batched (block = block_bh).  Returns the cudaError_t of the
// launch (0 = success).
int mcm_split_attention(const void* q, const void* k, const void* v, void* o, int B,
                        int H, int S, int head_dim, int mode, int block, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (block <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(q, k, v, o, B, H, S, head_dim, mode, block, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, B, H, S, head_dim, mode, block, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcm_split_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
