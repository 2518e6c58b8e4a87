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

#include "attention_common.cuh"

namespace {

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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (0 for an unsupported
// head_dim or dtype).  dtype: 0 = float32, 1 = bfloat16.
size_t mcm_split_attention_smem_bytes(int S, int head_dim, int dtype) {
  return with_head_dim(head_dim, (size_t)0, [&](auto dh) -> size_t {
    constexpr int DH = decltype(dh)::value;
    if (dtype == 0) return smem_bytes<float, DH>(S);
    if (dtype == 1) return smem_bytes<__nv_bfloat16, DH>(S);
    return 0;
  });
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
  return with_head_dim(head_dim, (int)cudaErrorInvalidValue, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    if (dtype == 0) return launch<float, DH>(q, k, v, o, B, H, S, mode, block, s);
    if (dtype == 1) return launch<__nv_bfloat16, DH>(q, k, v, o, B, H, S, mode, block, s);
    return (int)cudaErrorInvalidValue;
  });
}

const char* mcm_split_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
