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
// TPU kernels (and of csrc/bsd_attention.cuh):
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
// Three launch shapes, as JAX names them: a block owns a list of (b·h)
// pairs and a range of query rows (mode 0: one pair, one query tile; modes
// 1 and 2: every row of each pair of its group), and the last group is
// clamped to the pairs that exist (the tail head group of mode 1, H = 16 in
// groups of 6 gives 6, 6 and 4; the tail pair group of mode 2,
// B·H % block_bh ≠ 0), so nothing is written past them.  Mode 2 at
// B·H = 1536 and block_bh = 16 launches 96 blocks for 132 SMs, as the TPU
// grid does: 36 SMs stay idle.  The blocking is what the mode names, so it
// is kept; a mode-2 block has its SM to itself, so at Dh = 64 (the ViT
// head width, whose registers fit 16 warps without spills) it takes 16
// warps, 8 otherwise.  Inside a block, two
// designs, chosen by dtype and head dim at compile time (never on a failed
// build or launch):
//   * bf16 at Dh ≥ 16 — tensor cores (attention_mma.cuh): the block's pairs
//     stream through a ring of shared-memory stages, the next pair's K/V in
//     flight with cp.async while earlier pairs compute (no serial restage
//     of every pair behind __syncthreads); the warps are spread over
//     (pair, 16-row tile) work items, so a mode-2 block keeps its SM busy
//     across pairs; each item runs mma.sync QKᵀ and PV over ldmatrix
//     fragments.  The ring's depth is chosen on the host from S and the
//     pairs a block owns: up to three stages for a 16-warp mode-2 block, up
//     to two otherwise as long as two blocks still share an SM (mode 1 at
//     S = 197: two; at S = 257: one), one for mode 0 (one pair a block),
//     and never more than fit in the 227 KB a block may have (52 KB a stage
//     at S = 197, Dh = 64; 152 KB at S = 600, which takes one).
//   * fp32 (parity mode: IEEE fp32 products, which the tensor cores offer
//     only as TF32) and bf16 at Dh < 16 — CUDA cores: for each pair the
//     block stages its whole K and V in dynamic shared memory, K rows
//     padded by one 8-byte vector so that 32 lanes reading 32 different keys
//     hit different banks, and gives each warp one query row at a time (q
//     in registers, the logits of keys lane, lane + 32, ... in a per-warp
//     shared row, warp shuffles for the max and the sum; in PV each lane
//     owns Dh/32 output columns).
// Built without --use_fast_math: expf is IEEE, and so is the division of
// the CUDA-core bodies; the tensor-core bodies round each quotient
// correctly from one reciprocal per row (attention_mma.cuh).

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

// The pairs [begin, end) and query rows [r_begin, r_end) of block bid.
// mode 0: p1 = block_q, p2 = query tiles per pair
// mode 1: p1 = block_h, p2 = heads
// mode 2: p1 = block_bh
struct BlockWork {
  long long begin, end;
  int r_begin, r_end;
};

__device__ __forceinline__ BlockWork block_work(long long bid, long long n_pairs, int S,
                                                int mode, int p1, int p2) {
  BlockWork w{0, 0, 0, S};
  if (mode == 0) {
    w.begin = bid / p2;
    w.end = w.begin + 1;
    w.r_begin = (int)(bid % p2) * p1;
    w.r_end = min(S, w.r_begin + p1);
  } else if (mode == 1) {
    const int groups = (p2 + p1 - 1) / p1;
    const long long b = bid / groups;
    const int g = (int)(bid % groups);
    w.begin = b * p2 + (long long)g * p1;
    w.end = b * p2 + min(p2, (g + 1) * p1);
  } else {
    w.begin = bid * p1;
    w.end = min(n_pairs, w.begin + p1);
  }
  return w;
}

template <int DH, int NST, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
split_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                           long long n_pairs, int mode, int p1, int p2, float scale,
                           bool vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockWork w = block_work(blockIdx.x, n_pairs, S, mode, p1, p2);
  attend_pairs<DH, kFull, NST, WARPS>(q, k, v, o, S, S, w.begin, (int)(w.end - w.begin),
                                      w.r_begin, w.r_end, PairLayout{DH, DH, 1}, scale, vec16,
                                      smem);
}

template <typename T, int DH, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
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

  const BlockWork w = block_work(blockIdx.x, n_pairs, S, mode, p1, p2);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* row = rows + (size_t)warp * S;
  constexpr int kVecPerRow = DH / Sh::kVec;

  for (long long pair = w.begin; pair < w.end; ++pair) {
    const long long off = pair * S * DH;

    // -- stage this pair's K and V ------------------------------------------
    for (int i = threadIdx.x; i < S * kVecPerRow; i += WARPS * 32) {
      const int j = i / kVecPerRow;
      const int c = (i % kVecPerRow) * Sh::kVec;
      const long long g = off + (long long)j * DH + c;
      *reinterpret_cast<Vec*>(ks + (size_t)j * Sh::kKStride + c) =
          *reinterpret_cast<const Vec*>(k + g);
      *reinterpret_cast<Vec*>(vs + (size_t)j * Sh::kVStride + c) =
          *reinterpret_cast<const Vec*>(v + g);
    }
    __syncthreads();

    for (int r = w.r_begin + warp; r < w.r_end; r += WARPS) {
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

// Bytes of dynamic shared memory of the CUDA-core design with `warps`
// warps, or of the tensor-core design's one-stage ring (the least a launch
// needs).
template <typename T, int DH>
size_t smem_bytes(int S, int warps = kWarps) {
  if constexpr (kTensorCores<T, DH>) {
    return mma_stage_bytes<DH>(S);
  } else {
    using Sh = Shape<T, DH>;
    size_t kv = ((size_t)S * (Sh::kKStride + Sh::kVStride) * sizeof(T) + 15) & ~(size_t)15;
    return kv + (size_t)warps * S * sizeof(float);
  }
}

// Stages of the tensor-core ring for a block of `pairs` pairs: `most`,
// never more than the pairs, and fewer where they would exceed the block's
// shared-memory limit or keep `per_sm` blocks from sharing an SM.  One
// stage is always returned: a launch that needs more than the block limit
// is refused.
template <int DH>
int ring_stages(int S, int most, long long pairs, int per_sm) {
  const SmemLimits lim = smem_limits();
  long long n = most < pairs ? most : pairs;
  for (; n > 1; --n) {
    const size_t bytes = (size_t)n * mma_stage_bytes<DH>(S);
    if (bytes <= (size_t)lim.block && per_sm * (bytes + lim.reserved) <= (size_t)lim.sm) break;
  }
  return (int)(n < 1 ? 1 : n);
}

template <int DH, int NST, int WARPS>
int launch_mma(const void* q, const void* k, const void* v, void* o, int S, long long n_pairs,
               int mode, int p1, int p2, long long blocks, float scale, cudaStream_t stream) {
  const size_t smem = NST * mma_stage_bytes<DH>(S);
  cudaError_t err = cudaFuncSetAttribute(split_attention_mma_kernel<DH, NST, WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // rows are Dh·2 ≥ 32 bytes: 16-byte aligned wherever the bases are
  const bool vec16 = ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  split_attention_mma_kernel<DH, NST, WARPS><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, n_pairs, mode, p1, p2, scale, vec16);
  return (int)cudaGetLastError();
}

template <typename T, int DH, int WARPS>
int launch_simt(const void* q, const void* k, const void* v, void* o, int S, long long n_pairs,
                int mode, int p1, int p2, long long blocks, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DH>(S, WARPS);
  cudaError_t err = cudaFuncSetAttribute(split_attention_kernel<T, DH, WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_attention_kernel<T, DH, WARPS><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, n_pairs, mode, p1, p2, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
           int mode, int block, cudaStream_t stream) {
  const long long n_pairs = (long long)B * H;
  long long blocks, pairs_per_block;
  int p1 = block, p2 = 0;
  if (mode == 0) {
    p2 = (S + block - 1) / block;
    blocks = n_pairs * p2;
    pairs_per_block = 1;
  } else if (mode == 1) {
    p2 = H;
    blocks = (long long)B * ((H + block - 1) / block);
    pairs_per_block = block < H ? block : H;
  } else if (mode == 2) {
    blocks = (n_pairs + block - 1) / block;
    pairs_per_block = block < n_pairs ? block : n_pairs;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float scale = (float)(1.0 / sqrt((double)DH));  // Dh^-½ rounded once
  if constexpr (kTensorCores<T, DH>) {
    // mode 2 has few blocks, one to an SM: 16 warps and up to three stages
    // at Dh = 64, the ViT head width (≤ 128 registers a thread, as 16 warps
    // need: 116–122, no spills).  Otherwise 8 warps and up to two stages,
    // as long as two blocks still share an SM (their registers allow two at
    // Dh ≤ 64, one above).
    if constexpr (DH == 64) {
      if (mode == 2) {
        const int stages = ring_stages<DH>(S, 3, pairs_per_block, 1);
        if (stages == 3)
          return launch_mma<DH, 3, 16>(q, k, v, o, S, n_pairs, mode, p1, p2, blocks, scale,
                                       stream);
        if (stages == 2)
          return launch_mma<DH, 2, 16>(q, k, v, o, S, n_pairs, mode, p1, p2, blocks, scale,
                                       stream);
        return launch_mma<DH, 1, 16>(q, k, v, o, S, n_pairs, mode, p1, p2, blocks, scale, stream);
      }
    }
    const int stages = ring_stages<DH>(S, 2, pairs_per_block, DH > 64 ? 1 : 2);
    if (stages == 2)
      return launch_mma<DH, 2, kWarps>(q, k, v, o, S, n_pairs, mode, p1, p2, blocks, scale,
                                       stream);
    return launch_mma<DH, 1, kWarps>(q, k, v, o, S, n_pairs, mode, p1, p2, blocks, scale, stream);
  } else {
    // mode 2 likewise takes 16 warps at Dh = 64 where their logits rows fit
    if constexpr (DH == 64) {
      if (mode == 2 && smem_bytes<T, DH>(S, 16) <= (size_t)smem_limits().block)
        return launch_simt<T, DH, 16>(q, k, v, o, S, n_pairs, mode, p1, p2, blocks, scale,
                                      stream);
    }
    return launch_simt<T, DH, kWarps>(q, k, v, o, S, n_pairs, mode, p1, p2, blocks, scale,
                                      stream);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes (0 for an unsupported
// head_dim or dtype); for bf16 at head_dim ≥ 16, a block holding one pair
// (a block of several pairs takes up to three times that: its ring's
// stages, as many as fit).  dtype: 0 = float32, 1 = bfloat16.
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
