// Fused MCM-family OOD score: [B, D] image features × [C, D] normalized
// text features → [B] scores.
//
// Replaces the TPU kernel mcm_tpu/ops/mcm_score.py::_score_kernel (called
// through _pallas_mcm).  Per image row:
//   fp32 L2-normalize (x · (1 / sqrtf(Σx²)), the TPU kernel's order)
//   → IEEE fp32 logits against every text row (fp32 FMAs, no tensor cores:
//     TF32 would keep ~3 digits and the logits feed parity-relevant scores)
//   → / T → stable softmax → one reduction, picked by the template
//     parameter: MCM (−max prob), max-logit (−max raw logit), energy
//     (−T·(log z + m)), entropy (NaN rows propagate) or var (over C).
// There is no class padding, so no −1e30 mask.
//
// Bound on an H100 at the main-path shape (B = 128, C = 1000, D = 512):
// 2·B·C·D = 0.13 GFLOP of fp32 outside the tensor cores (1.96 µs at 67
// TFLOP/s) against 2.3 MB of traffic (0.69 µs at 3.35 TB/s): bound by the
// operations.  The TPU kernel keeps the whole [C, D] text matrix and a
// [block, C] logits tile in VMEM; a Hopper block has 227 KB, so this port
// tiles both B and C and goes through two launches on the caller's stream:
//
// 1. logits: a block owns a [32 rows × 32 classes] tile, so that B = 128
//    makes 4 × ⌈C / 32⌉ = 128 blocks at C = 1000 for the 132 SMs.  D streams
//    through shared memory in 32-wide chunks, double-buffered by cp.async
//    (16-byte pieces, coalesced, when D % 4 == 0 and the rows are 16-byte
//    aligned; 4-byte pieces otherwise; zero-filled past B, C and D).  While
//    the first chunk lands, four threads a row sum the block's Σx² and keep
//    1 / sqrtf(Σx²) per row; each landed chunk of image rows is scaled by it
//    in shared memory before any product, as JAX normalizes first.  Each
//    thread keeps a [kTM × kTN] register tile of sums and adds one IEEE
//    fp32 FMA per element of D, in order; its rows and classes are strided
//    by the thread grid, so the float4 reads of a staged chunk hit
//    distinct banks.  The logits go to a [B, C] fp32 workspace (512 KB at
//    B = 128, which stays in the 50 MB L2).
// 2. reduce: one block per row reads its logits row back and applies
//    exactly the plain version's formulas (entropy and var need every p of
//    the row, hence a full row rather than an online softmax).
//
// The wrapper allocates the workspace with torch.empty on the current
// stream.  Nothing here depends on C beyond the grid, so any C ≥ 1 runs.
// Built without --use_fast_math: sqrtf, the divisions, expf and logf are
// the IEEE ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;             // image rows of a logits block
constexpr int kBN = 32;             // classes of a logits block
constexpr int kBK = 32;             // elements of D per staged chunk
constexpr int kLd = kBK + 4;        // row stride of a staged chunk (floats)
constexpr int kTM = 4, kTN = 2;     // a thread's register tile
constexpr int kThreadsN = kBN / kTN;
constexpr int kThreadsM = kBM / kTM;
constexpr int kThreads = kThreadsM * kThreadsN;
constexpr int kReduceThreads = 256;
constexpr int kReduceWarps = kReduceThreads / 32;

enum Score { kMCM = 0, kMaxLogit = 1, kEnergy = 2, kEntropy = 3, kVar = 4 };

// max that propagates NaN like torch.amax (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return nan_max(a, b); }
};
struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

template <typename Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// every thread of the block gets the reduction of v over the block
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* scratch, Op op) {
  v = warp_reduce(v, op);
  __syncthreads();  // the previous reduction's reads of scratch are done
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kReduceWarps; ++w) r = op(r, scratch[w]);
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- 1. logits ---------------------------------------------------------------

// Stage chunk k0 .. k0 + kBK of rows r0 .. r0 + 32 of the [n, D] matrix src
// into tile (zeros past n and D).
template <bool VEC>
__device__ __forceinline__ void stage_rows(float (*tile)[kLd], const float* __restrict__ src,
                                           int r0, int n, int k0, int D) {
  // consecutive threads take consecutive pieces of a row: coalesced
  constexpr int kPieces = VEC ? kBK / 4 : kBK;  // pieces of a row's chunk
  constexpr int kWidth = kBK / kPieces;           // floats in a piece
  static_assert(32 * kPieces % kThreads == 0, "whole rounds of pieces");
#pragma unroll
  for (int it = 0; it < 32 * kPieces / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kPieces, k = (i % kPieces) * kWidth;
    // D % 4 == 0 under VEC: a piece lies wholly inside D or wholly past it
    const bool ok = r0 + r < n && k0 + k < D;
    const float* p = ok ? src + (size_t)(r0 + r) * D + k0 + k : src;
    if constexpr (VEC) {
      cp_async16(&tile[r][k], p, ok);
    } else {
      cp_async4(&tile[r][k], p, ok);
    }
  }
}

// inv[r] = 1 / sqrtf(Σx²) of rows r0 .. r0 + kBM of img (0 past B): kPer
// consecutive lanes share a row and combine their sums by shuffles.
template <bool VEC>
__device__ __forceinline__ void row_norms(const float* __restrict__ img, int r0, int B, int D,
                                          float* inv) {
  constexpr int kPer = kThreads / kBM;
  static_assert(kThreads % kBM == 0 && 32 % kPer == 0, "a row's threads share a warp");
  const int r = threadIdx.x / kPer, q = threadIdx.x % kPer;
  float ss = 0.f;
  if (r0 + r < B) {
    const float* x = img + (size_t)(r0 + r) * D;
    if constexpr (VEC) {
#pragma unroll 8
      for (int d = q * 4; d < D; d += kPer * 4) {
        const float4 v = *reinterpret_cast<const float4*>(x + d);
        ss = fmaf(v.x, v.x, ss);
        ss = fmaf(v.y, v.y, ss);
        ss = fmaf(v.z, v.z, ss);
        ss = fmaf(v.w, v.w, ss);
      }
    } else {
#pragma unroll 8
      for (int d = q; d < D; d += kPer) ss = fmaf(x[d], x[d], ss);
    }
  }
#pragma unroll
  for (int o = 1; o < kPer; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (q == 0) inv[r] = r0 + r < B ? 1.0f / sqrtf(ss) : 0.f;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
logits_kernel(const float* __restrict__ img, const float* __restrict__ txt,
              float* __restrict__ logits, int B, int C, int D) {
  static_assert(kBM == 32 && kBN == 32, "stage_rows stages 32 rows");
  __shared__ __align__(16) float xs[2][kBM][kLd];
  __shared__ __align__(16) float ts[2][kBN][kLd];
  __shared__ float inv[kBM];

  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % kThreadsN;  // classes tx + j·kThreadsN
  const int ty = threadIdx.x / kThreadsN;  // rows ty + i·kThreadsM

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int chunks = (D + kBK - 1) / kBK;
  stage_rows<VEC>(xs[0], img, row0, B, 0, D);
  stage_rows<VEC>(ts[0], txt, col0, C, 0, D);
  cp_async_commit();
  row_norms<VEC>(img, row0, B, D, inv);  // while chunk 0 lands
  for (int kc = 0; kc < chunks; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < chunks) {
      stage_rows<VEC>(xs[s ^ 1], img, row0, B, (kc + 1) * kBK, D);
      stage_rows<VEC>(ts[s ^ 1], txt, col0, C, (kc + 1) * kBK, D);
    }
    cp_async_commit();  // empty on the last chunk, so that wait<1> holds
    cp_async_wait<1>();  // chunk kc has landed
    __syncthreads();
    // normalize the landed image rows: x · (1 / sqrtf(Σx²)), before any
    // product (a zero row becomes NaN, as in the plain version)
#pragma unroll
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      xs[s][i / kBK][i % kBK] *= inv[i / kBK];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float4 a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(&xs[s][ty + i * kThreadsM][k]);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        b[j] = *reinterpret_cast<const float4*>(&ts[s][tx + j * kThreadsN][k]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
    __syncthreads();  // buffer s is free for chunk kc + 2
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + i * kThreadsM;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + j * kThreadsN;
      if (c < C) logits[(size_t)r * C + c] = acc[i][j];
    }
  }
}

// -- 2. reduce ---------------------------------------------------------------

template <int SCORE>
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ logits, float* __restrict__ out, int C, float T) {
  __shared__ float scratch[kReduceWarps];
  const float* l = logits + (size_t)blockIdx.x * C;

  if (SCORE == kMaxLogit) {
    float raw_max = -INFINITY;
    for (int c = threadIdx.x; c < C; c += kReduceThreads) raw_max = nan_max(raw_max, l[c]);
    raw_max = block_reduce(raw_max, scratch, Max());
    if (threadIdx.x == 0) out[blockIdx.x] = -raw_max;
    return;
  }
  float m = -INFINITY;
  for (int c = threadIdx.x; c < C; c += kReduceThreads) m = nan_max(m, l[c] / T);
  m = block_reduce(m, scratch, Max());
  float z = 0.f;
  for (int c = threadIdx.x; c < C; c += kReduceThreads) z += expf(l[c] / T - m);
  z = block_reduce(z, scratch, Sum());

  float result = 0.f;
  if (SCORE == kMCM) {
    float pmax = -INFINITY;
    for (int c = threadIdx.x; c < C; c += kReduceThreads)
      pmax = nan_max(pmax, expf(l[c] / T - m) / z);
    result = -block_reduce(pmax, scratch, Max());
  } else if (SCORE == kEnergy) {
    result = -(T * (logf(z) + m));
  } else if (SCORE == kEntropy) {
    float psum = 0.f, h = 0.f;
    for (int c = threadIdx.x; c < C; c += kReduceThreads) {
      const float p = expf(l[c] / T - m) / z;
      psum += p;
      if (p > 0.f) h += p * logf(p);
    }
    psum = block_reduce(psum, scratch, Sum());
    h = block_reduce(h, scratch, Sum());
    result = isnan(psum) ? NAN : -h;
  } else {  // kVar
    float psum = 0.f;
    for (int c = threadIdx.x; c < C; c += kReduceThreads) psum += expf(l[c] / T - m) / z;
    const float mean = block_reduce(psum, scratch, Sum()) / (float)C;
    float sq = 0.f;
    for (int c = threadIdx.x; c < C; c += kReduceThreads) {
      const float dev = expf(l[c] / T - m) / z - mean;
      sq = fmaf(dev, dev, sq);
    }
    result = -(block_reduce(sq, scratch, Sum()) / (float)C);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = result;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int SCORE>
int launch(const float* img, const float* txt, float* logits, float* out, int B, int C, int D,
           float T, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && aligned16(img) && aligned16(txt);
  const dim3 grid((C + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (vec) {
    logits_kernel<true><<<grid, kThreads, 0, stream>>>(img, txt, logits, B, C, D);
  } else {
    logits_kernel<false><<<grid, kThreads, 0, stream>>>(img, txt, logits, B, C, D);
  }
  reduce_kernel<SCORE><<<B, kReduceThreads, 0, stream>>>(logits, out, C, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// score: 0 MCM, 1 max-logit, 2 energy, 3 entropy, 4 var.  img [B, D] and
// txt [C, D] are contiguous fp32; logits [B, C] is an fp32 workspace; out
// is [B] fp32.  Returns the cudaError_t of the launches (0 = success).
int mcm_score(const float* img, const float* txt, float* logits, float* out, int B, int C,
              int D, float T, int score, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  switch (score) {
    case kMCM: return launch<kMCM>(img, txt, logits, out, B, C, D, T, s);
    case kMaxLogit: return launch<kMaxLogit>(img, txt, logits, out, B, C, D, T, s);
    case kEnergy: return launch<kEnergy>(img, txt, logits, out, B, C, D, T, s);
    case kEntropy: return launch<kEntropy>(img, txt, logits, out, B, C, D, T, s);
    case kVar: return launch<kVar>(img, txt, logits, out, B, C, D, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mcm_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
