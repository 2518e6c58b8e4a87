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
// Bound on an H100 at the main-path shape (B = 512, C = 1000, D = 512):
// 0.52 GFLOP of fp32 outside the tensor cores (7.8 µs at 67 TFLOP/s)
// against 3.1 MB of traffic (0.9 µs at 3.35 TB/s): compute-bound, about
// 7.8 µs per launch.
//
// Design: one block per kRows image rows.  The rows are normalized into
// shared memory; each thread takes classes c = tid, tid + kThreads, ... and
// computes its logits for all kRows rows at once, so each text row (2 MB
// in all at C = 1000, resident in L2) is read once per kRows images; the
// logits land in a [kRows, C] shared array.  Then warp r reduces row r with
// shuffles.  Shared memory is kRows·(C + D)·4 bytes plus a small scratch,
// which mcm_score_smem_bytes reports so that the caller's gate matches
// what the kernel allocates.  Built without --use_fast_math: sqrtf, the
// divisions, expf and logf are the IEEE ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;
static_assert(kRows <= kWarps, "one warp reduces one row");

enum Score { kMCM = 0, kMaxLogit = 1, kEnergy = 2, kEntropy = 3, kVar = 4 };

// max that propagates NaN like jnp.max (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int C, int D) {
  return (size_t)kRows * (C + D) * sizeof(float) + (size_t)kRows * kWarps * sizeof(float);
}

template <int SCORE>
__global__ void __launch_bounds__(kThreads)
mcm_score_kernel(const float* __restrict__ img, const float* __restrict__ txt,
                 float* __restrict__ out, int B, int C, int D, float T) {
  extern __shared__ __align__(16) float smem[];
  float* x = smem;                        // [kRows, D] normalized rows
  float* logits = x + kRows * D;          // [kRows, C]
  float* scratch = logits + kRows * C;    // [kRows, kWarps]

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // -- L2-normalize the rows ------------------------------------------------
  float ss[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ss[r] = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float val = r < rows ? img[(size_t)(row0 + r) * D + d] : 0.f;
      x[r * D + d] = val;
      ss[r] = fmaf(val, val, ss[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float s = warp_sum(ss[r]);
    if (lane == 0) scratch[r * kWarps + warp] = s;
  }
  __syncthreads();
  float inv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[r * kWarps + w];
    inv[r] = 1.0f / sqrtf(s);
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r * D + d] *= inv[r];
  }
  __syncthreads();

  // -- logits: each text row is read once for all kRows image rows ----------
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float* t = txt + (size_t)c * D;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float tv = __ldg(t + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(x[r * D + d], tv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) logits[r * C + c] = acc[r];
  }
  __syncthreads();

  // -- warp r reduces row r --------------------------------------------------
  if (warp >= rows) return;
  const float* l = logits + warp * C;
  float m = -INFINITY, raw_max = -INFINITY;
  for (int c = lane; c < C; c += 32) {
    m = nan_max(m, l[c] / T);
    raw_max = nan_max(raw_max, l[c]);
  }
  m = warp_max(m);
  raw_max = warp_max(raw_max);
  float z = 0.f;
  for (int c = lane; c < C; c += 32) z += expf(l[c] / T - m);
  z = warp_sum(z);

  float result;
  if (SCORE == kMCM) {
    float pmax = -INFINITY;
    for (int c = lane; c < C; c += 32) pmax = nan_max(pmax, expf(l[c] / T - m) / z);
    result = -warp_max(pmax);
  } else if (SCORE == kMaxLogit) {
    result = -raw_max;
  } else if (SCORE == kEnergy) {
    result = -(T * (logf(z) + m));
  } else if (SCORE == kEntropy) {
    float psum = 0.f, h = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float p = expf(l[c] / T - m) / z;
      psum += p;
      if (p > 0.f) h += p * logf(p);
    }
    psum = warp_sum(psum);
    h = warp_sum(h);
    result = isnan(psum) ? NAN : -h;
  } else {  // kVar
    float psum = 0.f;
    for (int c = lane; c < C; c += 32) psum += expf(l[c] / T - m) / z;
    const float mean = warp_sum(psum) / (float)C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dev = expf(l[c] / T - m) / z - mean;
      sq = fmaf(dev, dev, sq);
    }
    result = -(warp_sum(sq) / (float)C);
  }
  if (lane == 0) out[row0 + warp] = result;
}

template <int SCORE>
int launch(const float* img, const float* txt, float* out, int B, int C, int D,
           float T, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, D);
  cudaError_t err = cudaFuncSetAttribute(mcm_score_kernel<SCORE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kRows - 1) / kRows;
  mcm_score_kernel<SCORE><<<blocks, kThreads, smem, stream>>>(img, txt, out, B, C, D, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at (C, D).
size_t mcm_score_smem_bytes(int C, int D) { return smem_bytes(C, D); }

// score: 0 MCM, 1 max-logit, 2 energy, 3 entropy, 4 var.  img [B, D] and
// txt [C, D] are contiguous fp32; out is [B] fp32.  Returns the
// cudaError_t of the launch (0 = success).
int mcm_score(const float* img, const float* txt, float* out, int B, int C,
              int D, float T, int score, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  switch (score) {
    case kMCM: return launch<kMCM>(img, txt, out, B, C, D, T, s);
    case kMaxLogit: return launch<kMaxLogit>(img, txt, out, B, C, D, T, s);
    case kEnergy: return launch<kEnergy>(img, txt, out, B, C, D, T, s);
    case kEntropy: return launch<kEntropy>(img, txt, out, B, C, D, T, s);
    case kVar: return launch<kVar>(img, txt, out, B, C, D, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mcm_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
