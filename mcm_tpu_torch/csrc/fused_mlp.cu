// Fused transformer MLP: [M, D] → fc1 [D, F] + b1 → activation → fc2
// [F, D] + b2 → [M, D], with the [M, F] intermediate never written to
// device memory.
//
// Replaces the TPU kernel mcm_tpu/ops/mlp.py::_mlp_kernel (called through
// fused_mlp).  Numerics are the TPU kernel's:
//   * h = x·w1 accumulated in fp32 from input-type products, plus b1 in fp32;
//   * QuickGELU h·sigmoid(1.702h) or exact-erf GELU, in fp32;
//   * h rounded to the input type (not the unfused chain's rounding, which
//     rounds after fc1 and runs QuickGELU in bf16);
//   * h·w2 accumulated in fp32, plus b2 in fp32, cast to the input type.
//
// Bound on an H100: operations.  4·M·D·F FLOP (two products) against
// 2·M·D + 2·D·F elements of traffic; at the ViT-B/16 shape of a B = 128
// image batch (M = 25,216, D = 768, F = 3,072, bf16) that is 238 GFLOP
// (0.24 ms at 989 TFLOP/s) against 87 MB (0.026 ms at 3.35 TB/s).
//
// The TPU kernel keeps both weight matrices resident in VMEM (9.4 MB bf16
// at B/16).  A Hopper block has 227 KB of shared memory, so here:
//   * one block owns a tile of rows and loops over F in chunks; per chunk
//     it computes h = act(x_tile · w1[:, f0:f1] + b1) into shared memory,
//     rounds it, and accumulates h · w2[f0:f1, :] into an fp32 [rows, D]
//     accumulator; the weights stream through L2 chunk by chunk, and the
//     x tile stays in shared memory for the whole loop;
//   * bf16 with D a multiple of 128 (up to 1024) and F a multiple of the
//     chunk: tensor cores through nvcuda::wmma (16×16×16 bf16 → fp32).
//     8 warps; in fc1 each warp owns one 16×16 fragment of the h chunk, in
//     fc2 each warp owns D/8 output columns for all rows of the tile, kept
//     in registers (32 rows at D ≤ 768, 16 rows above, so that the
//     accumulator stays at ≤ 96 fp32 registers a thread).  Weight
//     fragments are read straight from device memory (L2), no staging;
//   * every other shape, and fp32 (parity mode), takes a CUDA-core kernel
//     of 16 rows a block with the accumulator in shared memory: IEEE fp32
//     FMAs, no TF32.
// Built without --use_fast_math: expf, erff and the division are IEEE.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// act: 0 = QuickGELU, 1 = exact-erf GELU
__device__ __forceinline__ float activate(float h, int act) {
  if (act == 0) return h * (1.f / (1.f + expf(-1.702f * h)));
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// -- tensor-core kernel (bf16) ----------------------------------------------

template <int BMF>
struct WmmaShape {
  static constexpr int kRows = 16 * BMF;            // rows of x a block owns
  static constexpr int kChunk = 128 / BMF;          // F columns per chunk: 8 fragments
  static constexpr int kChunkFrags = kChunk / 16;
  static constexpr int kHLd = kChunk + 8;           // padded h row (elements)
};

template <int BMF, int NF>
size_t wmma_smem_bytes() {
  using Sh = WmmaShape<BMF>;
  constexpr int D = 128 * NF;
  return (size_t)Sh::kRows * (D + 8) * sizeof(bf16)      // x tile
         + (size_t)Sh::kRows * Sh::kHLd * sizeof(bf16)   // rounded h chunk
         + (size_t)kWarps * 256 * sizeof(float);         // per-warp fragment scratch
}

template <int BMF, int NF>
__global__ void __launch_bounds__(kThreads)
fused_mlp_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ w2,
                      const float* __restrict__ b2, bf16* __restrict__ out,
                      int M, int F, int act) {
  using namespace nvcuda;
  using Sh = WmmaShape<BMF>;
  constexpr int D = 128 * NF;
  constexpr int kXLd = D + 8;  // padded x row: rows start on distinct banks
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + Sh::kRows * kXLd;
  float* scratch = reinterpret_cast<float*>(hs + Sh::kRows * Sh::kHLd);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long m0 = (long long)blockIdx.x * Sh::kRows;
  float* wscratch = scratch + warp * 256;

  // -- x tile into shared memory, 16-byte vectors; rows past M are zero -----
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < Sh::kRows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (m0 + r) * D + c);
    *reinterpret_cast<uint4*>(xs + r * kXLd + c) = val;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BMF][NF];
#pragma unroll
  for (int i = 0; i < BMF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // fc1 fragment of this warp within the chunk
  const int hr = warp / Sh::kChunkFrags;
  const int hc = warp % Sh::kChunkFrags;
  // fc2 output columns of this warp
  const int col0 = warp * NF * 16;

  for (int f0 = 0; f0 < F; f0 += Sh::kChunk) {
    // -- fc1: h[hr, hc] = x_tile[hr rows] · w1[:, f0 + hc·16 ...] --------------
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
      wmma::fill_fragment(hacc, 0.f);
      const bf16* wcol = w1 + f0 + hc * 16;
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, xs + hr * 16 * kXLd + k, kXLd);
        wmma::load_matrix_sync(b, wcol + (size_t)k * F, F);
        wmma::mma_sync(hacc, a, b, hacc);
      }
      wmma::store_matrix_sync(wscratch, hacc, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane * 8 + e;
        const int r = idx / 16, c = idx % 16;
        const float h = activate(wscratch[idx] + b1[f0 + hc * 16 + c], act);
        hs[(hr * 16 + r) * Sh::kHLd + hc * 16 + c] = __float2bfloat16_rn(h);
      }
    }
    __syncthreads();

    // -- fc2: acc[:, col0 ...] += h_chunk · w2[f0 ..., col0 ...] ----------------
#pragma unroll
    for (int k = 0; k < Sh::kChunk; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[BMF];
#pragma unroll
      for (int i = 0; i < BMF; ++i)
        wmma::load_matrix_sync(a[i], hs + i * 16 * Sh::kHLd + k, Sh::kHLd);
      const bf16* wrow = w2 + (size_t)(f0 + k) * D + col0;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wrow + j * 16, D);
#pragma unroll
        for (int i = 0; i < BMF; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();  // the next chunk's fc1 overwrites hs
  }

  // -- epilogue: + b2, cast, store the rows that exist ------------------------
#pragma unroll
  for (int i = 0; i < BMF; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(wscratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane * 8 + e;
        const int r = idx / 16, c = idx % 16;
        const long long row = m0 + i * 16 + r;
        const int col = col0 + j * 16 + c;
        if (row < M) out[row * D + col] = __float2bfloat16_rn(wscratch[idx] + b2[col]);
      }
      __syncwarp();  // the next fragment reuses the scratch
    }
  }
}

template <int BMF, int NF>
int launch_wmma(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int M, int F, int act, cudaStream_t stream) {
  const size_t smem = wmma_smem_bytes<BMF, NF>();
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_wmma_kernel<BMF, NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = WmmaShape<BMF>::kRows;
  const unsigned blocks = (unsigned)((M + rows - 1) / rows);
  fused_mlp_wmma_kernel<BMF, NF><<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), M, F, act);
  return (int)cudaGetLastError();
}

// BMF = 2 (32 rows) while the accumulator fits 96 registers, else 1.
#define MCM_MLP_NF_CASES(X) \
  X(1, 2) X(2, 2) X(3, 2) X(4, 2) X(5, 2) X(6, 2) X(7, 1) X(8, 1)

int wmma_rows_frags(int D) {
  switch (D / 128) {
#define X(nf, bmf) case nf: return bmf;
    MCM_MLP_NF_CASES(X)
#undef X
  }
  return 0;
}

bool wmma_takes(int D, int F, int dtype) {
  if (dtype != 1 || D % 128 != 0 || D < 128 || D > 1024 || F <= 0) return false;
  return F % (128 / wmma_rows_frags(D)) == 0;
}

size_t wmma_smem(int D) {
  switch (D / 128) {
#define X(nf, bmf) case nf: return wmma_smem_bytes<bmf, nf>();
    MCM_MLP_NF_CASES(X)
#undef X
  }
  return 0;
}

int dispatch_wmma(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, int M, int D, int F, int act,
                  cudaStream_t stream) {
  switch (D / 128) {
#define X(nf, bmf) \
  case nf: return launch_wmma<bmf, nf>(x, w1, b1, w2, b2, out, M, F, act, stream);
    MCM_MLP_NF_CASES(X)
#undef X
  }
  return (int)cudaErrorInvalidValue;
}

// -- CUDA-core kernel (fp32, and bf16 shapes the tensor-core kernel does not
// take) ------------------------------------------------------------------------

constexpr int kSimtRows = 16;
constexpr int kSimtChunk = 32;

size_t simt_smem(int D) {
  // x tile and accumulator, fp32 [rows, D] each, plus the h chunk
  return (size_t)kSimtRows * D * 2 * sizeof(float)
         + (size_t)kSimtRows * kSimtChunk * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_mlp_simt_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const float* __restrict__ b2, T* __restrict__ out,
                      int M, int D, int F, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [rows, D]
  float* acc = xs + kSimtRows * D;              // [rows, D]
  float* hs = acc + kSimtRows * D;              // [rows, chunk], rounded to T

  const long long m0 = (long long)blockIdx.x * kSimtRows;
  for (int i = threadIdx.x; i < kSimtRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    xs[i] = m0 + r < M ? to_f32(x[(m0 + r) * D + c]) : 0.f;
    acc[i] = 0.f;
  }
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += kSimtChunk) {
    const int nf = min(kSimtChunk, F - f0);
    // fc1: a warp takes one row and 32 neighbouring columns of w1
    for (int o = threadIdx.x; o < kSimtRows * kSimtChunk; o += kThreads) {
      const int r = o / kSimtChunk, c = o % kSimtChunk;
      float h = 0.f;
      if (c < nf) {
        const float* xr = xs + r * D;
        const T* wc = w1 + f0 + c;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(xr[d], to_f32(wc[(size_t)d * F]), s);
        h = to_f32(from_f32<T>(activate(s + b1[f0 + c], act)));
      }
      hs[o] = h;
    }
    __syncthreads();
    // fc2: a thread owns output columns col, col + 256, ... of every row
    for (int col = threadIdx.x; col < D; col += kThreads) {
      float wv[kSimtChunk];
#pragma unroll
      for (int f = 0; f < kSimtChunk; ++f)
        wv[f] = f < nf ? to_f32(w2[(size_t)(f0 + f) * D + col]) : 0.f;
      for (int r = 0; r < kSimtRows; ++r) {
        float a = acc[r * D + col];
#pragma unroll
        for (int f = 0; f < kSimtChunk; ++f) a = fmaf(hs[r * kSimtChunk + f], wv[f], a);
        acc[r * D + col] = a;
      }
    }
    __syncthreads();  // the next chunk overwrites hs
  }

  for (int i = threadIdx.x; i < kSimtRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (m0 + r < M) out[(m0 + r) * D + c] = from_f32<T>(acc[i] + b2[c]);
  }
}

template <typename T>
int launch_simt(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int M, int D, int F, int act,
                cudaStream_t stream) {
  const size_t smem = simt_smem(D);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_simt_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + kSimtRows - 1) / kSimtRows);
  fused_mlp_simt_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<T*>(out),
      M, D, F, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when (D, F, dtype) runs on the tensor-core kernel, 0 for the CUDA-core
// one.  dtype: 0 = float32, 1 = bfloat16.
int mcm_fused_mlp_tensor_cores(int D, int F, int dtype) {
  return wmma_takes(D, F, dtype) ? 1 : 0;
}

// Bytes of dynamic shared memory one block takes at (D, F, dtype).
size_t mcm_fused_mlp_smem_bytes(int D, int F, int dtype) {
  return wmma_takes(D, F, dtype) ? wmma_smem(D) : simt_smem(D);
}

// x [M, D], w1 [D, F], b1 [F] fp32, w2 [F, D], b2 [D] fp32, out [M, D];
// all contiguous, x/w1/w2/out 32-byte aligned.  act: 0 = QuickGELU,
// 1 = exact-erf GELU.  Returns the cudaError_t of the launch (0 = success).
int mcm_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* b2, void* out, int M, int D, int F, int act,
                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  if (D <= 0 || F <= 0 || (act != 0 && act != 1)) return (int)cudaErrorInvalidValue;
  if (wmma_takes(D, F, dtype)) return dispatch_wmma(x, w1, b1, w2, b2, out, M, D, F, act, s);
  if (dtype == 0) return launch_simt<float>(x, w1, b1, w2, b2, out, M, D, F, act, s);
  if (dtype == 1) return launch_simt<bf16>(x, w1, b1, w2, b2, out, M, D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcm_fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
