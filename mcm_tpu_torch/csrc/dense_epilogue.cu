// The epilogue of the towers' dense products in one pass: fp32 product plus
// fp32 bias, rounded to bf16, then QuickGELU or the residual add; or the erf
// GELU of the fp32 sum, then rounded.
//
// Replaces no TPU kernel.  On the TPU, XLA fuses the bias add, the rounding,
// QuickGELU and the residual add of mcm_tpu/models/clip.py::_dense and
// transformer_block into the dot's epilogue.  The port takes the product from
// cuBLAS with an fp32 output (torch.mm(..., out_dtype=float32)); this kernel
// is everything between that product and its next consumer, with the
// roundings of the plain chain
// (mcm_tpu_torch/ops/dense_epilogue.py::epilogue_reference), so its output is
// bit-equal to the chain's on the same product.  Per element, column c:
//   mode 0 bias:            out = bf16(acc + b[c])
//   mode 1 bias_quick_gelu: y = bf16(acc + b[c]); t = bf16(y * 1.703125f);
//                           s = bf16(1 / (1 + expf(-t))); out = bf16(y * s)
//   mode 2 bias_residual:   y = bf16(acc + b[c]); out = bf16(r + y)
//   mode 3 bias_gelu:       x = acc + b[c];
//                           out = bf16((x * 0.5f) * (1 + erff(x * 0.70710677f)))
// 1.703125 is 1.702 rounded to bf16 (JAX's weak typing of the scalar, which
// the chain copies); the sigmoid and the GELU are ATen's CUDA formulas in
// fp32 (F.gelu, approximate="none").  The library is built without
// --use_fast_math, so expf, erff and the division are the accurate ones, and
// every add, multiply and rounding is written as its round-to-nearest
// intrinsic, so nothing is contracted into an FMA.
//
// Bound on an H100: bytes.  An element reads 4 B of product, writes 2 B and,
// in mode 2, reads 2 B of residual: at ViT-L/14's fc1 site (B = 512,
// [131584, 4096]) 3.23 GB, 0.965 ms at 3.35 TB/s; at ViT-bigG/14's (B = 512,
// [131584, 8192], mode 3) 6.47 GB, 1.93 ms.  Mode 3's erff costs ~20 fp32
// instructions an element, under the bytes' time at the card's fp32 rate.
// Design:
// - a block owns a tile of 8 rows by 256 columns: a warp a row, a thread 8
//   columns as two runs of 4 that lie 128 apart, so that each load and store
//   instruction of a warp covers one contiguous span (512 B of product,
//   256 B of bf16) and the thread's loads are all in flight before its math;
// - a thread reads its 8 biases once;
// - the grid covers the columns in x and the row tiles in y, one tile a block
//   while they fit in y (to 524,280 rows), walking further rows grid-stride;
//   one tile a block measured 5-10 % faster on the card than a grid-stride
//   walk by one wave of resident blocks, and loads through the read-only
//   path 2-5 % faster than with the streaming hint;
// - N % 4 != 0, or a pointer off its vector's alignment, takes a scalar
//   kernel, one element a thread (the tests' odd widths).
// A launch's name in the device trace carries its mode as the template
// argument: tile_kernel<3> and scalar_kernel<3> are bias_gelu's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

enum Mode { kBias = 0, kBiasQuickGelu = 1, kBiasResidual = 2, kBiasGelu = 3 };

constexpr int kChunk = 4;                          // columns of one fp32 load
constexpr int kColThreads = 32;                    // a warp across a tile
constexpr int kRowThreads = 8;                     // rows of a tile
constexpr int kTileCols = 2 * kChunk * kColThreads;  // 256
constexpr int kThreads = kColThreads * kRowThreads;
constexpr long long kMaxGridY = 65535;
constexpr long long kMaxScalarBlocks = 1 << 16;
constexpr float kQuickGeluScale = 1.703125f;  // 1.702 rounded to bf16
constexpr float kSqrtHalf = 0.70710678118654752440f;  // ATen's M_SQRT1_2

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One element, with the plain chain's roundings; r is the residual (mode 2).
template <int MODE>
__device__ __forceinline__ __nv_bfloat16 epilogue(float acc, float bias, float r) {
  const float sum = __fadd_rn(acc, bias);
  if (MODE == kBias) return __float2bfloat16_rn(sum);
  if (MODE == kBiasGelu) {
    const float e = erff(__fmul_rn(sum, kSqrtHalf));
    return __float2bfloat16_rn(__fmul_rn(__fmul_rn(sum, 0.5f), __fadd_rn(1.0f, e)));
  }
  const float y = round_bf16(sum);
  if (MODE == kBiasResidual) return __float2bfloat16_rn(__fadd_rn(r, y));
  const float t = round_bf16(__fmul_rn(y, kQuickGeluScale));
  const float s = round_bf16(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-t))));
  return __float2bfloat16_rn(__fmul_rn(y, s));
}

__device__ __forceinline__ float low_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const float* __restrict__ acc, const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
                long long rows, long long cols) {
  const long long c0 = (long long)blockIdx.x * kTileCols + kChunk * threadIdx.x;
  if (c0 >= cols) return;
  const long long c[2] = {c0, c0 + kTileCols / 2};
  const bool live1 = c[1] < cols;
  const float4 b[2] = {__ldg(reinterpret_cast<const float4*>(bias + c[0])),
                       live1 ? __ldg(reinterpret_cast<const float4*>(bias + c[1]))
                             : make_float4(0.f, 0.f, 0.f, 0.f)};
  const long long stride = (long long)gridDim.y * kRowThreads;
  for (long long r = (long long)blockIdx.y * kRowThreads + threadIdx.y; r < rows; r += stride) {
    const long long row = r * cols;
    float4 a[2] = {};
    uint2 rw[2] = {};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 0 || live1) {
        a[k] = __ldg(reinterpret_cast<const float4*>(acc + row + c[k]));
        if (MODE == kBiasResidual) rw[k] = __ldg(reinterpret_cast<const uint2*>(res + row + c[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 0 || live1) {
        const uint32_t lo = pack(epilogue<MODE>(a[k].x, b[k].x, low_bf16(rw[k].x)),
                                 epilogue<MODE>(a[k].y, b[k].y, high_bf16(rw[k].x)));
        const uint32_t hi = pack(epilogue<MODE>(a[k].z, b[k].z, low_bf16(rw[k].y)),
                                 epilogue<MODE>(a[k].w, b[k].w, high_bf16(rw[k].y)));
        *reinterpret_cast<uint2*>(out + row + c[k]) = make_uint2(lo, hi);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    scalar_kernel(const float* __restrict__ acc, const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
                  long long rows, long long cols) {
  const long long n = rows * cols;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float r = MODE == kBiasResidual ? __bfloat162float(res[i]) : 0.0f;
    out[i] = epilogue<MODE>(acc[i], bias[i % cols], r);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

long long div_up(long long a, long long b) { return (a + b - 1) / b; }

template <int MODE>
int launch(const float* acc, const float* bias, const __nv_bfloat16* res, __nv_bfloat16* out,
           long long rows, long long cols, cudaStream_t stream) {
  const bool vec = cols % kChunk == 0 && aligned(acc, 16) && aligned(bias, 16) &&
                   aligned(out, 8) && (MODE != kBiasResidual || aligned(res, 8));
  if (vec) {
    const long long gx = div_up(cols, kTileCols);
    if (gx > INT_MAX) return (int)cudaErrorInvalidValue;
    const long long tiles = div_up(rows, kRowThreads);
    const long long gy = tiles < kMaxGridY ? tiles : kMaxGridY;
    tile_kernel<MODE><<<dim3((unsigned)gx, (unsigned)gy), dim3(kColThreads, kRowThreads), 0,
                        stream>>>(acc, bias, res, out, rows, cols);
  } else {
    const long long blocks = div_up(rows * cols, kThreads);
    const long long grid = blocks < kMaxScalarBlocks ? blocks : kMaxScalarBlocks;
    scalar_kernel<MODE><<<(unsigned)grid, kThreads, 0, stream>>>(acc, bias, res, out, rows, cols);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// acc [rows, cols] fp32, bias [cols] fp32, residual [rows, cols] bf16 (mode
// 2 only; may be null otherwise), out [rows, cols] bf16, all contiguous on the
// current device.  mode: 0 bias, 1 bias_quick_gelu, 2 bias_residual,
// 3 bias_gelu.  Returns the cudaError_t of the launch (0 = success).
int mcm_dense_epilogue(const float* acc, const float* bias, const void* residual, void* out,
                       long long rows, long long cols, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(residual);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  switch (mode) {
    case kBias: return launch<kBias>(acc, bias, r, o, rows, cols, s);
    case kBiasQuickGelu: return launch<kBiasQuickGelu>(acc, bias, r, o, rows, cols, s);
    case kBiasResidual:
      if (r == nullptr) return (int)cudaErrorInvalidValue;
      return launch<kBiasResidual>(acc, bias, r, o, rows, cols, s);
    case kBiasGelu: return launch<kBiasGelu>(acc, bias, r, o, rows, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mcm_dense_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
