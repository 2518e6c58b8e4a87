// LayerNorm of the towers in one pass: read each bf16 row once, keep the row
// and its fp32 mean and variance in registers, write the bf16 row once.
//
// Replaces no TPU kernel.  The JAX package writes LayerNorm as plain jnp
// (mcm_tpu/models/clip.py::layer_norm) and XLA fuses it into one pass on the
// TPU.  Eager PyTorch runs the same chain
// (mcm_tpu_torch/ops/layer_norm.py::layer_norm_reference) as about ten
// passes over device memory, ~68 B an element.  This kernel makes every
// rounding of that chain at the same place, per row of width C:
//   mean = fp32 sum of x, times `factor`;
//   d    = x - mean;                     (fp32, kept in registers)
//   var  = fp32 sum of d * d, times `factor`  (two passes over the registers,
//                                             no Welford, no E[x^2] - mean^2)
//   rstd = rsqrtf(var + eps);
//   out  = bf16(((d * rstd) * scale[c]) + bias[c])
// `factor` is ATen's mean factor, float(rows) / float(rows * C), which the
// wrapper computes as ATen does.  Each add and multiply is written as its
// round-to-nearest intrinsic, so nothing is contracted into an FMA; the
// library is built without --use_fast_math, so rsqrtf is the same
// rsqrt.approx.f32 that ATen's rsqrt kernel runs.
//
// The sums are taken in the order of ATen's reduce kernel
// (ATen/native/cuda/Reduce.cuh, setReduceConfig and ReduceOp) for a float
// mean over a contiguous last dimension with C % 128 == 0: a row belongs to
// W lanes; lane l reads the vectors of 4 columns l, l + W, l + 2W, ..., and
// keeps one sum per column of the vector, each from 0 in that order; it adds
// the four as ((s0 + s1) + s2) + s3; lanes above 32 fold into the first 32
// through shared memory, halving from W / 2 down to 32; the warp sums with
// __shfl_down_sync at offsets 16, 8, 4, 2, 1, and lane 0's is the row's.
// W is 32 from 16 rows on, and min(pow2(C / 4), 512 / pow2(rows)) below.
// That is the order of PyTorch 2.11, the card host's (earlier releases ran
// the warp's offsets upward, 1 to 16).  So the output is bit-equal to the
// chain's on the card, which tests/test_torch_kernels_gpu.py holds.
//
// Bound on an H100: bytes.  An element reads 2 B and writes 2 B: 4 B, plus
// the fp32 scale and bias (8 B a column) read once a block.  ViT-L/14 at B =
// 512, [131584, 1024]: 539 MB, 0.161 ms at 3.35 TB/s; ViT-bigG/14, [131584,
// 1664]: 876 MB, 0.261 ms.  The arithmetic (~8 fp32 operations an element
// and two 5-step shuffles a row) is far below the bytes' time.
// Design:
// - from 16 rows on, a warp owns a row: each lane issues all of its C / 128
//   loads of 8 bytes (4 bf16, ATen's vector of 4 floats) before any math, so
//   a warp's loads each cover 256 contiguous bytes, and its stores the same;
// - the row's C / 32 fp32 values stay in registers through both reductions
//   and the output, so x is read once;
// - the block (8 warps) stages scale and bias in shared memory once and then
//   walks rows grid-stride; the grid is one wave of resident blocks;
// - fewer than 16 rows (a CLS batch under 16) take the wide kernel: one block
//   of W threads a row, with ATen's shared-memory fold.
// The wrapper takes C % 128 == 0 with 256 <= C <= 2048 (every width of the
// port's towers), bf16 rows at an 8-byte-aligned row stride, and a contiguous
// output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kVec = 4;            // columns of one lane's load: ATen's float vector
constexpr int kWarp = 32;
constexpr int kMinChunks = 2;      // C >= 256
constexpr int kMaxChunks = 16;     // C <= 2048: C / 128 loads a lane
constexpr int kNarrowWarps = 8;    // rows a block of the narrow kernel holds at once
constexpr int kMaxLanes = 512;     // ATen's MAX_NUM_THREADS for a float reduction
constexpr int kWideFrom = 16;      // rows from which ATen gives a row one warp

__device__ __forceinline__ float low_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// The sum of one value a lane over the row's W lanes, in ATen's order; every
// lane gets the row's sum.  WIDE: W = blockDim.x > 32, `fold` holds W + 1
// floats; else W = 32.
template <bool WIDE>
__device__ __forceinline__ float row_sum(float t, float* fold) {
  if (WIDE) {
    const int lane = threadIdx.x;
    fold[lane] = t;
    for (int off = blockDim.x / 2; off >= kWarp; off >>= 1) {
      __syncthreads();
      if (lane < off) {
        t = __fadd_rn(t, fold[lane + off]);
        fold[lane] = t;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, off));
  if (!WIDE) return __shfl_sync(0xffffffffu, t, 0);
  // lane 0 of warp 0 holds the sum; its own slot, past the fold, so that the
  // next call's writes to the fold cannot race the reads here
  if (threadIdx.x == 0) fold[blockDim.x] = t;
  __syncthreads();
  return fold[blockDim.x];
}

// One row a warp (narrow: blockDim = (32, kNarrowWarps)) or one row a block
// (WIDE: blockDim = (W, 1)).  K = C / 128 loads a lane in the narrow kernel;
// the wide kernel's lanes hold at most as many, the rest masked off.
template <int K, bool WIDE>
__global__ void __launch_bounds__(WIDE ? kMaxLanes : kWarp * kNarrowWarps)
    layer_norm_kernel(const __nv_bfloat16* __restrict__ x, long long row_stride,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, long long rows, int cols, float factor,
                      float eps) {
  extern __shared__ __align__(16) float smem[];  // scale [cols], bias [cols]; WIDE: the fold [W + 1]
  float* s_scale = smem;
  float* s_bias = smem + cols;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int c = tid; c < cols; c += blockDim.x * blockDim.y) {
    s_scale[c] = scale[c];
    s_bias[c] = bias[c];
  }
  __syncthreads();
  const int lane = threadIdx.x;
  const int lanes = blockDim.x;
  const int nvec = cols / kVec;
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y; row < rows; row += step) {
    const uint2* xr = reinterpret_cast<const uint2*>(x + row * row_stride);
    float v[K][kVec];
    bool live[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      live[k] = !WIDE || lane + k * lanes < nvec;
      const uint2 w = live[k] ? __ldg(xr + lane + k * lanes) : make_uint2(0u, 0u);
      v[k][0] = low_bf16(w.x);
      v[k][1] = high_bf16(w.x);
      v[k][2] = low_bf16(w.y);
      v[k][3] = high_bf16(w.y);
    }
    float a[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (live[k])
#pragma unroll
        for (int i = 0; i < kVec; ++i) a[i] = __fadd_rn(a[i], v[k][i]);
    float t = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
    const float mean = __fmul_rn(row_sum<WIDE>(t, smem + 2 * cols), factor);

#pragma unroll
    for (int i = 0; i < kVec; ++i) a[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        v[k][i] = __fsub_rn(v[k][i], mean);
        if (live[k]) a[i] = __fadd_rn(a[i], __fmul_rn(v[k][i], v[k][i]));
      }
    t = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
    const float var = __fmul_rn(row_sum<WIDE>(t, smem + 2 * cols), factor);
    const float rstd = rsqrtf(__fadd_rn(var, eps));

    uint2* orow = reinterpret_cast<uint2*>(out + row * cols);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!live[k]) continue;
      const int j = lane + k * lanes;
      const float4 s = *reinterpret_cast<const float4*>(s_scale + kVec * j);
      const float4 b = *reinterpret_cast<const float4*>(s_bias + kVec * j);
      const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(v[k][0], rstd), s.x), b.x);
      const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(v[k][1], rstd), s.y), b.y);
      const float y2 = __fadd_rn(__fmul_rn(__fmul_rn(v[k][2], rstd), s.z), b.z);
      const float y3 = __fadd_rn(__fmul_rn(__fmul_rn(v[k][3], rstd), s.w), b.w);
      orow[j] = make_uint2(pack(y0, y1), pack(y2, y3));
    }
  }
}

int last_pow2(long long n) {
  int p = 1;
  while ((long long)p * 2 <= n && p < kMaxLanes) p *= 2;
  return p;
}

template <int K, bool WIDE>
int launch(const __nv_bfloat16* x, long long row_stride, const float* scale, const float* bias,
           __nv_bfloat16* out, long long rows, int cols, float factor, float eps,
           cudaStream_t stream) {
  auto kernel = layer_norm_kernel<K, WIDE>;
  if (WIDE) {
    // ATen's block: pow2(rows) rows share its 512 threads
    const int by_cols = last_pow2(cols / kVec), by_rows = kMaxLanes / last_pow2(rows);
    const int lanes = by_cols < by_rows ? by_cols : by_rows;
    const size_t smem = (2 * (size_t)cols + lanes + 1) * sizeof(float);
    kernel<<<(unsigned)rows, dim3(lanes, 1), smem, stream>>>(x, row_stride, scale, bias, out, rows,
                                                             cols, factor, eps);
    return (int)cudaGetLastError();
  }
  // one wave of resident blocks, from the card's SM count and this
  // instantiation's occupancy (its K fixes cols), asked once: the port's
  // cards are alike
  static std::atomic<int> wave{0};
  const size_t smem = 2 * (size_t)cols * sizeof(float);
  if (wave.load() == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarp * kNarrowWarps, smem);
    if (err != cudaSuccess) return (int)err;
    wave.store(sms * (per_sm > 0 ? per_sm : 1));
  }
  const long long tiles = (rows + kNarrowWarps - 1) / kNarrowWarps;
  const long long grid = tiles < wave.load() ? tiles : wave.load();
  kernel<<<(unsigned)grid, dim3(kWarp, kNarrowWarps), smem, stream>>>(x, row_stride, scale, bias, out,
                                                                      rows, cols, factor, eps);
  return (int)cudaGetLastError();
}

template <int K>
int dispatch(int chunks, const __nv_bfloat16* x, long long row_stride, const float* scale,
             const float* bias, __nv_bfloat16* out, long long rows, int cols, float factor, float eps,
             cudaStream_t stream) {
  if (chunks == K) {
    return rows < kWideFrom
               ? launch<K, true>(x, row_stride, scale, bias, out, rows, cols, factor, eps, stream)
               : launch<K, false>(x, row_stride, scale, bias, out, rows, cols, factor, eps, stream);
  }
  if constexpr (K < kMaxChunks) {
    return dispatch<K + 1>(chunks, x, row_stride, scale, bias, out, rows, cols, factor, eps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// x: rows of `cols` bf16 at `row_stride` elements apart, unit stride within a
// row; scale, bias: fp32 [cols]; out: bf16 [rows, cols], contiguous; all on
// the current device.  factor: ATen's mean factor, float(rows) / float(rows *
// cols).  Takes cols % 128 == 0 with 256 <= cols <= 2048, 8-byte-aligned x
// and out, and row_stride % 4 == 0.  Returns the cudaError_t of the launch
// (0 = success).
int mcm_layer_norm(const void* x, long long row_stride, const float* scale, const float* bias,
                   void* out, long long rows, int cols, float factor, float eps, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (rows < 0 || cols % (kVec * kWarp) != 0 || cols < kMinChunks * kVec * kWarp ||
      cols > kMaxChunks * kVec * kWarp || row_stride % kVec != 0 || !aligned(x, 8) ||
      !aligned(out, 8))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  return dispatch<kMinChunks>(cols / (kVec * kWarp), xb, row_stride, scale, bias, ob, rows, cols,
                              factor, eps, static_cast<cudaStream_t>(stream));
}

const char* mcm_layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
