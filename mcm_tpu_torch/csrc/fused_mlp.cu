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
// at B/16).  A Hopper block has 227 KB of shared memory, so every design
// here gives a block a tile of rows and loops over F in chunks: per chunk
// h = act(x_tile · w1[:, f0:f1] + b1), rounded, then acc += h · w2[f0:f1, :]
// into an fp32 [rows, D] accumulator held in registers; the x tile stays in
// shared memory for the whole loop and the weights stream through it, the
// whole of w1 and w2 for every row tile.  Three designs, chosen on the host
// by dtype and shape (never on a failed build or launch):
//   * bf16 at D = 384, 512, 768 or 1024 (the golden, text, B/16 / B/32 and
//     L/14 widths) with F a multiple of 64 — Hopper's warpgroup products
//     (wgmma) over weight tiles staged by the Tensor Memory Accelerator
//     (TMA):
//       - a block owns 64 rows (wgmma's M), twice the rows of the wmma
//         design, so each weight byte feeds twice the FLOP: 3.7 GB of
//         weight reads from L2 a call at the B/16, B = 128 shape, not 7.4.
//         (Pairing blocks in a cluster that shares each stage by TMA
//         multicast halves that again and was no faster on the card: L2 is
//         not what holds this design; PERF.md.);
//       - three warpgroups: one producer thread issues TMA copies into a
//         ring of 4–6 shared-memory stages (mbarrier full / empty pairs), so
//         the next weight tiles are in flight while these compute; two
//         consumer warpgroups (setmaxnreg: 240 registers a thread, the
//         producer 24) each own half of the D output columns, whose fp32
//         accumulator is 64 × D/2 (192 registers a thread at D = 768);
//       - a stage is 32·D bytes (24 KB at D = 768): a [D/4, 64] K-slice of
//         w1's chunk (two 32-column boxes, 64-byte swizzle, one per
//         consumer) or a [16, D] K-slice of w2's (64-column boxes, 128-byte
//         swizzle), 8 stages per 64-column chunk of F;
//       - x's 64-row tile is resident (96 KB at D = 768, 128-byte swizzle)
//         and is the A operand of fc1, read by the tensor cores from shared
//         memory; each consumer computes 32 of the chunk's 64 h columns
//         (m64n32k16), adds b1, applies the activation in fp32, rounds to
//         bf16 and stores them swizzled into a double-buffered h tile, which
//         after a barrier of the two consumers is the A operand of fc2
//         (m64n192k16 or m64n256k16 against the consumer's D/2 columns of
//         w2's slice): no fp32 scratch round trip;
//       - a consumer keeps one group of products queued: it issues stage
//         i's, then waits for stage i − 1's and releases its buffer;
//       - shared memory at D = 768: x 96 KB + h 16 KB + 4 stages of 24 KB;
//       - at D = 1024 a 64 × 1024 fp32 accumulator does not fit the
//         registers, so two blocks share each row tile, each owning half of
//         the output columns and computing the whole of fc1 for itself (1.5×
//         the products of one block); a stage is then 32·D/2 bytes (w1
//         [D/8, 64] or the block's half of w2 [16, D/2]), 5 of them beside
//         x's 128 KB.
//         (A 128-column chunk, m64n64 in fc1, needs 32 more accumulator
//         registers than the 240 allow at D = 768.)
//   * other bf16 shapes with D a multiple of 128 up to 1024 and F a
//     multiple of the chunk — tensor cores through
//     nvcuda::wmma (16×16×16 bf16 → fp32).  8 warps; in fc1 each warp owns
//     one 16×16 fragment of the h chunk, in fc2 each warp owns D/8 output
//     columns for all rows of the tile, kept in registers (32 rows at D ≤
//     768, 16 rows above, so that the accumulator stays at ≤ 96 fp32
//     registers a thread).  Weight fragments are read straight from device
//     memory (L2), no staging;
//   * every other shape, and fp32 (parity mode), takes a CUDA-core kernel
//     of 16 rows a block with the accumulator in shared memory: IEEE fp32
//     FMAs, no TF32.
// Built without --use_fast_math: expf, erff and the divisions are IEEE (the
// QuickGELU reciprocal is __frcp_rn, the correctly rounded 1 / x).

#include <cuda.h>
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
  // __frcp_rn is the correctly rounded reciprocal: IEEE 1.f / x, cheaper
  if (act == 0) return h * __frcp_rn(1.f + expf(-1.702f * h));
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// -- Hopper primitives: shared addresses, mbarriers, TMA, wgmma -----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// the box of `map` at (c0 inner, c1 outer) into shared memory at dst,
// completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle (1 = 128-byte, 2 = 64-byte).
//   * K-major with 128-byte swizzle (x, h): rows of 128 bytes (64 K
//     values), 8-row groups `sbo` = 1024 bytes apart; a k16 step inside the
//     128 bytes moves the start by 32 bytes (the swizzle is on address bits).
//   * MN-major (w1, w2 tiles, N contiguous): K rows of one swizzle atom's
//     width, 8-row groups `sbo` apart, atoms along N `lbo` apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t swizzle) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wait until at most one committed group of this warpgroup is pending
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of accumulators across a
// wgmma issue or wait (the hardware writes them asynchronously)
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d += a · b on one m64n32k16 tile: A and B from shared memory (descriptors),
// A K-major, B MN-major (tnspB), bf16 in, fp32 accumulators (accumulate = 0:
// d = a · b, whatever d held)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db,
                                          uint32_t accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a · b on one m64n192k16 tile: A and B from shared memory (descriptors),
// A K-major, B MN-major (tnspB), bf16 in, fp32 accumulators
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// d += a · b on one m64n256k16 tile: A and B from shared memory (descriptors),
// A K-major, B MN-major (tnspB), bf16 in, fp32 accumulators
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int D>
struct WgmmaShape {
  static constexpr int kRows = 64;                    // rows of x a block owns
  static constexpr int kSplit = D <= 768 ? 1 : 2;     // blocks sharing a row tile
  static constexpr int kCols = D / kSplit;            // output columns of a block
  static constexpr int kChunk = 64;                   // F columns per chunk
  static constexpr int kHalf = kCols / 2;             // output columns per consumer
  static constexpr int kN2 = kHalf <= 256 ? kHalf : kHalf / 2;  // N of one fc2 wgmma
  static constexpr int kN2Tiles = kHalf / kN2;
  static constexpr int kFc1Stages = 4 * kSplit;       // stages of a chunk's w1
  static constexpr int kW1Rows = D / kFc1Stages;      // K rows of w1 in one stage
  static constexpr int kXBytes = kRows * D * 2;       // [64, D] in [64, 64] boxes
  static constexpr int kHBytes = kRows * kChunk * 2;  // one h chunk
  static constexpr int kStageBytes = 32 * kCols;      // w1 [kW1Rows, 64] or w2 [16, kCols]
  static constexpr int kFixed = 1024 + kXBytes + 2 * kHBytes + 256;  // alignment, barriers
  static constexpr int kFit = (232448 - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr size_t kSmem = (size_t)kFixed + (size_t)kStages * kStageBytes;
  static_assert(kStages >= 2, "the weight ring needs two stages");
  static_assert(kN2 % 64 == 0 && kN2 <= 256, "fc2 tiles are whole 64-column boxes");
};

template <int N> struct Fc2Mma;
template <> struct Fc2Mma<192> {
  __device__ static __forceinline__ void run(float (&d)[96], uint64_t a, uint64_t b) {
    wgmma_n192(d, a, b);
  }
};
template <> struct Fc2Mma<256> {
  __device__ static __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b) {
    wgmma_n256(d, a, b);
  }
};

// Threads 0–255: the consumer warpgroups (warpgroup g owns output columns
// [g·D/2, (g+1)·D/2) and h columns [32g, 32g + 32) of each chunk); threads
// 256–383: the producer warpgroup, of which one thread issues every copy.
// ACT (0 = QuickGELU, 1 = GELU) is a template parameter so that only one
// activation's temporaries compete with the accumulator for registers.
template <int D, int ACT>
__global__ void __launch_bounds__(384, 1)
fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap w1map,
                       const __grid_constant__ CUtensorMap w2map, const float* __restrict__ b1,
                       const float* __restrict__ b2, bf16* __restrict__ out, int M, int F) {
  using Sh = WgmmaShape<D>;
  constexpr int NST = Sh::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  // 1024-byte aligned base: the 128-byte swizzle repeats every 1024 bytes
  const uint32_t xs = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t hs = xs + Sh::kXBytes;
  const uint32_t ring = hs + 2 * Sh::kHBytes;
  const uint32_t bars = ring + NST * Sh::kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NST + s); };
  const uint32_t xbar = bars + 16 * NST;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x / Sh::kSplit * Sh::kRows;
  const int col0 = blockIdx.x % Sh::kSplit * Sh::kCols;  // this block's output columns
  const int n_chunks = F / Sh::kChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // -- producer -------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(xbar, Sh::kXBytes);
      for (int j = 0; j < D / 64; ++j) tma_load(xs + j * 8192, &xmap, 64 * j, m0, xbar);
      int i = 0;  // stages issued
      for (int c = 0; c < n_chunks; ++c) {
        const int f0 = c * Sh::kChunk;
        for (int j = 0; j < Sh::kFc1Stages + 4; ++j, ++i) {
          const int s = i % NST;
          mbar_wait(empty(s), ((i / NST) & 1) ^ 1);
          mbar_expect_tx(full(s), Sh::kStageBytes);
          const uint32_t dst = ring + s * Sh::kStageBytes;
          if (j < Sh::kFc1Stages) {  // w1 rows j·kW1Rows + [0, kW1Rows), two 32 columns
            tma_load(dst, &w1map, f0, j * Sh::kW1Rows, full(s));
            tma_load(dst + Sh::kStageBytes / 2, &w1map, f0 + 32, j * Sh::kW1Rows, full(s));
          } else {  // w2 rows f0 + 16·(stage of fc2) + [0, 16), the block's columns
            const int r0 = f0 + 16 * (j - Sh::kFc1Stages);
            for (int b = 0; b < Sh::kCols / 64; ++b)
              tma_load(dst + b * 2048, &w2map, col0 + 64 * b, r0, full(s));
          }
        }
      }
    }
  } else {
    // -- consumers ------------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane >> 2, q = lane & 3;  // row g (and g + 8), column pair q
    float acc[Sh::kN2Tiles][Sh::kN2 / 2];
#pragma unroll
    for (int n = 0; n < Sh::kN2Tiles; ++n)
#pragma unroll
      for (int e = 0; e < Sh::kN2 / 2; ++e) acc[n][e] = 0.f;
    mbar_wait(xbar, 0);
    // Within a phase (fc1 or fc2 of a chunk), after stage i's products are
    // issued those of stage i − 1 are waited for and its buffer released,
    // so that one group of products is always queued on the tensor cores;
    // each phase ends by waiting for all of them.  The stage loops are
    // unrolled and no group stays in flight across the chunk loop, so that
    // ptxas can see every wait (it serialises the products otherwise).
    auto release_previous = [&](int i) {
      wgmma_wait_1();
      if (lane == 0) mbar_arrive(empty((i - 1) % NST));
    };
    int i = 0;  // stages consumed
    for (int c = 0; c < n_chunks; ++c) {
      const int f0 = c * Sh::kChunk;
      // fc1: h[:, 32·wg + (0..31)] over D in kFc1Stages stages of kW1Rows
      float h[16];  // no initial value: the chunk's first product overwrites it
#pragma unroll
      for (int j = 0; j < Sh::kFc1Stages; ++j, ++i) {
        const int s = i % NST;
        mbar_wait(full(s), (i / NST) & 1);
        const uint32_t wb = ring + s * Sh::kStageBytes + wg * (Sh::kStageBytes / 2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Sh::kW1Rows / 16; ++kk) {
          const int kg = j * (Sh::kW1Rows / 16) + kk;  // k16 step of x
          wgmma_n32(h, wgmma_desc(xs + (kg >> 2) * 8192 + (kg & 3) * 32, 16, 1024, 1),
                    wgmma_desc(wb + kk * 1024, Sh::kStageBytes / 2, 512, 2), kg > 0);
        }
        wgmma_commit();
        if (j > 0) release_previous(i);
      }
      wgmma_wait_all();
      fence_regs(h);
      if (lane == 0) mbar_arrive(empty((i - 1) % NST));
      // h + b1 → activation → bf16, into h tile c & 1 (K-major, 128-byte
      // swizzle: 16-byte chunk k of row r at chunk k ^ (r % 8))
      const uint32_t hb = hs + (c & 1) * Sh::kHBytes;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        const int col = 32 * wg + 8 * n8 + 2 * q;
        const float2 bias = *reinterpret_cast<const float2*>(b1 + f0 + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * warp + g + 8 * hh;
          const float v0 = activate(h[4 * n8 + 2 * hh] + bias.x, ACT);
          const float v1 = activate(h[4 * n8 + 2 * hh + 1] + bias.y, ACT);
          __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
          const uint32_t addr = hb + r * 128 + (((col >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(*reinterpret_cast<uint32_t*>(&p))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both halves of h stored
      // fc2: acc += h[:, 16j..16j+15] · w2[f0 + 16j .., this consumer's columns]
#pragma unroll
      for (int j = 0; j < 4; ++j, ++i) {
        const int s = i % NST;
        mbar_wait(full(s), (i / NST) & 1);
        const uint32_t wb = ring + s * Sh::kStageBytes + wg * (Sh::kHalf / 64) * 2048;
        const uint64_t da = wgmma_desc(hb + j * 32, 16, 1024, 1);
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < Sh::kN2Tiles; ++n)
          Fc2Mma<Sh::kN2>::run(acc[n], da,
                               wgmma_desc(wb + n * (Sh::kN2 / 64) * 2048, 2048, 1024, 1));
        wgmma_commit();
        if (j > 0) release_previous(i);
      }
      wgmma_wait_all();
#pragma unroll
      for (int n = 0; n < Sh::kN2Tiles; ++n) fence_regs(acc[n]);
      if (lane == 0) mbar_arrive(empty((i - 1) % NST));
    }
    // epilogue: + b2, cast, store the rows that exist
#pragma unroll
    for (int n = 0; n < Sh::kN2Tiles; ++n)
#pragma unroll
      for (int n8 = 0; n8 < Sh::kN2 / 8; ++n8) {
        const int col = col0 + wg * Sh::kHalf + n * Sh::kN2 + 8 * n8 + 2 * q;
        const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 16 * warp + g + 8 * hh;
          if (r >= M) continue;
          __nv_bfloat162 p = __floats2bfloat162_rn(acc[n][4 * n8 + 2 * hh] + bias.x,
                                                   acc[n][4 * n8 + 2 * hh + 1] + bias.y);
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * D + col) = p;
        }
      }
  }
}

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [outer, inner] bf16 matrix, copied in [box_outer, box_inner]
// boxes (rows past `outer` read as zero)
bool bf16_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
              uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int ACT>
int launch_wgmma_act(const CUtensorMap& xmap, const CUtensorMap& w1map, const CUtensorMap& w2map,
                     const void* b1, const void* b2, void* out, int M, int F,
                     cudaStream_t stream) {
  using Sh = WgmmaShape<D>;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_wgmma_kernel<D, ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Sh::kSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + Sh::kRows - 1) / Sh::kRows * Sh::kSplit);
  fused_mlp_wgmma_kernel<D, ACT><<<blocks, 384, Sh::kSmem, stream>>>(
      xmap, w1map, w2map, static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<bf16*>(out), M, F);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* out, int M, int F, int act, cudaStream_t stream) {
  using Sh = WgmmaShape<D>;
  CUtensorMap xmap, w1map, w2map;
  if (!bf16_map(&xmap, x, D, M, 64, Sh::kRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !bf16_map(&w1map, w1, F, D, 32, Sh::kW1Rows, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !bf16_map(&w2map, w2, D, F, 64, 16, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  if (act == 0) return launch_wgmma_act<D, 0>(xmap, w1map, w2map, b1, b2, out, M, F, stream);
  return launch_wgmma_act<D, 1>(xmap, w1map, w2map, b1, b2, out, M, F, stream);
}

bool wgmma_takes(int D, int F, int dtype) {
  return dtype == 1 && (D == 384 || D == 512 || D == 768 || D == 1024) && F > 0 && F % 64 == 0;
}

size_t wgmma_smem(int D) {
  switch (D) {
    case 384: return WgmmaShape<384>::kSmem;
    case 512: return WgmmaShape<512>::kSmem;
    case 768: return WgmmaShape<768>::kSmem;
    case 1024: return WgmmaShape<1024>::kSmem;
  }
  return 0;
}

int dispatch_wgmma(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int M, int D, int F, int act,
                   cudaStream_t stream) {
  switch (D) {
    case 384: return launch_wgmma<384>(x, w1, b1, w2, b2, out, M, F, act, stream);
    case 512: return launch_wgmma<512>(x, w1, b1, w2, b2, out, M, F, act, stream);
    case 768: return launch_wgmma<768>(x, w1, b1, w2, b2, out, M, F, act, stream);
    case 1024: return launch_wgmma<1024>(x, w1, b1, w2, b2, out, M, F, act, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// -- wmma kernel (bf16 shapes the wgmma kernel does not take) ------------------

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

// 1 when (D, F, dtype) runs on a tensor-core kernel (wgmma or wmma), 0
// for the CUDA-core one.  dtype: 0 = float32, 1 = bfloat16.
int mcm_fused_mlp_tensor_cores(int D, int F, int dtype) {
  return wgmma_takes(D, F, dtype) || wmma_takes(D, F, dtype) ? 1 : 0;
}

// Bytes of dynamic shared memory one block takes at (D, F, dtype).
size_t mcm_fused_mlp_smem_bytes(int D, int F, int dtype) {
  if (wgmma_takes(D, F, dtype)) return wgmma_smem(D);
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
  if (wgmma_takes(D, F, dtype)) return dispatch_wgmma(x, w1, b1, w2, b2, out, M, D, F, act, s);
  if (wmma_takes(D, F, dtype)) return dispatch_wmma(x, w1, b1, w2, b2, out, M, D, F, act, s);
  if (dtype == 0) return launch_simt<float>(x, w1, b1, w2, b2, out, M, D, F, act, s);
  if (dtype == 1) return launch_simt<bf16>(x, w1, b1, w2, b2, out, M, D, F, act, s);
  return (int)cudaErrorInvalidValue;
}

const char* mcm_fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
