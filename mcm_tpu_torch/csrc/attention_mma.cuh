// Tensor-core attention for Hopper in bf16: the tile routine and the
// block routine that the bsd body (bsd_attention.cuh), the split-heads body
// (split_attention.cu) and the flash body (flash_attention.cu) run at head
// dims 16 to 128.
//
// Numerics (kScaledQ) are the TPU kernels' (mcm_tpu/ops/attention.py:52-64,
// :112-130, :161-199):
//   * q is scaled in fp32 and rounded to bf16 once;
//   * logits are fp32 sums of bf16 products (mma.sync m16n8k16, fp32
//     accumulators);
//   * max, exp and sum are fp32 and the division is on the probabilities
//     (IEEE expf, built without --use_fast_math; the quotient correctly
//     rounded);
//   * p is rounded to bf16 before PV, straight from the logits' C fragment
//     into the A fragment of the PV product;
//   * PV accumulates in fp32; the output is rounded to bf16.
// The softmax between the two products follows the mode (SoftmaxMode);
// every mode but kFull exists for the timing probes of bsd_probe.cu.
// The flash body takes jax's TPU flash kernel's numerics instead
// (TileNumerics): q enters the product unscaled and the fp32 logits are
// multiplied by the scale after it; kFlashSingle then runs the two passes
// below (jax's single whole-sequence block), kFlashBlocks one pass over
// 128-key blocks with a running max and sum (jax's block loop, output_blocks).
//
// The tile: one warp owns 16 query rows of one (image, head) pair.  Its q
// rows live in registers as the A fragments of the QKᵀ product (Dh/16
// k-steps, 16 registers at Dh = 64); K and V lie in shared memory, read by
// ldmatrix.x4 (K) and ldmatrix.x4.trans (V).  The keys are walked in
// chunks of 16 (one k-step of PV: the fewest registers, 97 a thread at
// Dh = 64, and no slower than chunks of 32 or 64 on the card), twice:
//   * pass 1 computes each chunk's logits and keeps each row's running
//     max and fp32 sum (quad shuffles over the 4 lanes that share a row;
//     the sum is rescaled when the max moves);
//   * pass 2 recomputes the same chunk's logits with the same instruction
//     sequence, so they are bit-identical to pass 1's, forms
//     p = expf(x − m) / l (the quotient correctly rounded from one
//     reciprocal per row: MmaTile::quotient), rounds it to bf16 and
//     accumulates O (16 × Dh fp32, 32 registers at Dh = 64).
// Why two passes and not one: the whole row of logits does not fit in
// registers (16 × 272 fp32 at S = 257 is 136 registers a thread), and an
// online softmax in one pass rounds the unnormalised p and rescales O, a
// different rounding point than JAX's.  The recomputed QKᵀ costs a third
// more tensor-core work, which this memory-bound function can afford, and
// the registers stay fixed whatever S is.  The sum differs from the plain
// version's only in order (chunks, quads and the rescale), an fp32 ulp or
// so.  kNoExp and kBf16Sm need the final max before their sum (their
// terms are not rescalable), so they take a max-only pass first; kNoSoftmax
// takes pass 2 alone.
//
// Shared memory: K and V of a pair as [S16, Dh] bf16 tiles (S rounded up to
// 16 keys), 16-byte chunks of a row XOR-swizzled with the row so that the 8
// rows one ldmatrix matrix reads fall in 8 different bank groups, with no
// padding (which is what lets S = 600 at Dh = 64 fit: 152 KB).  Keys past S
// are masked to −inf in the logits and their p is 0; V's rows past S are
// zeroed, since 0 · NaN would not be 0.  The keys may stop short of the
// query rows (attend_pairs: rows [0, S), keys [0, kv)); the tiles then
// hold kv rows and the mask is at kv.
//
// The block: one routine (attend_pairs) walks a list of pairs and a range
// of query rows.  Its WARPS warps are spread over (pair, 16-row tile) work
// items, one each at a time (a round).  A ring of NST shared-memory stages
// holds the pairs' K/V: cp.async brings each pair's K and then its V (one
// commit group each), pair i + NST − 1 is in flight while a round works on
// earlier pairs, and within a round V lands while pass 1 runs on K.  A
// round touches at most NST − 1 pairs where their tiles cover the warps (so
// one stage is always loading), and all NST otherwise (short S: the loads
// are small).
// Copies are 16-byte where every row is 16-byte aligned, else 8-byte.

#pragma once

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the tensor-core design takes bf16 at head dims 16 to 128
template <typename T, int DH>
constexpr bool kTensorCores = std::is_same<T, bf16>::value && DH >= 16;

// the softmax between the two products (see bsd_attention.cuh)
enum SoftmaxMode : int { kFull = 0, kNoSoftmax = 1, kNoExp = 2, kBf16Sm = 3, kDeferDiv = 4 };

// where the scale goes and how the keys are walked
enum TileNumerics : int {
  kScaledQ = 0,      // q·scale rounded to bf16 into the A fragments; two passes
  kFlashSingle = 1,  // fp32 logits · scale; two passes (jax's single-step kernel)
  kFlashBlocks = 2,  // fp32 logits · scale; 128-key blocks (jax's block loop)
};

// -- PTX --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n of this thread's commit groups are pending.  A
// smaller count than asked is always safe, so anything past 5 waits for all.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a · b on one m16n8k16 tile, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- shared-memory tiles ---------------------------------------------------------

// A [rows, DH] bf16 tile, row-major with no padding; the 16-byte chunk c of
// row r is stored at chunk c ^ f(r), so that the 8 rows one ldmatrix
// matrix reads (one chunk each) cover all 32 banks.
template <int DH>
struct MmaLayout {
  static constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  static constexpr int kRowBytes = DH * 2;
  static constexpr int kXorMask = kChunks >= 8 ? 7 : kChunks - 1;
  static constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;  // rows per 128 bytes
  __device__ static __forceinline__ uint32_t offset(int row, int chunk) {
    return (uint32_t)row * kRowBytes + ((chunk ^ ((row / kRowsPerLine) & kXorMask)) << 4);
  }
};

// bytes of one stage (a pair's K and V tiles)
template <int DH>
size_t mma_stage_bytes(int S) {
  return (size_t)2 * ((S + 15) & ~15) * DH * sizeof(bf16);
}

// Copy rows [0, S) of one head (row j at src + j·row_stride) into the tile
// at dst, as cp.async pieces of 16 bytes (vec16) or 8.  Commits nothing.
template <int DH>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src, int S,
                                           long long row_stride, bool vec16) {
  using L = MmaLayout<DH>;
  if (vec16) {
    for (int i = threadIdx.x; i < S * L::kChunks; i += blockDim.x) {
      const int r = i / L::kChunks, c = i % L::kChunks;
      cp_async16(dst + L::offset(r, c), src + r * row_stride + c * 8);
    }
  } else {
    for (int i = threadIdx.x; i < S * 2 * L::kChunks; i += blockDim.x) {
      const int r = i / (2 * L::kChunks), c = i % (2 * L::kChunks);
      cp_async8(dst + L::offset(r, c >> 1) + (c & 1) * 8, src + r * row_stride + c * 4);
    }
  }
}

// -- the tile: 16 query rows of one pair, one warp --------------------------------

// Each thread holds two rows of the tile, h = 0 and 1: rows g and g + 8
// (g = lane / 4), in the C-fragment layout of mma.m16n8k16.
template <int DH, int MODE, int NUM = kScaledQ>
struct MmaTile {
  static constexpr int kKSteps = DH / 16;   // k-steps of QKᵀ
  static constexpr int kDimTiles = DH / 8;  // n-tiles of PV
  using L = MmaLayout<DH>;

  uint32_t qf[kKSteps][4];  // A fragments of q (kScaledQ: q·scale) in bf16
  float m[2], l[2];         // each row's max and sum
  float d[2], rd[2];        // the divisor of p and its reciprocal
  float sc;                 // the logits' scale (flash numerics)

  // q rows [r0, r0 + 16) (row r at q + r·row_stride), rows ≥ r_end as 0
  __device__ __forceinline__ void load_q(const bf16* q, long long row_stride, int r0, int r_end,
                                         float scale, int lane) {
    const int g = lane >> 2, t = lane & 3;
    sc = scale;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + ((e & 1) << 3);
        const int c = 16 * kk + 2 * t + ((e >> 1) << 3);
        uint32_t raw = 0u;
        if (r < r_end) raw = *reinterpret_cast<const uint32_t*>(q + r * row_stride + c);
        if constexpr (NUM == kScaledQ) {
          qf[kk][e] = pack_bf16(__uint_as_float(raw << 16) * scale,
                                __uint_as_float(raw & 0xffff0000u) * scale);
        } else {
          qf[kk][e] = raw;  // two bf16 values, the lower column in the low half
        }
      }
  }

  // logits of keys [c0, c0 + 16): s[j][e] is row e >> 1, key
  // c0 + 8j + 2t + (e & 1) (t = lane % 4); keys ≥ S are −inf.  Flash
  // numerics scale the fp32 sum here, before the mask, as jax does.
  __device__ __forceinline__ void logits(float (&s)[2][4], uint32_t ks, int c0, int S,
                                         int lane) const {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int key = c0 + (lane & 7) + ((lane >> 4) << 3);
    const int chunk_lane = (lane >> 3) & 1;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t b[4];
      ldsm_x4(ks + L::offset(key, 2 * kk + chunk_lane), b);
      mma_bf16(s[0], qf[kk], b[0], b[1]);
      mma_bf16(s[1], qf[kk], b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (NUM != kScaledQ) s[j][e] = __fmul_rn(s[j][e], sc);  // no FMA contraction
        if constexpr (MODE == kBf16Sm) s[j][e] = round_to<bf16>(s[j][e]);
        if (c0 + 16 > S && c0 + 8 * j + 2 * (lane & 3) + (e & 1) >= S) s[j][e] = -INFINITY;
      }
  }

  // f(s, c0) for the logits s of each chunk c0 = 0, 16, ... < S, in order
  template <typename F>
  __device__ __forceinline__ void each_chunk(uint32_t ks, int S, int lane, F&& f) const {
    float s[2][4];
    for (int c0 = 0; c0 < S; c0 += 16) {
      logits(s, ks, c0, S, lane);
      f(s, c0);
    }
  }

  // pass 1 over K: m and l of both rows, as the mode needs them
  __device__ __forceinline__ void stats(uint32_t ks, int S, int lane) {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    if constexpr (MODE == kNoSoftmax) return;
    if constexpr (MODE == kFull || MODE == kDeferDiv) {
      // the 4 threads of a row share its running max (quad shuffles) and
      // rescale their partial sums when it moves
      each_chunk(ks, S, lane, [&](const float(&s)[2][4], int) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                                 fmaxf(s[1][2 * h], s[1][2 * h + 1]));
          const float mn = fmaxf(m[h], quad_max(mx));
          if (mn != m[h]) l[h] *= expf(m[h] - mn);
          m[h] = mn;
          l[h] += (expf(s[0][2 * h] - mn) + expf(s[0][2 * h + 1] - mn)) +
                  (expf(s[1][2 * h] - mn) + expf(s[1][2 * h + 1] - mn));
        }
      });
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
    } else {  // kNoExp, kBf16Sm: the final max first, then the sum
      each_chunk(ks, S, lane, [&](const float(&s)[2][4], int) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      });
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
      each_chunk(ks, S, lane, [&](const float(&s)[2][4], int) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e >> 1] += weight(s[j][e], e >> 1);
      });
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d[h] = MODE == kBf16Sm ? round_to<bf16>(l[h]) : l[h];
      rd[h] = __frcp_rn(d[h]);
    }
  }

  // x / d[h], correctly rounded (Markstein): q0 = x·(1/d) is within an ulp
  // of the quotient, the FMA gives its exact remainder, and one more FMA
  // rounds the corrected quotient once.  Equal to IEEE x / d[h] wherever
  // the quotient is a normal number, for three FMA-pipe instructions
  // instead of the division routine's reciprocal, refinement and range
  // checks on every logit.
  __device__ __forceinline__ float quotient(float x, int h) const {
    const float q0 = __fmul_rn(x, rd[h]);
    return fmaf(fmaf(-q0, d[h], x), rd[h], q0);
  }

  // the unnormalised weight of logit x in row h (0 for a masked key)
  __device__ __forceinline__ float weight(float x, int h) const {
    if constexpr (MODE == kNoExp) {
      return x == -INFINITY ? 0.f : x - m[h];
    } else if constexpr (MODE == kBf16Sm) {
      return round_to<bf16>(expf(round_to<bf16>(x - m[h])));
    } else {
      return expf(x - m[h]);
    }
  }

  // p of logit x in row h, before its rounding to bf16
  __device__ __forceinline__ float prob(float x, int h) const {
    if constexpr (MODE == kNoSoftmax) {
      return x == -INFINITY ? 0.f : x;
    } else if constexpr (MODE == kDeferDiv) {
      return weight(x, h);
    } else if constexpr (MODE == kBf16Sm) {
      return round_to<bf16>(quotient(weight(x, h), h));
    } else {
      return quotient(weight(x, h), h);
    }
  }

  // pass 2 over K and V: O of the tile, stored to rows [r0, r_end) at
  // o + r·row_stride
  __device__ __forceinline__ void output(uint32_t ks, uint32_t vs, int S, bf16* o,
                                         long long row_stride, int r0, int r_end,
                                         int lane) const {
    float acc[kDimTiles][4];
#pragma unroll
    for (int n = 0; n < kDimTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const int key_lane = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int chunk_lane = lane >> 4;
    each_chunk(ks, S, lane, [&](const float(&s)[2][4], int c0) {
      // C fragments of the two 8-key tiles → A fragment of 16 keys
      const uint32_t a[4] = {pack_bf16(prob(s[0][0], 0), prob(s[0][1], 0)),
                             pack_bf16(prob(s[0][2], 1), prob(s[0][3], 1)),
                             pack_bf16(prob(s[1][0], 0), prob(s[1][1], 0)),
                             pack_bf16(prob(s[1][2], 1), prob(s[1][3], 1))};
#pragma unroll
      for (int nn = 0; nn < DH / 16; ++nn) {
        uint32_t b[4];
        ldsm_x4_trans(vs + L::offset(c0 + key_lane, 2 * nn + chunk_lane), b);
        mma_bf16(acc[2 * nn], a, b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
      }
    });
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= r_end) continue;
      bf16* orow = o + r * row_stride + 2 * t;
#pragma unroll
      for (int n = 0; n < kDimTiles; ++n) {
        float x0 = acc[n][2 * h], x1 = acc[n][2 * h + 1];
        if constexpr (MODE == kDeferDiv) {
          x0 /= l[h];
          x1 /= l[h];
        }
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(x0, x1);
      }
    }
  }

  // jax's flash block loop (kFlashBlocks), one pass over blocks of 128 keys
  // (flash_attention.py:439-473).  A block's logits stay in registers
  // (8 chunks, 64 a thread) while its row max is formed; then
  //   m_next = max(m, rowmax(s));  p = expf(s − m_next), rounded to bf16
  //   l_corr = expf(m − m_next)·l;  l_next = Σp + l_corr
  //   O = O·(l_corr·l_inv) + (p·v)·l_inv,  l_inv = 1 / l_next (1 if 0)
  // with every product and sum of the update rounded on its own (no FMA
  // contraction), and O stored to rows [r0, r_end) at o + r·row_stride.
  __device__ __forceinline__ void output_blocks(uint32_t ks, uint32_t vs, int S, bf16* o,
                                                long long row_stride, int r0, int r_end,
                                                int lane) {
    constexpr int kChunks = 8;  // 16-key chunks of a 128-key block
    float acc[kDimTiles][4];
#pragma unroll
    for (int n = 0; n < kDimTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    const int key_lane = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int chunk_lane = lane >> 4;
    for (int b0 = 0; b0 < S; b0 += 16 * kChunks) {
      float s[kChunks][2][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (b0 + 16 * c >= S) continue;
        logits(s[c], ks, b0 + 16 * c, S, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[c][j][e]);
      }
      float m_next[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) m_next[h] = fmaxf(m[h], quad_max(mx[h]));
      uint32_t a[kChunks][4];  // p in bf16, the A fragments of PV
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (b0 + 16 * c >= S) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[c][j][e] = expf(s[c][j][e] - m_next[e >> 1]);
            sum[e >> 1] += s[c][j][e];
          }
        a[c][0] = pack_bf16(s[c][0][0], s[c][0][1]);
        a[c][1] = pack_bf16(s[c][0][2], s[c][0][3]);
        a[c][2] = pack_bf16(s[c][1][0], s[c][1][1]);
        a[c][3] = pack_bf16(s[c][1][2], s[c][1][3]);
      }
      float f[2], l_inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float l_corr = __fmul_rn(expf(m[h] - m_next[h]), l[h]);
        const float l_next = __fadd_rn(quad_sum(sum[h]), l_corr);
        l_inv[h] = l_next == 0.f ? 1.f : 1.f / l_next;
        f[h] = __fmul_rn(l_corr, l_inv[h]);
        m[h] = m_next[h];
        l[h] = l_next;
      }
      // p·v of at most 64 output columns at a time: at Dh = 128 the partial
      // sums take 32 registers a thread beside O's 64, not 64 more (ptxas
      // spills there otherwise)
      constexpr int kGroup = kDimTiles < 8 ? kDimTiles : 8;
#pragma unroll
      for (int n0 = 0; n0 < kDimTiles; n0 += kGroup) {
        float pv[kGroup][4];
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (b0 + 16 * c >= S) continue;
#pragma unroll
          for (int nn = 0; nn < kGroup / 2; ++nn) {
            uint32_t b[4];
            ldsm_x4_trans(vs + L::offset(b0 + 16 * c + key_lane, n0 + 2 * nn + chunk_lane), b);
            mma_bf16(pv[2 * nn], a[c], b[0], b[1]);
            mma_bf16(pv[2 * nn + 1], a[c], b[2], b[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n0 + n][e] = __fadd_rn(__fmul_rn(acc[n0 + n][e], f[e >> 1]),
                                       __fmul_rn(pv[n][e], l_inv[e >> 1]));
      }
    }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= r_end) continue;
      bf16* orow = o + r * row_stride + 2 * t;
#pragma unroll
      for (int n = 0; n < kDimTiles; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
};

// -- the block: a list of pairs, a range of query rows -----------------------------

// Where pair p's rows lie: pair p is (image p / heads, head p % heads) of
// [B, S, D] projections, head h the columns [h·DH, (h+1)·DH) of rows
// in_stride (q/k/v) and out_stride (o) elements apart.  Dense [B·H, S, DH]
// heads are the case heads = 1, in_stride = out_stride = DH.
struct PairLayout {
  long long in_stride, out_stride;
  int heads;

  __device__ __forceinline__ long long in_off(long long p, int S, int dh) const {
    return (p / heads) * S * in_stride + (p % heads) * dh;
  }
  __device__ __forceinline__ long long out_off(long long p, int S, int dh) const {
    return (p / heads) * S * out_stride + (p % heads) * dh;
  }
};

// Query rows [r_begin, r_end) of pairs [pair_begin, pair_begin + n_pairs),
// each of S rows, over their keys [0, kv), through a ring of NST stages in
// smem (NST · mma_stage_bytes<DH>(kv)).  Every thread of the block (WARPS
// warps) calls it; vec16 says that every K/V row is 16-byte aligned.
template <int DH, int MODE, int NST, int WARPS, int NUM = kScaledQ>
__device__ __forceinline__ void attend_pairs(const bf16* __restrict__ q,
                                             const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, bf16* __restrict__ o,
                                             int S, int kv, long long pair_begin, int n_pairs,
                                             int r_begin, int r_end, PairLayout lay,
                                             float scale, bool vec16, unsigned char* smem) {
  using L = MmaLayout<DH>;
  const int kv16 = (kv + 15) & ~15;
  const uint32_t tile_bytes = (uint32_t)kv16 * DH * sizeof(bf16);
  const uint32_t base = smem_addr(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // V rows [kv, kv16) of every stage: zero (p is 0 there, but 0 · NaN is not)
  for (int i = threadIdx.x; i < NST * (kv16 - kv) * L::kChunks; i += blockDim.x) {
    const int st = i / ((kv16 - kv) * L::kChunks);
    const int rest = i % ((kv16 - kv) * L::kChunks);
    *reinterpret_cast<uint4*>(smem + (size_t)st * 2 * tile_bytes + tile_bytes +
                              L::offset(kv + rest / L::kChunks, rest % L::kChunks)) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // pair i of the list into stage i % NST: its K, then its V, a group each
  auto fetch = [&](int i) {
    const uint32_t ks = base + (uint32_t)(i % NST) * 2 * tile_bytes;
    const long long off = lay.in_off(pair_begin + i, S, DH);
    stage_rows<DH>(ks, k + off, kv, lay.in_stride, vec16);
    cp_async_commit();
    stage_rows<DH>(ks + tile_bytes, v + off, kv, lay.in_stride, vec16);
    cp_async_commit();
  };

  const int n_tiles = (r_end - r_begin + 15) / 16;
  const int items = n_pairs * n_tiles;
  // pairs a round may touch: leave one stage loading where the others'
  // tiles keep every warp busy
  const int span = (NST > 1 && (NST - 1) * n_tiles >= WARPS) ? NST - 1 : NST;
  int fetched = 0;
  for (; fetched < min(NST, n_pairs); ++fetched) fetch(fetched);

  for (int t0 = 0; t0 < items;) {
    const int p_lo = t0 / n_tiles;
    const int t1 = min(min(items, t0 + WARPS), (p_lo + span) * n_tiles);
    const int p_hi = (t1 - 1) / n_tiles;
    const int item = t0 + warp;
    const bool mine = item < t1;
    const int i = item / n_tiles;
    const int r0 = r_begin + (item % n_tiles) * 16;
    const uint32_t ks = base + (uint32_t)(i % NST) * 2 * tile_bytes;
    const long long off = lay.in_off(pair_begin + i, S, DH);

    MmaTile<DH, MODE, NUM> tile;
    bf16* out = o + lay.out_off(pair_begin + i, S, DH);
    if constexpr (NUM == kFlashBlocks) {
      // one pass: K and V of every pair up to p_hi
      cp_async_wait_at_most(2 * (fetched - 1 - p_hi));
      __syncthreads();
      if (mine) {
        tile.load_q(q + off, lay.in_stride, r0, r_end, scale, lane);
        tile.output_blocks(ks, ks + tile_bytes, kv, out, lay.out_stride, r0, r_end, lane);
      }
    } else {
      // pending after K of pair p_hi: its V, and K and V of each later pair
      cp_async_wait_at_most(2 * (fetched - 1 - p_hi) + 1);
      __syncthreads();
      if (mine) {
        tile.load_q(q + off, lay.in_stride, r0, r_end, scale, lane);
        tile.stats(ks, kv, lane);
      }
      cp_async_wait_at_most(2 * (fetched - 1 - p_hi));
      __syncthreads();
      if (mine) tile.output(ks, ks + tile_bytes, kv, out, lay.out_stride, r0, r_end, lane);
    }
    __syncthreads();  // the stages of finished pairs may be refilled
    t0 = t1;
    for (const int p_next = t0 / n_tiles; fetched < n_pairs && fetched < p_next + NST; ++fetched)
      fetch(fetched);
  }
}


}  // namespace
