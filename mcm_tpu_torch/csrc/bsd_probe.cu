// Timing probes of the bsd kernel: bsd_attention.cuh in each of its five
// modes (kFull, kNoSoftmax, kNoExp, kBf16Sm, kDeferDiv).  Most modes
// compute wrong attention on purpose; each bounds the cost of the piece of
// the softmax it removes or changes.
//
// Replaces the TPU kernel tools/bsd_probe.py::_kernel (called through
// _call).  Like that tool it runs at one head dim, 64 (ViT-B/16's D / heads),
// so only that width is compiled.  Bound and design: bsd_attention.cuh.

#include "bsd_attention.cuh"

namespace {

constexpr int kProbeHeadDim = 64;

}  // namespace

extern "C" {

// As mcm_bsd_attention (q, k, v, o with row strides in_stride / out_stride),
// plus mode: 0 = full, 1 = nosoftmax, 2 = noexp, 3 = bf16sm, 4 = deferdiv.
// head_dim must be 64.  Returns the cudaError_t of the launch (0 = success).
int mcm_bsd_probe(const void* q, const void* k, const void* v, void* o, int B, int S,
                  int heads, int head_dim, long long in_stride, long long out_stride,
                  int dtype, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != kProbeHeadDim) return (int)cudaErrorInvalidValue;
  constexpr int DH = kProbeHeadDim;
  switch (mode) {
    case kFull:
      return bsd_dispatch<kFull, DH>(q, k, v, o, B, S, heads, in_stride, out_stride, dtype, s);
    case kNoSoftmax:
      return bsd_dispatch<kNoSoftmax, DH>(q, k, v, o, B, S, heads, in_stride, out_stride,
                                          dtype, s);
    case kNoExp:
      return bsd_dispatch<kNoExp, DH>(q, k, v, o, B, S, heads, in_stride, out_stride, dtype, s);
    case kBf16Sm:
      return bsd_dispatch<kBf16Sm, DH>(q, k, v, o, B, S, heads, in_stride, out_stride, dtype, s);
    case kDeferDiv:
      return bsd_dispatch<kDeferDiv, DH>(q, k, v, o, B, S, heads, in_stride, out_stride,
                                         dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mcm_bsd_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
