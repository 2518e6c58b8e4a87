// Multi-head encoder attention straight from [B, S, D] projections: the bsd
// kernel of the main path (mode kFull of bsd_attention.cuh, which holds the
// kernel, its numerics, its bound and its design).
//
// Replaces the TPU kernel mcm_tpu/ops/attention.py::_bsd_attention_kernel
// (called through _pallas_bsd_attention).

#include "bsd_attention.cuh"

extern "C" {

// Bytes of dynamic shared memory one block takes (0 for an unsupported
// head_dim or dtype).  dtype: 0 = float32, 1 = bfloat16.
size_t mcm_bsd_attention_smem_bytes(int S, int head_dim, int dtype) {
  return with_head_dim(head_dim, (size_t)0, [&](auto dh) -> size_t {
    constexpr int DH = decltype(dh)::value;
    if (dtype == 0) return bsd_smem_bytes<float, DH>(S);
    if (dtype == 1) return bsd_smem_bytes<__nv_bfloat16, DH>(S);
    return 0;
  });
}

// q, k, v: head h of token (b, s) at element b·S·in_stride + s·in_stride +
// h·head_dim; o likewise with out_stride.  A packed [B, S, 3D] projection
// is served by passing q, q + D, q + 2D with in_stride = 3D.  Returns the
// cudaError_t of the launch (0 = success).
int mcm_bsd_attention(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int heads, int head_dim,
                      long long in_stride, long long out_stride, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(head_dim, (int)cudaErrorInvalidValue, [&](auto dh) {
    return bsd_dispatch<kFull, decltype(dh)::value>(q, k, v, o, B, S, heads, in_stride,
                                                    out_stride, dtype, s);
  });
}

const char* mcm_bsd_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
