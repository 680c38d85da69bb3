// Packed-qkv self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of libcontinual_tpu/ops/attention.py:
//   * attn_fwd_kernel             <- _qkv_kernel      (launched by _qkv_attention_pallas)
//   * attn_bwd_dq_kernel +
//     attn_bwd_dkdv_kernel        <- _qkv_bwd_kernel  (launched by _qkv_bwd_pallas)
//
// The kernels live in attention_kernels.cuh, shared with prefix_attention.cu;
// here they run with no prefix (P = 0), so a head's keys and values are the S
// rows of the packed qkv tensor. That header states the rounding points, what
// bounds the kernels on an H100 and what the design does about it.

#include "attention_kernels.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int lct_qkv_max_seq() { return lct::kMaxKeys; }

extern "C" int lct_qkv_fwd(const void* qkv, void* out, int B, int S, int H, int hd, int dtype,
                           float scale, void* stream) {
  return (int)lct::attn_fwd<false>(qkv, nullptr, nullptr, 0, 0, out, B, S, 0, H, hd, dtype,
                                   scale, static_cast<cudaStream_t>(stream));
}

// stats: float32 scratch of 3 * B * H * S elements, written then read.
extern "C" int lct_qkv_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int B, int S,
                           int H, int hd, int dtype, float scale, void* stream) {
  return (int)lct::attn_bwd<false>(qkv, nullptr, nullptr, 0, 0, g, dqkv, nullptr, nullptr, stats,
                                   B, S, 0, H, hd, dtype, scale, static_cast<cudaStream_t>(stream));
}
