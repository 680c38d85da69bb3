// Self-attention off the packed (B, S, 3D) qkv tensor, forward and backward,
// for Hopper (sm_90a): one library with a plain C interface for the three
// kernel families of attention_kernels.cuh.
//
// Replaces the Pallas TPU kernels of libcontinual_tpu/ops/attention.py:
//   lct_qkv_*   packed qkv       attn_fwd_kernel <- _qkv_kernel
//                                attn_bwd_dq_kernel + attn_bwd_dkdv_kernel <- _qkv_bwd_kernel
//   lct_pqkv_*  prefix keys/values, P rows of pk and pv (B, P, D) in front of each
//               head's keys; one softmax over P + S keys, K and V never concatenated
//                                <- _pqkv_kernel / _pqkv_bwd_kernel
//   lct_mqkv_*  a shared (S, S) f32 additive mask on the scores (the CLIP text
//               tower's causal mask); the mask gets no gradient
//                                <- _mqkv_kernel / _mqkv_bwd_kernel
//
// The header states the rounding points, what bounds the kernels on an H100
// (the bytes: about 52 us forward at B 128, S 222; 9.4 us forward and 16.5 us
// backward for the masked kernels at B 100, S 77, D 512 in bf16; the f32 FMA
// loop of this first version in practice) and what the design does about it.
//
// dtype: 0 = float32, 1 = bfloat16. Each function returns a cudaError_t (0 on
// success). stats: float32 scratch of 3 * B * H * S elements, written then read.

#include "attention_kernels.cuh"

// ---------------------------------------------------------------- packed qkv

extern "C" int lct_qkv_max_seq() { return lct::kMaxKeys; }

extern "C" int lct_qkv_fwd(const void* qkv, void* out, int B, int S, int H, int hd, int dtype,
                           float scale, void* stream) {
  return (int)lct::attn_fwd<lct::kPlain>(qkv, nullptr, nullptr, 0, 0, nullptr, out, B, S, 0, H,
                                         hd, dtype, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int lct_qkv_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int B, int S,
                           int H, int hd, int dtype, float scale, void* stream) {
  return (int)lct::attn_bwd<lct::kPlain>(qkv, nullptr, nullptr, 0, 0, nullptr, g, dqkv, nullptr,
                                         nullptr, stats, B, S, 0, H, hd, dtype, scale,
                                         static_cast<cudaStream_t>(stream));
}

// ------------------------------------------------------------- prefix keys/values

// pk, pv: (B, P, D) with row stride D and batch strides pk_bstride,
// pv_bstride in elements (0 for a prefix shared by every image).
extern "C" int lct_pqkv_max_keys() { return lct::kMaxKeys; }

extern "C" int lct_pqkv_fwd(const void* qkv, const void* pk, const void* pv, long long pk_bstride,
                            long long pv_bstride, void* out, int B, int S, int P, int H, int hd,
                            int dtype, float scale, void* stream) {
  return (int)lct::attn_fwd<lct::kPrefix>(qkv, pk, pv, pk_bstride, pv_bstride, nullptr, out, B, S,
                                          P, H, hd, dtype, scale,
                                          static_cast<cudaStream_t>(stream));
}

// dqkv (B, S, 3D), dpk and dpv (B, P, D): contiguous outputs.
extern "C" int lct_pqkv_bwd(const void* qkv, const void* pk, const void* pv, long long pk_bstride,
                            long long pv_bstride, const void* g, void* dqkv, void* dpk, void* dpv,
                            void* stats, int B, int S, int P, int H, int hd, int dtype,
                            float scale, void* stream) {
  return (int)lct::attn_bwd<lct::kPrefix>(qkv, pk, pv, pk_bstride, pv_bstride, nullptr, g, dqkv,
                                          dpk, dpv, stats, B, S, P, H, hd, dtype, scale,
                                          static_cast<cudaStream_t>(stream));
}

// ------------------------------------------------------------------ masked

// mask: (S, S) float32, contiguous, added to every image's and head's scores.
extern "C" int lct_mqkv_max_seq() { return lct::kMaxKeys; }

extern "C" int lct_mqkv_fwd(const void* qkv, const float* mask, void* out, int B, int S, int H,
                            int hd, int dtype, float scale, void* stream) {
  return (int)lct::attn_fwd<lct::kMasked>(qkv, nullptr, nullptr, 0, 0, mask, out, B, S, 0, H, hd,
                                          dtype, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int lct_mqkv_bwd(const void* qkv, const float* mask, const void* g, void* dqkv,
                            void* stats, int B, int S, int H, int hd, int dtype, float scale,
                            void* stream) {
  return (int)lct::attn_bwd<lct::kMasked>(qkv, nullptr, nullptr, 0, 0, mask, g, dqkv, nullptr,
                                          nullptr, stats, B, S, 0, H, hd, dtype, scale,
                                          static_cast<cudaStream_t>(stream));
}
