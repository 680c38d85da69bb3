// Prefix-KV self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of libcontinual_tpu/ops/attention.py:
//   * attn_fwd_kernel             <- _pqkv_kernel      (launched by _pqkv_pallas)
//   * attn_bwd_dq_kernel +
//     attn_bwd_dkdv_kernel        <- _pqkv_bwd_kernel  (launched by _pqkv_bwd_pallas)
//
// The queries are the S rows of the packed (B, S, 3D) qkv tensor; each head
// sees P + S keys and values: the P prompt rows of pk and pv, (B, P, D), then
// the S sequence rows of qkv. The TPU kernel takes the prompt block as a
// second score matmul under one jointly normalised softmax; here both blocks
// load into one shared-memory tile of P + S rows in the same loop, straight
// from their own pointers, so the concatenated K and V never exist in device
// memory and one max and one denominator cover both. The backward writes the
// packed dqkv plus dpk and dpv, one row per image: a prompt broadcast over
// the batch (batch stride 0) gets per-image gradients, which the caller sums.
//
// The kernels are those of attention_kernels.cuh (shared with
// qkv_attention.cu), which states the rounding points, what bounds them on
// an H100 (the bytes, at about 47 us forward and 83 us backward at B 128,
// S 197, P 10 in bf16; the f32 FMA loop of this first version in practice)
// and what the design does about it.

#include "attention_kernels.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// pk, pv: (B, P, D) with row stride D and batch strides pk_bstride,
// pv_bstride in elements (0 for a prefix shared by every image).
extern "C" int lct_pqkv_max_keys() { return lct::kMaxKeys; }

extern "C" int lct_pqkv_fwd(const void* qkv, const void* pk, const void* pv, long long pk_bstride,
                            long long pv_bstride, void* out, int B, int S, int P, int H, int hd,
                            int dtype, float scale, void* stream) {
  return (int)lct::attn_fwd<true>(qkv, pk, pv, pk_bstride, pv_bstride, out, B, S, P, H, hd,
                                  dtype, scale, static_cast<cudaStream_t>(stream));
}

// dqkv (B, S, 3D), dpk and dpv (B, P, D): contiguous outputs. stats: float32
// scratch of 3 * B * H * S elements, written then read.
extern "C" int lct_pqkv_bwd(const void* qkv, const void* pk, const void* pv, long long pk_bstride,
                            long long pv_bstride, const void* g, void* dqkv, void* dpk, void* dpv,
                            void* stats, int B, int S, int P, int H, int hd, int dtype,
                            float scale, void* stream) {
  return (int)lct::attn_bwd<true>(qkv, pk, pv, pk_bstride, pv_bstride, g, dqkv, dpk, dpv, stats,
                                  B, S, P, H, hd, dtype, scale, static_cast<cudaStream_t>(stream));
}
