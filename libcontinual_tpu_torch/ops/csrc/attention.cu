// Self-attention off the packed (B, S, 3D) qkv tensor, forward and backward,
// for Hopper (sm_90a): one library with a plain C interface for the three
// kernel families of attention_kernels.cuh, and the generic (B, H, S, hd)
// attention forward of generic_attention.cuh.
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
//   lct_attn_*  generic q (B, H, Sq, hd), k and v (B, H, Skv, hd), any Sq, Skv
//               and hd 1-128, forward only (the backward is PyTorch ops, as
//               the JAX op's is XLA)
//                                gattn_kernel <- _attention_kernel, and the
//               measurement variants of tools/bench_attention.py
//               (_kernel_v2, _kernel_fast, _kernel_mmonly, _kernel_qblock) and
//               tools/exp_flash_kernel.py (fwd_kernel)
//
// The packed, prefix and masked kernels take any S and P (keys and values
// stream through shared memory in 64-row tiles, nothing grows with S) and
// hd 1-128, like the TPU bodies, which hold a head's (S, S) tile in VMEM.
// Their bf16 instantiations run every product on the tensor cores (mma.sync
// m16n8k16): the forward in two passes over the key tiles so that the
// normalised P is rounded before P . v, as the TPU bodies round it; the
// backward as a per-query-tile dq kernel and a per-key-tile dk/dv kernel (no
// atomics). The f32 instantiations are f32 FMA on the CUDA cores.
// attention_kernels.cuh states the design, the rounding points and what
// bounds the kernels on an H100: the bytes (about 52 us forward and 91 us
// backward at B 128, S 222; 9.4 us forward and 16.5 us backward for the
// masked kernels at B 100, S 77, D 512 in bf16).
//
// dtype: 0 = float32, 1 = bfloat16. Each function returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for a shape or dtype the kernels do not
// take: hd above 128, B or H above 65535). stats: float32 scratch of
// 3 * B * H * S elements, written then read.

#include "attention_kernels.cuh"
#include "generic_attention.cuh"

// ---------------------------------------------------------------- packed qkv

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

// ------------------------------------------------------------------ generic

// The largest head dim of every attention kernel here (any sequence length).
extern "C" int lct_attn_max_head_dim() {
  static_assert(lct::kMaxHeadDim == lct::gattn::kMaxHeadDim, "one head-dim limit");
  return lct::kMaxHeadDim;
}

// q, k, v: element strides on B, H and S (sb, sh, ss) each, the last dim
// contiguous; out: contiguous (B, H, Sq, hd). mode: 0 _attention_kernel (P in
// f32), 1 _kernel_v2, 2 _kernel_v2 without the max, 3 _kernel_fast, 4
// _kernel_fast with bf16 exp, 5 _kernel_mmonly (lct::gattn::Mode). mult: the
// scores' multiplier (scale; scale * log2(e) for modes 3 and 4; unused by 5).
extern "C" int lct_attn_fwd(const void* q, const void* k, const void* v, void* out, int B, int H,
                            int Sq, int Skv, int hd, long long qsb, long long qsh, long long qss,
                            long long ksb, long long ksh, long long kss, long long vsb,
                            long long vsh, long long vss, int dtype, int mode, float mult,
                            void* stream) {
  const lct::gattn::Args a{q,   k,   v,   out, B,   H,   Sq,  Skv, hd,  qsb, qsh,
                           qss, ksb, ksh, kss, vsb, vsh, vss, mult};
  return (int)lct::gattn::forward(a, dtype, mode, static_cast<cudaStream_t>(stream));
}
