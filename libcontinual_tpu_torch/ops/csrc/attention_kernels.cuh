// Self-attention off the packed (B, S, 3D) qkv tensor for Hopper (sm_90a),
// in three compile-time modes (Mode below), all exported by attention.cu:
//   * kPlain   no extra input:           _qkv_kernel  / _qkv_bwd_kernel
//   * kPrefix  P prompt key/value rows:  _pqkv_kernel / _pqkv_bwd_kernel
//   * kMasked  a shared (S, S) f32 additive mask on the scores:
//                                        _mqkv_kernel / _mqkv_bwd_kernel
// (all six in libcontinual_tpu/ops/attention.py).
//
// Keys and values. One head sees N = P + S keys. Key j < P is row j of the
// prefix tensors pk / pv, (B, P, D) with row stride D and a batch stride of
// its own (0 for a prompt broadcast over the batch); key j >= P is sequence
// row j - P of the packed qkv tensor, [q | k | v] with row stride 3D, head h
// at columns h*hd ... h*hd+hd. Both are read straight into one shared-memory
// tile in the same loop, so the concatenated (B, P+S, H, hd) K and V, the
// head-split copy of qkv and the (S, P+S) scores never exist in device memory.
// One softmax runs over all N keys: one max and one denominator over the
// prefix and the sequence scores together.
//
// Masked mode (the CLIP text tower's causal mask). The mask is a (S, S) f32
// tensor with row stride S, shared by every image and head, read straight
// from global memory (L2-resident: 24 KB at S 77) where a score is formed and
// added to it. It gets no gradient. A -1e30 entry gives exactly 0 after
// expf(s - max); padded keys (j >= S) read no mask and stay zero.
//
// Rounding points are those of the TPU kernel bodies:
//   forward:  s = (q . k^T in f32) * scale [+ mask]; P = softmax(s) in f32, rounded to
//             the input type before P . v; f32 accumulation; output rounded once.
//   backward: P recomputed in f32; dP = g . v^T; c = rowsum(dP * P);
//             dv = round(P)^T . g; dS = round(P * (dP - c)); dq = dS . k * scale;
//             dk = dS^T . q * scale; all products accumulate in f32. For a
//             prefix key the same dk and dv are dpk and dpv.
// Products of bf16 values are exact in f32, so the only difference from the
// plain PyTorch versions is the order of the f32 sums.
//
// What bounds these kernels on an H100: at ViT-B shapes (S 197-222, P <= 10,
// hd 64) attention does a few hundred FLOP per byte of qkv, and the least
// time is set by the bytes (about 50 us forward at B 128). This first version
// does its products on the CUDA cores in f32 FMA, fed from shared memory, so
// it is bound by those FMAs and the shared-memory reads that feed them, far
// from either roofline. A block keeps a whole head's N <= 256 keys and values
// in shared memory, so every key row is read from device memory once per
// query tile and the scores never leave the chip. Each thread owns a small
// register tile of each product (2 x 4 outputs per k step), which cuts
// shared-memory reads per FMA to 3/4. wgmma on bf16 tiles fed by TMA is the
// next step for speed.
//
// The mode is a template argument, so each instantiation compiles without the
// other modes' branches.
//
// Determinism: every sum runs in a fixed order (no atomics). The backward
// splits into a per-query-tile kernel (dq, plus the row statistics) and a
// per-key-tile kernel (dk, dv, or dpk, dpv for prefix keys) that replays the
// same score and dP arithmetic, so both see bit-identical P and dS. Both form
// a score as __fadd_rn(__fmul_rn(q . k, scale), mask): the explicit roundings
// forbid the compiler to fuse the scale and the mask into an fma in one
// kernel and not in the other.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lct {

constexpr int kThreads = 256;  // 16 x 16 thread grid over every product tile
constexpr int kQT = 32;        // query rows per tile
constexpr int kKT = 64;        // key columns per tile
constexpr int kMaxKeys = 256;  // K and V of one head (P + S rows) in shared memory

enum Mode : int { kPlain = 0, kPrefix = 1, kMasked = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded through the storage type: the TPU kernel's `.astype(x.dtype)`.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Copy `rows` rows of one head (hd columns) from global memory into a float
// tile with leading dimension ld; rows at or past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t row_stride, int row0, int rows,
                                          int S, int hd) {
  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int r = e / hd, c = e - (e / hd) * hd;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < S ? to_f(src[(int64_t)gr * row_stride + c]) : 0.f;
  }
}

// Copy keys (or values) row0 ... row0+rows of one head: key j < P from the
// prefix rows `pre` (row stride D), key P <= j < P + S from the sequence rows
// `seq` (row stride 3D); keys at or past P + S are zero.
template <bool PREFIX, typename T>
__device__ __forceinline__ void load_keys(float* dst, int ld, const T* pre, const T* seq,
                                          int row0, int rows, int P, int S, int D, int hd) {
  for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
    const int r = e / hd, c = e - (e / hd) * hd;
    const int j = row0 + r;
    float x = 0.f;
    if (PREFIX && j < P)
      x = to_f(pre[(int64_t)j * D + c]);
    else if (j < P + S)
      x = to_f(seq[(int64_t)(j - P) * 3 * D + c]);
    dst[r * ld + c] = x;
  }
}

// acc[r][c] += sum_{k < K} A[r*am + k*ak] * B[k*bk + c*bn], k ascending, one
// fmaf per term. The fixed order makes the same product bit-identical in every
// kernel that computes it.
template <int TM, int TN>
__device__ __forceinline__ void mac(float (&acc)[TM][TN], const float* A, int am, int ak,
                                    const float* B, int bk, int bn, int K) {
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) a[r] = A[r * am + k * ak];
#pragma unroll
    for (int c = 0; c < TN; ++c) b[c] = B[k * bk + c * bn];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
}

// out[i][j] = (X[i] . Y[j]) * scale for a kQT-row tile X against Np rows of Y
// (both ld-strided, hd deep), in chunks of kKT columns. With MASK,
// mask[i * mask_ld + j] is added for i < rows and j < cols.
template <bool MASK>
__device__ __forceinline__ void scaled_products(const float* X, const float* Y, float* out,
                                                int ld, int ldo, int Np, int hd, float scale,
                                                const float* mask, int mask_ld, int rows,
                                                int cols) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = ty * 2;
  for (int c0 = 0; c0 < Np; c0 += kKT) {
    const int j0 = c0 + tx * 4;
    float acc[2][4];
    zero(acc);
    mac(acc, X + i0 * ld, ld, 1, Y + j0 * ld, 1, ld, hd);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = __fmul_rn(acc[r][c], scale);
        const int i = i0 + r, j = j0 + c;
        if (MASK && i < rows && j < cols) v = __fadd_rn(v, mask[(int64_t)i * mask_ld + j]);
        out[i * ldo + j] = v;
      }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row max and row sum of exp(s - max) over the first N entries of one score
// row, by one warp, in a fixed order.
__device__ __forceinline__ void row_stats(const float* s, int N, float* m_out, float* l_out) {
  const int lane = threadIdx.x % 32;
  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) m = fmaxf(m, s[j]);
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < N; j += 32) l += expf(s[j] - m);
  *m_out = m;
  *l_out = warp_sum(l);
}

// ---------------------------------------------------------------- forward

// One block per (query tile, head, image).
template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ pk, const T* __restrict__ pv,
                int64_t pk_bstride, int64_t pv_bstride, const float* __restrict__ mask,
                T* __restrict__ out, int S, int P, int H, float scale) {
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked;
  constexpr int LD = HD + 1;  // odd stride: neighbouring rows fall in other banks
  constexpr int TN = HD / 16;
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * HD, N = P + S, Np = round_up(N, kKT), LDP = Np + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // kQT x LD
  float* Ks = Qs + kQT * LD;   // Np x LD
  float* Vs = Ks + Np * LD;    // Np x LD
  float* Ps = Vs + Np * LD;    // kQT x LDP: scores, then P
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (int64_t)b * S * 3 * D + h * HD;
  const T* pkb = PREFIX ? pk + (int64_t)b * pk_bstride + h * HD : nullptr;
  const T* pvb = PREFIX ? pv + (int64_t)b * pv_bstride + h * HD : nullptr;

  load_tile(Qs, LD, base, 3 * D, q0, kQT, S, HD);
  load_keys<PREFIX>(Ks, LD, pkb, base + D, 0, Np, P, S, D, HD);
  load_keys<PREFIX>(Vs, LD, pvb, base + 2 * D, 0, Np, P, S, D, HD);
  __syncthreads();
  scaled_products<MASK>(Qs, Ks, Ps, LD, LDP, Np, HD, scale,
                        MASK ? mask + (int64_t)q0 * S : nullptr, S, S - q0, S);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kQT; i += kThreads / 32) {
    float* row = Ps + i * LDP;
    float m, l;
    row_stats(row, N, &m, &l);
    for (int j = lane; j < Np; j += 32)
      row[j] = j < N ? round_to<T>(expf(row[j] - m) / l) : 0.f;
  }
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = ty * 2, d0 = tx * TN;
  float acc[2][TN];
  zero(acc);
  mac(acc, Ps + i0 * LDP, LDP, 1, Vs + d0, LD, 1, N);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + i0 + r;
    if (qi < S) {
#pragma unroll
      for (int c = 0; c < TN; ++c)
        out[((int64_t)b * S + qi) * D + h * HD + d0 + c] = from_f<T>(acc[r][c]);
    }
  }
}

// --------------------------------------------------------------- backward

// One block per (query tile, head, image): recompute P over full rows of N
// keys, form dS, write dq, and store the row statistics (max, sum,
// rowsum(dP * P)) that the key-tile kernel needs to rebuild the same P and dS.
template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ pk,
                   const T* __restrict__ pv, int64_t pk_bstride, int64_t pv_bstride,
                   const float* __restrict__ mask, const T* __restrict__ g,
                   T* __restrict__ dqkv, float* __restrict__ stats, int S, int P, int H,
                   float scale) {
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked;
  constexpr int LD = HD + 1;
  constexpr int TN = HD / 16;
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * HD, N = P + S, Np = round_up(N, kKT), LDP = Np + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // kQT x LD
  float* Gs = Qs + kQT * LD;   // kQT x LD
  float* Ks = Gs + kQT * LD;   // Np x LD
  float* Vs = Ks + Np * LD;    // Np x LD
  float* Ss = Vs + Np * LD;    // kQT x LDP: scores
  float* dS = Ss + kQT * LDP;  // kQT x LDP: dP, then dS
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (int64_t)b * S * 3 * D + h * HD;
  const T* pkb = PREFIX ? pk + (int64_t)b * pk_bstride + h * HD : nullptr;
  const T* pvb = PREFIX ? pv + (int64_t)b * pv_bstride + h * HD : nullptr;

  load_tile(Qs, LD, base, 3 * D, q0, kQT, S, HD);
  load_tile(Gs, LD, g + (int64_t)b * S * D + h * HD, D, q0, kQT, S, HD);
  load_keys<PREFIX>(Ks, LD, pkb, base + D, 0, Np, P, S, D, HD);
  load_keys<PREFIX>(Vs, LD, pvb, base + 2 * D, 0, Np, P, S, D, HD);
  __syncthreads();
  scaled_products<MASK>(Qs, Ks, Ss, LD, LDP, Np, HD, scale,
                        MASK ? mask + (int64_t)q0 * S : nullptr, S, S - q0, S);
  scaled_products<false>(Gs, Vs, dS, LD, LDP, Np, HD, 1.f, nullptr, 0, 0, 0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t srow = ((int64_t)b * H + h) * S;  // stats are (3, B, H, S)
  const int64_t splane = (int64_t)gridDim.z * H * S;
  for (int i = warp; i < kQT; i += kThreads / 32) {
    const float* s = Ss + i * LDP;
    float* dp = dS + i * LDP;
    float m, l;
    row_stats(s, N, &m, &l);
    float dsum = 0.f;
    for (int j = lane; j < N; j += 32) dsum += dp[j] * (expf(s[j] - m) / l);
    dsum = warp_sum(dsum);
    for (int j = lane; j < Np; j += 32) {
      const float p = expf(s[j] - m) / l;
      dp[j] = j < N ? round_to<T>(p * (dp[j] - dsum)) : 0.f;
    }
    const int qi = q0 + i;
    if (lane == 0 && qi < S) {
      stats[srow + qi] = m;
      stats[splane + srow + qi] = l;
      stats[2 * splane + srow + qi] = dsum;
    }
  }
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = ty * 2, d0 = tx * TN;
  float acc[2][TN];
  zero(acc);
  mac(acc, dS + i0 * LDP, LDP, 1, Ks + d0, LD, 1, N);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + i0 + r;
    if (qi < S) {
#pragma unroll
      for (int c = 0; c < TN; ++c)
        dqkv[((int64_t)b * S + qi) * 3 * D + h * HD + d0 + c] = from_f<T>(acc[r][c] * scale);
    }
  }
}

// One block per (key tile, head, image) over the N keys: walk the query tiles
// in order, rebuild P and dS for this key tile from the stored row
// statistics, and accumulate dv = round(P)^T . g and dk = dS^T . q in
// registers. A prefix key's dk and dv go to dpk and dpv ((B, P, D),
// contiguous), a sequence key's into the packed dqkv.
template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ pk,
                     const T* __restrict__ pv, int64_t pk_bstride, int64_t pv_bstride,
                     const float* __restrict__ mask, const T* __restrict__ g,
                     T* __restrict__ dqkv, T* __restrict__ dpk, T* __restrict__ dpv,
                     const float* __restrict__ stats, int S, int P, int H, float scale) {
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked;
  constexpr int LD = HD + 1;
  constexpr int TN = HD / 16;
  constexpr int LDK = kKT + 1;
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * HD, N = P + S;
  extern __shared__ float smem[];
  float* Ks = smem;             // kKT x LD
  float* Vs = Ks + kKT * LD;    // kKT x LD
  float* Qs = Vs + kKT * LD;    // kQT x LD
  float* Gs = Qs + kQT * LD;    // kQT x LD
  float* Pb = Gs + kQT * LD;    // kQT x LDK: round(P)
  float* dS = Pb + kQT * LDK;   // kQT x LDK
  float* st = dS + kQT * LDK;   // 3 x kQT: max, sum, rowsum(dP * P)
  const int k0 = blockIdx.x * kKT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (int64_t)b * S * 3 * D + h * HD;
  const T* gbase = g + (int64_t)b * S * D + h * HD;
  const T* pkb = PREFIX ? pk + (int64_t)b * pk_bstride + h * HD : nullptr;
  const T* pvb = PREFIX ? pv + (int64_t)b * pv_bstride + h * HD : nullptr;
  const int64_t srow = ((int64_t)b * H + h) * S;
  const int64_t splane = (int64_t)gridDim.z * H * S;

  load_keys<PREFIX>(Ks, LD, pkb, base + D, k0, kKT, P, S, D, HD);
  load_keys<PREFIX>(Vs, LD, pvb, base + 2 * D, k0, kKT, P, S, D, HD);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float dv[4][TN], dk[4][TN];
  zero(dv);
  zero(dk);
  for (int q0 = 0; q0 < S; q0 += kQT) {
    __syncthreads();  // previous tile's Pb/dS/Qs/Gs fully consumed
    load_tile(Qs, LD, base, 3 * D, q0, kQT, S, HD);
    load_tile(Gs, LD, gbase, D, q0, kQT, S, HD);
    for (int e = threadIdx.x; e < kQT; e += blockDim.x) {
      const bool ok = q0 + e < S;
      st[e] = ok ? stats[srow + q0 + e] : 0.f;
      st[kQT + e] = ok ? stats[splane + srow + q0 + e] : 1.f;
      st[2 * kQT + e] = ok ? stats[2 * splane + srow + q0 + e] : 0.f;
    }
    __syncthreads();
    {
      const int i0 = ty * 2, j0 = tx * 4;
      float s[2][4], dp[2][4];
      zero(s);
      zero(dp);
      mac(s, Qs + i0 * LD, LD, 1, Ks + j0 * LD, 1, LD, HD);
      mac(dp, Gs + i0 * LD, LD, 1, Vs + j0 * LD, 1, LD, HD);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + r;
        const bool row_ok = q0 + i < S;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;
          // __fmul_rn / __fadd_rn: never fused, so sv is the score the dq
          // kernel stored
          float sv = __fmul_rn(s[r][c], scale);
          if (MASK && row_ok && k0 + j < N)
            sv = __fadd_rn(sv, mask[(int64_t)(q0 + i) * S + k0 + j]);
          float p = expf(sv - st[i]) / st[kQT + i];
          if (!row_ok || k0 + j >= N) p = 0.f;
          Pb[i * LDK + j] = round_to<T>(p);
          dS[i * LDK + j] = round_to<T>(p * (dp[r][c] - st[2 * kQT + i]));
        }
      }
    }
    __syncthreads();
    const int n = min(kQT, S - q0);
    mac(dv, Pb + ty * 4, 1, LDK, Gs + tx * TN, LD, 1, n);
    mac(dk, dS + ty * 4, 1, LDK, Qs + tx * TN, LD, 1, n);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty * 4 + r;
    T* krow = nullptr;
    T* vrow = nullptr;
    if (PREFIX && kj < P) {
      krow = dpk + ((int64_t)b * P + kj) * D + h * HD + tx * TN;
      vrow = dpv + ((int64_t)b * P + kj) * D + h * HD + tx * TN;
    } else if (kj < N) {
      krow = dqkv + ((int64_t)b * S + kj - P) * 3 * D + D + h * HD + tx * TN;
      vrow = krow + D;
    }
    if (krow != nullptr) {
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        krow[c] = from_f<T>(dk[r][c] * scale);
        vrow[c] = from_f<T>(dv[r][c]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

inline size_t fwd_smem(int N, int hd) {
  const int Np = round_up(N, kKT), LD = hd + 1;
  return sizeof(float) * ((size_t)kQT * LD + 2 * (size_t)Np * LD + (size_t)kQT * (Np + 1));
}

inline size_t bwd_dq_smem(int N, int hd) {
  const int Np = round_up(N, kKT), LD = hd + 1;
  return sizeof(float) * (2 * (size_t)kQT * LD + 2 * (size_t)Np * LD + 2 * (size_t)kQT * (Np + 1));
}

inline size_t bwd_dkdv_smem(int hd) {
  const int LD = hd + 1;
  return sizeof(float) * (2 * (size_t)kKT * LD + 2 * (size_t)kQT * LD +
                          2 * (size_t)kQT * (kKT + 1) + 3 * (size_t)kQT);
}

// What the kernels take: at most 65535 images and heads (grid y and z), P + S
// keys in 1 ... kMaxKeys, hd 16, 32 or 64, float32 (0) or bfloat16 (1).
inline bool supported(int B, int S, int P, int H, int hd, int dtype) {
  return B > 0 && S > 0 && P >= 0 && P + S <= kMaxKeys && H > 0 && B <= 65535 &&
         H <= 65535 && (hd == 16 || hd == 32 || hd == 64) && (dtype == 0 || dtype == 1);
}

template <typename T, int HD, int MODE>
cudaError_t launch_fwd(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                       int64_t pv_bstride, const float* mask, void* out, int B, int S, int P,
                       int H, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(P + S, HD);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, HD, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kQT - 1) / kQT, H, B);
  attn_fwd_kernel<T, HD, MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(pk), static_cast<const T*>(pv),
      pk_bstride, pv_bstride, mask, static_cast<T*>(out), S, P, H, scale);
  return cudaGetLastError();
}

template <typename T, int HD, int MODE>
cudaError_t launch_bwd(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                       int64_t pv_bstride, const float* mask, const void* g, void* dqkv,
                       void* dpk, void* dpv, void* stats, int B, int S, int P, int H,
                       float scale, cudaStream_t stream) {
  const size_t smem1 = bwd_dq_smem(P + S, HD), smem2 = bwd_dkdv_smem(HD);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, HD, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, HD, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  const T* pk_ = static_cast<const T*>(pk);
  const T* pv_ = static_cast<const T*>(pv);
  dim3 grid1((S + kQT - 1) / kQT, H, B);
  attn_bwd_dq_kernel<T, HD, MODE><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(qkv), pk_, pv_, pk_bstride, pv_bstride, mask,
      static_cast<const T*>(g), static_cast<T*>(dqkv), static_cast<float*>(stats), S, P, H,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2((P + S + kKT - 1) / kKT, H, B);
  attn_bwd_dkdv_kernel<T, HD, MODE><<<grid2, kThreads, smem2, stream>>>(
      static_cast<const T*>(qkv), pk_, pv_, pk_bstride, pv_bstride, mask,
      static_cast<const T*>(g), static_cast<T*>(dqkv), static_cast<T*>(dpk),
      static_cast<T*>(dpv), static_cast<const float*>(stats), S, P, H, scale);
  return cudaGetLastError();
}

// Whether the mode's extra inputs are there: kPrefix needs P >= 1 (others
// P == 0), kMasked a mask (others none).
template <int MODE>
bool mode_inputs_ok(int P, const float* mask) {
  return (P > 0) == (MODE == kPrefix) && (mask != nullptr) == (MODE == kMasked);
}

// Forward and backward for any supported (dtype, hd); a cudaError_t, 0 on
// success. stats: float32 scratch of 3 * B * H * S elements, written then read.
template <int MODE>
cudaError_t attn_fwd(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                     int64_t pv_bstride, const float* mask, void* out, int B, int S, int P,
                     int H, int hd, int dtype, float scale, cudaStream_t st) {
  if (!supported(B, S, P, H, hd, dtype) || !mode_inputs_ok<MODE>(P, mask))
    return cudaErrorInvalidValue;
#define LCT_FWD(T, HD)                                                                       \
  return launch_fwd<T, HD, MODE>(qkv, pk, pv, pk_bstride, pv_bstride, mask, out, B, S, P, H, \
                                 scale, st)
  if (dtype == 0) {
    if (hd == 16) LCT_FWD(float, 16);
    if (hd == 32) LCT_FWD(float, 32);
    LCT_FWD(float, 64);
  }
  if (hd == 16) LCT_FWD(__nv_bfloat16, 16);
  if (hd == 32) LCT_FWD(__nv_bfloat16, 32);
  LCT_FWD(__nv_bfloat16, 64);
#undef LCT_FWD
}

template <int MODE>
cudaError_t attn_bwd(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                     int64_t pv_bstride, const float* mask, const void* g, void* dqkv,
                     void* dpk, void* dpv, void* stats, int B, int S, int P, int H, int hd,
                     int dtype, float scale, cudaStream_t st) {
  if (!supported(B, S, P, H, hd, dtype) || !mode_inputs_ok<MODE>(P, mask))
    return cudaErrorInvalidValue;
#define LCT_BWD(T, HD)                                                                     \
  return launch_bwd<T, HD, MODE>(qkv, pk, pv, pk_bstride, pv_bstride, mask, g, dqkv, dpk, \
                                 dpv, stats, B, S, P, H, scale, st)
  if (dtype == 0) {
    if (hd == 16) LCT_BWD(float, 16);
    if (hd == 32) LCT_BWD(float, 32);
    LCT_BWD(float, 64);
  }
  if (hd == 16) LCT_BWD(__nv_bfloat16, 16);
  if (hd == 32) LCT_BWD(__nv_bfloat16, 32);
  LCT_BWD(__nv_bfloat16, 64);
#undef LCT_BWD
}

}  // namespace lct
