// Packed-qkv self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of libcontinual_tpu/ops/attention.py:
//   * qkv_fwd_kernel           <- _qkv_kernel      (launched by _qkv_attention_pallas)
//   * qkv_bwd_dq_kernel +
//     qkv_bwd_dkdv_kernel      <- _qkv_bwd_kernel  (launched by _qkv_bwd_pallas)
//
// Both read the heads straight out of the packed (B, S, 3D) tensor laid out as
// [q | k | v] (row stride 3D, head h at columns h*hd ... h*hd+hd), and write the
// packed layout back, so no head-split copy of qkv ever exists in device memory.
// Neither saves anything of size S x S: the backward recomputes the
// probabilities on chip, as the TPU kernel does.
//
// Rounding points are those of the TPU kernel bodies:
//   forward:  s = (q . k^T in f32) * scale; P = softmax(s) in f32, rounded to the
//             input type before P . v; f32 accumulation; output rounded once.
//   backward: P recomputed in f32; dP = g . v^T; dv = round(P)^T . g;
//             dS = round(P * (dP - rowsum(dP * P))); dq = dS . k * scale;
//             dk = dS^T . q * scale; all products accumulate in f32.
// Products of bf16 values are exact in f32, so the only difference from the
// plain PyTorch version is the order of the f32 sums.
//
// What bounds these kernels on an H100: at ViT-B shapes (S 197-222, hd 64)
// attention is a few hundred FLOP per byte of qkv, so they are bound by
// arithmetic, and this first version does its products on the CUDA cores in
// f32 FMA (not the tensor cores), fed from shared memory. A block keeps a
// whole head's K and V (S <= 256) in shared memory, so every key row is read
// from device memory once per query tile and the S x S scores never leave the
// chip. Each thread owns a small register tile of each product (2 x 4 outputs
// per k step), which cuts shared-memory reads per FMA to 3/4. Moving the
// products onto wgmma with TMA-fed tiles is the next step for speed.
//
// Determinism: every sum runs in a fixed order (no atomics). The backward
// splits into a per-query-tile kernel (dq, plus the row statistics) and a
// per-key-tile kernel (dk, dv) that replays exactly the same score and dP
// arithmetic, so both see bit-identical P and dS.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid over every product tile
constexpr int kQT = 32;        // query rows per tile
constexpr int kKT = 64;        // key columns per tile
constexpr int kMaxS = 256;     // K and V of one head must fit in shared memory

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

// out[i][j] = (X[i] . Y[j]) * scale for a kQT-row tile X against Sp rows of Y
// (both ld-strided, hd deep), in chunks of kKT columns.
__device__ __forceinline__ void scaled_products(const float* X, const float* Y, float* out,
                                                int ld, int ldo, int Sp, int hd,
                                                float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = ty * 2;
  for (int c0 = 0; c0 < Sp; c0 += kKT) {
    const int j0 = c0 + tx * 4;
    float acc[2][4];
    zero(acc);
    mac(acc, X + i0 * ld, ld, 1, Y + j0 * ld, 1, ld, hd);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[(i0 + r) * ldo + j0 + c] = __fmul_rn(acc[r][c], scale);
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

// Row max and row sum of exp(s - max) over the first S entries of one score
// row, by one warp, in a fixed order.
__device__ __forceinline__ void row_stats(const float* s, int S, float* m_out, float* l_out) {
  const int lane = threadIdx.x % 32;
  float m = -INFINITY;
  for (int j = lane; j < S; j += 32) m = fmaxf(m, s[j]);
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < S; j += 32) l += expf(s[j] - m);
  *m_out = m;
  *l_out = warp_sum(l);
}

// ---------------------------------------------------------------- forward

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
qkv_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S, int H, float scale) {
  constexpr int LD = HD + 1;  // odd stride: neighbouring rows fall in other banks
  constexpr int TN = HD / 16;
  const int D = H * HD, Sp = round_up(S, kKT), LDP = Sp + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // kQT x LD
  float* Ks = Qs + kQT * LD;   // Sp x LD
  float* Vs = Ks + Sp * LD;    // Sp x LD
  float* Ps = Vs + Sp * LD;    // kQT x LDP: scores, then P
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (int64_t)b * S * 3 * D + h * HD;

  load_tile(Qs, LD, base, 3 * D, q0, kQT, S, HD);
  load_tile(Ks, LD, base + D, 3 * D, 0, Sp, S, HD);
  load_tile(Vs, LD, base + 2 * D, 3 * D, 0, Sp, S, HD);
  __syncthreads();
  scaled_products(Qs, Ks, Ps, LD, LDP, Sp, HD, scale);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kQT; i += kThreads / 32) {
    float* row = Ps + i * LDP;
    float m, l;
    row_stats(row, S, &m, &l);
    for (int j = lane; j < Sp; j += 32)
      row[j] = j < S ? round_to<T>(expf(row[j] - m) / l) : 0.f;
  }
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = ty * 2, d0 = tx * TN;
  float acc[2][TN];
  zero(acc);
  mac(acc, Ps + i0 * LDP, LDP, 1, Vs + d0, LD, 1, S);
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

// One block per (query tile, head, image): recompute P over full rows, form
// dS, write dq, and store the row statistics (max, sum, rowsum(dP * P)) that
// the key-tile kernel needs to rebuild the same P and dS.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
qkv_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
                  float* __restrict__ stats, int S, int H, float scale) {
  constexpr int LD = HD + 1;
  constexpr int TN = HD / 16;
  const int D = H * HD, Sp = round_up(S, kKT), LDP = Sp + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // kQT x LD
  float* Gs = Qs + kQT * LD;   // kQT x LD
  float* Ks = Gs + kQT * LD;   // Sp x LD
  float* Vs = Ks + Sp * LD;    // Sp x LD
  float* Ss = Vs + Sp * LD;    // kQT x LDP: scores
  float* dS = Ss + kQT * LDP;  // kQT x LDP: dP, then dS
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (int64_t)b * S * 3 * D + h * HD;

  load_tile(Qs, LD, base, 3 * D, q0, kQT, S, HD);
  load_tile(Gs, LD, g + (int64_t)b * S * D + h * HD, D, q0, kQT, S, HD);
  load_tile(Ks, LD, base + D, 3 * D, 0, Sp, S, HD);
  load_tile(Vs, LD, base + 2 * D, 3 * D, 0, Sp, S, HD);
  __syncthreads();
  scaled_products(Qs, Ks, Ss, LD, LDP, Sp, HD, scale);
  scaled_products(Gs, Vs, dS, LD, LDP, Sp, HD, 1.f);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t srow = ((int64_t)b * H + h) * S;  // stats are (3, B, H, S)
  const int64_t splane = (int64_t)gridDim.z * H * S;
  for (int i = warp; i < kQT; i += kThreads / 32) {
    const float* s = Ss + i * LDP;
    float* dp = dS + i * LDP;
    float m, l;
    row_stats(s, S, &m, &l);
    float dsum = 0.f;
    for (int j = lane; j < S; j += 32) dsum += dp[j] * (expf(s[j] - m) / l);
    dsum = warp_sum(dsum);
    for (int j = lane; j < Sp; j += 32) {
      const float p = expf(s[j] - m) / l;
      dp[j] = j < S ? round_to<T>(p * (dp[j] - dsum)) : 0.f;
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
  mac(acc, dS + i0 * LDP, LDP, 1, Ks + d0, LD, 1, S);
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

// One block per (key tile, head, image): walk the query tiles in order,
// rebuild P and dS for this key tile from the stored row statistics, and
// accumulate dv = round(P)^T . g and dk = dS^T . q in registers.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
qkv_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
                    const float* __restrict__ stats, int S, int H, float scale) {
  constexpr int LD = HD + 1;
  constexpr int TN = HD / 16;
  constexpr int LDK = kKT + 1;
  const int D = H * HD;
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
  const int64_t srow = ((int64_t)b * H + h) * S;
  const int64_t splane = (int64_t)gridDim.z * H * S;

  load_tile(Ks, LD, base + D, 3 * D, k0, kKT, S, HD);
  load_tile(Vs, LD, base + 2 * D, 3 * D, k0, kKT, S, HD);

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
          // __fmul_rn: never fused into the subtraction, so s is the value the
          // dq kernel stored
          float p = expf(__fmul_rn(s[r][c], scale) - st[i]) / st[kQT + i];
          if (!row_ok || k0 + j >= S) p = 0.f;
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
    if (kj < S) {
      T* row = dqkv + ((int64_t)b * S + kj) * 3 * D + h * HD + tx * TN;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        row[D + c] = from_f<T>(dk[r][c] * scale);
        row[2 * D + c] = from_f<T>(dv[r][c]);
      }
    }
  }
}

size_t fwd_smem(int S, int hd) {
  const int Sp = round_up(S, kKT), LD = hd + 1;
  return sizeof(float) * ((size_t)kQT * LD + 2 * (size_t)Sp * LD + (size_t)kQT * (Sp + 1));
}

size_t bwd_dq_smem(int S, int hd) {
  const int Sp = round_up(S, kKT), LD = hd + 1;
  return sizeof(float) * (2 * (size_t)kQT * LD + 2 * (size_t)Sp * LD + 2 * (size_t)kQT * (Sp + 1));
}

size_t bwd_dkdv_smem(int hd) {
  const int LD = hd + 1;
  return sizeof(float) * (2 * (size_t)kKT * LD + 2 * (size_t)kQT * LD +
                          2 * (size_t)kQT * (kKT + 1) + 3 * (size_t)kQT);
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* qkv, void* out, int B, int S, int H, float scale,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(S, HD);
  cudaError_t err = cudaFuncSetAttribute(qkv_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kQT - 1) / kQT, H, B);
  qkv_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), S, H, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int B, int S,
                       int H, float scale, cudaStream_t stream) {
  const size_t smem1 = bwd_dq_smem(S, HD), smem2 = bwd_dkdv_smem(HD);
  cudaError_t err = cudaFuncSetAttribute(qkv_bwd_dq_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(qkv_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  dim3 grid1((S + kQT - 1) / kQT, H, B);
  qkv_bwd_dq_kernel<T, HD><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv),
      static_cast<float*>(stats), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2((S + kKT - 1) / kKT, H, B);
  qkv_bwd_dkdv_kernel<T, HD><<<grid2, kThreads, smem2, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv),
      static_cast<const float*>(stats), S, H, scale);
  return cudaGetLastError();
}

bool supported(int B, int S, int H, int hd, int dtype) {
  return B > 0 && S > 0 && S <= kMaxS && H > 0 && B <= 65535 && H <= 65535 &&
         (hd == 16 || hd == 32 || hd == 64) && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int lct_qkv_max_seq() { return kMaxS; }

extern "C" int lct_qkv_fwd(const void* qkv, void* out, int B, int S, int H, int hd, int dtype,
                           float scale, void* stream) {
  if (!supported(B, S, H, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LCT_FWD(T, HD) return (int)launch_fwd<T, HD>(qkv, out, B, S, H, scale, st)
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

// stats: float32 scratch of 3 * B * H * S elements, written then read.
extern "C" int lct_qkv_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int B, int S,
                           int H, int hd, int dtype, float scale, void* stream) {
  if (!supported(B, S, H, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LCT_BWD(T, HD) return (int)launch_bwd<T, HD>(qkv, g, dqkv, stats, B, S, H, scale, st)
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
