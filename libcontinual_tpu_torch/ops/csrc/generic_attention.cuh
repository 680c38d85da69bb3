// Generic attention forward, softmax(q . k^T * scale) . v over (B, H, S, hd)
// tensors, for Hopper (sm_90a), exported by attention.cu. One template,
// gattn_kernel<T, HDP, MODE>, computes:
//   * kExact     _attention_kernel (libcontinual_tpu/ops/attention.py), the
//                generic op's TPU forward: P kept in f32;
//   * kV2        _kernel_v2 of tools/bench_attention.py with the max
//                subtracted, and fwd_kernel of tools/exp_flash_kernel.py (the
//                same function on Sq == Skv);
//   * kV2NoMax   _kernel_v2 without the max;
//   * kFast      _kernel_fast and _kernel_qblock (the same function): exp2
//                with scale * log2(e) folded into the scores, no max;
//   * kFastBf16  _kernel_fast with bf16_sm: exp2 of the bf16 scores, in bf16;
//   * kMMOnly    _kernel_mmonly: S = q . k^T rounded to the input type, then
//                S . v; no scale, no softmax.
//
// Layout. q is (B, H, Sq, hd) and k, v are (B, H, Skv, hd), each read through
// its own element strides on B, H and S (the last dim is contiguous), so a
// (B, S, H, hd) tensor passed as .transpose(1, 2) is read in place. Any
// Sq >= 1, any Skv >= 1 (longer or shorter than Sq) and hd 1 ... 128: hd is
// padded to HDP in {16, 32, 64, 128} with zero columns in shared memory only.
// The output is contiguous (B, H, Sq, hd), in the input type.
//
// What bounds it on an H100: at ViT-B/16 shapes (B 128, H 12, S 197-222,
// hd 64, bf16) the work is about 300 FLOP per byte of q, k, v and o, at the
// bf16 tensor-core ridge, so the least time is about 46-52 us, set by the
// bytes. At B 8, Sq = Skv = 1024, hd 128 the work is operation-bound.
//
// Design of the bf16 instantiations, that of the packed forward
// (attn_fwd_kernel in attention_kernels.cuh), whose primitives it uses: both
// products on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
// accumulators). One block of 4 warps per (64-query tile, head, image),
// each warp owning 16 query rows (a thread's: rows g and g + 8 of the
// warp's, g = lane / 4). The Q tile is staged once
// and held as A-fragments (at hd 128 read from shared memory at each use:
// holding them would spill). K and V stream in 64-key bf16 tiles by
// 16-byte cp.async copies, double-buffered, each read through its own B, H
// and S strides (stage_rows; rows that are not whole 16-byte chunks, or not
// 16-byte aligned, element by element), so shared memory does not grow with
// Skv; rows past Sq or Skv and columns past hd are zero in shared memory
// only. The scores S = Q . K^T land in the accumulator registers (a row's
// 64 scores in the 4 lanes of a quad, reduced with shuffles in a fixed
// order); P goes from there straight into A-fragments, rounded to bf16 as
// it is packed, and O += P . V takes V through ldmatrix.trans. Keys past
// Skv get P = 0 by a select; query rows past Sq are not stored.
//   The variants (kV2, kV2NoMax, kFast, kFastBf16) round the normalised P
//     before P . v, so they need each row's sum (kV2: and max) before the
//     first product: pass 1 over the key tiles forms the scores and the row
//     statistics (kV2's sum rescaled online as the max grows), pass 2 forms
//     the scores again, the mode's rounded P in the score registers, and
//     O += P . V. kV2 and kV2NoMax form the quotient exp(.) / l as
//     softmax_prob (the product with the correctly rounded 1 / l, corrected
//     by one fma: the division's value almost always, with no divide per
//     score); kFast* keep their product with 1 / l, which is their function.
//   kMMOnly is one pass: round(q . k^T) goes straight into the A-fragments.
//   kExact is one pass with an online softmax: a running max m, a running
//     sum l and the f32 output accumulator rescaled by exp(m_old - m_new);
//     the output is o / l, rounded once. P stays in f32, and its product
//     with V is split: hi = bf16(P), lo = bf16(P - hi), o += hi . V + lo . V
//     (two passes of mma over the same V tile; V is exact in bf16). That leaves
//     |P - hi - lo| <= 2^-18 P, far below the output's one bf16 rounding:
//     the one departure from the TPU body's f32 P . v, which is otherwise
//     the same function up to the order of the f32 sums, at any Skv.
// Registers are capped at 128 (hd <= 64) so that 4 blocks share an SM;
// shared memory is 5 tiles (Q, 2 K, 2 V) of 64 x (HDP + 8) bf16, 46 KB at
// hd 64, whatever Skv.
//
// The f32 instantiations (the checks hold them to 1e-5, so no TF32) are the
// first version's body, in f32 FMA on the CUDA
// cores: 256 threads on a 16 x 16 grid, each owning rows ty + 16 r (r < 4)
// of the tile and, in the score product, key columns tx + 16 c (c < 4), in
// the output product head columns tx + 16 c (c < HDP / 16); K and V in f32
// shared tiles (kThreads, LD = HDP + 1, the Ps tile of P: f32 only).
//
// Rounding points (those of the TPU bodies; the plain PyTorch versions in
// ops/attention.py repeat them):
//   scores  s = (q . k^T in f32) * scale (kFast*: * scale * log2(e), the
//           wrapper's one f32 multiplier); __fmul_rn so no fma fuses it;
//   kExact  p = exp(s - m) in f32, o = round((sum p v) / l) (bf16: p v as
//           hi v + lo v, above);
//   kV2     p = round(exp(s - m) / l);  kV2NoMax  p = round(exp(s) / l);
//   kFast   p = round(exp2(s) * (1 / l));
//   kFastBf16  e = bf16(exp2(bf16(s))), l = sum e in f32, p = round(e * (1 / l));
//   kMMOnly p = round(q . k^T);
//   then o = round(sum p v), every sum in f32. round() is the cast to the
//   input type. pl.reciprocal(approx=True) of the fast bodies is the exact
//   reciprocal here (__frcp_rn), as in the plain versions.
//
// Determinism: every sum runs in a fixed order; no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_kernels.cuh"

namespace lct {
namespace gattn {

constexpr int kThreads = 256;  // f32 only: a 16 x 16 thread grid
constexpr int kTile = 64;      // query rows and key rows per tile (kMmaRows, kKT in bf16)
constexpr int kMaxHeadDim = 128;

enum Mode : int { kExact = 0, kV2 = 1, kV2NoMax = 2, kFast = 3, kFastBf16 = 4, kMMOnly = 5 };

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ T store_f(float x);
template <>
__device__ __forceinline__ float store_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded through the storage type: the TPU body's `.astype(dtype)`.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  const T t = store_f<T>(x);
  return load_f(&t);
}

// Copy rows row0 ... row0+63 of one head (element strides: row_stride between
// rows, 1 between columns) into a kTile x LD float tile; rows at or past
// `rows` and columns at or past hd are zero.
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t row_stride, int row0,
                                          int rows, int hd) {
  constexpr int LD = HDP + 1;
  for (int e = threadIdx.x; e < kTile * HDP; e += kThreads) {
    const int r = e / HDP, c = e % HDP;
    const int gr = row0 + r;
    dst[r * LD + c] = (gr < rows && c < hd) ? load_f(src + (int64_t)gr * row_stride + c) : 0.f;
  }
}

// Row max and row sum over the 16 lanes that share a row (lanes differ in
// their low 4 bits), in a fixed order.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[r][c] = (Q row ty+16r) . (K row tx+16c) over HDP columns, k ascending,
// one fmaf per term; then the mode's multiplier (kMMOnly: rounded to T).
template <typename T, int HDP, int MODE>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* Qs, const float* Ks,
                                       float mult) {
  constexpr int LD = HDP + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < HDP; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Qs[(ty + 16 * r) * LD + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Ks[(tx + 16 * c) * LD + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[r][c] = MODE == kMMOnly ? round_to<T>(s[r][c]) : __fmul_rn(s[r][c], mult);
}

// The unnormalized weight of one score in the first pass of a variant
// (kV2: relative to the row max m).
template <int MODE>
__device__ __forceinline__ float weight(float s, float m) {
  if constexpr (MODE == kV2) return expf(s - m);
  if constexpr (MODE == kV2NoMax) return expf(s);
  if constexpr (MODE == kFast) return exp2f(s);
  // kFastBf16: exp2 of the bf16 score, rounded to bf16
  return round_to<__nv_bfloat16>(exp2f(round_to<__nv_bfloat16>(s)));
}

// f32: one block of kThreads per (64-query tile, head, image), FMA on the
// CUDA cores.
template <typename T, int HDP, int MODE>
__device__ __forceinline__ void gattn_fma(float* smem, const T* __restrict__ q,
                                          const T* __restrict__ k, const T* __restrict__ v,
                                          T* __restrict__ out, int H, int Sq, int Skv, int hd,
                                          int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                                          int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                                          int64_t vss, float mult) {
  constexpr int LD = HDP + 1;    // odd stride: rows tx and tx + 1 in other banks
  constexpr int LDP = kTile + 1;
  constexpr int TN = HDP / 16;   // output columns a thread owns
  constexpr bool TWO_PASS = MODE != kExact && MODE != kMMOnly;
  float* Qs = smem;              // kTile x LD
  float* Ks = Qs + kTile * LD;   // kTile x LD
  float* Vs = Ks + kTile * LD;   // kTile x LD
  float* Ps = Vs + kTile * LD;   // kTile x LDP: this tile's P
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + (int64_t)b * qsb + (int64_t)h * qsh;
  const T* kb = k + (int64_t)b * ksb + (int64_t)h * ksh;
  const T* vb = v + (int64_t)b * vsb + (int64_t)h * vsh;

  load_rows<T, HDP>(Qs, qb, qss, q0, Sq, hd);

  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = MODE == kV2 || MODE == kExact ? -INFINITY : 0.f;
    l[r] = 0.f;
  }
  float s[4][4];

  if (TWO_PASS) {  // the row max (kV2) and sum of every key, before any P . v
    for (int k0 = 0; k0 < Skv; k0 += kTile) {
      __syncthreads();  // the previous tile's K fully read (and Qs written)
      load_rows<T, HDP>(Ks, kb, kss, k0, Skv, hd);
      __syncthreads();
      scores<T, HDP, MODE>(s, Qs, Ks, mult);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float m_new = m[r];
        if (MODE == kV2) {
          float tmax = -INFINITY;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k0 + tx + 16 * c < Skv) tmax = fmaxf(tmax, s[r][c]);
          m_new = fmaxf(m[r], row_max(tmax));
        }
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + tx + 16 * c < Skv) part += weight<MODE>(s[r][c], m_new);
        part = row_sum(part);
        l[r] = MODE == kV2 ? fmaf(l[r], expf(m[r] - m_new), part) : l[r] + part;
        m[r] = m_new;
      }
    }
  }

  float acc[4][TN];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  float inv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) inv[r] = __frcp_rn(l[r]);

  for (int k0 = 0; k0 < Skv; k0 += kTile) {
    __syncthreads();  // the previous tile's K, V and P fully read
    load_rows<T, HDP>(Ks, kb, kss, k0, Skv, hd);
    load_rows<T, HDP>(Vs, vb, vss, k0, Skv, hd);
    __syncthreads();
    scores<T, HDP, MODE>(s, Qs, Ks, mult);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float p[4];
      if (MODE == kExact) {
        float tmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + tx + 16 * c < Skv) tmax = fmaxf(tmax, s[r][c]);
        const float m_new = fmaxf(m[r], row_max(tmax));
        const float alpha = expf(m[r] - m_new);  // 0 on the first tile
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[c] = k0 + tx + 16 * c < Skv ? expf(s[r][c] - m_new) : 0.f;
          part += p[c];
        }
        l[r] = fmaf(l[r], alpha, row_sum(part));
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] *= alpha;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x;
          if (MODE == kV2 || MODE == kV2NoMax)
            x = __fdiv_rn(weight<MODE>(s[r][c], m[r]), l[r]);
          else if (MODE == kFast || MODE == kFastBf16)
            x = __fmul_rn(weight<MODE>(s[r][c], 0.f), inv[r]);
          else  // kMMOnly: the rounded scores themselves
            x = s[r][c];
          p[c] = k0 + tx + 16 * c < Skv ? round_to<T>(x) : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty + 16 * r) * LDP + tx + 16 * c] = p[c];
    }
    __syncthreads();
    // acc[r][c] += sum_j P[ty+16r][j] V[j][tx+16c], j ascending; keys past
    // Skv have P 0 and V 0
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float a[4], bv[TN];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Ps[(ty + 16 * r) * LDP + j];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = Vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
  }

  T* ob = out + ((int64_t)b * H + h) * Sq * hd;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) {
        const float o = MODE == kExact ? __fdiv_rn(acc[r][c], l[r]) : acc[r][c];
        ob[(int64_t)qi * hd + d] = store_f<T>(o);
      }
    }
  }
}

// bf16: one block of 4 warps per (64-query tile, head, image), each warp
// owning 16 query rows. Two-pass modes: stage i < tiles brings K of key tile
// i (pass 1), stage tiles + i brings K and V of key tile i (pass 2);
// kExact and kMMOnly: stage i brings K and V of key tile i. Stage i + 1 is
// in flight while stage i is computed.
template <int HDP, int MODE>
__device__ __forceinline__ void gattn_mma(unsigned char* smem, const __nv_bfloat16* __restrict__ q,
                                          const __nv_bfloat16* __restrict__ k,
                                          const __nv_bfloat16* __restrict__ v,
                                          __nv_bfloat16* __restrict__ out, int H, int Sq, int Skv,
                                          int hd, int64_t qsb, int64_t qsh, int64_t qss,
                                          int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                                          int64_t vsh, int64_t vss, float mult, bool vec) {
  using T = __nv_bfloat16;
  constexpr bool TWO_PASS = MODE != kExact && MODE != kMMOnly, HOLD = HDP <= 64;
  constexpr int LD = MmaTile<T, HDP>::kLd, TILE = MmaTile<T, HDP>::kElems, NT = kKT / 8;
  const int tiles = (Skv + kKT - 1) / kKT, stages = TWO_PASS ? 2 * tiles : tiles;
  T* Qs = reinterpret_cast<T*>(smem);  // kMmaRows x LD
  T* Ks = Qs + TILE;                   // 2 buffers
  T* Vs = Ks + 2 * TILE;               // 2 buffers
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* qb = q + (int64_t)b * qsb + (int64_t)h * qsh;
  const T* kb = k + (int64_t)b * ksb + (int64_t)h * ksh;
  const T* vb = v + (int64_t)b * vsb + (int64_t)h * vsh;

  auto prefetch = [&](int i) {
    const bool with_v = !TWO_PASS || i >= tiles;
    const int row0 = (TWO_PASS && i >= tiles ? i - tiles : i) * kKT, buf = i % 2;
    stage_rows<T, HDP, false>(Ks + buf * TILE, nullptr, kb, row0, 0, Skv, 0, kss, hd, vec);
    if (with_v)
      stage_rows<T, HDP, false>(Vs + buf * TILE, nullptr, vb, row0, 0, Skv, 0, vss, hd, vec);
  };
  stage_rows<T, HDP, false>(Qs, nullptr, qb, q0, 0, Sq, 0, qss, hd, vec);
  prefetch(0);
  cp_async_commit();

  RowFrags<HDP, HOLD> qf;
  // rows g and g + 8 of the warp's: max (kV2, kExact), sum, 1 / sum
  float m[2], l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = MODE == kV2 || MODE == kExact ? -INFINITY : 0.f;
  float o[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  for (int i = 0; i < stages; ++i) {
    if (i + 1 < stages) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage i (and at i == 0 the Q tile) visible to every warp
    if (i == 0) qf.load(Qs + warp * 16 * LD);
    const bool pass1 = TWO_PASS && i < tiles;
    const int k0 = (TWO_PASS && !pass1 ? i - tiles : i) * kKT, buf = i % 2;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_abt(s, qf, Ks + buf * TILE);  // q . k^T
    // the mode's score; -inf past Skv, which every weight maps to 0
    const bool edge = k0 + kKT > Skv;  // the last tile holds keys past Skv
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = MODE == kMMOnly ? round_to<T>(s[j][e]) : __fmul_rn(s[j][e], mult);
        s[j][e] = edge && k0 + j * 8 + 2 * t + (e % 2) >= Skv ? -INFINITY : x;
      }
    if (pass1) {  // the row sum (kV2: and max) of the mode's weights
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m_new = m[r];
        if (MODE == kV2) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          m_new = fmaxf(m[r], mx);  // finite: key 0 is in tile 0
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          sum += weight<MODE>(s[j][2 * r], m_new) + weight<MODE>(s[j][2 * r + 1], m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        // kV2: expf(-inf) = 0 on the first tile
        l[r] = MODE == kV2 ? fmaf(l[r], expf(m[r] - m_new), sum) : l[r] + sum;
        m[r] = m_new;
      }
    } else if (MODE == kExact) {
      // online softmax: P = exp(s - m_new) in f32, l and o rescaled
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);     // finite: key 0 is in tile 0
        const float alpha = expf(m[r] - m_new);  // 0 on the first tile
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = expf(s[j][2 * r + c] - m_new);  // 0 past Skv
            s[j][2 * r + c] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = fmaf(l[r], alpha, sum);
        m[r] = m_new;
#pragma unroll
        for (int d = 0; d < HDP / 8; ++d) {
          o[d][2 * r] *= alpha;
          o[d][2 * r + 1] *= alpha;
        }
      }
      const T* Vb = Vs + buf * TILE;
      mma_xb<NT, HDP>(o, s, Vb);  // o += hi . V: mma_xb packs bf16(P)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] -= round_to<T>(s[j][e]);  // P - hi, exact
      mma_xb<NT, HDP>(o, s, Vb);  // o += lo . V
    } else {
      // the mode's P in the score registers; mma_xb rounds it to bf16
      if (TWO_PASS && i == tiles)
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[r] = __frcp_rn(l[r]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          float p = s[j][e];  // kMMOnly: the rounded score itself
          if (MODE == kV2 || MODE == kV2NoMax)
            p = softmax_prob(s[j][e], m[r], l[r], inv[r]);
          else if (MODE == kFast || MODE == kFastBf16)
            p = __fmul_rn(weight<MODE>(s[j][e], 0.f), inv[r]);
          s[j][e] = edge && k0 + j * 8 + 2 * t + (e % 2) >= Skv ? 0.f : p;
        }
      mma_xb<NT, HDP>(o, s, Vs + buf * TILE);
    }
    __syncthreads();  // buffer i % 2 read in full before stage i + 2 overwrites it
  }

  const int row_g = q0 + warp * 16 + g;  // this thread's rows: row_g and row_g + 8
  T* ob = out + ((int64_t)b * H + h) * Sq * hd;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row_g + (e / 2) * 8;
    if (row >= Sq) continue;
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      const int col = d * 8 + 2 * t + (e % 2);
      if (col < hd) {
        const float x = MODE == kExact ? __fdiv_rn(o[d][e], l[e / 2]) : o[d][e];
        ob[(int64_t)row * hd + col] = store_f<T>(x);
      }
    }
  }
}

// The f32 FMA body (kThreads a block) or the bf16 tensor-core body
// (kMmaThreads, registers capped at 128 for hd <= 64 so that 4 blocks share
// an SM).
template <typename T, int HDP, int MODE>
__global__ void __launch_bounds__(kIsF32<T> ? kThreads : kMmaThreads,
                                  kIsF32<T> ? 1 : HDP <= 64 ? 4 : 2)
gattn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int Sq, int Skv, int hd, int64_t qsb, int64_t qsh,
             int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
             int64_t vss, float mult, bool vec) {
  extern __shared__ __align__(16) unsigned char gattn_smem[];
  if constexpr (kIsF32<T>)
    gattn_fma<T, HDP, MODE>(reinterpret_cast<float*>(gattn_smem), q, k, v, out, H, Sq, Skv, hd,
                            qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, mult);
  else
    gattn_mma<HDP, MODE>(gattn_smem, q, k, v, out, H, Sq, Skv, hd, qsb, qsh, qss, ksb, ksh, kss,
                         vsb, vsh, vss, mult, vec);
}

// ------------------------------------------------------------------ launch

// f32: Q, K, V and P tiles in f32; bf16: Q, 2 K and 2 V tiles in bf16.
template <typename T, int HDP>
constexpr size_t smem_bytes() {
  return kIsF32<T> ? sizeof(float) * (3 * (size_t)kTile * (HDP + 1) + (size_t)kTile * (kTile + 1))
                   : sizeof(T) * 5 * MmaTile<T, HDP>::kElems;
}

// What the kernel takes: at most 65535 images and heads (grid z and y), Sq,
// Skv >= 1, hd 1 ... kMaxHeadDim, float32 (0) or bfloat16 (1), a known mode.
inline bool supported(int B, int H, int Sq, int Skv, int hd, int dtype, int mode) {
  return B > 0 && H > 0 && B <= 65535 && H <= 65535 && Sq > 0 && Skv > 0 && hd > 0 &&
         hd <= kMaxHeadDim && (dtype == 0 || dtype == 1) && mode >= kExact && mode <= kMMOnly;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, H, Sq, Skv, hd;
  int64_t qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float mult;
};

// Whether every row the bf16 kernel stages from q, k and v starts on a
// 16-byte boundary and holds whole 16-byte chunks, so cp.async can copy it.
inline bool vectorizable(const Args& a) {
  constexpr int chunk = 16 / sizeof(__nv_bfloat16);
  bool ok = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && a.hd % chunk == 0;
  const int64_t strides[] = {a.qsb, a.qsh, a.qss, a.ksb, a.ksh, a.kss, a.vsb, a.vsh, a.vss};
  for (int64_t st : strides) ok = ok && st % chunk == 0;
  return ok;
}

template <typename T, int HDP, int MODE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HDP>();
  cudaError_t err = cudaFuncSetAttribute(gattn_kernel<T, HDP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kTile - 1) / kTile, a.H, a.B);
  gattn_kernel<T, HDP, MODE><<<grid, kIsF32<T> ? kThreads : kMmaThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.H, a.Sq, a.Skv, a.hd, a.qsb, a.qsh, a.qss, a.ksb, a.ksh, a.kss,
      a.vsb, a.vsh, a.vss, a.mult, !kIsF32<T> && vectorizable(a));
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_hd(const Args& a, cudaStream_t stream) {
  if (a.hd <= 16) return launch<T, 16, MODE>(a, stream);
  if (a.hd <= 32) return launch<T, 32, MODE>(a, stream);
  if (a.hd <= 64) return launch<T, 64, MODE>(a, stream);
  return launch<T, 128, MODE>(a, stream);
}

template <typename T>
cudaError_t launch_mode(const Args& a, int mode, cudaStream_t stream) {
  switch (mode) {
    case kExact: return launch_hd<T, kExact>(a, stream);
    case kV2: return launch_hd<T, kV2>(a, stream);
    case kV2NoMax: return launch_hd<T, kV2NoMax>(a, stream);
    case kFast: return launch_hd<T, kFast>(a, stream);
    case kFastBf16: return launch_hd<T, kFastBf16>(a, stream);
    default: return launch_hd<T, kMMOnly>(a, stream);
  }
}

// The forward in `mode` for any supported (dtype, hd); a cudaError_t, 0 on
// success.
inline cudaError_t forward(const Args& a, int dtype, int mode, cudaStream_t stream) {
  if (!supported(a.B, a.H, a.Sq, a.Skv, a.hd, dtype, mode)) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_mode<float>(a, mode, stream);
  return launch_mode<__nv_bfloat16>(a, mode, stream);
}

}  // namespace gattn
}  // namespace lct
