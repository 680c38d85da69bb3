// Self-attention off the packed (B, S, 3D) qkv tensor for Hopper (sm_90a),
// in three compile-time modes (Mode below), all exported by attention.cu:
//   * kPlain   no extra input:           _qkv_kernel  / _qkv_bwd_kernel
//   * kPrefix  P prompt key/value rows:  _pqkv_kernel / _pqkv_bwd_kernel
//   * kMasked  a shared (S, S) f32 additive mask on the scores:
//                                        _mqkv_kernel / _mqkv_bwd_kernel
// (all six in libcontinual_tpu/ops/attention.py). The TPU bodies hold one
// head's whole (S, S) score tile in VMEM; here nothing grows with S: keys
// and values stream through shared memory in 64-row tiles, so any S and any
// P + S run, at hd 1 ... 128 (padded with zero columns in shared memory only
// to HDP = 16, 32, 64 or 128).
//
// Keys and values. One head sees N = P + S keys. Key j < P is row j of the
// prefix tensors pk / pv, (B, P, D) with row stride D and a batch stride of
// its own (0 for a prompt broadcast over the batch); key j >= P is sequence
// row j - P of the packed qkv tensor, [q | k | v] with row stride 3D, head h
// at columns h*hd ... h*hd+hd. Both are read straight into the same tile (the
// tile that straddles P mixes them), so the concatenated (B, P+S, H, hd) K
// and V, the head-split copy of qkv and the (S, P+S) scores never exist in
// device memory. One softmax runs over all N keys.
//
// Masked mode (the CLIP text tower's causal mask). The mask is a (S, S) f32
// tensor with row stride S, shared by every image and head, read from global
// memory (L2-resident: 24 KB at S 77) where a score is formed and added to
// it. It gets no gradient. A -1e30 entry gives exactly 0 after
// expf(s - max); keys past N are -inf and read no mask.
//
// Rounding points are those of the TPU kernel bodies:
//   forward:  s = (q . k^T in f32) * scale [+ mask]; P = exp(s - max) / sum
//             in f32, rounded to the input type before P . v; f32
//             accumulation; the output rounded once.
//   backward: P recomputed in f32 from the same s; dP = g . v^T;
//             c = rowsum(dP * P); dv = round(P)^T . g; dS = round(P * (dP - c));
//             dq = dS . k * scale; dk = dS^T . q * scale; all products
//             accumulate in f32. For a prefix key the same dk and dv are dpk
//             and dpv.
// Products of bf16 values are exact in f32, so the only difference from the
// plain PyTorch versions is the order of the f32 sums (and, on the tensor
// cores, how one mma instruction adds its 16 products). Every kernel forms a
// score as __fadd_rn(__fmul_rn(q . k, scale), mask): the explicit roundings
// forbid the compiler to fuse the scale and the mask into an fma in one
// kernel and not in another. The forward and the bf16 backward form P from a
// score as softmax_prob below; the f32 backward divides.
//
// What bounds them on an H100: at ViT-B shapes (S 197-222, P <= 10, hd 64)
// attention does a few hundred FLOP per byte of qkv, and the least time is
// set by the bytes: about 52 us forward and 91 us backward (qkv and g read,
// dqkv written once) at B 128, S 222.
//
// The bf16 kernels run their products on Hopper's tensor cores as
// mma.sync.m16n8k16 (bf16 in, f32 accumulators), in blocks of 4 warps, each
// warp owning 16 rows of a 64-row tile. The rows a warp multiplies from are
// staged once and held as A-fragments in registers (in the backward at
// hd 128 read from shared memory at each use: holding them would spill);
// the tiles it multiplies against stream in 64-row bf16 tiles through
// shared memory, double-buffered with 16-byte cp.async copies (zero-filled
// past the last row and past hd; rows padded by 16 bytes so that ldmatrix
// hits every bank once), read by ldmatrix (.trans where the tile's rows are
// the product's k index). An f32 result that feeds another product (P, dS) goes from the
// accumulator registers straight into A-fragments, rounded to bf16 as it is
// packed: the C and A layouts of m16n8k16 line up.
//
// Forward (attn_fwd_kernel), one block per 64-query tile. Because the TPU
// body rounds the *normalised* P before P . v, the block makes two passes
// over the key tiles: pass 1 forms the scores and each row's max and sum
// (the sum rescaled online as the max grows, rows reduced over the quad with
// shuffles); pass 2 forms the scores again, P = round(exp(s - m) / l) in the
// accumulator registers, and accumulates O += P . V. The cost is q . k^T
// twice, which at these shapes stays below the byte bound's time at the
// dense peak; what the block spends most on is the softmax's per-score
// arithmetic (an expf in each pass), so the quotient exp(s - m) / l has no
// divide per score (softmax_prob), and registers are capped at 128 (hd <= 64)
// so that 4 blocks share an SM. Shared memory: 5 tiles (Q, 2 K, 2 V) of
// 64 x (HDP + 8) bf16, 46 KB at hd 64, whatever N.
//
// Backward: two kernels and no atomics, every sum in a fixed order, so two
// calls give the same bits.
//   * attn_bwd_dq_kernel, one block per 64-query tile: Q and g staged once;
//     K and V stream in 64-key tiles, twice. Sweep 1 forms S = Q . K^T and
//     dP = g . V^T and keeps each row's max m, sum l and
//     a = sum exp(s - m) dP online (l and a rescaled when m moves); it stores
//     m, l and dsum = a / l (the (3, B, H, S) f32 scratch) for the other
//     kernel. This is rowsum(dP * P) over the unrounded P, as the TPU body
//     forms it, not FlashAttention-2's rowsum(dO * O): the forward's O comes
//     from a rounded P and is itself rounded, a different function. Sweep 2
//     forms S and dP again, dS in the accumulator registers, and
//     dq += dS . K.
//   * attn_bwd_dkdv_kernel, one block per 64-key tile over the N keys: K and
//     V staged once (a prefix key from pk / pv, the tile that straddles P
//     mixed); Q, g and the 64 rows of statistics stream in 64-query tiles.
//     It forms S^T = K . Q^T and dP^T = V . g^T (keys are the accumulator
//     rows), P^T and dS^T in registers, then dV += round(P^T) . g and
//     dK += dS^T . Q. A prefix key's dk and dv go to dpk and dpv.
//   Each product runs over 32-key (dq) or 32-query (dk/dv) halves of a tile,
//   so that the scores and dP of one half (32 registers) sit beside the held
//   fragments and the accumulators; registers are capped at 168 (hd <= 64)
//   so that 3 blocks share an SM (6 tiles of shared memory, 55-57 KB at
//   hd 64). Query rows past S and keys past N get P = 0 (dS = 0).
//   Bit-identity: the dk/dv kernel forms each score with the operands of
//   the dq kernel's mma swapped (K as A, Q as B). Each product and its
//   position in the k order are the same, but how the tensor cores add the
//   16 products of one mma is not documented, so P and dS are *not* claimed
//   bit-identical across the two kernels; each agrees with the plain version
//   within the stated tolerance, which is the gate.
// The f32 instantiations (no train step runs them; the checks hold them to
// 1e-5, so no TF32) keep the streamed structure with f32 tiles and do their
// products in f32 FMA on the CUDA cores: the forward with P . V through a
// per-warp P tile in shared memory, the backward as 16 x 16 thread grids over
// 32-query tiles (kThreads, kQT), whose two kernels build P and dS with the
// same arithmetic from the stored statistics (and so see bit-identical P and
// dS).
//
// The mode is a template argument, so each instantiation compiles without the
// other modes' branches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lct {

constexpr int kMaxHeadDim = 128;
constexpr int kKT = 64;           // keys per streamed tile (every kernel)
constexpr int kMmaThreads = 128;  // bf16 kernels and the f32 forward: 4 warps of 16 rows
constexpr int kMmaRows = 64;      // the same: query (forward, dq) or key (dk/dv) rows a block
constexpr int kHalf = 32;         // bf16 backward: keys (dq) or queries (dk/dv) a register tile
constexpr int kThreads = 256;     // f32 backward only: a 16 x 16 thread grid over a product tile
constexpr int kQT = 32;           // f32 backward only: query rows per tile

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

// hd padded to the instantiation's width.
inline int padded_head_dim(int hd) { return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

// ---------------------------------------------- primitives of the kernels

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// exp(s - m) / l, a softmax probability, as every kernel here forms it: the
// quotient as the product with inv, the correctly rounded 1 / l, corrected
// by one fma of the remainder (Markstein), so within an ulp of the division
// and almost always equal to it, with no divide per score.
__device__ __forceinline__ float softmax_prob(float s, float m, float l, float inv) {
  const float x = expf(s - m);
  const float q = __fmul_rn(x, inv);
  return fmaf(fmaf(-q, l, x), inv, q);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest `n` has landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a . b on one 16 x 8 x 16 bf16 tile, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory row of a streamed tile: HDP elements and 16 bytes of
// padding, so the 8 rows an ldmatrix (or a quad's FMA loads) touch fall in
// 8 different 16-byte bank groups.
template <typename T, int HDP>
struct MmaTile {
  static constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kLd = HDP + kChunk;
  static constexpr int kElems = kKT * kLd;       // one 64-row tile
};

// Stage rows row0 ... row0+63 of one head into `dst`: row j < P from `pre`
// (row stride D), row P <= j < N from `seq` (row stride seq_ld, row j - P);
// rows at or past N and columns at or past hd are zero. `vec`: hd and every
// row start are whole 16-byte chunks, so cp.async copies them (asynchronous,
// committed by the caller); otherwise plain element copies.
template <typename T, int HDP, bool PREFIX>
__device__ __forceinline__ void stage_rows(T* dst, const T* pre, const T* seq, int row0, int P,
                                           int N, int D, int seq_ld, int hd, bool vec) {
  using Tile = MmaTile<T, HDP>;
  if (vec) {
    constexpr int kPerRow = HDP / Tile::kChunk;
    for (int e = threadIdx.x; e < kKT * kPerRow; e += kMmaThreads) {
      const int r = e / kPerRow, c = (e % kPerRow) * Tile::kChunk, j = row0 + r;
      const T* src = seq;  // a valid address; nothing is read from it
      int bytes = 0;
      if (j < N && c < hd) {
        src = (PREFIX && j < P) ? pre + (int64_t)j * D + c : seq + (int64_t)(j - P) * seq_ld + c;
        bytes = 16;
      }
      cp_async16(dst + r * Tile::kLd + c, src, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < kKT * HDP; e += kMmaThreads) {
      const int r = e / HDP, c = e % HDP, j = row0 + r;
      T x = from_f<T>(0.f);
      if (j < N && c < hd)
        x = (PREFIX && j < P) ? pre[(int64_t)j * D + c] : seq[(int64_t)(j - P) * seq_ld + c];
      dst[r * Tile::kLd + c] = x;
    }
  }
}

// The m16n8k16 A-fragments of a warp's 16 rows of a staged bf16 tile, over
// HDP columns: held in registers (HOLD) or read from the tile by ldmatrix at
// each use.
template <int HDP, bool HOLD>
struct RowFrags {
  static constexpr int LD = MmaTile<__nv_bfloat16, HDP>::kLd;
  uint32_t r[HOLD ? HDP / 16 : 1][4];
  const __nv_bfloat16* w;  // the warp's first row

  // x4: rows 0..7 and 8..15, each at columns kk*16 + 0..7 and + 8..15
  __device__ __forceinline__ void fetch(uint32_t (&a)[4], int kk) const {
    const int lane = threadIdx.x % 32;
    ldmatrix_x4(a, w + ((lane % 8) + ((lane / 8) % 2) * 8) * LD + kk * 16 + (lane / 16) * 8);
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* rows) {
    w = rows;
    if constexpr (HOLD) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) fetch(r[kk], kk);
    }
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk) const {
    if constexpr (HOLD) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = r[kk][e];
    } else {
      fetch(a, kk);
    }
  }
};

// acc += A . B^T over HDP columns: A the warp's 16 rows (`a`), B rows
// 0 ... 8*NT-1 of a staged bf16 tile (B's rows are acc's columns). acc is in
// the mma accumulator layout: acc[j] holds columns j*8 + 2t, +1 of rows g
// (acc[j][0..1]) and g + 8 (acc[j][2..3]), where g = lane / 4, t = lane % 4.
template <int NT, int HDP, bool HOLD>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const RowFrags<HDP, HOLD>& a,
                                        const __nv_bfloat16* B) {
  constexpr int LD = MmaTile<__nv_bfloat16, HDP>::kLd;
  const int lane = threadIdx.x % 32;
  // x4: B rows jp*16 + 0..7 and + 8..15, each at columns kk*16 + 0..7 and + 8..15
  const int row = (lane % 8) + (lane / 16) * 8, col = ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t af[4];
    a.get(af, kk);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, B + (jp * 16 + row) * LD + kk * 16 + col);
      mma_bf16(acc[2 * jp], af, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], af, b[2], b[3]);
    }
  }
}

// o += round(X) . B for the warp's 16 rows: X (16 x 8*NT, f32, accumulator
// layout) rounded to bf16 as it is packed into A-fragments; B rows
// 0 ... 8*NT-1 of a staged bf16 tile (the k index) through ldmatrix.trans;
// o (16 x HDP) in the accumulator layout (o[d] holds columns d*8 + 2t, +1).
template <int NT, int HDP>
__device__ __forceinline__ void mma_xb(float (&o)[HDP / 8][4], const float (&x)[NT][4],
                                       const __nv_bfloat16* B) {
  constexpr int LD = MmaTile<__nv_bfloat16, HDP>::kLd;
  const int lane = threadIdx.x % 32;
  // x4.trans: B rows kk*16 + 0..7 and + 8..15, each at columns dp*16 + 0..7 and + 8..15
  const int row = (lane % 8) + ((lane / 8) % 2) * 8, col = (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, B + (kk * 16 + row) * LD + dp * 16 + col);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// The warp's 16 x 64 raw scores q . k^T in the accumulator layout. bf16:
// tensor cores from the Q fragments `qf` and ldmatrix on the K tile; f32:
// FMA from the Q and K tiles.
template <typename T, int HDP>
__device__ __forceinline__ void fwd_scores(float (&s)[kKT / 8][4], const RowFrags<HDP, true>& qf,
                                           const T* Qw, const T* Kb) {
  constexpr int LD = MmaTile<T, HDP>::kLd;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if constexpr (kIsF32<T>) {
    const float* qa = Qw + g * LD;
    const float* qb = qa + 8 * LD;
#pragma unroll 4
    for (int k = 0; k < HDP; ++k) {
      const float a0 = qa[k], a1 = qb[k];
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float kv = Kb[(j * 8 + 2 * t + c) * LD + k];
          s[j][c] = fmaf(a0, kv, s[j][c]);
          s[j][2 + c] = fmaf(a1, kv, s[j][2 + c]);
        }
    }
  } else {
    mma_abt<kKT / 8>(s, qf, Kb);
  }
}

// o += round(P) . V for the warp's 16 rows over one 64-key tile; P (already
// normalised, in f32) in the score layout of fwd_scores, o over HDP columns.
// bf16: mma_xb; f32: P (its own rounding) goes through the warp's tile Pw in
// shared memory.
template <typename T, int HDP>
__device__ __forceinline__ void fwd_pv(float (&o)[HDP / 8][4], const float (&p)[kKT / 8][4],
                                       const T* Vb, float* Pw) {
  constexpr int LD = MmaTile<T, HDP>::kLd;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (kIsF32<T>) {
    constexpr int LDP = kKT + 4;
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) Pw[(g + (e / 2) * 8) * LDP + j * 8 + 2 * t + (e % 2)] = p[j][e];
    __syncwarp();
#pragma unroll 4
    for (int k = 0; k < kKT; ++k) {
      const float p0 = Pw[g * LDP + k], p1 = Pw[(g + 8) * LDP + k];
#pragma unroll
      for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = Vb[k * LD + d * 8 + 2 * t + c];
          o[d][c] = fmaf(p0, v, o[d][c]);
          o[d][2 + c] = fmaf(p1, v, o[d][2 + c]);
        }
    }
    __syncwarp();  // Pw read in full before the next tile writes it
  } else {
    mma_xb<kKT / 8, HDP>(o, p, Vb);
  }
}

// ---------------------------------------------------------------- forward

// One block per (64-query tile, head, image), 4 warps of 16 query rows.
// Stage i < tiles brings K of key tile i (pass 1); stage tiles + i brings K
// and V of key tile i (pass 2). Stage i + 1 is in flight while stage i is
// computed.
template <typename T, int HDP, int MODE>
__global__ void __launch_bounds__(kMmaThreads, HDP <= 64 ? 4 : 2)
attn_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ pk, const T* __restrict__ pv,
                int64_t pk_bstride, int64_t pv_bstride, const float* __restrict__ mask,
                T* __restrict__ out, int S, int P, int H, int hd, float scale, bool vec) {
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked;
  constexpr bool MMA = !kIsF32<T>;
  using Tile = MmaTile<T, HDP>;
  constexpr int LD = Tile::kLd, TILE = Tile::kElems;
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * hd, N = P + S, tiles = (N + kKT - 1) / kKT;
  extern __shared__ __align__(16) unsigned char fwd_tiles[];
  T* Qs = reinterpret_cast<T*>(fwd_tiles);  // kMmaRows x LD
  T* Ks = Qs + TILE;                       // 2 buffers
  T* Vs = Ks + 2 * TILE;                   // 2 buffers
  float* Pw = reinterpret_cast<float*>(Vs + 2 * TILE);  // f32 only: 4 x 16 x (kKT + 4)
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* base = qkv + (int64_t)b * S * 3 * D + (int64_t)h * hd;
  const T* pkb = PREFIX ? pk + b * pk_bstride + (int64_t)h * hd : nullptr;
  const T* pvb = PREFIX ? pv + b * pv_bstride + (int64_t)h * hd : nullptr;
  const int stages = 2 * tiles;

  auto prefetch = [&](int i) {
    const int row0 = (i < tiles ? i : i - tiles) * kKT, buf = i % 2;
    stage_rows<T, HDP, PREFIX>(Ks + buf * TILE, pkb, base + D, row0, P, N, D, 3 * D, hd, vec);
    if (i >= tiles)
      stage_rows<T, HDP, PREFIX>(Vs + buf * TILE, pvb, base + 2 * D, row0, P, N, D, 3 * D, hd,
                                 vec);
  };
  stage_rows<T, HDP, false>(Qs, nullptr, base, q0, 0, S, D, 3 * D, hd, vec);
  prefetch(0);
  cp_async_commit();

  RowFrags<HDP, true> qf;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];  // rows g and g + 8
  float o[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  const T* Qw = Qs + warp * 16 * LD;
  const int row_g = q0 + warp * 16 + g;  // this thread's rows: row_g and row_g + 8

  for (int i = 0; i < stages; ++i) {
    if (i + 1 < stages) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage i (and at i == 0 the Q tile) visible to every warp
    if (MMA && i == 0) qf.load(reinterpret_cast<const __nv_bfloat16*>(Qw));
    const bool pass1 = i < tiles;
    const int k0 = (pass1 ? i : i - tiles) * kKT, buf = i % 2;
    float s[kKT / 8][4];
    fwd_scores<T, HDP>(s, qf, Qw, Ks + buf * TILE);
    const bool edge = k0 + kKT > N;  // the last tile holds keys past N
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_g + (e / 2) * 8, col = k0 + j * 8 + 2 * t + (e % 2);
        float v = __fmul_rn(s[j][e], scale);
        if (MASK && row < S && col < N) v = __fadd_rn(v, mask[(int64_t)row * S + col]);
        s[j][e] = edge && col >= N ? -INFINITY : v;
      }
    if (pass1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);  // finite: key 0 is in tile 0
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j)
          sum += expf(s[j][2 * r] - m_new) + expf(s[j][2 * r + 1] - m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = fmaf(l[r], expf(m[r] - m_new), sum);  // expf(-inf) = 0 on the first tile
        m[r] = m_new;
      }
    } else {
      // P = exp(s - m) / l; fwd_pv rounds it to T
      if (i == tiles)
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[r] = __frcp_rn(l[r]);
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = softmax_prob(s[j][e], m[e / 2], l[e / 2], inv[e / 2]);
      fwd_pv<T, HDP>(o, s, Vs + buf * TILE, Pw + warp * 16 * (kKT + 4));
    }
    __syncthreads();  // buffer i % 2 read in full before stage i + 2 overwrites it
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row_g + (e / 2) * 8;
    if (row >= S) continue;
    T* orow = out + ((int64_t)b * S + row) * D + (int64_t)h * hd;
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      const int col = d * 8 + 2 * t + (e % 2);
      if (col < hd) orow[col] = from_f<T>(o[d][e]);
    }
  }
}

// --------------------------------------------------- backward: primitives

// Copy `rows` rows of one head (HD columns, those at or past hd zero) from
// global memory into a float tile with leading dimension ld; rows at or past
// S are zero.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int64_t row_stride,
                                          int row0, int rows, int S, int hd) {
  for (int e = threadIdx.x; e < rows * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < S && c < hd ? to_f(src[(int64_t)gr * row_stride + c]) : 0.f;
  }
}

// Copy keys (or values) row0 ... row0+rows of one head: key j < P from the
// prefix rows `pre` (row stride D), key P <= j < P + S from the sequence rows
// `seq` (row stride 3D); keys at or past P + S and columns at or past hd are
// zero.
template <bool PREFIX, int HD, typename T>
__device__ __forceinline__ void load_keys(float* dst, int ld, const T* pre, const T* seq,
                                          int row0, int rows, int P, int S, int D, int hd) {
  for (int e = threadIdx.x; e < rows * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD;
    const int j = row0 + r;
    float x = 0.f;
    if (c >= hd)
      x = 0.f;
    else if (PREFIX && j < P)
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

// out[i][j] = (X[i] . Y[j]) * scale for a kQT-row tile X against the kKT rows
// of a key tile Y (both ld-strided, hd deep). With MASK, mask[i * mask_ld + j]
// is added for i < rows and j < cols.
template <bool MASK>
__device__ __forceinline__ void scaled_products(const float* X, const float* Y, float* out,
                                                int ld, int ldo, int hd, float scale,
                                                const float* mask, int mask_ld, int rows,
                                                int cols) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = ty * 2, j0 = tx * 4;
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

// --------------------------------------------------------------- backward

// f32: one block of kThreads per (kQT-query tile, head, image). Sweep 1 over
// the key tiles: each row's max m, sum l and a = sum exp(s - m) dP, online;
// the row statistics (m, l, dsum = a / l) go to `stats` for the key-tile
// kernel. Sweep 2: s and dP again, dS as the key-tile kernel forms it,
// dq += dS . k.
template <typename T, int HD, int MODE>
__device__ __forceinline__ void bwd_dq_fma(float* smem, const T* __restrict__ qkv,
                                           const T* __restrict__ pk, const T* __restrict__ pv,
                                           int64_t pk_bstride, int64_t pv_bstride,
                                           const float* __restrict__ mask, const T* __restrict__ g,
                                           T* __restrict__ dqkv, float* __restrict__ stats, int S,
                                           int P, int H, int hd, float scale) {
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked;
  constexpr int LD = HD + 1;
  constexpr int TN = HD / 16;
  constexpr int LDK = kKT + 1;
  constexpr int kRowsPerWarp = kQT / (kThreads / 32);
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * hd, N = P + S;
  float* Qs = smem;            // kQT x LD
  float* Gs = Qs + kQT * LD;   // kQT x LD
  float* Ks = Gs + kQT * LD;   // kKT x LD
  float* Vs = Ks + kKT * LD;   // kKT x LD
  float* Ss = Vs + kKT * LD;   // kQT x LDK: scores
  float* dS = Ss + kQT * LDK;  // kQT x LDK: dP, then dS
  float* st = dS + kQT * LDK;  // 3 x kQT: max, sum, rowsum(dP * P)
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (int64_t)b * S * 3 * D + (int64_t)h * hd;
  const T* pkb = PREFIX ? pk + b * pk_bstride + (int64_t)h * hd : nullptr;
  const T* pvb = PREFIX ? pv + b * pv_bstride + (int64_t)h * hd : nullptr;
  const float* mrow = MASK ? mask + (int64_t)q0 * S : nullptr;

  load_tile<HD>(Qs, LD, base, 3 * D, q0, kQT, S, hd);
  load_tile<HD>(Gs, LD, g + (int64_t)b * S * D + (int64_t)h * hd, D, q0, kQT, S, hd);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m[kRowsPerWarp], l[kRowsPerWarp], a[kRowsPerWarp];  // rows warp + 8 r
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    a[r] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();  // the previous tile's K, V, scores and dP fully read
    load_keys<PREFIX, HD>(Ks, LD, pkb, base + D, k0, kKT, P, S, D, hd);
    load_keys<PREFIX, HD>(Vs, LD, pvb, base + 2 * D, k0, kKT, P, S, D, hd);
    __syncthreads();
    scaled_products<MASK>(Qs, Ks, Ss, LD, LDK, HD, scale, MASK ? mrow + k0 : nullptr, S,
                          S - q0, N - k0);
    scaled_products<false>(Gs, Vs, dS, LD, LDK, HD, 1.f, nullptr, 0, 0, 0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* s = Ss + (warp + 8 * r) * LDK;
      const float* dp = dS + (warp + 8 * r) * LDK;
      float tmax = -INFINITY;
      for (int j = lane; j < kKT; j += 32)
        if (k0 + j < N) tmax = fmaxf(tmax, s[j]);
      const float m_new = fmaxf(m[r], warp_max(tmax));  // finite: key 0 is in tile 0
      float le = 0.f, ae = 0.f;
      for (int j = lane; j < kKT; j += 32)
        if (k0 + j < N) {
          const float e = expf(s[j] - m_new);
          le += e;
          ae += e * dp[j];
        }
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      l[r] = fmaf(l[r], alpha, warp_sum(le));
      a[r] = fmaf(a[r], alpha, warp_sum(ae));
      m[r] = m_new;
    }
  }

  const int64_t srow = ((int64_t)b * H + h) * S;  // stats are (3, B, H, S)
  const int64_t splane = (int64_t)gridDim.z * H * S;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp + 8 * r, qi = q0 + i;
      const float dsum = a[r] / l[r];
      st[i] = m[r];
      st[kQT + i] = l[r];
      st[2 * kQT + i] = dsum;
      if (qi < S) {
        stats[srow + qi] = m[r];
        stats[splane + srow + qi] = l[r];
        stats[2 * splane + srow + qi] = dsum;
      }
    }
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = ty * 2, d0 = tx * TN;
  float acc[2][TN];
  zero(acc);
  for (int k0 = 0; k0 < N; k0 += kKT) {
    __syncthreads();  // the previous tile's K and dS fully read (and st written)
    load_keys<PREFIX, HD>(Ks, LD, pkb, base + D, k0, kKT, P, S, D, hd);
    load_keys<PREFIX, HD>(Vs, LD, pvb, base + 2 * D, k0, kKT, P, S, D, hd);
    __syncthreads();
    scaled_products<MASK>(Qs, Ks, Ss, LD, LDK, HD, scale, MASK ? mrow + k0 : nullptr, S,
                          S - q0, N - k0);
    scaled_products<false>(Gs, Vs, dS, LD, LDK, HD, 1.f, nullptr, 0, 0, 0);
    __syncthreads();
    // dS exactly as attn_bwd_dkdv_kernel forms it from the stored statistics
    for (int e = threadIdx.x; e < kQT * kKT; e += kThreads) {
      const int i = e / kKT, j = e % kKT;
      float p = expf(Ss[i * LDK + j] - st[i]) / st[kQT + i];
      if (q0 + i >= S || k0 + j >= N) p = 0.f;
      dS[i * LDK + j] = round_to<T>(p * (dS[i * LDK + j] - st[2 * kQT + i]));
    }
    __syncthreads();
    mac(acc, dS + i0 * LDK, LDK, 1, Ks + d0, LD, 1, kKT);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + i0 + r;
    if (qi < S) {
#pragma unroll
      for (int c = 0; c < TN; ++c)
        if (d0 + c < hd)
          dqkv[((int64_t)b * S + qi) * 3 * D + (int64_t)h * hd + d0 + c] =
              from_f<T>(acc[r][c] * scale);
    }
  }
}

// f32: one block of kThreads per (key tile, head, image) over the N keys:
// walk the query tiles in order, rebuild P and dS for this key tile from the
// stored row statistics, and accumulate dv = round(P)^T . g and
// dk = dS^T . q in registers. A prefix key's dk and dv go to dpk and dpv
// ((B, P, D), contiguous), a sequence key's into the packed dqkv.
template <typename T, int HD, int MODE>
__device__ __forceinline__ void bwd_dkdv_fma(float* smem, const T* __restrict__ qkv,
                                             const T* __restrict__ pk, const T* __restrict__ pv,
                                             int64_t pk_bstride, int64_t pv_bstride,
                                             const float* __restrict__ mask,
                                             const T* __restrict__ g, T* __restrict__ dqkv,
                                             T* __restrict__ dpk, T* __restrict__ dpv,
                                             const float* __restrict__ stats, int S, int P, int H,
                                             int hd, float scale) {
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked;
  constexpr int LD = HD + 1;
  constexpr int TN = HD / 16;
  constexpr int LDK = kKT + 1;
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * hd, N = P + S;
  float* Ks = smem;             // kKT x LD
  float* Vs = Ks + kKT * LD;    // kKT x LD
  float* Qs = Vs + kKT * LD;    // kQT x LD
  float* Gs = Qs + kQT * LD;    // kQT x LD
  float* Pb = Gs + kQT * LD;    // kQT x LDK: round(P)
  float* dS = Pb + kQT * LDK;   // kQT x LDK
  float* st = dS + kQT * LDK;   // 3 x kQT: max, sum, rowsum(dP * P)
  const int k0 = blockIdx.x * kKT, h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + (int64_t)b * S * 3 * D + (int64_t)h * hd;
  const T* gbase = g + (int64_t)b * S * D + (int64_t)h * hd;
  const T* pkb = PREFIX ? pk + b * pk_bstride + (int64_t)h * hd : nullptr;
  const T* pvb = PREFIX ? pv + b * pv_bstride + (int64_t)h * hd : nullptr;
  const int64_t srow = ((int64_t)b * H + h) * S;
  const int64_t splane = (int64_t)gridDim.z * H * S;

  load_keys<PREFIX, HD>(Ks, LD, pkb, base + D, k0, kKT, P, S, D, hd);
  load_keys<PREFIX, HD>(Vs, LD, pvb, base + 2 * D, k0, kKT, P, S, D, hd);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float dv[4][TN], dk[4][TN];
  zero(dv);
  zero(dk);
  for (int q0 = 0; q0 < S; q0 += kQT) {
    __syncthreads();  // previous tile's Pb/dS/Qs/Gs fully consumed
    load_tile<HD>(Qs, LD, base, 3 * D, q0, kQT, S, hd);
    load_tile<HD>(Gs, LD, gbase, D, q0, kQT, S, hd);
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
          // kernel formed
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
      krow = dpk + ((int64_t)b * P + kj) * D + (int64_t)h * hd + tx * TN;
      vrow = dpv + ((int64_t)b * P + kj) * D + (int64_t)h * hd + tx * TN;
    } else if (kj < N) {
      krow = dqkv + ((int64_t)b * S + kj - P) * 3 * D + D + (int64_t)h * hd + tx * TN;
      vrow = krow + D;
    }
    if (krow != nullptr) {
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        if (tx * TN + c < hd) {
          krow[c] = from_f<T>(dk[r][c] * scale);
          vrow[c] = from_f<T>(dv[r][c]);
        }
      }
    }
  }
}


// bf16: one block of 4 warps per (64-query tile, head, image), each warp
// owning 16 query rows (this thread's: row_g and row_g + 8). Stage i < tiles
// brings K and V of key tile i for sweep 1, stage tiles + i the same tile for
// sweep 2; stage i + 1 is in flight while stage i is used.
template <int HDP, int MODE>
__device__ __forceinline__ void bwd_dq_mma(
    unsigned char* smem, const __nv_bfloat16* __restrict__ qkv,
    const __nv_bfloat16* __restrict__ pk, const __nv_bfloat16* __restrict__ pv,
    int64_t pk_bstride, int64_t pv_bstride, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
    float* __restrict__ stats, int S, int P, int H, int hd, float scale, bool vec) {
  using T = __nv_bfloat16;
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked, HOLD = HDP <= 64;
  constexpr int LD = MmaTile<T, HDP>::kLd, TILE = MmaTile<T, HDP>::kElems, NT = kHalf / 8;
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * hd, N = P + S, tiles = (N + kKT - 1) / kKT, stages = 2 * tiles;
  T* Qs = reinterpret_cast<T*>(smem);  // kMmaRows x LD
  T* Gs = Qs + TILE;                   // kMmaRows x LD
  T* Ks = Gs + TILE;                   // 2 buffers
  T* Vs = Ks + 2 * TILE;               // 2 buffers
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const T* base = qkv + (int64_t)b * S * 3 * D + (int64_t)h * hd;
  const T* pkb = PREFIX ? pk + b * pk_bstride + (int64_t)h * hd : nullptr;
  const T* pvb = PREFIX ? pv + b * pv_bstride + (int64_t)h * hd : nullptr;

  auto prefetch = [&](int i) {
    const int row0 = (i < tiles ? i : i - tiles) * kKT, buf = i % 2;
    stage_rows<T, HDP, PREFIX>(Ks + buf * TILE, pkb, base + D, row0, P, N, D, 3 * D, hd, vec);
    stage_rows<T, HDP, PREFIX>(Vs + buf * TILE, pvb, base + 2 * D, row0, P, N, D, 3 * D, hd,
                               vec);
  };
  stage_rows<T, HDP, false>(Qs, nullptr, base, q0, 0, S, D, 3 * D, hd, vec);
  stage_rows<T, HDP, false>(Gs, nullptr, dout + (int64_t)b * S * D + (int64_t)h * hd, q0, 0, S,
                            D, D, hd, vec);
  prefetch(0);
  cp_async_commit();

  RowFrags<HDP, HOLD> qf, gf;
  // rows row_g and row_g + 8: max, sum, a = sum exp(s - m) dP, 1 / sum, a / sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f}, inv[2], dsum[2];
  float dq[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;
  const int row_g = q0 + warp * 16 + lane / 4;

  for (int i = 0; i < stages; ++i) {
    if (i + 1 < stages) prefetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage i (and at i == 0 the Q and g tiles) visible to every warp
    if (i == 0) {
      qf.load(Qs + warp * 16 * LD);
      gf.load(Gs + warp * 16 * LD);
    }
    const bool sweep1 = i < tiles;
    if (i == tiles) {  // the row statistics are complete: store them for the dk/dv kernel
      const int64_t srow = ((int64_t)b * H + h) * S, splane = (int64_t)gridDim.z * H * S;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        inv[r] = __frcp_rn(l[r]);
        dsum[r] = a[r] / l[r];
        const int row = row_g + 8 * r;
        if (t == 0 && row < S) {
          stats[srow + row] = m[r];
          stats[splane + srow + row] = l[r];
          stats[2 * splane + srow + row] = dsum[r];
        }
      }
    }
    const int k0 = (sweep1 ? i : i - tiles) * kKT, buf = i % 2;
#pragma unroll
    for (int c = 0; c < kKT / kHalf; ++c) {
      const int c0 = k0 + c * kHalf;
      if (c0 >= N) break;
      const T* Kb = Ks + buf * TILE + c * kHalf * LD;
      float s[NT][4] = {}, dp[NT][4] = {};
      mma_abt(s, qf, Kb);                                 // S = Q . K^T
      mma_abt(dp, gf, Vs + buf * TILE + c * kHalf * LD);  // dP = g . V^T
      const bool edge = c0 + kHalf > N;  // the last half holds keys past N
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_g + (e / 2) * 8, col = c0 + j * 8 + 2 * t + (e % 2);
          float v = __fmul_rn(s[j][e], scale);
          if (MASK && row < S && col < N) v = __fadd_rn(v, mask[(int64_t)row * S + col]);
          s[j][e] = edge && col >= N ? -INFINITY : v;
        }
      if (sweep1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);  // finite: key 0 is in the first half
          float le = 0.f, ae = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              const float x = expf(s[j][2 * r + c2] - m_new);
              le += x;
              ae = fmaf(x, dp[j][2 * r + c2], ae);
            }
          le += __shfl_xor_sync(0xffffffffu, le, 1);
          le += __shfl_xor_sync(0xffffffffu, le, 2);
          ae += __shfl_xor_sync(0xffffffffu, ae, 1);
          ae += __shfl_xor_sync(0xffffffffu, ae, 2);
          const float alpha = expf(m[r] - m_new);  // 0 on the first half
          l[r] = fmaf(l[r], alpha, le);
          a[r] = fmaf(a[r], alpha, ae);
          m[r] = m_new;
        }
      } else {
        // dS = P * (dP - dsum) in the score registers; mma_xb rounds it to bf16
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            s[j][e] = softmax_prob(s[j][e], m[r], l[r], inv[r]) * (dp[j][e] - dsum[r]);
          }
        mma_xb<NT, HDP>(dq, s, Kb);  // dq += dS . K
      }
    }
    __syncthreads();  // buffer i % 2 read in full before stage i + 2 overwrites it
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row_g + (e / 2) * 8;
    if (row >= S) continue;
    T* drow = dqkv + ((int64_t)b * S + row) * 3 * D + (int64_t)h * hd;
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      const int col = d * 8 + 2 * t + (e % 2);
      if (col < hd) drow[col] = from_f<T>(dq[d][e] * scale);
    }
  }
}

// bf16: one block of 4 warps per (64-key tile, head, image) over the N keys,
// each warp owning 16 keys (this thread's: key_g and key_g + 8), which are
// the rows of every product: S^T = K . Q^T, dP^T = V . g^T, then
// dV += round(P^T) . g and dK += dS^T . Q. Stage i brings the Q and g rows
// of query tile i (stage 0 also K and V); stage i + 1 is in flight while
// stage i is used. The statistics of query tile i + 1 are read into
// registers early in iteration i and go to shared memory at its end.
template <int HDP, int MODE>
__device__ __forceinline__ void bwd_dkdv_mma(
    unsigned char* smem, const __nv_bfloat16* __restrict__ qkv,
    const __nv_bfloat16* __restrict__ pk, const __nv_bfloat16* __restrict__ pv,
    int64_t pk_bstride, int64_t pv_bstride, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
    __nv_bfloat16* __restrict__ dpk, __nv_bfloat16* __restrict__ dpv,
    const float* __restrict__ stats, int S, int P, int H, int hd, float scale, bool vec) {
  using T = __nv_bfloat16;
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked, HOLD = HDP <= 64;
  constexpr int LD = MmaTile<T, HDP>::kLd, TILE = MmaTile<T, HDP>::kElems, NT = kHalf / 8;
  constexpr int R = kMmaRows;
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * hd, N = P + S, qtiles = (S + R - 1) / R;
  T* Ks = reinterpret_cast<T*>(smem);  // R x LD
  T* Vs = Ks + TILE;                   // R x LD
  T* Qs = Vs + TILE;                   // 2 buffers
  T* Gs = Qs + 2 * TILE;               // 2 buffers
  float* St = reinterpret_cast<float*>(Gs + 2 * TILE);  // 2 buffers of m, l, 1 / l, dsum x R
  const int k0 = blockIdx.x * kKT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const T* base = qkv + (int64_t)b * S * 3 * D + (int64_t)h * hd;
  const T* gbase = dout + (int64_t)b * S * D + (int64_t)h * hd;
  const T* pkb = PREFIX ? pk + b * pk_bstride + (int64_t)h * hd : nullptr;
  const T* pvb = PREFIX ? pv + b * pv_bstride + (int64_t)h * hd : nullptr;
  const int64_t srow = ((int64_t)b * H + h) * S, splane = (int64_t)gridDim.z * H * S;

  auto prefetch = [&](int i) {
    const int buf = i % 2;
    stage_rows<T, HDP, false>(Qs + buf * TILE, nullptr, base, i * R, 0, S, D, 3 * D, hd, vec);
    stage_rows<T, HDP, false>(Gs + buf * TILE, nullptr, gbase, i * R, 0, S, D, D, hd, vec);
  };
  // thread x < R: the statistics of query i * R + x; a query past S gets
  // m 0, l 1, dsum 0, and P is forced to 0 there
  float st_m, st_l, st_d;
  auto load_stats = [&](int i) {
    const int q = i * R + threadIdx.x;
    const bool ok = q < S;
    st_m = ok ? stats[srow + q] : 0.f;
    st_l = ok ? stats[splane + srow + q] : 1.f;
    st_d = ok ? stats[2 * splane + srow + q] : 0.f;
  };
  auto store_stats = [&](int i) {
    float* dst = St + (i % 2) * 4 * R + threadIdx.x;
    dst[0] = st_m;
    dst[R] = st_l;
    dst[2 * R] = __frcp_rn(st_l);
    dst[3 * R] = st_d;
  };
  stage_rows<T, HDP, PREFIX>(Ks, pkb, base + D, k0, P, N, D, 3 * D, hd, vec);
  stage_rows<T, HDP, PREFIX>(Vs, pvb, base + 2 * D, k0, P, N, D, 3 * D, hd, vec);
  prefetch(0);
  cp_async_commit();
  if (threadIdx.x < R) {
    load_stats(0);
    store_stats(0);
  }

  RowFrags<HDP, HOLD> kf, vf;
  float dk[HDP / 8][4], dv[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  const int key_g = k0 + warp * 16 + lane / 4;

  for (int i = 0; i < qtiles; ++i) {
    const bool next = i + 1 < qtiles;
    if (next) prefetch(i + 1);
    cp_async_commit();
    if (next && threadIdx.x < R) load_stats(i + 1);
    cp_async_wait<1>();
    __syncthreads();  // stage i (and at i == 0 K, V and tile 0's statistics) visible
    if (i == 0) {
      kf.load(Ks + warp * 16 * LD);
      vf.load(Vs + warp * 16 * LD);
    }
    const int buf = i % 2;
    const float* sm = St + buf * 4 * R;
#pragma unroll
    for (int c = 0; c < R / kHalf; ++c) {
      const int c0 = i * R + c * kHalf;
      if (c0 >= S) break;
      const T* Qb = Qs + buf * TILE + c * kHalf * LD;
      const T* Gb = Gs + buf * TILE + c * kHalf * LD;
      float s[NT][4] = {}, dp[NT][4] = {};
      mma_abt(s, kf, Qb);   // S^T = K . Q^T
      mma_abt(dp, vf, Gb);  // dP^T = V . g^T
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_g + (e / 2) * 8, qc = c * kHalf + j * 8 + 2 * t + (e % 2);
          const int q = i * R + qc;
          const bool ok = q < S && key < N;
          float v = __fmul_rn(s[j][e], scale);
          if (MASK && ok) v = __fadd_rn(v, mask[(int64_t)q * S + key]);
          const float p = ok ? softmax_prob(v, sm[qc], sm[R + qc], sm[2 * R + qc]) : 0.f;
          s[j][e] = p;                                // P^T; mma_xb rounds it to bf16
          dp[j][e] = p * (dp[j][e] - sm[3 * R + qc]);  // dS^T, rounded likewise
        }
      mma_xb<NT, HDP>(dv, s, Gb);   // dV += round(P^T) . g
      mma_xb<NT, HDP>(dk, dp, Qb);  // dK += dS^T . Q
    }
    if (next && threadIdx.x < R) store_stats(i + 1);
    __syncthreads();  // buffers i % 2 read in full before stage i + 2 overwrites them
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kj = key_g + (e / 2) * 8;
    T* krow;
    T* vrow;
    if (PREFIX && kj < P) {
      krow = dpk + ((int64_t)b * P + kj) * D + (int64_t)h * hd;
      vrow = dpv + ((int64_t)b * P + kj) * D + (int64_t)h * hd;
    } else if (kj < N) {
      krow = dqkv + ((int64_t)b * S + kj - P) * 3 * D + D + (int64_t)h * hd;
      vrow = krow + D;
    } else {
      continue;
    }
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      const int col = d * 8 + 2 * t + (e % 2);
      if (col < hd) {
        krow[col] = from_f<T>(dk[d][e] * scale);
        vrow[col] = from_f<T>(dv[d][e]);
      }
    }
  }
}

// The two backward kernels: the bf16 instantiations run the tensor-core
// bodies (4 warps a block, registers capped at 168 for hd <= 64 so that 3
// blocks share an SM), the f32 ones the FMA bodies (kThreads a block).
template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kIsF32<T> ? kThreads : kMmaThreads,
                                  kIsF32<T> ? 1 : HD <= 64 ? 3 : 2)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ pk,
                   const T* __restrict__ pv, int64_t pk_bstride, int64_t pv_bstride,
                   const float* __restrict__ mask, const T* __restrict__ g,
                   T* __restrict__ dqkv, float* __restrict__ stats, int S, int P, int H, int hd,
                   float scale, bool vec) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  if constexpr (kIsF32<T>)
    bwd_dq_fma<T, HD, MODE>(reinterpret_cast<float*>(bwd_smem), qkv, pk, pv, pk_bstride,
                            pv_bstride, mask, g, dqkv, stats, S, P, H, hd, scale);
  else
    bwd_dq_mma<HD, MODE>(bwd_smem, qkv, pk, pv, pk_bstride, pv_bstride, mask, g, dqkv, stats, S,
                         P, H, hd, scale, vec);
}

template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kIsF32<T> ? kThreads : kMmaThreads,
                                  kIsF32<T> ? 1 : HD <= 64 ? 3 : 2)
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ pk,
                     const T* __restrict__ pv, int64_t pk_bstride, int64_t pv_bstride,
                     const float* __restrict__ mask, const T* __restrict__ g,
                     T* __restrict__ dqkv, T* __restrict__ dpk, T* __restrict__ dpv,
                     const float* __restrict__ stats, int S, int P, int H, int hd, float scale,
                     bool vec) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  if constexpr (kIsF32<T>)
    bwd_dkdv_fma<T, HD, MODE>(reinterpret_cast<float*>(bwd_smem), qkv, pk, pv, pk_bstride,
                              pv_bstride, mask, g, dqkv, dpk, dpv, stats, S, P, H, hd, scale);
  else
    bwd_dkdv_mma<HD, MODE>(bwd_smem, qkv, pk, pv, pk_bstride, pv_bstride, mask, g, dqkv, dpk,
                           dpv, stats, S, P, H, hd, scale, vec);
}

// ------------------------------------------------------------------ launch

template <typename T, int HDP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(T) * (size_t)5 * MmaTile<T, HDP>::kElems +
         (kIsF32<T> ? sizeof(float) * 4 * 16 * (kKT + 4) : 0);
}

// The backward kernels' shared memory. bf16: 6 tiles (dq: Q, g, 2 K, 2 V;
// dk/dv: K, V, 2 Q, 2 g), and for dk/dv 2 x 4 rows of query statistics.
template <typename T, int HDP>
constexpr size_t bwd_dq_smem() {
  constexpr size_t LD = HDP + 1;
  return kIsF32<T> ? sizeof(float) * (2 * kQT * LD + 2 * kKT * LD + 2 * kQT * (kKT + 1) + 3 * kQT)
                   : sizeof(T) * 6 * MmaTile<T, HDP>::kElems;
}

template <typename T, int HDP>
constexpr size_t bwd_dkdv_smem() {
  constexpr size_t LD = HDP + 1;
  return kIsF32<T> ? sizeof(float) * (2 * kKT * LD + 2 * kQT * LD + 2 * kQT * (kKT + 1) + 3 * kQT)
                   : sizeof(T) * 6 * MmaTile<T, HDP>::kElems + sizeof(float) * 2 * 4 * kMmaRows;
}

// What the kernels take: at most 65535 images and heads (grid z and y), any
// S >= 1 and P >= 0, hd 1 ... kMaxHeadDim, float32 (0) or bfloat16 (1).
inline bool supported(int B, int S, int P, int H, int hd, int dtype) {
  return B > 0 && S > 0 && P >= 0 && H > 0 && B <= 65535 && H <= 65535 && hd > 0 &&
         hd <= kMaxHeadDim && (dtype == 0 || dtype == 1);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether every row a kernel stages from qkv, pk and pv starts on a 16-byte
// boundary and holds whole 16-byte chunks, so cp.async can copy it (the
// backward also needs g aligned: its rows are D apart).
template <typename T, bool PREFIX>
bool vectorizable(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                  int64_t pv_bstride, int hd) {
  constexpr int chunk = 16 / sizeof(T);
  bool ok = aligned16(qkv) && hd % chunk == 0;
  if (PREFIX) ok = ok && aligned16(pk) && aligned16(pv) && pk_bstride % chunk == 0 &&
                   pv_bstride % chunk == 0;
  return ok;
}

template <typename T, int HDP, int MODE>
cudaError_t launch_fwd(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                       int64_t pv_bstride, const float* mask, void* out, int B, int S, int P,
                       int H, int hd, float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, HDP>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, HDP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = vectorizable<T, MODE == kPrefix>(qkv, pk, pv, pk_bstride, pv_bstride, hd);
  dim3 grid((S + kMmaRows - 1) / kMmaRows, H, B);
  attn_fwd_kernel<T, HDP, MODE><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(pk), static_cast<const T*>(pv),
      pk_bstride, pv_bstride, mask, static_cast<T*>(out), S, P, H, hd, scale, vec);
  return cudaGetLastError();
}

template <typename T, int HDP, int MODE>
cudaError_t launch_bwd(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                       int64_t pv_bstride, const float* mask, const void* g, void* dqkv,
                       void* dpk, void* dpv, void* stats, int B, int S, int P, int H, int hd,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem1 = bwd_dq_smem<T, HDP>(), smem2 = bwd_dkdv_smem<T, HDP>();
  constexpr int threads = kIsF32<T> ? kThreads : kMmaThreads;
  constexpr int rows = kIsF32<T> ? kQT : kMmaRows;  // queries a dq block
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, HDP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, HDP, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  const T* pk_ = static_cast<const T*>(pk);
  const T* pv_ = static_cast<const T*>(pv);
  const bool vec = !kIsF32<T> && aligned16(g) &&
                   vectorizable<T, MODE == kPrefix>(qkv, pk, pv, pk_bstride, pv_bstride, hd);
  dim3 grid1((S + rows - 1) / rows, H, B);
  attn_bwd_dq_kernel<T, HDP, MODE><<<grid1, threads, smem1, stream>>>(
      static_cast<const T*>(qkv), pk_, pv_, pk_bstride, pv_bstride, mask,
      static_cast<const T*>(g), static_cast<T*>(dqkv), static_cast<float*>(stats), S, P, H, hd,
      scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2((P + S + kKT - 1) / kKT, H, B);
  attn_bwd_dkdv_kernel<T, HDP, MODE><<<grid2, threads, smem2, stream>>>(
      static_cast<const T*>(qkv), pk_, pv_, pk_bstride, pv_bstride, mask,
      static_cast<const T*>(g), static_cast<T*>(dqkv), static_cast<T*>(dpk),
      static_cast<T*>(dpv), static_cast<const float*>(stats), S, P, H, hd, scale, vec);
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
#define LCT_FWD(T, HDP)                                                                       \
  return launch_fwd<T, HDP, MODE>(qkv, pk, pv, pk_bstride, pv_bstride, mask, out, B, S, P, H, \
                                  hd, scale, st)
  const int hdp = padded_head_dim(hd);
  if (dtype == 0) {
    if (hdp == 16) LCT_FWD(float, 16);
    if (hdp == 32) LCT_FWD(float, 32);
    if (hdp == 64) LCT_FWD(float, 64);
    LCT_FWD(float, 128);
  }
  if (hdp == 16) LCT_FWD(__nv_bfloat16, 16);
  if (hdp == 32) LCT_FWD(__nv_bfloat16, 32);
  if (hdp == 64) LCT_FWD(__nv_bfloat16, 64);
  LCT_FWD(__nv_bfloat16, 128);
#undef LCT_FWD
}

template <int MODE>
cudaError_t attn_bwd(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                     int64_t pv_bstride, const float* mask, const void* g, void* dqkv,
                     void* dpk, void* dpv, void* stats, int B, int S, int P, int H, int hd,
                     int dtype, float scale, cudaStream_t st) {
  if (!supported(B, S, P, H, hd, dtype) || !mode_inputs_ok<MODE>(P, mask))
    return cudaErrorInvalidValue;
#define LCT_BWD(T, HDP)                                                                     \
  return launch_bwd<T, HDP, MODE>(qkv, pk, pv, pk_bstride, pv_bstride, mask, g, dqkv, dpk, \
                                  dpv, stats, B, S, P, H, hd, scale, st)
  const int hdp = padded_head_dim(hd);
  if (dtype == 0) {
    if (hdp == 16) LCT_BWD(float, 16);
    if (hdp == 32) LCT_BWD(float, 32);
    if (hdp == 64) LCT_BWD(float, 64);
    LCT_BWD(float, 128);
  }
  if (hdp == 16) LCT_BWD(__nv_bfloat16, 16);
  if (hdp == 32) LCT_BWD(__nv_bfloat16, 32);
  if (hdp == 64) LCT_BWD(__nv_bfloat16, 64);
  LCT_BWD(__nv_bfloat16, 128);
#undef LCT_BWD
}

}  // namespace lct
