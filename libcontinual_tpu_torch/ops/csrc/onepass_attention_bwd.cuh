// The one-pass backward of the packed, prefix and masked attention for Hopper
// (sm_90a), at bf16, hd <= 64 and N = P + S <= 256 keys: an overload of
// attn_bwd_dkdv_kernel (template arguments <MODE, KEYS>) that computes dq, dk
// and dv in one launch, beside the streaming pair of attention_kernels.cuh
// (attn_bwd_dq_kernel + attn_bwd_dkdv_kernel), which keeps every other shape
// (f32, hd 65-128, more than 256 keys). attn_bwd_any below is the one place
// that chooses between them, from the shape alone (onepass, the forward's
// rule); attention.cu's entry points call it and export the predicate
// (lct_attn_onepass). (The overload keeps the dk/dv kernel's name, as the
// one-pass forward keeps attn_fwd_kernel's: the keys are its accumulator
// rows, as there.)
//
// Replaces, at those shapes, the TPU kernels _qkv_bwd_kernel, _pqkv_bwd_kernel
// and _mqkv_bwd_kernel (libcontinual_tpu/ops/attention.py), with their rounding
// points: s = (q . k^T in f32) * scale [+ mask], formed as
// __fadd_rn(__fmul_rn(.)); P in f32 (softmax_prob); dP = g . v^T;
// c = rowsum(dP * P) over the unrounded P; dv = round(P)^T . g;
// dS = round(P * (dP - c)); dq = dS . k * scale; dk = dS^T . q * scale; f32
// accumulation, each gradient rounded once. Only the order of the f32 sums
// differs from the streaming pair and the plain versions.
//
// What bounds it. At ViT-B shapes (B 128, S 197-222, hd 64) the bytes set the
// least time (about 91 us at S 222: qkv and g read, dqkv written once). The
// streaming pair forms S and dP three times a score (the dq kernel's two
// sweeps over K and V, the dk/dv kernel's one) with three expf, and streams K
// and V once per query tile and Q and g once per key tile, on mma.sync.
//
// What the design does about it. One block per (head, image) stages the
// head's Q, K, V and g once (each up to 256 x 64 bf16, 32 KB, in 128-byte-
// swizzled rows that wgmma reads; zero past S, N and hd; the tile that
// straddles P mixes prefix and sequence rows), and every product runs on
// wgmma: seven 64 x N x 64 product units a head instead of nine, two expf a
// score instead of three.
//   * The block is KEYS / 64 warpgroups; warpgroup w owns keys 64w ... 64w+63.
//   * Sweep 1 (queries as the accumulator rows): warpgroup w takes the 64-query
//     tiles w, w + KEYS/64, ...; with the tile's Q and g as register
//     A-fragments, per 64-key block it forms S = Q . K^T and dP = g . V^T and
//     keeps each row's max m, sum l and a = sum exp(s - m) dP online, as the
//     streaming dq kernel does; each row's (m, l, 1 / l, a / l) goes to
//     shared memory. One block barrier.
//   * Sweep 2 (keys as the accumulator rows): the warpgroups walk the 32-query
//     chunks. Each forms S^T = K_w . Q^T and dP^T = V_w . g^T for its 64 keys,
//     then P^T and dS^T in the accumulator registers (a column's statistics
//     from shared memory; a query past S or a key past N gets the score -inf,
//     so P = 0 and dS = 0 with no branch), and, with P^T and dS^T rounded to
//     bf16 straight into A-fragments (the m64nNk16 accumulator layout is the
//     A-fragment layout), dV += round(P^T) . g and dK += dS^T . Q. dK and dV
//     of its 64 keys stay in registers across the chunks.
//   * dq. Each warpgroup also stores its dS^T fragments transposed (stmatrix)
//     as its 64-key panel of the chunk's dS (a [query][key] B operand), in one
//     of kPanelBufs rotating buffers. One warpgroup a chunk (they take turns)
//     waits until every panel is in, forms the chunk's dq^T = K^T . dS^T over
//     all N keys (K read transposed from the staged rows) and stores it
//     through shared memory in 16-byte rows. Named barriers pair the panels'
//     writers and their reader (one "in", one "read in full" a buffer), so no
//     block barrier runs in sweep 2 and the warpgroups drift apart: one's
//     softmax overlaps another's products.
//   * Every wgmma of a pipeline stage is issued unconditionally (KEYS is a
//     template argument; the dq stage is whole inside its warpgroup's turn):
//     a wgmma inside a branch made ptxas serialize all of them.
//   * Registers: at most 128 a thread at 256 keys (512 threads, 1 block an
//     SM; dK and dV take 64, a chunk's S^T and dP^T 32); shared memory
//     213 KB at 256 keys, 107 KB at 128 (2 blocks an SM), 54 KB at 64 (4).
// One launch per backward; no atomics, every sum in a fixed order, so two calls
// give the same bits.

#pragma once

#include "onepass_attention.cuh"

namespace lct {

constexpr int kBwdChunk = 32;   // queries a chunk of sweep 2
constexpr int kPanelBufs = 4;   // rotating buffers of the chunks' dS panels
constexpr int kStage = 64 * kOnePassHd;  // bf16 elements of 64 staged rows

// ------------------------------------------------------------ wgmma primitives

// reg_fence over an m64n32 accumulator
__device__ __forceinline__ void reg_fence16(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B on m64n32k16, both operands in shared memory; B K-major. TNSP_A
// 0: A's rows run along m (K-major); 1: A is read transposed, its swizzled rows
// along k (K as A = K^T, keys x hd). d[4c + e]: row g (e < 2) or g + 8, column
// 8c + 2t + e % 2.
template <int TNSP_A>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TNSP_A));
}

// The block's named barriers past __syncthreads' 0: a panel buffer's dS is in
// (kReady + buffer: the chunk's other warpgroups arrive, its dq warpgroup
// waits) and read in full (kFree + buffer: the dq warpgroup arrives, the
// others wait before they write the buffer again).
constexpr int kReady = 1, kFree = kReady + kPanelBufs;
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Four 8 x 8 bf16 tiles from the mma fragment layout (x[j]: row lane / 4,
// columns 2 (lane % 4) and + 1 of tile j) stored transposed; lane 8j + i
// gives the address of stored row i of tile j.
__device__ __forceinline__ void stmatrix_x4_trans(void* p, const uint32_t (&x)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(smem_addr(p)), "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3])
               : "memory");
}

// Stage `rows` rows of one head in 128-byte swizzled rows, by the whole block:
// row j < P from `pre` (row stride D), P <= j < N from `seq` (row stride
// seq_ld, row j - P); zero at or past N and in the columns at or past hd.
// `vec`: cp.async copies (committed by the caller), else element copies.
template <bool PREFIX>
__device__ __forceinline__ void stage_head(__nv_bfloat16* dst, const __nv_bfloat16* pre,
                                           const __nv_bfloat16* seq, int64_t seq_ld, int rows,
                                           int P, int N, int D, int hd, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * 8; e += blockDim.x) {
      const int r = e / 8, c = e % 8;
      const __nv_bfloat16* src = seq;  // a valid address; nothing is read from it
      int bytes = 0;
      if (r < N && c * 8 < hd) {
        src = (PREFIX && r < P) ? pre + (int64_t)r * D + c * 8
                                : seq + (int64_t)(r - P) * seq_ld + c * 8;
        bytes = 16;
      }
      cp_async16(dst + r * 64 + (c ^ (r % 8)) * 8, src, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < rows * 64; e += blockDim.x) {
      const int r = e / 64, col = e % 64;
      __nv_bfloat16 x = __float2bfloat16_rn(0.f);
      if (r < N && col < hd)
        x = (PREFIX && r < P) ? pre[(int64_t)r * D + col] : seq[(int64_t)(r - P) * seq_ld + col];
      dst[r * 64 + ((col / 8) ^ (r % 8)) * 8 + col % 8] = x;
    }
  }
}

// Shared memory of a block over KEYS staged keys: Q, K, V and g (KEYS
// swizzled rows each), kPanelBufs buffers of a dS panel a warpgroup
// (kBwdChunk x 64, swizzled), a dq tile a warpgroup (the same), the row
// statistics (a float4 a query), and 1 KB to align Q to the swizzle's period.
constexpr size_t onepass_bwd_smem_bytes(int keys) {
  return 1024 + (size_t)4 * keys * 64 * sizeof(__nv_bfloat16) +
         (size_t)(kPanelBufs + 1) * (keys / 64) * kBwdChunk * 64 * sizeof(__nv_bfloat16) +
         (size_t)keys * 16;
}

// ---------------------------------------------------------------- the kernel

// One block of KEYS / 64 warpgroups per (head, image). KEYS: N rounded up to
// 64 (64, 128, 192 or 256). dq goes to dqkv's q columns; dk and dv of a
// sequence key to its k and v columns, of a prefix key to dpk and dpv ((B, P,
// D), contiguous). pairs: hd even, so dk and dv go out two at a time; ovec:
// hd and dqkv's rows whole 16-byte chunks, so dq goes out 16 bytes at a time.
template <int MODE, int KEYS>
__global__ void __launch_bounds__(KEYS / 64 * kMmaThreads, KEYS <= 128 ? 256 / KEYS : 1)
attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ pk,
                     const __nv_bfloat16* __restrict__ pv, int64_t pk_bstride, int64_t pv_bstride,
                     const float* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dqkv, __nv_bfloat16* __restrict__ dpk,
                     __nv_bfloat16* __restrict__ dpv, int S, int P, int H, int hd, float scale,
                     bool vec, bool pairs, bool ovec) {
  using T = __nv_bfloat16;
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked;
  constexpr int NW = KEYS / 64;  // warpgroups, and 64-key blocks
  constexpr int NT = NW * kMmaThreads;
  constexpr int QC = kBwdChunk, HDP = kOnePassHd, PANEL = QC * 64;
  P = PREFIX ? P : 0;  // a compile-time 0 without a prefix
  const int D = H * hd, N = P + S;
  extern __shared__ __align__(16) unsigned char onepass_bwd_tiles[];
  const unsigned pad = (1024u - (smem_addr(onepass_bwd_tiles) & 1023u)) & 1023u;
  T* Qs = reinterpret_cast<T*>(onepass_bwd_tiles + pad);  // KEYS swizzled rows
  T* Ks = Qs + KEYS * 64;                                  // the same
  T* Vs = Ks + KEYS * 64;
  T* Gs = Vs + KEYS * 64;
  T* Ds = Gs + KEYS * 64;  // kPanelBufs x NW panels: dS as [query][key], swizzled
  T* Os = Ds + kPanelBufs * NW * PANEL;                      // NW dq tiles: [query][d]
  float4* St = reinterpret_cast<float4*>(Os + NW * PANEL);  // (m, l, 1 / l, a / l) a query
  const int h = blockIdx.x, b = blockIdx.y;
  // warp-uniform, so that the operand descriptors live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kMmaThreads, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0), lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* base = qkv + (int64_t)b * S * 3 * D + (int64_t)h * hd;
  const T* gbase = dout + (int64_t)b * S * D + (int64_t)h * hd;
  const T* pkb = PREFIX ? pk + b * pk_bstride + (int64_t)h * hd : nullptr;
  const T* pvb = PREFIX ? pv + b * pv_bstride + (int64_t)h * hd : nullptr;
  const int qtiles = (S + 63) / 64, qrows = qtiles * 64;  // qrows <= KEYS: S <= N

  stage_head<false>(Qs, nullptr, base, 3 * D, qrows, 0, S, D, hd, vec);
  stage_head<PREFIX>(Ks, pkb, base + D, 3 * D, KEYS, P, N, D, hd, vec);
  stage_head<PREFIX>(Vs, pvb, base + 2 * D, 3 * D, KEYS, P, N, D, hd, vec);
  stage_head<false>(Gs, nullptr, gbase, D, qrows, 0, S, D, hd, vec);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // ---- sweep 1: each query row's m, l and a over the N keys, online
  for (int tq = wg; tq < qtiles; tq += NW) {
    const int row_g = tq * 64 + warp * 16 + g;  // this thread's rows: row_g and row_g + 8
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
    // the warp's 16 rows of the tile's Q and g as A-fragments (ldmatrix from
    // the swizzled rows): k-step kk, lanes 16-31 the upper 8 columns
    uint32_t qa[HDP / 16][4], ga[HDP / 16][4];
    {
      const int r = tq * 64 + warp * 16 + lane % 16;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int c = ((2 * kk + lane / 16) ^ (r % 8)) * 8;
        ldmatrix_x4(qa[kk], Qs + r * 64 + c);
        ldmatrix_x4(ga[kk], Gs + r * 64 + c);
      }
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      float s[32], dp[32];
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        wgmma_rs<0>(s, qa[kk], sw128_desc(Ks + j * kStage + kk * 16), kk);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        wgmma_rs<0>(dp, ga[kk], sw128_desc(Vs + j * kStage + kk * 16), kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = i / 4, e = i % 4;
        const int row = row_g + (e / 2) * 8, col = j * 64 + c * 8 + 2 * t + (e % 2);
        float v = __fmul_rn(s[i], scale);
        if (MASK && row < S && col < N) v = __fadd_rn(v, mask[(int64_t)row * S + col]);
        if (j == NW - 1) v = col < N ? v : -INFINITY;  // KEYS - 64 < N: only here
        s[i] = v;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);  // finite: key 0 is in the first block
        float le[2] = {0.f, 0.f}, ae[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const float x = expf(s[4 * c + 2 * r + c2] - m_new);
            le[c2] += x;
            ae[c2] = fmaf(x, dp[4 * c + 2 * r + c2], ae[c2]);
          }
        float ls = le[0] + le[1], as = ae[0] + ae[1];
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        ls += __shfl_xor_sync(0xffffffffu, ls, 2);
        as += __shfl_xor_sync(0xffffffffu, as, 1);
        as += __shfl_xor_sync(0xffffffffu, as, 2);
        const float alpha = expf(m[r] - m_new);  // 0 on the first block
        l[r] = fmaf(l[r], alpha, ls);
        a[r] = fmaf(a[r], alpha, as);
        m[r] = m_new;
      }
    }
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        St[row_g + 8 * r] = make_float4(m[r], l[r], __frcp_rn(l[r]), a[r] / l[r]);
  }
  __syncthreads();

  // ---- sweep 2: the 32-query chunks, keys as the accumulator rows
  const int key_g = wg * 64 + warp * 16 + g;  // this thread's keys: key_g and key_g + 8
  const T* Kw = Ks + wg * kStage;
  const T* Vw = Vs + wg * kStage;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  const int chunks = (S + QC - 1) / QC;
  for (int ch = 0; ch < chunks; ++ch) {
    const int q0 = ch * QC, buf = ch % kPanelBufs, turn = ch % NW;  // turn: dq's warpgroup
    float s[16], dp[16];
    reg_fence16(s);
    reg_fence16(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss32<0>(s, sw128_desc(Kw + kk * 16), sw128_desc(Qs + q0 * 64 + kk * 16), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss32<0>(dp, sw128_desc(Vw + kk * 16), sw128_desc(Gs + q0 * 64 + kk * 16), kk);
    wgmma_commit();
    wgmma_wait<1>();  // S^T; dP^T's products still run
    reg_fence16(s);

    // P^T in place, while dP^T's products run; column 8c + 2t + u is query
    // q0 + that. Branch-free: a query past S or a key past N scores -inf, so
    // P = dS = 0 there.
#pragma unroll
    for (int c = 0; c < QC / 8; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = q0 + c * 8 + 2 * t + u;
        const float4 st = St[q];  // q < qrows: written by sweep 1, finite
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * c + 2 * r + u, key = key_g + 8 * r;
          const bool ok = q < S && key < N;
          float v = __fmul_rn(s[i], scale);
          if (MASK && ok) v = __fadd_rn(v, mask[(int64_t)q * S + key]);
          s[i] = softmax_prob(ok ? v : -INFINITY, st.x, st.y, st.z);  // P^T
        }
      }
    wgmma_wait<0>();
    reg_fence16(dp);
#pragma unroll
    for (int c = 0; c < QC / 8; ++c)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float dsum = St[q0 + c * 8 + 2 * t + u].w;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * c + 2 * r + u;
          dp[i] = s[i] * (dp[i] - dsum);  // dS^T, rounded as it is packed
        }
      }
    // P^T and dS^T as the A-fragments of the 16-query steps kk: chunks 2kk, 2kk + 1
    uint32_t pa[QC / 16][4], da[QC / 16][4];
#pragma unroll
    for (int kk = 0; kk < QC / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }
    // this buffer's panels of chunk ch - kPanelBufs read in full by their dq
    if (ch >= kPanelBufs && wg != (ch - kPanelBufs) % NW) named_sync(kFree + buf, NT);
    // dS rounded once (the fragments) into this warpgroup's panel as
    // [query][key - 64 wg]: tile c of key half r stored transposed, lane 8c + i
    // giving query row 8c + i
    T* Dw = Ds + (buf * NW + wg) * PANEL;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kc = 2 * warp + r;  // the tile's 8 keys: 16-byte chunk kc of the row
      const uint32_t x[4] = {da[0][r], da[0][2 + r], da[1][r], da[1][2 + r]};
      stmatrix_x4_trans(Dw + lane * 64 + ((kc ^ (lane % 8)) * 8), x);
    }
    fence_proxy_async();  // the panel's stores, visible to wgmma
    if (wg != turn) named_arrive(kReady + buf, NT);

    // dV += round(P^T) . g, dK += dS^T . Q (the chunk's rows as the k index)
    reg_fence(dk);
    reg_fence(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QC / 16; ++kk)
      wgmma_rs<1>(dv, pa[kk], sw128_desc(Gs + (q0 + kk * 16) * 64), 1);
#pragma unroll
    for (int kk = 0; kk < QC / 16; ++kk)
      wgmma_rs<1>(dk, da[kk], sw128_desc(Qs + (q0 + kk * 16) * 64), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);

    if (wg == turn) {
      // the chunk's dq^T = K^T . dS^T over all N keys: every warpgroup's panel
      named_sync(kReady + buf, NT);
      float dq[16];
      reg_fence16(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NW * 4; ++kk)
        wgmma_ss32<1>(dq, sw128_desc(Ks + kk * 16 * 64),
                      sw128_desc(Ds + (buf * NW + kk / 4) * PANEL + (kk % 4) * 16), kk);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence16(dq);
      if (ch + kPanelBufs < chunks) named_arrive(kFree + buf, NT);
      // dq rounded once, through this warp's 16 columns of the warpgroup's
      // tile as [query][d] rows (the fragments stored transposed), then out
      // in 16-byte pieces: the warp's two of each row
      T* Ow = Os + wg * PANEL;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int dc = 2 * warp + r;  // the tile's 8 columns: 16-byte chunk dc of the row
        const uint32_t x[4] = {
            pack_bf16(dq[2 * r] * scale, dq[2 * r + 1] * scale),
            pack_bf16(dq[4 + 2 * r] * scale, dq[5 + 2 * r] * scale),
            pack_bf16(dq[8 + 2 * r] * scale, dq[9 + 2 * r] * scale),
            pack_bf16(dq[12 + 2 * r] * scale, dq[13 + 2 * r] * scale)};
        stmatrix_x4_trans(Ow + lane * 64 + ((dc ^ (lane % 8)) * 8), x);
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = lane + 32 * k, row = e / 2, dc = 2 * warp + e % 2, q = q0 + row;
        const T* src = Ow + row * 64 + ((dc ^ (row % 8)) * 8);
        T* drow = dqkv + ((int64_t)b * S + q) * 3 * D + (int64_t)h * hd + dc * 8;
        if (q < S && dc * 8 < hd) {
          if (ovec) {
            *reinterpret_cast<uint4*>(drow) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int c = 0; c < 8 && dc * 8 + c < hd; ++c) drow[c] = src[c];
          }
        }
      }
    }
  }

  // dK (times scale) and dV of this thread's keys, rounded once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_g + 8 * r;
    if (key >= N) continue;
    T* krow;
    T* vrow;
    if (PREFIX && key < P) {
      krow = dpk + ((int64_t)b * P + key) * D + (int64_t)h * hd;
      vrow = dpv + ((int64_t)b * P + key) * D + (int64_t)h * hd;
    } else {
      krow = dqkv + ((int64_t)b * S + key - P) * 3 * D + D + (int64_t)h * hd;
      vrow = krow + D;
    }
#pragma unroll
    for (int c = 0; c < HDP / 8; ++c) {
      const int d = c * 8 + 2 * t;
      const float k0 = dk[4 * c + 2 * r] * scale, k1 = dk[4 * c + 2 * r + 1] * scale;
      const float v0 = dv[4 * c + 2 * r], v1 = dv[4 * c + 2 * r + 1];
      if (d >= hd) continue;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(krow + d) = pack_bf16(k0, k1);
        *reinterpret_cast<uint32_t*>(vrow + d) = pack_bf16(v0, v1);
      } else {
        krow[d] = __float2bfloat16_rn(k0);
        vrow[d] = __float2bfloat16_rn(v0);
        if (d + 1 < hd) {
          krow[d + 1] = __float2bfloat16_rn(k1);
          vrow[d + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch

template <int MODE, int KEYS>
cudaError_t launch_bwd_onepass(const void* qkv, const void* pk, const void* pv,
                               int64_t pk_bstride, int64_t pv_bstride, const float* mask,
                               const void* g, void* dqkv, void* dpk, void* dpv, int B, int S,
                               int P, int H, int hd, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  // the overload named through its type: the streaming template has the same name
  void (*kernel)(const T*, const T*, const T*, int64_t, int64_t, const float*, const T*, T*, T*,
                 T*, int, int, int, int, float, bool, bool, bool) = attn_bwd_dkdv_kernel<MODE, KEYS>;
  constexpr size_t smem = onepass_bwd_smem_bytes(KEYS);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec =
      aligned16(g) && vectorizable<T, MODE == kPrefix>(qkv, pk, pv, pk_bstride, pv_bstride, hd);
  const auto aligned4 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; };
  const bool pairs = hd % 2 == 0 && aligned4(dqkv) &&
                     (MODE != kPrefix || (aligned4(dpk) && aligned4(dpv)));
  const bool ovec = hd % 8 == 0 && aligned16(dqkv);
  kernel<<<dim3(H, B), KEYS / 64 * kMmaThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(pk), static_cast<const T*>(pv),
      pk_bstride, pv_bstride, mask, static_cast<const T*>(g), static_cast<T*>(dqkv),
      static_cast<T*>(dpk), static_cast<T*>(dpv), S, P, H, hd, scale, vec, pairs, ovec);
  return cudaGetLastError();
}

// The backward of any supported shape: the one-pass kernel where onepass
// takes it, the streaming pair elsewhere (which alone uses `stats`).
template <int MODE>
cudaError_t attn_bwd_any(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                         int64_t pv_bstride, const float* mask, const void* g, void* dqkv,
                         void* dpk, void* dpv, void* stats, int B, int S, int P, int H, int hd,
                         int dtype, float scale, cudaStream_t st) {
  if (!supported(B, S, P, H, hd, dtype) || !mode_inputs_ok<MODE>(P, mask))
    return cudaErrorInvalidValue;
#define LCT_ONEPASS(KEYS)                                                                  \
  return launch_bwd_onepass<MODE, KEYS>(qkv, pk, pv, pk_bstride, pv_bstride, mask, g, dqkv, \
                                        dpk, dpv, B, S, P, H, hd, scale, st)
  if (onepass(P + S, hd, dtype)) {  // the keys rounded up to 64
    if (P + S <= 64) LCT_ONEPASS(64);
    if (P + S <= 128) LCT_ONEPASS(128);
    if (P + S <= 192) LCT_ONEPASS(192);
    LCT_ONEPASS(256);
  }
#undef LCT_ONEPASS
  return attn_bwd<MODE>(qkv, pk, pv, pk_bstride, pv_bstride, mask, g, dqkv, dpk, dpv, stats, B,
                        S, P, H, hd, dtype, scale, st);
}

}  // namespace lct
