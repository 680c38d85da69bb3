// The one-pass forward of the packed, prefix and masked attention for Hopper
// (sm_90a), at bf16, hd <= 64 and N = P + S <= 256 keys: an overload of
// attn_fwd_kernel (template arguments <MODE, KEYS>) beside the streaming
// kernel of attention_kernels.cuh, which keeps every other shape (f32, hd
// 65-128, more than 256 keys). attn_fwd_any below is the one place that
// chooses between them, from the shape alone (onepass); attention.cu's entry
// points call it and export the predicate (lct_attn_onepass).
//
// Replaces, at those shapes, the TPU kernels _qkv_kernel, _pqkv_kernel and
// _mqkv_kernel (libcontinual_tpu/ops/attention.py), with their rounding
// points: s = (q . k^T in f32) * scale [+ mask], P = exp(s - max) / sum in
// f32 (softmax_prob: the quotient without a divide), P rounded to bf16
// before P . v, f32 accumulation, the output rounded once. Only the order of
// the f32 sums differs from the streaming kernel and the plain versions.
//
// What bounds it. At ViT-B shapes (B 128, S 197-222, hd 64) the bytes set the
// least time (about 52 us at S 222; attention_kernels.cuh). The products at
// the dense peak take about half that, and so does the softmax's per-score
// arithmetic (an expf is six FMA-pipe instructions and one MUFU). The
// streaming kernel rounds the *normalised* P, so it has to know each row's
// max and sum before it forms any P: it makes two passes over the key tiles,
// forming q . k^T and an expf per score twice.
//
// What the design does about it. With at most 256 keys, a query tile's whole
// score row fits in registers, so the max and sum are known before any P is
// formed: q . k^T runs once, expf runs once per score (the exponentials are
// kept, then scaled by the reciprocal of the sum), and K and V are read into
// shared memory once per (image, head).
//   * One block of one warpgroup (4 warps, 16 query rows each) per (head,
//     image). It stages the head's K and V once, KEYS rows each (N rounded
//     up to 64; up to 256 x 64 bf16, 32 KB) with 16-byte cp.async copies
//     (zero-filled past N and past hd; the tile that straddles P mixes
//     prefix and sequence rows, as in the streaming kernel) into
//     128-byte-swizzled rows that wgmma reads, then walks the head's
//     64-query tiles. Each warp stages its own 16 rows of the next tile's Q
//     (double-buffered) while the current one computes, so no block barrier
//     runs after the first tile. (No TMA: a tensor map cannot zero the rows
//     past one image's S inside the packed (B, S, 3D) tensor, nor switch to
//     the prefix rows mid-tile; the copies are issued once per block.)
//   * S = Q . K^T by wgmma m64n64k16 per 64-key block, Q as register
//     A-fragments (ldmatrix from a padded tile), K from shared memory: KEYS / 2
//     f32 registers of scores a thread (128 at 256 keys).
//   * The softmax in those registers: a row lives in one quad, so the max and
//     the sum take two shuffles each. It is branch-free over all KEYS
//     columns (keys past N, all in the last 64-key block, are -inf, so
//     P = 0): each pass is KEYS / 2 independent chains for the scheduler.
//   * O = P . V by wgmma with P packed to bf16 straight from the score
//     registers (the accumulator layout of m64nNk16 is the A-fragment layout)
//     and V from shared memory read transposed (its rows are the product's k
//     index). The output tile goes out through shared memory in 16-byte
//     stores.
//   * KEYS is a template argument (64, 128, 192, 256), so every wgmma is
//     issued unconditionally: a wgmma inside a branch made ptxas serialize
//     all of them. Registers: up to 255 at 192 and 256 keys (2 blocks an
//     SM), 168 at 128 keys and fewer (3 blocks an SM; 92 and 60 KB of shared
//     memory a block). One block's softmax runs on the FMA pipes while
//     another's products run on the tensor cores.
// One launch per forward; no atomics, every sum in a fixed order, so two calls
// give the same bits.

#pragma once

#include "attention_kernels.cuh"

namespace lct {

constexpr int kOnePassKeys = 256;  // the most keys (P + S) the one-pass forward takes
constexpr int kOnePassHd = 64;     // its head dim: hd <= 64, zero-padded to 64 in shared memory

// Whether a forward or backward of N keys at head dim hd and dtype (0 f32, 1
// bf16) takes a one-pass kernel; every other shape takes the streaming ones.
// One rule for both directions: both one-pass kernels hold a head of at most
// kOnePassKeys keys at hd <= kOnePassHd on chip, so a shape's forward and
// backward choose alike.
inline bool onepass(int N, int hd, int dtype) {
  return dtype == 1 && N >= 1 && N <= kOnePassKeys && hd >= 1 && hd <= kOnePassHd;
}

// ------------------------------------------------------------ wgmma primitives

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// Generic-proxy writes to shared memory (cp.async, st.shared) made visible to
// wgmma's reads (the async proxy); a __syncthreads follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins the accumulators: after a wgmma_wait the compiler sees them rewritten
// here, so it cannot hoist a read above the wait; before a wgmma's fence, their
// last write is here, on the warp-uniform path.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a wgmma operand in shared memory laid out in 128-byte
// swizzled rows (64 bf16 a row; 16-byte chunk c of row r stored at chunk
// c ^ (r % 8); 8-row groups 1024 bytes apart, the stride byte offset). The
// leading byte offset is unused by these operands (a K-major slice of 16
// columns, an MN-major one of 64) and set to the group stride too.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  constexpr uint64_t kGroup = 1024 >> 4;
  return ((addr & 0x3FFFF) >> 4) | (kGroup << 16) | (kGroup << 32) | (1ull << 62);
}

// d (+)= A . B on m64n64k16, bf16 in, f32 accumulators: A the warpgroup's
// 64 x 16 from registers (each warp's 16 rows in the m16n8k16 A-fragment
// layout), B 16 x 64 from shared memory (desc). TNSP_B 0: B's k index runs
// along its swizzled rows (K, keys x hd, as B = K^T); 1: its n index does (V,
// keys x hd). accumulate 0 overwrites d. d: the m64n64 accumulator layout,
// d[4c + e] of column chunk c: row g (e < 2) or g + 8, column 8c + 2t + e % 2.
template <int TNSP_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TNSP_B));
}

// Stage rows 0 ... rows-1 of one head's keys (or values) in 128-byte swizzled
// rows: row j < P from `pre` (row stride D), P <= j < N from `seq` (row stride
// 3D, row j - P); zero at or past N and in the columns at or past hd. `vec`:
// hd and every row start are whole 16-byte chunks, so cp.async copies them
// (committed by the caller); otherwise element copies.
template <bool PREFIX>
__device__ __forceinline__ void stage_swizzled(__nv_bfloat16* dst, const __nv_bfloat16* pre,
                                               const __nv_bfloat16* seq, int rows, int P, int N,
                                               int D, int hd, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * 8; e += kMmaThreads) {
      const int r = e / 8, c = e % 8;
      const __nv_bfloat16* src = seq;  // a valid address; nothing is read from it
      int bytes = 0;
      if (r < N && c * 8 < hd) {
        src = (PREFIX && r < P) ? pre + (int64_t)r * D + c * 8
                                : seq + (int64_t)(r - P) * 3 * D + c * 8;
        bytes = 16;
      }
      cp_async16(dst + r * 64 + (c ^ (r % 8)) * 8, src, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < rows * 64; e += kMmaThreads) {
      const int r = e / 64, col = e % 64;
      __nv_bfloat16 x = __float2bfloat16_rn(0.f);
      if (r < N && col < hd)
        x = (PREFIX && r < P) ? pre[(int64_t)r * D + col] : seq[(int64_t)(r - P) * 3 * D + col];
      dst[r * 64 + ((col / 8) ^ (r % 8)) * 8 + col % 8] = x;
    }
  }
}

// Stage query rows q0 ... q0+15 (row stride 3D) into a warp's 16 rows of a
// padded tile (kLd a row; rows at or past S and columns at or past hd zero),
// by the warp alone: it waits for its own copies, with no block barrier.
__device__ __forceinline__ void stage_warp_rows(__nv_bfloat16* dst, const __nv_bfloat16* seq,
                                                int q0, int S, int D, int hd, bool vec) {
  constexpr int LD = MmaTile<__nv_bfloat16, kOnePassHd>::kLd;
  const int lane = threadIdx.x % 32;
  if (vec) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane + 32 * k, r = e / 8, c = (e % 8) * 8, j = q0 + r;
      const __nv_bfloat16* src = seq;  // a valid address; nothing is read from it
      int bytes = 0;
      if (j < S && c < hd) {
        src = seq + (int64_t)j * 3 * D + c;
        bytes = 16;
      }
      cp_async16(dst + r * LD + c, src, bytes);
    }
  } else {
    for (int e = lane; e < 16 * kOnePassHd; e += 32) {
      const int r = e / kOnePassHd, c = e % kOnePassHd, j = q0 + r;
      dst[r * LD + c] = j < S && c < hd ? seq[(int64_t)j * 3 * D + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Shared memory of a block over `rows` staged keys (N rounded up to 64): K
// and V in swizzled rows, two padded Q tiles and the output tile, and 1 KB to
// align K to the swizzle's 1024-byte period.
constexpr size_t onepass_smem_bytes(int rows) {
  return 1024 + (size_t)2 * rows * 64 * sizeof(__nv_bfloat16) +
         sizeof(__nv_bfloat16) * 3 * MmaTile<__nv_bfloat16, kOnePassHd>::kElems;
}

// ---------------------------------------------------------------- the kernel

// One block of kMmaThreads (a warpgroup) per (head, image); its 64-query
// tiles in turn. KEYS: N rounded up to 64 (64, 128, 192 or 256), the keys it
// stages and multiplies.
template <int MODE, int KEYS>
__global__ void __launch_bounds__(kMmaThreads, KEYS <= 128 ? 3 : 2)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ pk,
                const __nv_bfloat16* __restrict__ pv, int64_t pk_bstride, int64_t pv_bstride,
                const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int S, int P,
                int H, int hd, float scale, bool vec) {
  using T = __nv_bfloat16;
  constexpr bool PREFIX = MODE == kPrefix, MASK = MODE == kMasked;
  constexpr int HDP = kOnePassHd, LDQ = MmaTile<T, HDP>::kLd;
  constexpr int NB = KEYS / 64;  // 64-key blocks of the scores (N rounded up to 64)
  constexpr int kParts = 4;      // partial maxima and sums a row, for ILP
  P = PREFIX ? P : 0;            // a compile-time 0 without a prefix
  const int D = H * hd, N = P + S;
  // 16-byte output stores: hd and every row start whole 16-byte chunks
  const bool ovec = hd % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  extern __shared__ __align__(16) unsigned char onepass_tiles[];
  const unsigned pad = (1024u - (smem_addr(onepass_tiles) & 1023u)) & 1023u;
  T* Ks = reinterpret_cast<T*>(onepass_tiles + pad);  // KEYS swizzled rows
  T* Vs = Ks + KEYS * 64;                              // the same
  T* Qs = Vs + KEYS * 64;                              // 2 buffers of 64 x LDQ, padded rows
  T* Os = Qs + 2 * kMmaRows * LDQ;                     // 64 x LDQ: the output tile
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* base = qkv + (int64_t)b * S * 3 * D + (int64_t)h * hd;
  const T* pkb = PREFIX ? pk + b * pk_bstride + (int64_t)h * hd : nullptr;
  const T* pvb = PREFIX ? pv + b * pv_bstride + (int64_t)h * hd : nullptr;
  const int tiles = (S + kMmaRows - 1) / kMmaRows;

  // groups: the first Q tile (each warp its own 16 rows) and K; V; then each
  // next Q tile
  stage_warp_rows(Qs + warp * 16 * LDQ, base, warp * 16, S, D, hd, vec);
  stage_swizzled<PREFIX>(Ks, pkb, base + D, KEYS, P, N, D, hd, vec);
  cp_async_commit();
  stage_swizzled<PREFIX>(Vs, pvb, base + 2 * D, KEYS, P, N, D, hd, vec);
  cp_async_commit();

  for (int tile = 0; tile < tiles; ++tile) {
    const int q0 = tile * kMmaRows;
    T* Qt = Qs + tile % 2 * kMmaRows * LDQ;
    if (tile == 0) {
      cp_async_wait<1>();  // Q and K
      fence_proxy_async();
      __syncthreads();  // K from every thread
    } else {
      cp_async_wait<0>();  // this warp's rows of this tile's Q
      __syncwarp();
    }
    RowFrags<HDP, true> qf;
    qf.load(Qt + warp * 16 * LDQ);

    // S = Q . K^T over the KEYS staged keys. No wgmma sits in a branch: a
    // conditional one made ptxas serialize every wgmma of the kernel.
    float s[NB][32];
#pragma unroll
    for (int j = 0; j < NB; ++j) reg_fence(s[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        wgmma_rs<0>(s[j], qf.r[kk], sw128_desc(Ks + j * 64 * 64 + kk * 16), kk);
    wgmma_commit();
    // this warp's rows of the next tile's Q while the products run (the
    // buffer's rows were last read by this warp, a tile ago)
    if (tile + 1 < tiles)
      stage_warp_rows(Qs + (tile + 1) % 2 * kMmaRows * LDQ + warp * 16 * LDQ, base,
                      q0 + kMmaRows + warp * 16, S, D, hd, vec);
    cp_async_commit();
    if (tile == 0) {  // V landed (the newest group is the next Q tile)
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NB; ++j) reg_fence(s[j]);

    // P = exp(s - m) / l in f32, in place. Branch-free over every column, so
    // the scheduler sees 128 independent chains (a branch per slab of
    // columns past N spilled registers and ran slower); keys past N give
    // -inf, then P = 0.
    const int row_g = q0 + warp * 16 + g;  // this thread's rows: row_g and row_g + 8
    float m[2][kParts], l[2][kParts];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < kParts; ++u) {
        m[r][u] = -INFINITY;
        l[r][u] = 0.f;
      }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = i / 4, e = i % 4;  // chunk and element
        const int row = row_g + (e / 2) * 8, col = j * 64 + c * 8 + 2 * t + (e % 2);
        float v = __fmul_rn(s[j][i], scale);
        if (MASK && row < S && col < N) v = __fadd_rn(v, mask[(int64_t)row * S + col]);
        if (j == NB - 1) v = col < N ? v : -INFINITY;  // KEYS - 64 < N: only here
        s[j][i] = v;
        float& mu = m[e / 2][(c % 2) * 2 + e % 2];
        mu = fmaxf(mu, v);
      }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // finite: key 0 is always there
      mx[r] = fmaxf(fmaxf(m[r][0], m[r][1]), fmaxf(m[r][2], m[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = i / 4, e = i % 4;
        s[j][i] = expf(s[j][i] - mx[e / 2]);
        l[e / 2][(c % 2) * 2 + e % 2] += s[j][i];
      }
    float sum[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = (l[r][0] + l[r][1]) + (l[r][2] + l[r][3]);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = __frcp_rn(sum[r]);
    }
    // softmax_prob's quotient on the kept exponential x
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float x = s[j][i], q = __fmul_rn(x, inv[(i % 4) / 2]);
        s[j][i] = fmaf(fmaf(-q, sum[(i % 4) / 2], x), inv[(i % 4) / 2], q);
      }
    // P rounded to bf16 as the A-fragments of the 16-key steps; step kk:
    // chunks 2 (kk % 4) and + 1 of block kk / 4
    uint32_t pa[NB * 4][4];
#pragma unroll
    for (int kk = 0; kk < NB * 4; ++kk) {
      const float* x = s[kk / 4] + 8 * (kk % 4);
      pa[kk][0] = pack_bf16(x[0], x[1]);
      pa[kk][1] = pack_bf16(x[2], x[3]);
      pa[kk][2] = pack_bf16(x[4], x[5]);
      pa[kk][3] = pack_bf16(x[6], x[7]);
    }

    // O = P . V over the KEYS staged keys (V is zero past N)
    float o[32];
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NB * 4; ++kk)
      wgmma_rs<1>(o, pa[kk], sw128_desc(Vs + kk * 16 * 64), kk);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);

    // the warp's 16 output rows, rounded once, through its rows of Os so
    // that each row goes out in 16-byte stores (element stores where hd or
    // the output's rows are not whole 16-byte chunks)
    T* Ow = Os + warp * 16 * LDQ;
#pragma unroll
    for (int c = 0; c < HDP / 8; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(Ow + (g + 8 * r) * LDQ + c * 8 + 2 * t) =
            pack_bf16(o[4 * c + 2 * r], o[4 * c + 2 * r + 1]);
    __syncwarp();
    T* obase = out + ((int64_t)b * S + q0 + warp * 16) * D + (int64_t)h * hd;
    const int rows = min(16, S - q0 - warp * 16);
    if (ovec) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = lane + 32 * k, r = e / 8, c = (e % 8) * 8;
        const uint4 x = *reinterpret_cast<const uint4*>(Ow + r * LDQ + c);
        if (r < rows && c < hd) *reinterpret_cast<uint4*>(obase + (int64_t)r * D + c) = x;
      }
    } else {
      for (int e = lane; e < rows * HDP; e += 32) {
        const int r = e / HDP, c = e % HDP;
        if (c < hd) obase[(int64_t)r * D + c] = Ow[r * LDQ + c];
      }
    }
    __syncwarp();  // Ow read in full before the next tile writes it
  }
}

// ------------------------------------------------------------------ launch

template <int MODE, int KEYS>
cudaError_t launch_fwd_onepass(const void* qkv, const void* pk, const void* pv,
                               int64_t pk_bstride, int64_t pv_bstride, const float* mask,
                               void* out, int B, int S, int P, int H, int hd, float scale,
                               cudaStream_t stream) {
  using T = __nv_bfloat16;
  // the overload named through its type: the streaming template has the same parameters
  void (*kernel)(const T*, const T*, const T*, int64_t, int64_t, const float*, T*, int, int, int,
                 int, float, bool) = attn_fwd_kernel<MODE, KEYS>;
  constexpr size_t smem = onepass_smem_bytes(KEYS);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec = vectorizable<T, MODE == kPrefix>(qkv, pk, pv, pk_bstride, pv_bstride, hd);
  kernel<<<dim3(H, B), kMmaThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(pk), static_cast<const T*>(pv),
      pk_bstride, pv_bstride, mask, static_cast<T*>(out), S, P, H, hd, scale, vec);
  return cudaGetLastError();
}

// The forward of any supported shape: the one-pass kernel where onepass
// takes it, the streaming kernel elsewhere.
template <int MODE>
cudaError_t attn_fwd_any(const void* qkv, const void* pk, const void* pv, int64_t pk_bstride,
                         int64_t pv_bstride, const float* mask, void* out, int B, int S, int P,
                         int H, int hd, int dtype, float scale, cudaStream_t st) {
  if (!supported(B, S, P, H, hd, dtype) || !mode_inputs_ok<MODE>(P, mask))
    return cudaErrorInvalidValue;
#define LCT_ONEPASS(KEYS)                                                                \
  return launch_fwd_onepass<MODE, KEYS>(qkv, pk, pv, pk_bstride, pv_bstride, mask, out, B, S, \
                                        P, H, hd, scale, st)
  if (onepass(P + S, hd, dtype)) {  // the keys rounded up to 64
    if (P + S <= 64) LCT_ONEPASS(64);
    if (P + S <= 128) LCT_ONEPASS(128);
    if (P + S <= 192) LCT_ONEPASS(192);
    LCT_ONEPASS(256);
  }
#undef LCT_ONEPASS
  return attn_fwd<MODE>(qkv, pk, pv, pk_bstride, pv_bstride, mask, out, B, S, P, H, hd, dtype,
                        scale, st);
}

}  // namespace lct
