// 3x3 stride-1 SAME convolution over NHWC activations, and its weight
// gradient, for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of libcontinual_tpu/ops/conv.py:
//   lct_conv3x3_fwd  conv3x3_fwd_kernel         <- _fwd_kernel (9 tap-shifted GEMMs,
//                    f32 accumulation; also dx, on the rotated, C<->O-transposed taps)
//   lct_conv3x3_dw   conv3x3_dw_partial_kernel  <- _dw_kernel ((9, C, O) f32 weight
//                    + conv3x3_dw_reduce_kernel    gradient over M = B*H*W pixels)
//
// Layouts: x (B, H, W, C), taps w (9, C, O) (HWIO with the two spatial axes
// merged, tap = dh * 3 + dw), y and g (B, H, W, O); all contiguous. dtype:
// 0 = float32, 1 = bfloat16 (x, w, y and g share it); the weight gradient is
// float32. Each function returns a cudaError_t (0 on success).
//
// Arithmetic: y[b, h, w, o] = sum over taps and c of
// x[b, h + dh - 1, w + dw - 1, c] * taps[dh * 3 + dw, c, o], with x read as
// zero outside the image; products of bf16 values are exact in f32, every sum
// is in f32, and y is rounded once. The only difference from the plain
// PyTorch versions (ops/conv.py) is the order of the f32 sums.
//
// What bounds them on an H100: a resnet18 stage at CIFAR geometry (B 128,
// 64 -> 64 at 32 x 32 ... 512 -> 512 at 4 x 4) is 9.66 GFLOP on 16.8 MB of
// bf16 activations, about 576 FLOP per byte, so the least time is set by the
// tensor cores (about 9.8 us at 989 TFLOP/s), not by the 5-10 us of bytes.
//   * forward (both dtypes): f32 FMA on the CUDA cores (67 TFLOP/s at most),
//     fed from shared memory, so bound by those FMAs and the shared-memory
//     reads that feed them. A block owns 64 output pixels (a tile of rows of
//     one image, or several whole small images) by 64 output channels. For
//     each chunk of 16 input channels it stages the input rows the tile
//     needs, with the 1-pixel zero halo, in shared memory (f32) once, and the
//     chunk's taps of all 9 positions; the 9 tap-shifted products then read
//     the same staged rows, so an input element is read from device memory
//     once per chunk and not 9 times. Each thread keeps a 4 pixel x 4
//     channel tile of f32 sums in registers (5 shared-memory reads for 16
//     FMAs).
//   * weight gradient: dw[tap] = x_tap^T . g is a reduction over the M =
//     B*H*W pixels, split into S slices of M: a partial kernel writes one
//     f32 sum per slice, and conv3x3_dw_reduce_kernel adds the slices in a
//     fixed order. No atomics: two calls give the same bits.
//     bf16: each tap is a GEMM with the channels c as rows, o as columns and
//     the pixels as its depth, on the tensor cores (mma.sync m16n8k16, bf16
//     in, f32 accumulators). A block of 4 warps owns a 64 x 64 (c, o) tile,
//     one row of taps (dh: its 3 taps dw), over one slice; each warp keeps
//     32 x 32 f32 sums of each of the 3 taps (96 registers). Per step of
//     128 pixels the block stages, with 16-byte cp.async copies
//     double-buffered into bf16 tiles (rows padded by 16 bytes, so ldmatrix
//     hits every bank once): the 128 g rows, and the 130 x rows that the 3
//     taps read, which are one contiguous run of pixels
//     (pixel m + (dh - 1) * W + dw - 1 for dw = 0, 1, 2). The A-fragments
//     (x_tap^T) of all 3 taps come from that one window by ldmatrix.trans,
//     each lane at its own pixel's row shifted by dw; the B-fragments (g) by
//     ldmatrix.trans once for the 3 taps. A tap that falls outside the image
//     (the 1-pixel halo, or a neighbouring image's row when a step spans
//     several images) points its lane at a zero row instead: a per-pixel mask
//     of the valid taps, written once per step, stands in for the halo, and
//     the inner loop has no divide. So x is read from device memory 3 times
//     (once per dh), not 9, and a warp's 16 pixels are 8 ldmatrix for 24
//     mma, with no branch between them (a warp multiplies the zero channels
//     of a tile past C or O too: a branch per tile cost more than the
//     products it saved). Channels past C or O are zero in shared memory
//     only; pixels past the slice are zero in g and masked in x. Slices are
//     sized for about two blocks an SM. Rows that are not whole 16-byte
//     chunks (C or O not a multiple of 8) are staged element by element.
//     f32 (the checks hold it to 1e-5, so no TF32): the FMA body, a block
//     owning one tap's 64 x 64 (c, o) tile as a 16 x 16 thread grid, on the
//     same slices.
// The forward on the tensor cores is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_kernels.cuh"  // cp.async, ldmatrix and mma.sync primitives

namespace lctconv {

using lct::kIsF32;

constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 tile of sums (FMA kernels)
constexpr int kBM = 64;        // output pixels per forward block
constexpr int kBN = 64;        // output channels (forward), c and o (weight gradient) per block
constexpr int kCK = 16;        // input channels per staged chunk (forward)
constexpr int kPK = 16;        // pixels per step of the f32 weight gradient (f32 only)
// the bf16 weight gradient on the tensor cores
constexpr int kMmaThreads = 128;         // 4 warps, 2 x 2 over the 64 x 64 (c, o) tile
constexpr int kKC = 128;                 // pixels per staged step
constexpr int kLd = kBN + 8;             // bf16 row of a staged tile: 64 channels + 16 bytes
constexpr int kRowChunks = kBN / 8;      // 16-byte chunks of a staged row
constexpr int kXRows = kKC + 3;          // x window: kKC + 2 pixel rows and the zero row
constexpr int kZeroRow = kKC + 2;
constexpr int kTargetBlocks = 2 * 132;   // bf16 partial blocks: about two an SM
constexpr int kMinSlice = 4 * kKC;       // the shortest slice of M, in pixels
constexpr size_t kDwSmem =
    sizeof(__nv_bfloat16) * 2 * (kXRows + kKC) * kLd + 2 * kKC;  // 2 buffers + the masks

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

// The forward tile: nb images x tr rows x tw columns of output pixels, at
// most kBM of them. Rows of one image while a row is narrower than kBM,
// several whole images once one image has fewer than kBM pixels.
struct Tile {
  int tr, tw, nb, tiles_h, tiles_w, tiles_b;
};

inline Tile fwd_tile(int B, int H, int W) {
  Tile t;
  t.tw = W < kBM ? W : kBM;
  t.tr = kBM / t.tw;
  if (t.tr > H) t.tr = H;
  if (t.tr < 1) t.tr = 1;
  t.nb = 1;
  if (t.tr == H && t.tw == W) {
    t.nb = kBM / (H * W);
    if (t.nb > B) t.nb = B;
    if (t.nb < 1) t.nb = 1;
  }
  t.tiles_w = (W + t.tw - 1) / t.tw;
  t.tiles_h = (H + t.tr - 1) / t.tr;
  t.tiles_b = (B + t.nb - 1) / t.nb;
  return t;
}

inline size_t fwd_smem_bytes(const Tile& t) {
  const size_t npos = (size_t)t.nb * (t.tr + 2) * (t.tw + 2);
  return (9 * kCK * kBN + npos * kCK) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int B,
                   int H, int W, int C, int O, Tile tile) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                  // [9][kCK][kBN] taps of the chunk
  float* sx = smem + 9 * kCK * kBN;  // [nb][tr + 2][tw + 2][kCK] input rows with the halo
  const int ph = tile.tr + 2, pw = tile.tw + 2;
  const int npos = tile.nb * ph * pw;
  int t = blockIdx.x;
  const int w0 = (t % tile.tiles_w) * tile.tw;
  t /= tile.tiles_w;
  const int h0 = (t % tile.tiles_h) * tile.tr;
  const int b0 = (t / tile.tiles_h) * tile.nb;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int per_img = tile.tr * tile.tw;

  // this thread's 4 pixels (p = ty + 16 i) and 4 channels (n0 + 4 tx + j)
  int base[4];
  long long out_off[4];
  bool valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    const int img = p / per_img, r = (p / tile.tw) % tile.tr, c = p % tile.tw;
    const int gb = b0 + img, gh = h0 + r, gw = w0 + c;
    valid[i] = p < tile.nb * per_img && gb < B && gh < H && gw < W;
    base[i] = valid[i] ? ((img * ph + r) * pw + c) * kCK : 0;
    out_off[i] = valid[i] ? (((long long)gb * H + gh) * W + gw) * O : 0;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kCK) {
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < npos * kCK; idx += kThreads) {
      const int k = idx % kCK, pos = idx / kCK;
      const int cc = pos % pw, rr = (pos / pw) % ph, img = pos / (pw * ph);
      const int gb = b0 + img, gh = h0 - 1 + rr, gw = w0 - 1 + cc, gc = k0 + k;
      float v = 0.f;
      if (gb < B && gh >= 0 && gh < H && gw >= 0 && gw < W && gc < C)
        v = to_f(x[(((long long)gb * H + gh) * W + gw) * C + gc]);
      sx[idx] = v;
    }
    for (int idx = tid; idx < 9 * kCK * kBN; idx += kThreads) {
      const int n = idx % kBN, k = (idx / kBN) % kCK, tap = idx / (kBN * kCK);
      const int gc = k0 + k, gn = n0 + n;
      sw[idx] = (gc < C && gn < O) ? to_f(w[((long long)tap * C + gc) * O + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * pw + tap % 3) * kCK;
      const float* wt = sw + tap * kCK * kBN + tx * 4;
#pragma unroll
      for (int k = 0; k < kCK; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(wt + k * kBN);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = sx[base[i] + shift + k];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!valid[i]) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < O) y[out_off[i] + n] = from_f<T>(acc[i][j]);
    }
  }
}

// The weight-gradient split, for both dtypes: S slices of M, each slice_len
// pixels (a multiple of kKC, so of kPK too), so that the bf16 kernel's
// blocks (3 rows of taps x the (c, o) tiles x S) number about kTargetBlocks
// and no slice is shorter than kMinSlice pixels.
struct Slices {
  int S, len;
};

inline Slices dw_slices(int B, int H, int W, int C, int O) {
  const long long M = (long long)B * H * W;
  const long long tiles = 3LL * ((C + kBN - 1) / kBN) * ((O + kBN - 1) / kBN);
  long long s = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = (M + kMinSlice - 1) / kMinSlice;
  if (s > most) s = most;
  if (s < 1) s = 1;
  long long len = (M + s - 1) / s;
  len = (len + kKC - 1) / kKC * kKC;
  Slices out;
  out.len = (int)len;
  out.S = (int)((M + len - 1) / len);
  return out;
}

// partial[s, tap, c, o] = sum over the pixels m of slice s of
// x[m shifted by tap, c] * g[m, o]. f32: a block of kThreads owns one tap's
// 64 x 64 (c, o) tile.
template <typename T>
__device__ __forceinline__ void dw_partial_fma(const T* __restrict__ x, const T* __restrict__ g,
                                               float* __restrict__ partial, int B, int H, int W,
                                               int C, int O, int slice_len) {
  __shared__ __align__(16) float xs[kPK][kBN];
  __shared__ __align__(16) float gs[kPK][kBN];
  const int o0 = blockIdx.x * kBN, c0 = blockIdx.y * kBN;
  const int tap = blockIdx.z % 9, s = blockIdx.z / 9;
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  const long long M = (long long)B * H * W;
  const long long m_lo = (long long)s * slice_len;
  const long long m_hi = m_lo + slice_len < M ? m_lo + slice_len : M;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int col = tid % kBN, row0 = tid / kBN;  // staging: 4 rows of kPK per thread
  const int hw = H * W;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long m0 = m_lo; m0 < m_hi; m0 += kPK) {
    __syncthreads();
#pragma unroll
    for (int r = row0; r < kPK; r += kThreads / kBN) {
      const long long m = m0 + r;
      float xv = 0.f, gv = 0.f;
      if (m < m_hi) {
        const int b = (int)(m / hw), rem = (int)(m % hw);
        const int ih = rem / W + dh, iw = rem % W + dw;
        if (c0 + col < C && ih >= 0 && ih < H && iw >= 0 && iw < W)
          xv = to_f(x[(((long long)b * H + ih) * W + iw) * C + c0 + col]);
        if (o0 + col < O) gv = to_f(g[m * O + o0 + col]);
      }
      xs[r][col] = xv;
      gs[r][col] = gv;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPK; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[p][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[p][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
  }
  float* out = partial + ((long long)s * 9 + tap) * C * O;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < O) out[(long long)c * O + o] = acc[i][j];
    }
  }
}

// bf16: a block of kMmaThreads owns a 64 x 64 (c, o) tile of the 3 taps of
// one row dh; warp w owns channels c0 + 32 (w / 2) ... + 31 and outputs
// o0 + 32 (w % 2) ... + 31. Step i stages pixels m0 = m_lo + kKC i ...: the
// x window (row r is pixel m0 + (dh - 1) W - 1 + r, r < kKC + 2; row kZeroRow
// stays zero) and the g rows, in flight while step i is computed, and each
// pixel's mask (bit dw: tap dw reads inside the image), written after step
// i's products.
__device__ __forceinline__ void dw_partial_mma(unsigned char* smem,
                                               const __nv_bfloat16* __restrict__ x,
                                               const __nv_bfloat16* __restrict__ g,
                                               float* __restrict__ partial, int B, int H, int W,
                                               int C, int O, int slice_len, bool vec_x,
                                               bool vec_g) {
  using T = __nv_bfloat16;
  T* Xs = reinterpret_cast<T*>(smem);                     // 2 x kXRows x kLd
  T* Gs = Xs + 2 * kXRows * kLd;                          // 2 x kKC x kLd
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Gs + 2 * kKC * kLd);  // 2 x kKC
  const int o0 = blockIdx.x * kBN, c0 = blockIdx.y * kBN;
  const int dh = blockIdx.z % 3, s = blockIdx.z / 3;
  const long long M = (long long)B * H * W;
  const long long m_lo = (long long)s * slice_len;
  const long long m_hi = m_lo + slice_len < M ? m_lo + slice_len : M;
  const int steps = (int)((m_hi - m_lo + kKC - 1) / kKC);
  const int nc = C - c0 < kBN ? C - c0 : kBN, no = O - o0 < kBN ? O - o0 : kBN;
  const long long shift = (long long)(dh - 1) * W - 1;  // x window row 0 is pixel m0 + shift
  const int tid = threadIdx.x;

  // zero both buffers once: the zero row, and the columns past nc and no
  // that the element-wise staging never writes
  for (int e = tid; e < (int)(2 * (kXRows + kKC) * kLd * sizeof(T) / 16); e += kMmaThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto prefetch = [&](int i) {
    const long long m0 = m_lo + (long long)i * kKC;
    T* xd = Xs + (i % 2) * kXRows * kLd;
    T* gd = Gs + (i % 2) * kKC * kLd;
    if (vec_x) {  // every 16-byte chunk of a row; those past C zero-filled
      for (int e = tid; e < (kKC + 2) * kRowChunks; e += kMmaThreads) {
        const int r = e / kRowChunks, c = (e % kRowChunks) * 8;
        const long long f = m0 + shift + r;
        const bool ok = f >= 0 && f < M && c < nc;
        lct::cp_async16(xd + r * kLd + c, ok ? x + f * C + c0 + c : x, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < (kKC + 2) * nc; e += kMmaThreads) {
        const int r = e / nc, c = e % nc;
        const long long f = m0 + shift + r;
        xd[r * kLd + c] = f >= 0 && f < M ? x[f * C + c0 + c] : __float2bfloat16_rn(0.f);
      }
    }
    if (vec_g) {
      for (int e = tid; e < kKC * kRowChunks; e += kMmaThreads) {
        const int r = e / kRowChunks, c = (e % kRowChunks) * 8;
        const bool ok = m0 + r < m_hi && c < no;
        lct::cp_async16(gd + r * kLd + c, ok ? g + (m0 + r) * O + o0 + c : g, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kKC * no; e += kMmaThreads) {
        const int r = e / no, c = e % no;
        gd[r * kLd + c] = m0 + r < m_hi ? g[(m0 + r) * O + o0 + c] : __float2bfloat16_rn(0.f);
      }
    }
  };
  // each pixel's mask of step i, in 32-bit arithmetic from the slice's first
  // pixel (w_lo, h_lo): bit dw set where tap dw reads inside the image
  const long long row_lo = m_lo / W;
  const int w_lo = (int)(m_lo - row_lo * W), h_lo = (int)(row_lo % H);
  auto write_masks = [&](int i) {
    for (int p = tid; p < kKC; p += kMmaThreads) {
      const int off = i * kKC + p;  // < slice_len
      int mask = 0;
      if (m_lo + off < m_hi) {
        const int q = w_lo + off, rows = q / W, w = q - rows * W;
        const int h = (h_lo + rows) % H + dh - 1;
        if (h >= 0 && h < H) mask = (w > 0 ? 1 : 0) | 2 | (w + 1 < W ? 4 : 0);
      }
      Ms[(i % 2) * kKC + p] = (uint8_t)mask;
    }
  };

  const int warp = tid / 32, lane = tid % 32, wc = warp / 2, wo = warp % 2;
  float acc[3][2][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][mt][nt][e] = 0.f;

  prefetch(0);
  write_masks(0);
  lct::cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) prefetch(i + 1);
    lct::cp_async_commit();
    lct::cp_async_wait<1>();
    __syncthreads();  // step i visible to every warp
    const T* xb = Xs + (i % 2) * kXRows * kLd;
    const T* gb = Gs + (i % 2) * kKC * kLd;
    const uint8_t* mb = Ms + (i % 2) * kKC;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      // B (g, pixels x o) through ldmatrix.trans: bf[np] holds the k halves
      // of output tiles 2 np and 2 np + 1
      uint32_t bf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        lct::ldmatrix_x4_trans(
            bf[np], gb + (ks * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLd + wo * 32 + np * 16 +
                        (lane / 16) * 8);
      // A (x_tap^T, c x pixels): this lane addresses pixel p's row, shifted
      // by the tap, or the zero row
      const int p = ks * 16 + (lane % 8) + (lane / 16) * 8;
      const int mask = mb[p];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const T* row = xb + ((mask >> t) & 1 ? p + t : kZeroRow) * kLd + wc * 32 +
                       ((lane / 8) % 2) * 8;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          lct::ldmatrix_x4_trans(a, row + mt * 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            lct::mma_bf16(acc[t][mt][nt], a, bf[nt / 2][(nt % 2) * 2],
                          bf[nt / 2][(nt % 2) * 2 + 1]);
        }
      }
    }
    // step i + 1's masks, while other warps still multiply
    if (i + 1 < steps) write_masks(i + 1);
    __syncthreads();  // step i + 1's masks written, buffers i % 2 read in full
  }

  const int gq = lane / 4, tq = lane % 4;
  float* out = partial + ((long long)s * 9 + dh * 3) * C * O;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + wc * 32 + mt * 16 + gq + (e / 2) * 8;
          const int o = o0 + wo * 32 + nt * 8 + 2 * tq + (e % 2);
          if (c < C && o < O) out[((long long)t * C + c) * O + o] = acc[t][mt][nt][e];
        }
}

// The partial sums of slice blockIdx.z / taps (f32: 9 taps, bf16: 3 rows of
// taps): the f32 FMA body or the bf16 tensor-core body.
template <typename T>
__global__ void __launch_bounds__(kIsF32<T> ? kThreads : kMmaThreads, kIsF32<T> ? 1 : 3)
conv3x3_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          float* __restrict__ partial, int B, int H, int W, int C, int O,
                          int slice_len, bool vec_x, bool vec_g) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  if constexpr (kIsF32<T>)
    dw_partial_fma<T>(x, g, partial, B, H, W, C, O, slice_len);
  else
    dw_partial_mma(dw_smem, x, g, partial, B, H, W, C, O, slice_len, vec_x, vec_g);
}

// dw[i] = partial[0, i] + partial[1, i] + ... in slice order.
__global__ void conv3x3_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                         long long n, int S) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += partial[(long long)s * n + i];
  dw[i] = sum;
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, void* y, int B, int H, int W, int C, int O,
                cudaStream_t stream) {
  const Tile tile = fwd_tile(B, H, W);
  const size_t smem = fwd_smem_bytes(tile);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tile.tiles_b * tile.tiles_h * tile.tiles_w, (O + kBN - 1) / kBN);
  conv3x3_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), B, H, W, C, O, tile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw(const void* x, const void* g, float* partial, float* out, int B, int H, int W,
               int C, int O, cudaStream_t stream) {
  const Slices sl = dw_slices(B, H, W, C, O);
  const int per_slice = kIsF32<T> ? 9 : 3;  // f32: one block per tap; bf16: per row of taps
  const size_t smem = kIsF32<T> ? 0 : kDwSmem;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_dw_partial_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((O + kBN - 1) / kBN, (C + kBN - 1) / kBN, per_slice * sl.S);
  // 16-byte cp.async copies of whole rows: aligned pointers, rows of whole chunks
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && C % 8 == 0;
  const bool vec_g = reinterpret_cast<uintptr_t>(g) % 16 == 0 && O % 8 == 0;
  conv3x3_dw_partial_kernel<T><<<grid, kIsF32<T> ? kThreads : kMmaThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, B, H, W, C, O, sl.len, vec_x,
      vec_g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 9LL * C * O;
  conv3x3_dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, n, sl.S);
  return cudaGetLastError();
}

// Any image size: the forward tile is at most kBM pixels and its staged rows
// do not grow with H * W; the weight gradient's slices cover M whatever it is.
inline bool shape_ok(int B, int H, int W, int C, int O) {
  return B > 0 && H > 0 && W > 0 && C > 0 && O > 0;
}

}  // namespace lctconv

// y (B, H, W, O) = conv3x3(x (B, H, W, C), taps w (9, C, O)), in x's dtype.
extern "C" int lct_conv3x3_fwd(const void* x, const void* w, void* y, int B, int H, int W, int C,
                               int O, int dtype, void* stream) {
  if (!lctconv::shape_ok(B, H, W, C, O)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)lctconv::fwd<float>(x, w, y, B, H, W, C, O, s);
  if (dtype == 1) return (int)lctconv::fwd<__nv_bfloat16>(x, w, y, B, H, W, C, O, s);
  return (int)cudaErrorInvalidValue;
}

// The number of slices of M the weight gradient sums over: partial holds
// slices * 9 * C * O floats.
extern "C" int lct_conv3x3_dw_slices(int B, int H, int W, int C, int O) {
  return lctconv::dw_slices(B, H, W, C, O).S;
}

// dw (9, C, O) f32 = sum over pixels of x shifted by each tap times g (B, H, W, O).
extern "C" int lct_conv3x3_dw(const void* x, const void* g, void* partial, void* dw, int B, int H,
                              int W, int C, int O, int dtype, void* stream) {
  if (!lctconv::shape_ok(B, H, W, C, O)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  if (dtype == 0) return (int)lctconv::dw<float>(x, g, p, out, B, H, W, C, O, s);
  if (dtype == 1) return (int)lctconv::dw<__nv_bfloat16>(x, g, p, out, B, H, W, C, O, s);
  return (int)cudaErrorInvalidValue;
}
