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
// This first version does its products on the CUDA cores in f32 FMA (67
// TFLOP/s at most), fed from shared memory, so it is bound by those FMAs and
// the shared-memory reads that feed them. What the design does about it:
//   * forward: a block owns 64 output pixels (a tile of rows of one image, or
//     several whole small images) by 64 output channels. For each chunk of 16
//     input channels it stages the input rows the tile needs, with the
//     1-pixel zero halo, in shared memory (f32) once, and the chunk's taps of
//     all 9 positions; the 9 tap-shifted products then read the same staged
//     rows, so an input element is read from device memory once per chunk and
//     not 9 times. Each thread keeps a 4 pixel x 4 channel tile of f32 sums in
//     registers (5 shared-memory reads for 16 FMAs).
//   * weight gradient: dw[tap] = x_tap^T . g is a reduction over M. A block
//     owns a 64 x 64 (c, o) tile of one tap over a fixed slice of M and writes
//     f32 partial sums; a second kernel adds the slices in a fixed order. No
//     atomics: the result does not depend on the schedule.
// wgmma on bf16 tiles fed by TMA is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lctconv {

constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 tile of sums
constexpr int kBM = 64;        // output pixels per forward block
constexpr int kBN = 64;        // output channels per block
constexpr int kCK = 16;        // input channels per staged chunk
constexpr int kPK = 16;        // pixels per weight-gradient step
constexpr int kTargetBlocks = 4 * 132;  // about four blocks an SM

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

// The weight-gradient split: S slices of M, each slice_len pixels (a multiple
// of kPK), so that the tiles times the slices give about kTargetBlocks blocks
// and no slice is shorter than 512 pixels.
struct Slices {
  int S, len;
};

inline Slices dw_slices(int B, int H, int W, int C, int O) {
  const long long M = (long long)B * H * W;
  const long long tiles = 9LL * ((C + kBN - 1) / kBN) * ((O + kBN - 1) / kBN);
  long long s = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = (M + 511) / 512;
  if (s > most) s = most;
  if (s < 1) s = 1;
  long long len = (M + s - 1) / s;
  len = (len + kPK - 1) / kPK * kPK;
  Slices out;
  out.len = (int)len;
  out.S = (int)((M + len - 1) / len);
  return out;
}

// partial[s, tap, c, o] = sum over the pixels m of slice s of
// x[m shifted by tap, c] * g[m, o]; a block owns one tap's 64 x 64 (c, o) tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          float* __restrict__ partial, int B, int H, int W, int C, int O,
                          int slice_len) {
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
  dim3 grid((O + kBN - 1) / kBN, (C + kBN - 1) / kBN, 9 * sl.S);
  conv3x3_dw_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, B, H, W, C, O, sl.len);
  cudaError_t err = cudaGetLastError();
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
