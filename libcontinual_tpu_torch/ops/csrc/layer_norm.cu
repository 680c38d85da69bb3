// LayerNorm over the last axis of (rows, D) activations, forward and
// backward, for Hopper (sm_90a), with a plain C interface.
//
// Replaces no TPU kernel. The JAX package leaves LayerNorm to XLA (flax
// LayerNorm(dtype=...)), which fuses the f32 casts around it into the
// normalisation. Eager PyTorch does not: the port's composition
//   F.layer_norm(x.float(), (D,), w.float(), b.float(), eps).to(dtype)
// launched an upcast, an f32 LayerNorm and a downcast (and two parameter
// casts), moving 20 bytes for each bf16 element forward and 24 backward. These
// kernels keep its rounding points and move 4 forward (6 with an f32 output)
// and 6 backward (8 with an f32 output gradient):
//   lct_ln_fwd   ln_fwd_kernel          y = (x - mean) * rstd * w + b
//   lct_ln_bwd   ln_bwd_kernel          dx, and where asked a row of dw and db
//                                       partial sums a block
//                + ln_bwd_reduce_kernel those rows added in a fixed order
//
// Rounding points. x (bf16 or f32) converts to f32 exactly; mean, the
// variance about it, rstd = 1 / sqrt(var + eps) and y are f32, and y is
// rounded once to its own dtype (bf16 or f32). Backward: the output gradient
// g (in y's dtype) converts exactly; xhat = (x - mean) * rstd, wdy = g * w,
// and the row means of wdy and wdy * xhat are f32; dx = rstd * (wdy - xhat *
// mean(wdy * xhat) - mean(wdy)) is rounded once to x's dtype; dw = sum of g *
// xhat and db = sum of g over the rows are f32, rounded once to the
// parameters' dtype. w and b are read in their own dtype (bf16 or f32). Only
// the order of the f32 sums differs from the plain versions (ops/layer_norm.py).
//
// What bounds them on an H100: bytes. There is no reuse: every element is
// read and written once, with a few f32 operations each. At L2P's prompted
// pass (B 128, S 222, D 768, bf16) the forward moves 87 MB (26 us at 3.35
// TB/s) and the backward 131 MB (39 us). What the design does about it:
//   * one warp a row: lane l holds the row's 16-byte chunks l, l + 32, ...
//     (8 bf16 or 4 f32 values each; D 768 in bf16 is 3 chunks a lane) in f32
//     registers, so x is read from device memory once; the mean, then the
//     variance about it (no E[x^2] - mean^2 cancellation), are two sums over
//     registers and xor shuffles, with no shared memory and no block barrier
//     inside a row;
//   * every load and store of the activations is 16 bytes a lane (8 with an
//     f32 input and a bf16 output), neighbouring lanes on neighbouring chunks;
//   * w and b are staged once a block in shared memory as f32, in a layout in
//     which a warp's 16-byte reads of its chunks hit every bank once; a block
//     of 8 warps walks rows with the grid's stride, and the grid is at most 8
//     blocks an SM, so staging is paid once a block, not once a row, and each
//     SM keeps enough rows in flight to cover the memory latency;
//   * the forward writes mean and rstd (8 bytes a row) only when a backward
//     will read them;
//   * dw and db: each warp sums its columns over its rows in registers, the
//     block's warps add theirs in warp order in shared memory, and each block
//     writes one row of partial sums; ln_bwd_reduce_kernel adds the rows in a
//     fixed order. No atomics: two calls give the same bits.
//
// Layouts: x, y, g and dx (rows, D), contiguous, 16-byte aligned; w, b, dw and
// db (D); mean and rstd (rows) f32. dtype: 0 = float32, 1 = bfloat16. D a
// multiple of 8 from 8 to 4096. Each function returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for a shape or dtype the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace lct {

constexpr int kLnWarps = 8;        // rows in flight a block: one warp a row
constexpr int kLnBlocksPerSM = 8;  // the grid's cap, in blocks an SM
constexpr int kLnMaxDim = 4096;

// N values of T, loaded and stored as whole 8-, 16- or 32-byte vectors.
template <typename T, int N>
struct Pack {
  static constexpr int kWords = N * (int)sizeof(T) / 4;  // 2, 4 or 8
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWords == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    }
  }

  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kWords == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i)
        reinterpret_cast<uint4*>(p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                                    w[4 * i + 3]);
    }
  }

  // value i, exactly, in f32
  __device__ __forceinline__ float get(int i) const {
    if constexpr (std::is_same<T, float>::value) {
      return __uint_as_float(w[i]);
    } else {
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
    }
  }

  // f[0..N) rounded to T (bf16: to nearest, ties to even)
  __device__ __forceinline__ void set(const float* f) {
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = __float_as_uint(f[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
               ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A parameter (bf16 when wdt is 1, else f32) at column d, in f32.
__device__ __forceinline__ float param_at(const void* p, int wdt, int d) {
  return wdt == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[d])
                  : static_cast<const float*>(p)[d];
}

// Where column d = c * N + k of a staged parameter sits in shared memory: the
// 4-value quarters k / 4 of all chunks c lie together, so the float4 reads of
// one quarter by a warp's lanes (neighbouring chunks) are neighbouring.
template <int N>
__device__ __forceinline__ int smem_index(int d, int chunks) {
  const int c = d / N, k = d % N;
  return ((k >> 2) * chunks + c) * 4 + (k & 3);
}

template <int N>
__device__ __forceinline__ void smem_chunk(const float* s, int c, int chunks, float* out) {
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    const float4 v = reinterpret_cast<const float4*>(s)[h * chunks + c];
    out[4 * h] = v.x;
    out[4 * h + 1] = v.y;
    out[4 * h + 2] = v.z;
    out[4 * h + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void smem_add_chunk(float* s, int c, int chunks, const float* v,
                                               bool first) {
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    float4* p = reinterpret_cast<float4*>(s) + h * chunks + c;
    float4 t = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *p;
    t.x += v[4 * h];
    t.y += v[4 * h + 1];
    t.z += v[4 * h + 2];
    t.w += v[4 * h + 3];
    *p = t;
  }
}

// CPL: the most 16-byte chunks a lane holds (ceil(D / N / 32), rounded up to
// 1, 2, 3, 4, 8, 16 or 32).
template <typename TX, typename TY, int CPL>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_fwd_kernel(const TX* __restrict__ x, const void* __restrict__ w, const void* __restrict__ b,
              int wdt, TY* __restrict__ y, float* __restrict__ mean_out,
              float* __restrict__ rstd_out, int rows, int D, float eps) {
  constexpr int N = 16 / (int)sizeof(TX);
  extern __shared__ float4 ln_smem[];
  float* s_w = reinterpret_cast<float*>(ln_smem);
  float* s_b = s_w + D;
  const int chunks = D / N;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const int i = smem_index<N>(d, chunks);
    s_w[i] = param_at(w, wdt, d);
    s_b[i] = param_at(b, wdt, d);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float dim = (float)D;
  for (int64_t row = (int64_t)blockIdx.x * kLnWarps + (threadIdx.x >> 5); row < rows;
       row += (int64_t)gridDim.x * kLnWarps) {
    const TX* xr = x + row * D;
    float v[CPL][N];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = j * 32 + lane;
      if (c < chunks) {
        Pack<TX, N> p;
        p.load(xr + c * N);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          v[j][n] = p.get(n);
          sum += v[j][n];
        }
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) v[j][n] = 0.f;
      }
    }
    const float mean = warp_sum(sum) / dim;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (j * 32 + lane < chunks) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float t = v[j][n] - mean;
          sq += t * t;
        }
      }
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / dim + eps);
    TY* yr = y + row * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = j * 32 + lane;
      if (c < chunks) {
        float gw[N], gb[N], o[N];
        smem_chunk<N>(s_w, c, chunks, gw);
        smem_chunk<N>(s_b, c, chunks, gb);
#pragma unroll
        for (int n = 0; n < N; ++n) o[n] = (v[j][n] - mean) * rstd * gw[n] + gb[n];
        Pack<TY, N> q;
        q.set(o);
        q.store(yr + c * N);
      }
    }
    if (mean_out != nullptr && lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// PARAMS: also the block's row of dw and db partial sums, partial[blockIdx.x]
// = (dw[0..D), db[0..D)). dx may be null (x needs no gradient).
template <typename TX, typename TY, int CPL, bool PARAMS>
__global__ void __launch_bounds__(kLnWarps * 32)
ln_bwd_kernel(const TX* __restrict__ x, const TY* __restrict__ g, const void* __restrict__ w,
              int wdt, const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
              TX* __restrict__ dx, float* __restrict__ partial, int rows, int D) {
  constexpr int N = 16 / (int)sizeof(TX);
  constexpr int PCPL = PARAMS ? CPL : 1;
  extern __shared__ float4 ln_smem[];
  float* s_w = reinterpret_cast<float*>(ln_smem);
  const int chunks = D / N;
  for (int d = threadIdx.x; d < D; d += blockDim.x) s_w[smem_index<N>(d, chunks)] = param_at(w, wdt, d);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float dim = (float)D;
  float pw[PCPL][N], pb[PCPL][N];
#pragma unroll
  for (int j = 0; j < PCPL; ++j) {
#pragma unroll
    for (int n = 0; n < N; ++n) pw[j][n] = pb[j][n] = 0.f;
  }
  for (int64_t row = (int64_t)blockIdx.x * kLnWarps + warp; row < rows;
       row += (int64_t)gridDim.x * kLnWarps) {
    const TX* xr = x + row * D;
    const TY* gr = g + row * D;
    const float mean = mean_in[row], rstd = rstd_in[row];
    float xh[CPL][N], wdy[CPL][N];
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = j * 32 + lane;
      if (c < chunks) {
        Pack<TX, N> px;
        Pack<TY, N> pg;
        px.load(xr + c * N);
        pg.load(gr + c * N);
        float gw[N];
        smem_chunk<N>(s_w, c, chunks, gw);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float gv = pg.get(n);
          xh[j][n] = (px.get(n) - mean) * rstd;
          wdy[j][n] = gv * gw[n];
          a += wdy[j][n] * xh[j][n];
          s += wdy[j][n];
          if constexpr (PARAMS) {
            pw[j][n] += gv * xh[j][n];
            pb[j][n] += gv;
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) xh[j][n] = wdy[j][n] = 0.f;
      }
    }
    if (dx == nullptr) continue;
    a = warp_sum(a) / dim;
    s = warp_sum(s) / dim;
    TX* dr = dx + row * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = j * 32 + lane;
      if (c < chunks) {
        float o[N];
#pragma unroll
        for (int n = 0; n < N; ++n) o[n] = rstd * (wdy[j][n] - xh[j][n] * a - s);
        Pack<TX, N> q;
        q.set(o);
        q.store(dr + c * N);
      }
    }
  }
  if constexpr (PARAMS) {
    // the block's warps add their sums in warp order: (dw, db) in the staged layout
    float* s_dw = s_w + D;
    float* s_db = s_dw + D;
    for (int k = 0; k < kLnWarps; ++k) {
      if (warp == k) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = j * 32 + lane;
          if (c < chunks) {
            smem_add_chunk<N>(s_dw, c, chunks, pw[j], k == 0);
            smem_add_chunk<N>(s_db, c, chunks, pb[j], k == 0);
          }
        }
      }
      __syncthreads();
    }
    float* out = partial + (int64_t)blockIdx.x * 2 * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const int i = smem_index<N>(d, chunks);
      out[d] = s_dw[i];
      out[D + d] = s_db[i];
    }
  }
}

// dw and db from the backward's rows of partial sums: column by column, each
// of 8 thread rows adds every 8th row of partials in order, then thread row 0
// adds the 8 sums in order.
template <typename TW>
__global__ void __launch_bounds__(256)
ln_bwd_reduce_kernel(const float* __restrict__ partial, int parts, int D, TW* __restrict__ dw,
                     TW* __restrict__ db) {
  __shared__ float s[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;  // of the 2D columns (dw, db)
  float acc = 0.f;
  if (col < 2 * D) {
    for (int p = threadIdx.y; p < parts; p += 8) acc += partial[(int64_t)p * 2 * D + col];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * D) {
    float t = s[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < 8; ++k) t += s[k][threadIdx.x];
    TW* out = col < D ? dw + col : db + (col - D);
    if constexpr (std::is_same<TW, float>::value) {
      *out = t;
    } else {
      *out = __float2bfloat16_rn(t);
    }
  }
}

// ------------------------------------------------------------------ host side

inline int ln_sms() {
  static int sms[64] = {0};  // per device; a race writes the same value
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 1;
  }
  return sms[dev];
}

// Blocks of a launch over `rows` rows: one row a warp, at most kLnBlocksPerSM
// blocks an SM (the warps then walk the rows with the grid's stride).
inline int ln_grid(int rows) {
  const int64_t need = ((int64_t)rows + kLnWarps - 1) / kLnWarps;
  const int64_t cap = (int64_t)ln_sms() * kLnBlocksPerSM;
  return (int)(need < cap ? need : cap);
}

inline bool ln_shape_ok(int rows, int D) {
  return rows >= 1 && D >= 8 && D <= kLnMaxDim && D % 8 == 0;
}

// The chunks a lane holds, as the instantiated CPL: 1, 2, 3, 4, 8, 16, 32.
inline int ln_cpl(int D, int bytes) {
  const int chunks = D * bytes / 16;
  const int cpl = (chunks + 31) / 32;
  return cpl <= 4 ? cpl : cpl <= 8 ? 8 : cpl <= 16 ? 16 : 32;
}

template <typename TX, typename TY, int CPL>
cudaError_t ln_fwd_launch(const void* x, const void* w, const void* b, int wdt, void* y,
                          float* mean, float* rstd, int rows, int D, float eps, cudaStream_t s) {
  const size_t smem = 2 * (size_t)D * sizeof(float);
  ln_fwd_kernel<TX, TY, CPL><<<ln_grid(rows), kLnWarps * 32, smem, s>>>(
      static_cast<const TX*>(x), w, b, wdt, static_cast<TY*>(y), mean, rstd, rows, D, eps);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t ln_fwd(const void* x, const void* w, const void* b, int wdt, void* y, float* mean,
                   float* rstd, int rows, int D, float eps, cudaStream_t s) {
  switch (ln_cpl(D, sizeof(TX))) {
    case 1: return ln_fwd_launch<TX, TY, 1>(x, w, b, wdt, y, mean, rstd, rows, D, eps, s);
    case 2: return ln_fwd_launch<TX, TY, 2>(x, w, b, wdt, y, mean, rstd, rows, D, eps, s);
    case 3: return ln_fwd_launch<TX, TY, 3>(x, w, b, wdt, y, mean, rstd, rows, D, eps, s);
    case 4: return ln_fwd_launch<TX, TY, 4>(x, w, b, wdt, y, mean, rstd, rows, D, eps, s);
    case 8: return ln_fwd_launch<TX, TY, 8>(x, w, b, wdt, y, mean, rstd, rows, D, eps, s);
    case 16: return ln_fwd_launch<TX, TY, 16>(x, w, b, wdt, y, mean, rstd, rows, D, eps, s);
    default:
      if constexpr (sizeof(TX) == 4)  // bf16 rows of at most 4096 hold at most 16 chunks a lane
        return ln_fwd_launch<TX, TY, 32>(x, w, b, wdt, y, mean, rstd, rows, D, eps, s);
      return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TY, int CPL>
cudaError_t ln_bwd_launch(const void* x, const void* g, const void* w, int wdt,
                          const float* mean, const float* rstd, void* dx, float* partial,
                          int rows, int D, cudaStream_t s) {
  const int grid = ln_grid(rows);
  if (partial == nullptr) {
    ln_bwd_kernel<TX, TY, CPL, false><<<grid, kLnWarps * 32, D * sizeof(float), s>>>(
        static_cast<const TX*>(x), static_cast<const TY*>(g), w, wdt, mean, rstd,
        static_cast<TX*>(dx), nullptr, rows, D);
  } else {
    ln_bwd_kernel<TX, TY, CPL, true><<<grid, kLnWarps * 32, 3 * D * sizeof(float), s>>>(
        static_cast<const TX*>(x), static_cast<const TY*>(g), w, wdt, mean, rstd,
        static_cast<TX*>(dx), partial, rows, D);
  }
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t ln_bwd(const void* x, const void* g, const void* w, int wdt, const float* mean,
                   const float* rstd, void* dx, float* partial, int rows, int D,
                   cudaStream_t s) {
  switch (ln_cpl(D, sizeof(TX))) {
    case 1: return ln_bwd_launch<TX, TY, 1>(x, g, w, wdt, mean, rstd, dx, partial, rows, D, s);
    case 2: return ln_bwd_launch<TX, TY, 2>(x, g, w, wdt, mean, rstd, dx, partial, rows, D, s);
    case 3: return ln_bwd_launch<TX, TY, 3>(x, g, w, wdt, mean, rstd, dx, partial, rows, D, s);
    case 4: return ln_bwd_launch<TX, TY, 4>(x, g, w, wdt, mean, rstd, dx, partial, rows, D, s);
    case 8: return ln_bwd_launch<TX, TY, 8>(x, g, w, wdt, mean, rstd, dx, partial, rows, D, s);
    case 16: return ln_bwd_launch<TX, TY, 16>(x, g, w, wdt, mean, rstd, dx, partial, rows, D, s);
    default:
      if constexpr (sizeof(TX) == 4)
        return ln_bwd_launch<TX, TY, 32>(x, g, w, wdt, mean, rstd, dx, partial, rows, D, s);
      return cudaErrorInvalidValue;
  }
}

}  // namespace lct

// The rows of f32 partial sums (each 2 * D floats) that lct_ln_bwd writes to
// `partial` when it sums dw and db over `rows` rows.
extern "C" int lct_ln_bwd_parts(int rows) { return rows >= 1 ? lct::ln_grid(rows) : 0; }

// y (rows, D) in ydt = LayerNorm of x (rows, D) in xdt with w and b (D) in
// wdt; mean and rstd (rows, f32) written when not null (both or neither).
extern "C" int lct_ln_fwd(const void* x, const void* w, const void* b, void* y, void* mean,
                          void* rstd, int rows, int D, int xdt, int ydt, int wdt, float eps,
                          void* stream) {
  if (!lct::ln_shape_ok(rows, D) || (mean == nullptr) != (rstd == nullptr) ||
      (unsigned)xdt > 1 || (unsigned)ydt > 1 || (unsigned)wdt > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (xdt == 1) {
    if (ydt == 1) return (int)lct::ln_fwd<__nv_bfloat16, __nv_bfloat16>(x, w, b, wdt, y, m, r, rows, D, eps, s);
    return (int)lct::ln_fwd<__nv_bfloat16, float>(x, w, b, wdt, y, m, r, rows, D, eps, s);
  }
  if (ydt == 1) return (int)lct::ln_fwd<float, __nv_bfloat16>(x, w, b, wdt, y, m, r, rows, D, eps, s);
  return (int)lct::ln_fwd<float, float>(x, w, b, wdt, y, m, r, rows, D, eps, s);
}

// dx (rows, D) in xdt (skipped when dx is null) from x (rows, D) in xdt, the
// output gradient g (rows, D) in gdt, w (D) in wdt and the forward's mean and
// rstd. With `partial` (lct_ln_bwd_parts(rows) * 2 * D f32 scratch), also dw
// and db (D) in wdt.
extern "C" int lct_ln_bwd(const void* x, const void* g, const void* w, const void* mean,
                          const void* rstd, void* dx, void* partial, void* dw, void* db,
                          int rows, int D, int xdt, int gdt, int wdt, void* stream) {
  if (!lct::ln_shape_ok(rows, D) || mean == nullptr || rstd == nullptr ||
      (partial != nullptr && (dw == nullptr || db == nullptr)) ||
      (dx == nullptr && partial == nullptr) || (unsigned)xdt > 1 || (unsigned)gdt > 1 ||
      (unsigned)wdt > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(partial);
  cudaError_t err;
  if (xdt == 1) {
    err = gdt == 1 ? lct::ln_bwd<__nv_bfloat16, __nv_bfloat16>(x, g, w, wdt, m, r, dx, p, rows, D, s)
                   : lct::ln_bwd<__nv_bfloat16, float>(x, g, w, wdt, m, r, dx, p, rows, D, s);
  } else {
    err = gdt == 1 ? lct::ln_bwd<float, __nv_bfloat16>(x, g, w, wdt, m, r, dx, p, rows, D, s)
                   : lct::ln_bwd<float, float>(x, g, w, wdt, m, r, dx, p, rows, D, s);
  }
  if (err != cudaSuccess || p == nullptr) return (int)err;
  const dim3 block(32, 8);
  const int grid = (2 * D + 31) / 32;
  const int parts = lct::ln_grid(rows);
  if (wdt == 1) {
    lct::ln_bwd_reduce_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        p, parts, D, static_cast<__nv_bfloat16*>(dw), static_cast<__nv_bfloat16*>(db));
  } else {
    lct::ln_bwd_reduce_kernel<float><<<grid, block, 0, s>>>(p, parts, D, static_cast<float*>(dw),
                                                            static_cast<float*>(db));
  }
  return (int)cudaGetLastError();
}
