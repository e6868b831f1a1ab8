// Shared by fusedconv_pw.cu (1x1 convs, kTaps = 1) and fusedconv_c3.cu (3x3
// stride-1 convs, kTaps = 9): the three kernels the fused bottleneck
// convolutions are made of in float32, as templates over the storage type T
// (instantiated for float; the rounding helpers round_to, prologue_pre and
// out_cotangent also serve __nv_bfloat16 in the tensor-core kernels) and the
// number of taps.
//
//   rows_kernel   one 64 x 64 tile of an (n, C) output whose rows are the
//                 activation's rows (pixels). Forward: y = z @ w with
//                 z = relu(x*a + b) made on the load, and the tile's column
//                 sums of y and y^2. Backward: dz = g @ w^T with
//                 g = dy + ds + 2 dq y made on the load, then the prologue's
//                 backward in the epilogue (dx, and the tile's column sums for
//                 da and db).
//   wgrad_kernel  one 64 x 64 tile of dw[tap] = z_shift(tap)^T g over one
//                 split of the rows, z and g both made on the load.
//   reduce_partials  adds the per-block partial sums in a fixed order.
//
// The TPU kernels (corrifnet_tpu/ops/fusedconv.py) add s, q, da, db and dw
// into one resident block over a sequential grid and keep the whole weight in
// fast memory. Here blocks run in no order and a block has 227 KB at most, so
// the products are tiled over rows, input and output channels, every sum
// across blocks goes through a scratch buffer of partial sums, and
// reduce_partials adds them in index order: no atomics, the same bits on
// every run. The scratch costs 2 * ceil(n/64) * C floats for the column sums
// and splits * taps * ci * co floats for dw.
//
// A 3x3 conv is the same product with nine taps: for tap (u, v) row p reads
// the row of pixel p + (u-1, v-1) of its image, or 0 outside it -- the
// padding is applied to z, after the prologue, never to x. The backward reads
// g at p - (u-1, v-1).
//
// Products are f32 FMAs on the CUDA cores with f32 accumulation (a 4 x 4
// register block per thread over 16-deep shared tiles). They run here for
// float32 only: the bfloat16 forward and backward are the tensor-core
// kernels of fusedconv_wgmma.cuh and fusedconv_wgmma_bwd.cuh, which take
// prologue_pre and out_cotangent from here. Rounding points are those of
// the TPU kernels: see round_to's callers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace corrifnet_fc {

constexpr int kTile = 64;        // rows and columns of a block's output tile
constexpr int kDepth = 16;       // contraction depth of one shared tile
constexpr int kThreads = 256;    // 16 x 16 threads, each a 4 x 4 register block
constexpr int kStride = kTile + 4;  // shared row stride: 16-byte aligned rows,
                                    // 2-way conflicts at most on transposed stores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The value a tensor of type T would hold.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// pre = x*a + b, the multiply and the add each rounded to T and never
// contracted into one fma; a and b are already rounded to T.
template <typename T>
__device__ __forceinline__ float prologue_pre(float x, float a, float b) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x, a)), b));
}

// g = dy + ds + (2 dq) y in f32, rounded to T.
template <typename T>
__device__ __forceinline__ float out_cotangent(float dy, float y, float ds, float dq2) {
  return round_to<T>(__fadd_rn(__fadd_rn(dy, ds), __fmul_rn(dq2, y)));
}

struct Args {
  const void* x;    // (n, ci) activations
  const void* w;    // (taps, ci, co) weights
  const float* a;   // (ci,) prologue scale, or null
  const float* b;   // (ci,) prologue shift, or null
  const void* y;    // (n, co) forward output (backward input)
  const void* dy;   // (n, co)
  const float* ds;  // (co,)
  const float* dq;  // (co,)
  void* out;        // rows_kernel: y (n, co) forward, dx (n, ci) backward
  float* part;      // rows_kernel: (row blocks, 2, columns); wgrad: (splits, taps, ci, co)
  int n, ci, co;    // rows (images * h * wd), input and output channels
  int h, wd;        // image height and width (taps = 9)
  int chunk;        // wgrad: rows per split
};

// acc += As^T Bs over one shared tile: rows ty*4.., columns tx*4..
__device__ __forceinline__ void tile_fma(const float (*as)[kStride],
                                         const float (*bs)[kStride], float acc[4][4],
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// kBwd false: out = y = z @ w, column sums of y and y^2 when kSums.
// kBwd true:  out = dx from dz = g @ w^T, column sums for da and db when kPro.
template <typename T, int kTaps, bool kBwd, bool kPro, bool kSums>
__global__ void __launch_bounds__(kThreads) rows_kernel(Args p) {
  __shared__ __align__(16) float as[kDepth][kStride];
  __shared__ __align__(16) float bs[kDepth][kStride];
  __shared__ float red[2][16][kTile];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * kTile, col0 = blockIdx.y * kTile;
  const int kc = kBwd ? p.co : p.ci;    // channels contracted per tap
  const int nout = kBwd ? p.ci : p.co;  // columns of the output
  const T* src = static_cast<const T*>(kBwd ? p.dy : p.x);
  const T* yv = static_cast<const T*>(p.y);
  const T* wv = static_cast<const T*>(p.w);

  // the A loader: this thread fills contraction index lk of rows lr + 16 j
  const int lk = tid & 15, lr = tid >> 4;
  int ah[4], aw[4];
  if (kTaps > 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rem = (row0 + lr + 16 * j) % (p.h * p.wd);
      ah[j] = rem / p.wd;
      aw[j] = rem % p.wd;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kTaps; ++t) {
    // the pixel this tap reads, relative to the output pixel
    const int du = kTaps == 1 ? 0 : (kBwd ? 1 - t / 3 : t / 3 - 1);
    const int dv = kTaps == 1 ? 0 : (kBwd ? 1 - t % 3 : t % 3 - 1);
    for (int k0 = 0; k0 < kc; k0 += kDepth) {
      const int k = k0 + lk;
      float c0 = 0.f, c1 = 0.f;  // this k's (a, b) forward, (ds, 2 dq) backward
      if (k < kc) {
        if (kBwd) {
          c0 = p.ds[k];
          c1 = 2.f * p.dq[k];
        } else if (kPro) {
          c0 = round_to<T>(p.a[k]);
          c1 = round_to<T>(p.b[k]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row0 + lr + 16 * j;
        bool live = r < p.n && k < kc;
        if (kTaps > 1)
          live = live && (unsigned)(ah[j] + du) < (unsigned)p.h &&
                 (unsigned)(aw[j] + dv) < (unsigned)p.wd;
        float v = 0.f;  // rows past n, channels past kc and the padding are 0
        if (live) {
          const size_t e = (size_t)(r + du * p.wd + dv) * kc + k;
          if (kBwd) {
            v = out_cotangent<T>(to_f32(src[e]), to_f32(yv[e]), c0, c1);
          } else {
            v = to_f32(src[e]);
            if (kPro) v = fmaxf(prologue_pre<T>(v, c0, c1), 0.f);
          }
        }
        as[lk][lr + 16 * j] = v;
      }
      if (kBwd) {
        // B[k = o][c] = w[t][c][o]: contiguous along o
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = col0 + lr + 16 * j;
          bs[lk][lr + 16 * j] = (k < kc && c < nout)
              ? to_f32(wv[((size_t)t * p.ci + c) * p.co + k]) : 0.f;
        }
      } else {
        // B[k = c][o] = w[t][c][o]: contiguous along o
        const int bc = tid & 63, bk = tid >> 6;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = bk + 4 * j;
          bs[kk][bc] = (k0 + kk < kc && col0 + bc < nout)
              ? to_f32(wv[((size_t)t * p.ci + k0 + kk) * p.co + col0 + bc]) : 0.f;
        }
      }
      __syncthreads();
      tile_fma(as, bs, acc, ty, tx);
      __syncthreads();
    }
  }

  // epilogue: this thread holds rows row0 + ty*4 + i, columns col0 + tx*4 + j
  T* out = static_cast<T*>(p.out);
  float sum0[4] = {0.f, 0.f, 0.f, 0.f}, sum1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + tx * 4 + j;
    float ca = 0.f, cb = 0.f;
    if (kBwd && kPro && c < nout) {
      ca = round_to<T>(p.a[c]);
      cb = round_to<T>(p.b[c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r >= p.n || c >= nout) continue;
      const size_t e = (size_t)r * nout + c;
      if (!kBwd) {
        // the statistics see the f32 accumulator, y its rounding
        const float v = acc[i][j];
        out[e] = from_f32<T>(v);
        sum0[j] += v;
        sum1[j] += v * v;
      } else if (kPro) {
        const float dz = round_to<T>(acc[i][j]);  // rounded before the mask
        const float xv = to_f32(static_cast<const T*>(p.x)[e]);
        const float dpre = prologue_pre<T>(xv, ca, cb) > 0.f ? dz : 0.f;
        out[e] = from_f32<T>(__fmul_rn(dpre, ca));
        sum0[j] += dpre * xv;  // da
        sum1[j] += dpre;       // db
      } else {
        out[e] = from_f32<T>(acc[i][j]);
      }
    }
  }
  if (kSums) {
    // the tile's column sums: over this thread's rows above, then over the 16
    // row groups in order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx * 4 + j] = sum0[j];
      red[1][ty][tx * 4 + j] = sum1[j];
    }
    __syncthreads();
    if (tid < 2 * kTile) {
      const int which = tid >> 6, c = tid & 63;
      float total = red[which][0][c];
#pragma unroll
      for (int g = 1; g < 16; ++g) total += red[which][g][c];
      if (col0 + c < nout)
        p.part[((size_t)blockIdx.x * 2 + which) * nout + col0 + c] = total;
    }
  }
}

// part[split][tap][c][o] = sum over the split's rows of z_shift(tap)[r][c] * g[r][o].
// grid: (ci tiles, co tiles * kTaps, splits).
template <typename T, int kTaps, bool kPro>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(Args p) {
  __shared__ __align__(16) float as[kDepth][kStride];
  __shared__ __align__(16) float bs[kDepth][kStride];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t = blockIdx.y % kTaps;
  const int c0 = blockIdx.x * kTile, o0 = (blockIdx.y / kTaps) * kTile;
  const int du = kTaps == 1 ? 0 : t / 3 - 1, dv = kTaps == 1 ? 0 : t % 3 - 1;
  const int r_begin = blockIdx.z * p.chunk;
  const int r_end = min(p.n, r_begin + p.chunk);
  const T* xv = static_cast<const T*>(p.x);
  const T* yv = static_cast<const T*>(p.y);
  const T* dyv = static_cast<const T*>(p.dy);

  // the loader: this thread fills channel lc of rows lk + 4 j of both tiles
  const int lc = tid & 63, lk = tid >> 6;
  const int c = c0 + lc, o = o0 + lc;
  float ca = 0.f, cb = 0.f, cds = 0.f, cdq2 = 0.f;
  if (kPro && c < p.ci) {
    ca = round_to<T>(p.a[c]);
    cb = round_to<T>(p.b[c]);
  }
  if (o < p.co) {
    cds = p.ds[o];
    cdq2 = 2.f * p.dq[o];
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kDepth) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = lk + 4 * j, r = r0 + kk;
      float z = 0.f, g = 0.f;  // rows past the split's end add nothing
      if (r < r_end) {
        if (o < p.co) {
          const size_t e = (size_t)r * p.co + o;
          g = out_cotangent<T>(to_f32(dyv[e]), to_f32(yv[e]), cds, cdq2);
        }
        bool live = c < p.ci;
        if (kTaps > 1) {
          const int rem = r % (p.h * p.wd);
          live = live && (unsigned)(rem / p.wd + du) < (unsigned)p.h &&
                 (unsigned)(rem % p.wd + dv) < (unsigned)p.wd;
        }
        if (live) {
          z = to_f32(xv[(size_t)(r + du * p.wd + dv) * p.ci + c]);
          if (kPro) z = fmaxf(prologue_pre<T>(z, ca, cb), 0.f);
        }
      }
      as[kk][lc] = z;
      bs[kk][lc] = g;
    }
    __syncthreads();
    tile_fma(as, bs, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci_ = c0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co_ = o0 + tx * 4 + j;
      if (ci_ < p.ci && co_ < p.co)
        p.part[(((size_t)blockIdx.z * kTaps + t) * p.ci + ci_) * p.co + co_] = acc[i][j];
    }
  }
}

// out[c] = part[0][c] + part[1][c] + ... in a fixed order: eight strided
// partial sums per column, then those eight in order. block (32, 8).
template <typename TOut>
__global__ void __launch_bounds__(256) reduce_partials(const float* __restrict__ part,
                                                      TOut* __restrict__ out,
                                                      int count, int columns) {
  __shared__ float sm[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < columns)
    for (int i = threadIdx.y; i < count; i += 8) s += part[(size_t)i * columns + c];
  sm[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < columns) {
    float total = sm[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < 8; ++i) total += sm[i][threadIdx.x];
    out[c] = from_f32<TOut>(total);
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename TOut>
cudaError_t launch_reduce(const float* part, TOut* out, int count, int columns,
                          cudaStream_t stream) {
  reduce_partials<TOut><<<ceil_div(columns, 32), dim3(32, 8), 0, stream>>>(
      part, out, count, columns);
  return cudaGetLastError();
}

// Forward of either conv (T = float): y, and (s, q) into sq (2, co) when it
// is not null.
template <typename T, int kTaps>
cudaError_t launch_forward(Args p, float* sq, cudaStream_t stream) {
  const dim3 grid(ceil_div(p.n, kTile), ceil_div(p.co, kTile));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const bool pro = p.a != nullptr, sums = sq != nullptr;
  if (kTaps > 1 && !pro) return cudaErrorInvalidValue;
  if (pro && sums) {
    rows_kernel<T, kTaps, false, true, true><<<grid, kThreads, 0, stream>>>(p);
  } else if (pro) {
    rows_kernel<T, kTaps, false, true, false><<<grid, kThreads, 0, stream>>>(p);
  } else if constexpr (kTaps == 1) {
    if (sums)
      rows_kernel<T, 1, false, false, true><<<grid, kThreads, 0, stream>>>(p);
    else
      rows_kernel<T, 1, false, false, false><<<grid, kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !sums) return err;
  return launch_reduce<float>(p.part, sq, grid.x, 2 * p.co, stream);
}

// Backward of either conv: dx, dw (cast to T), and (da, db) into dab (2, ci)
// when there is a prologue. `part` holds the column partial sums, `dw_part`
// the splits' partial products.
template <typename T, int kTaps>
cudaError_t launch_backward(Args p, void* dx, void* dw, float* dab, float* part,
                            float* dw_part, int splits, cudaStream_t stream) {
  const bool pro = p.a != nullptr;
  if (kTaps > 1 && !pro) return cudaErrorInvalidValue;
  if (splits < 1 || splits > 65535 || p.chunk < 1 ||
      (long long)splits * p.chunk < p.n)
    return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(p.n, kTile), ceil_div(p.ci, kTile));
  const dim3 wgrid(ceil_div(p.ci, kTile), ceil_div(p.co, kTile) * kTaps, splits);
  if (grid.y > 65535 || wgrid.y > 65535) return cudaErrorInvalidValue;

  p.out = dx;
  p.part = part;
  if (pro) {
    rows_kernel<T, kTaps, true, true, true><<<grid, kThreads, 0, stream>>>(p);
  } else if constexpr (kTaps == 1) {
    rows_kernel<T, 1, true, false, false><<<grid, kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (pro) {
    err = launch_reduce<float>(part, dab, grid.x, 2 * p.ci, stream);
    if (err != cudaSuccess) return err;
  }

  p.out = nullptr;
  p.part = dw_part;
  if (pro) {
    wgrad_kernel<T, kTaps, true><<<wgrid, kThreads, 0, stream>>>(p);
  } else if constexpr (kTaps == 1) {
    wgrad_kernel<T, 1, false><<<wgrid, kThreads, 0, stream>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<T>(dw_part, static_cast<T*>(dw), splits, kTaps * p.ci * p.co,
                          stream);
}

}  // namespace corrifnet_fc
