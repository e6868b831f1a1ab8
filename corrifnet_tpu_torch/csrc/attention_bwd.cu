// Fused multi-head attention backward for Hopper (sm_90a): dq, dk, dv of
//     o = dropout(softmax(q k^T * scale)) v      per (batch*head), head_dim 64,
// from q, k, v, o, dO and the forward's logsumexp residual.
//
// Replaces the TPU kernel corrifnet_tpu/ops/attention.py::_bwd_kernel (reached
// through _fused_bwd_impl's pl.pallas_call). Per (query row i, key row j):
//     p    = exp(s * scale - lse_i)              (the forward's probabilities)
//     m    = keep / (1 - rate)                   (1 at rate 0)
//     dp   = (dO_i . v_j) * m
//     ds   = p * (dp - delta_i),   delta_i = dO_i . o_i
//     dq_i = scale * sum_j ds k_j,  dk_j = scale * sum_i ds q_i,
//     dv_j = sum_i p m dO_i.
// The keep flags are the forward's, regenerated from the same Philox key and
// the absolute (batch*head, row, column) (see attention_common.cuh).
//
// What bounds it on the H100: compute (seven 64x64x64 tile products per tile
// pair against two in the forward), and the (N, N) matrices p, dp and ds
// must never reach device memory. The TPU kernel walks query blocks on one
// core with whole-(N, 64) f32 dk/dv sums carried in fast memory; blocks on
// an SM run in parallel and cannot carry sums from one to the next. Design:
// three launches on one stream, no atomics, so results are repeatable bit
// for bit:
//   1. delta: one warp per query row;
//   2. dq pass: one block per (bh, query tile) walks the key tiles;
//   3. dk/dv pass: one block per (bh, key tile) walks the query tiles.
// Both passes use the forward's tiling: 256 threads, each a 4x4 register
// block of the 64x64 score tile (rows ty+16a, columns tx+16b), operands
// staged in padded f32 shared memory (85 KB and 102 KB, opted in with
// cudaFuncSetAttribute), plain f32 FMA. p stays in f32 throughout, where
// the TPU kernel rounds it to the value dtype before its PV and dv products.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// last launch (or the first error).

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace corrifnet;

constexpr int kDqSmemBytes = 5 * kTileFloats * sizeof(float) + kMaskBytes;
constexpr int kDkvSmemBytes =
    6 * kTileFloats * sizeof(float) + kMaskBytes + 2 * kTile * sizeof(float);
constexpr int kWarpsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_delta_kernel(const T* __restrict__ d_o, const T* __restrict__ o,
                       float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * kD;
  float s = to_f32(d_o[base + lane]) * to_f32(o[base + lane]) +
            to_f32(d_o[base + lane + 32]) * to_f32(o[base + lane + 32]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// s = q k^T and dp = dO v^T of one tile pair, 4x4 per thread.
__device__ __forceinline__ void scores_and_dp(const float* qs, const float* dos,
                                              const float* ks, const float* vs,
                                              int tx, int ty, float s[4][4],
                                              float dp[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s[a][b] = 0.f;
      dp[a][b] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = qs[(ty + 16 * a) * kPad + d];
      da[a] = dos[(ty + 16 * a) * kPad + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = ks[(tx + 16 * b) * kPad + d];
      vb[b] = vs[(tx + 16 * b) * kPad + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(da[a], vb[b], dp[a][b]);
      }
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int n, float scale, uint32_t seed, uint32_t offset,
                        uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  float* qs = smem;                  // query tile
  float* dos = qs + kTileFloats;     // dO tile
  float* ks = dos + kTileFloats;     // key tile of the step
  float* vs = ks + kTileFloats;      // value tile of the step
  float* dss = vs + kTileFloats;     // ds of the step
  uint8_t* ms = reinterpret_cast<uint8_t*>(dss + kTileFloats);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t head = (size_t)blockIdx.y * n * kD;
  const int q0 = blockIdx.x * kTile;

  load_tile(qs, q + head + (size_t)q0 * kD, tid);
  load_tile(dos, d_o + head + (size_t)q0 * kD, tid);

  float row_lse[4], row_delta[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t r = (size_t)blockIdx.y * n + q0 + ty + 16 * a;
    row_lse[a] = lse[r];
    row_delta[a] = delta[r];
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous step's readers of ks/vs/dss/ms are done
    load_tile(ks, k + head + (size_t)k0 * kD, tid);
    load_tile(vs, v + head + (size_t)k0 * kD, tid);
    if (kDrop)
      fill_keep_tile(ms, seed, offset, blockIdx.y, q0, k0, threshold, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp(qs, dos, ks, vs, tx, ty, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b;
        const float p = expf(s[a][b] * scale - row_lse[a]);
        float g = dp[a][b];
        if (kDrop) g = ms[r * kTile + c] ? g * inv_keep : 0.f;
        dss[r * kPad + c] = p * (g - row_delta[a]);
      }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      float da[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = dss[(ty + 16 * a) * kPad + j];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = ks[j * kPad + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(da[a], kb[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t row = head + (size_t)(q0 + ty + 16 * a) * kD;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dq[row + tx + 16 * b] = from_f32<T>(acc[a][b] * scale);
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ d_o,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int n, float scale, uint32_t seed,
                         uint32_t offset, uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  float* ks = smem;                  // key tile
  float* vs = ks + kTileFloats;      // value tile
  float* qs = vs + kTileFloats;      // query tile of the step
  float* dos = qs + kTileFloats;     // dO tile of the step
  float* ps = dos + kTileFloats;     // dropped probabilities of the step
  float* dss = ps + kTileFloats;     // ds of the step
  float* ls = dss + kTileFloats;     // lse of the step's query rows
  float* dl = ls + kTile;            // delta of the step's query rows
  uint8_t* ms = reinterpret_cast<uint8_t*>(dl + kTile);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t head = (size_t)blockIdx.y * n * kD;
  const int k0 = blockIdx.x * kTile;

  load_tile(ks, k + head + (size_t)k0 * kD, tid);
  load_tile(vs, v + head + (size_t)k0 * kD, tid);

  // sums over query rows for key row ty+16a, head dim tx+16b
  float acc_dk[4][4], acc_dv[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      acc_dk[a][b] = 0.f;
      acc_dv[a][b] = 0.f;
    }

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous step's readers are done
    load_tile(qs, q + head + (size_t)q0 * kD, tid);
    load_tile(dos, d_o + head + (size_t)q0 * kD, tid);
    if (tid < kTile) {
      const size_t r = (size_t)blockIdx.y * n + q0 + tid;
      ls[tid] = lse[r];
      dl[tid] = delta[r];
    }
    if (kDrop)
      fill_keep_tile(ms, seed, offset, blockIdx.y, q0, k0, threshold, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp(qs, dos, ks, vs, tx, ty, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b;
        const float p = expf(s[a][b] * scale - ls[r]);
        float g = dp[a][b], pd = p;
        if (kDrop) {
          const bool keep = ms[r * kTile + c] != 0;
          g = keep ? g * inv_keep : 0.f;
          pd = keep ? p * inv_keep : 0.f;
        }
        ps[r * kPad + c] = pd;
        dss[r * kPad + c] = p * (g - dl[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pa[4], da[4], ob[4], qb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ps[r * kPad + ty + 16 * a];
        da[a] = dss[r * kPad + ty + 16 * a];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        ob[b] = dos[r * kPad + tx + 16 * b];
        qb[b] = qs[r * kPad + tx + 16 * b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc_dv[a][b] = fmaf(pa[a], ob[b], acc_dv[a][b]);
          acc_dk[a][b] = fmaf(da[a], qb[b], acc_dk[a][b]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t row = head + (size_t)(k0 + ty + 16 * a) * kD;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      dk[row + tx + 16 * b] = from_f32<T>(acc_dk[a][b] * scale);
      dv[row + tx + 16 * b] = from_f32<T>(acc_dv[a][b]);
    }
  }
}

template <typename T, bool kDrop>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* d_o, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int bh, int n, float scale,
                   uint32_t seed, uint32_t offset, uint32_t threshold,
                   float inv_keep, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_kernel<T, kDrop>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T, kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(d_o);
  const int rows = bh * n;
  attention_delta_kernel<T><<<rows / kWarpsPerBlock, kThreads, 0, stream>>>(
      dop, static_cast<const T*>(o), delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kTile, bh);
  attention_bwd_dq_kernel<T, kDrop><<<grid, kThreads, kDqSmemBytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), n, scale, seed, offset,
      threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T, kDrop><<<grid, kThreads, kDkvSmemBytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), n,
      scale, seed, offset, threshold, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, d_o, dq, dk, dv: contiguous
// (bh, n, 64); lse: (bh, n) f32 from the forward; delta: (bh, n) f32 scratch.
// threshold, inv_keep, seed, offset: as given to the forward.
extern "C" int corrifnet_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* d_o, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv,
                                       int bh, int n, int dtype, float scale,
                                       unsigned int threshold, float inv_keep,
                                       unsigned int seed, unsigned int offset,
                                       void* stream) {
  if (n <= 0 || n % kTile != 0 || bh <= 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && threshold == 0)
    err = launch<float, false>(q, k, v, o, d_o, l, dl, dq, dk, dv, bh, n, scale, seed, offset, threshold, inv_keep, s);
  else if (dtype == 0)
    err = launch<float, true>(q, k, v, o, d_o, l, dl, dq, dk, dv, bh, n, scale, seed, offset, threshold, inv_keep, s);
  else if (dtype == 1 && threshold == 0)
    err = launch<__nv_bfloat16, false>(q, k, v, o, d_o, l, dl, dq, dk, dv, bh, n, scale, seed, offset, threshold, inv_keep, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, true>(q, k, v, o, d_o, l, dl, dq, dk, dv, bh, n, scale, seed, offset, threshold, inv_keep, s);
  return static_cast<int>(err);
}
