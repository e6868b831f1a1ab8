// Fused multi-head attention forward for Hopper (sm_90a):
//     o = dropout(softmax(q k^T * scale)) v      per (batch*head), head_dim 64,
//     lse = log sum_j exp(q k_j * scale)          per query row (f32).
//
// Replaces the TPU kernel corrifnet_tpu/ops/attention.py::_fwd_kernel
// (reached through _fused_fwd's pl.pallas_call), including its in-kernel
// attention-probability dropout and its logsumexp residual for the backward.
//
// What bounds it on the H100: at the model's shapes (N = 512 or 2048 tokens,
// head_dim 64) attention is compute-bound -- 4*N*N*64 FLOPs against 4*N*64
// elements moved -- and the (N, N) score matrix must never reach device
// memory. Design: one block of 256 threads per (bh, 64-row query tile). The
// block walks 64-row K/V tiles staged in shared memory (as f32), keeps an
// online softmax (running row max and row sum) and an f32 output
// accumulator in registers, so scores and probabilities live only in
// registers and one shared tile. Each thread owns a 4x4 register block of
// the score tile and of the output tile (rows ty+16a, columns tx+16b), which
// gives 16 FMAs for every 8 shared-memory reads. Products use plain f32 FMA
// on the CUDA cores; moving them to bf16 mma/wgmma is later work.
//
// Dropout (rate > 0) drops after the softmax, as the TPU kernel does: the
// row sum that normalizes is the undropped one, and each probability that
// enters the PV product is multiplied by keep / (1 - rate). The keep flags
// of each (query tile, key tile) come from Philox4x32-10 computed here (see
// attention_common.cuh) into a 4 KB shared tile while K and V are staged.
// At rate 0 that code is compiled out (template parameter), so the products
// and the softmax are those of the kernel without dropout, bit for bit.
//
// C interface (bound with ctypes): returns cudaGetLastError() of the launch.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace corrifnet;

constexpr int kSmemBytes = (3 * kTile * kPad + kTile * kD) * sizeof(float);

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n, float scale, uint32_t seed,
                     uint32_t offset, uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  float* qs = smem;                // [kTile][kPad] query tile
  float* ks = qs + kTile * kPad;   // [kTile][kPad] key tile
  float* ps = ks + kTile * kPad;   // [kTile][kPad] probabilities of the step
  float* vs = ps + kTile * kPad;   // [kTile][kD]   value tile
  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + kTile * kD);  // keep flags

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // owns columns tx + 16*b
  const int ty = tid >> 4;  // owns rows ty + 16*a
  const size_t head = (size_t)blockIdx.y * n * kD;
  const int q0 = blockIdx.x * kTile;

  for (int e = tid; e < kTile * kD; e += kThreads) {
    const int r = e / kD, c = e % kD;
    qs[r * kPad + c] = to_f32(q[head + (size_t)(q0 + r) * kD + c]);
  }

  float row_max[4], row_sum[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    row_max[a] = -INFINITY;
    row_sum[a] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous step's readers of ks/vs/ps/ms are done
    for (int e = tid; e < kTile * kD; e += kThreads) {
      const int r = e / kD, c = e % kD;
      const size_t g = head + (size_t)(k0 + r) * kD + c;
      ks[r * kPad + c] = to_f32(k[g]);
      vs[r * kD + c] = to_f32(v[g]);
    }
    if (kDrop)
      fill_keep_tile(ms, seed, offset, blockIdx.y, q0, k0, threshold, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * kPad + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = ks[(tx + 16 * b) * kPad + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }

    // Online softmax. A row's 64 scores are spread over the 16 lanes that
    // share ty (one half of a warp), so xor-shuffles over 8, 4, 2, 1 reduce it.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] *= scale;
        mx = fmaxf(mx, s[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(row_max[a], mx);
      const float alpha = expf(row_max[a] - m_new);  // 0 on the first step
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        rs += p;  // the undropped sum normalizes
        const int r = ty + 16 * a, c = tx + 16 * b;
        if (kDrop)
          ps[r * kPad + c] = ms[r * kTile + c] ? p * inv_keep : 0.f;
        else
          ps[r * kPad + c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      row_sum[a] = row_sum[a] * alpha + rs;
      row_max[a] = m_new;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      float pa[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * kPad + j];
#pragma unroll
      for (int b = 0; b < 4; ++b) vb[b] = vs[j * kD + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(pa[a], vb[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float inv = 1.f / row_sum[a];
    const size_t row = head + (size_t)(q0 + ty + 16 * a) * kD;
#pragma unroll
    for (int b = 0; b < 4; ++b) o[row + tx + 16 * b] = from_f32<T>(acc[a][b] * inv);
    if (lse != nullptr && tx == 0)
      lse[(size_t)blockIdx.y * n + q0 + ty + 16 * a] = row_max[a] + logf(row_sum[a]);
  }
}

template <typename T, bool kDrop>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int n, float scale, uint32_t seed,
                   uint32_t offset, uint32_t threshold, float inv_keep,
                   cudaStream_t stream) {
  constexpr int smem = kSmemBytes + (kDrop ? kMaskBytes : 0);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T, kDrop>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n / kTile, bh);
  attention_fwd_kernel<T, kDrop><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, scale, seed, offset,
      threshold, inv_keep);
  return cudaGetLastError();
}

// The keep mask of `count` (batch*head) rows starting at bh0, written with
// the kernels' own tile function: out[(z, row, col)] as bytes.
__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(uint8_t* __restrict__ out, int n, int bh0, uint32_t seed,
                 uint32_t offset, uint32_t threshold) {
  __shared__ __align__(4) uint8_t ms[kMaskBytes];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  fill_keep_tile(ms, seed, offset, bh0 + blockIdx.z, row0, col0, threshold, tid);
  __syncthreads();
  for (int e = tid; e < kMaskBytes; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    out[((size_t)blockIdx.z * n + row0 + r) * n + col0 + c] = ms[e];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous (bh, n, 64); lse:
// (bh, n) f32 or null. threshold = rate * 2^32 (0: no dropout), inv_keep =
// 1 / (1 - rate), (seed, offset) the Philox key.
extern "C" int corrifnet_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse, int bh,
                                       int n, int dtype, float scale,
                                       unsigned int threshold, float inv_keep,
                                       unsigned int seed, unsigned int offset,
                                       void* stream) {
  if (n <= 0 || n % kTile != 0 || bh <= 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && threshold == 0)
    err = launch<float, false>(q, k, v, o, l, bh, n, scale, seed, offset, threshold, inv_keep, s);
  else if (dtype == 0)
    err = launch<float, true>(q, k, v, o, l, bh, n, scale, seed, offset, threshold, inv_keep, s);
  else if (dtype == 1 && threshold == 0)
    err = launch<__nv_bfloat16, false>(q, k, v, o, l, bh, n, scale, seed, offset, threshold, inv_keep, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, true>(q, k, v, o, l, bh, n, scale, seed, offset, threshold, inv_keep, s);
  return static_cast<int>(err);
}

// out: (count, n, n) bytes, 1 where the entry is kept.
extern "C" int corrifnet_attention_keep_mask(void* out, int bh0, int count, int n,
                                             unsigned int threshold,
                                             unsigned int seed,
                                             unsigned int offset, void* stream) {
  if (n <= 0 || n % kTile != 0 || count <= 0 || count > 65535 || bh0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kTile, n / kTile, count);
  keep_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), n, bh0, seed, offset, threshold);
  return static_cast<int>(cudaGetLastError());
}
