// Fused multi-head attention forward for Hopper (sm_90a):
//     o = softmax(q k^T * scale) v        per (batch*head), head_dim 64.
//
// Replaces the TPU kernel corrifnet_tpu/ops/attention.py::_fwd_kernel
// (reached through _fused_fwd's pl.pallas_call) on the inference path:
// dropout rate 0 and no logsumexp residual, which only the backward reads.
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
// C interface (bound with ctypes): returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;         // head_dim
constexpr int kTile = 64;      // query rows per block == key rows per step
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4x4 register block
constexpr int kPad = kD + 1;   // padded shared row stride (no bank conflicts)
constexpr int kSmemBytes = (3 * kTile * kPad + kTile * kD) * sizeof(float);

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int n,
                     float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                // [kTile][kPad] query tile
  float* ks = qs + kTile * kPad;   // [kTile][kPad] key tile
  float* ps = ks + kTile * kPad;   // [kTile][kPad] probabilities of the step
  float* vs = ps + kTile * kPad;   // [kTile][kD]   value tile

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
    __syncthreads();  // the previous step's readers of ks/vs/ps are done
    for (int e = tid; e < kTile * kD; e += kThreads) {
      const int r = e / kD, c = e % kD;
      const size_t g = head + (size_t)(k0 + r) * kD + c;
      ks[r * kPad + c] = to_f32(k[g]);
      vs[r * kD + c] = to_f32(v[g]);
    }
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
        ps[(ty + 16 * a) * kPad + tx + 16 * b] = p;
        rs += p;
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
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int n, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n / kTile, bh);
  attention_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous (bh, n, 64).
extern "C" int corrifnet_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int bh, int n,
                                       int dtype, float scale, void* stream) {
  if (n <= 0 || n % kTile != 0 || bh <= 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(q, k, v, o, bh, n, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, o, bh, n, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
