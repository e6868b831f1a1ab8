// Fused multi-head attention forward for Hopper (sm_90a):
//     o = dropout(softmax(q k^T * scale)) v      per (batch*head), head_dim 64,
//     lse = log sum_j exp(q k_j * scale)          per query row (f32).
//
// Replaces the TPU kernel corrifnet_tpu/ops/attention.py::_fwd_kernel
// (reached through _fused_fwd's pl.pallas_call), including its in-kernel
// attention-probability dropout and its logsumexp residual for the backward.
//
// What bounds it on the H100: at the model's shapes (N = 512 or 2048 tokens,
// head_dim 64) attention is bound by operations -- 4*N*N*64 FLOPs against
// 4*N*64 elements moved -- and the (N, N) score matrix must never reach
// device memory. Two instantiations, chosen by the operands' type:
//
// bfloat16 (attention_fwd_wgmma_kernel), the model's working type. Both
// products run on the tensor cores as asynchronous warpgroup products,
// wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 (HGMMA in the SASS):
// bf16 operands, f32 accumulators. A block is one warpgroup (128 threads)
// and owns a 64-row query tile, 16 rows a warp; the grid is (N / 64,
// batch*head): 256 blocks for the smallest launch (B = 4, N = 512), about
// two for each of the 132 SMs and all resident at once, and 1024 or 2048
// for N = 2048, where three blocks fit an SM (shared memory) and the last
// wave is at most a sixth of the card. The block walks 64-row K/V tiles that
// arrive as bf16 in shared memory in the 128-byte swizzle by 16-byte
// cp.async, in a ring of three stages with one __syncthreads() a tile:
// tile i + 2 loads while tile i is multiplied. Shared memory: the query
// tile (8 KB, read once with ldmatrix into A fragments that stay in
// registers) and 3 x 16 KB of K/V, 56 KB a block. s = q k^T reads the key
// tile through a K-major descriptor, o += p v reads the value tile through a
// transposed (MN-major) one, so neither tile is ever transposed in memory.
// Scores, the online softmax (base 2, the scale folded into the exponent,
// ex2.approx), the row sum, the lse and the output accumulator are f32 in
// registers; a row's maximum reduces over the four lanes of a quad with two
// shuffles, its sum once at the end. The probabilities never touch shared
// memory: the f32 accumulator layout of the first product, rounded to bf16,
// is the A register layout of the second. Rounding p to bf16 before p v is
// what the TPU kernel does too (attention.py:214, 222); here it is the
// unnormalised p = exp(s - running max) <= 1 that is rounded, and the f32
// row sum of the unrounded p normalises at the end. ptxas: 122 registers a
// thread at rate 0 and 164 with dropout, no spills.
//
// What it waits on (scripts/bench_torch_attention.py, N = 2048): at rate 0
// about 300 TFLOP/s, a third of the tensor cores' peak. With the softmax
// arithmetic taken out (an experiment, not kept) the products, copies and
// barriers alone run at 390 to 415 TFLOP/s, so a quarter of the time is
// softmax arithmetic that does not hide behind the tensor cores (the
// exponentials themselves are 4% of the time), and the rest is the
// skeleton: 64-wide products, one block-wide barrier and eight cp.async
// address computations a thread for every 64 keys. Waiting for p v one tile
// later (a fourth stage) and a fourth block an SM changed nothing. With
// dropout the kernel is bound by the integer pipe: a Philox4x32-10 call is
// twenty 32 x 32 -> 64 bit multiplies and twenty three-input xors for four
// mask entries, and takes as long again as everything else. An earlier
// version of this kernel with mma.sync.m16n8k16 and ldmatrix reached 217 to
// 224 TFLOP/s at 16 rows a warp and 271 to 277 at 32 (its K/V fragments used
// twice); this one replaced it because it was faster at every shape.
//
// float32 (attention_fwd_kernel): plain f32 FMA on the CUDA cores, a 4x4
// register block a thread over f32 shared tiles. bf16 products cannot meet
// the 2e-5 bounds that the f32 model is held to against the CPU, so this
// instantiation stays as it was; it is not on the bf16 model's path.
//
// Dropout (rate > 0) drops after the softmax, as the TPU kernel does: the
// row sum that normalizes is the undropped one, and each probability that
// enters the PV product is multiplied by keep / (1 - rate). The keep flags
// come from Philox4x32-10 computed here (attention_common.cuh): in the bf16
// kernel each lane makes the eight calls that cover the entries it and its
// neighbour own (keep_bits_rows), after the score product is started and
// before it is waited for, so the integer pipe works while the tensor cores
// do. At rate 0 that code is compiled out (template parameter).
//
// Operands are (B, H, N, 64) views with element strides for batch, head and
// row and a contiguous last dimension, so the (B, N, 3, H, 64) product of
// the qkv projection is read in place and o is written as (B, N, H, 64).
//
// C interface (bound with ctypes): returns cudaGetLastError() of the launch.

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace corrifnet;

// ------------------------------------------------------------------ bf16

template <bool kDrop>
__global__ void __launch_bounds__(kBlock)
attention_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, Strides sq, Strides sk,
                           Strides sv, Strides so, int heads, int n, float scale,
                           uint32_t seed, uint32_t offset, uint32_t threshold,
                           float inv_keep) {
  constexpr int kRows = kWarps * 16;  // a warp owns rows 16 warp .. 16 warp + 15
  extern __shared__ __align__(1024) uint8_t smem_wg[];
  const uint32_t q_s = smem_u32(smem_wg);   // [kRows][64] bf16, swizzled
  const uint32_t kv_s = q_s + kRows * 128;  // kStages x (K tile, V tile)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const bf16* kp = head_base(k, sk, bh, heads);
  const bf16* vp = head_base(v, sv, bh, heads);
  const int tiles = n / kTile;

  load_rows_async(q_s, head_base(q, sq, bh, heads) + (long long)q0 * sq.n, sq.n, kRows,
                  tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) load_pair_async(kv_s, st, kp, sk.n, vp, sv.n, st, tid);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the query tile has landed
  __syncthreads();
  uint32_t qf[4][4];
  load_a_frags(qf, q_s, warp * 16, lane);

  const float c = scale * kLog2e;  // scores to base-2 exponents
  float row_max[2] = {-INFINITY, -INFINITY};  // of s * c, rows g and g + 8
  float row_sum[2] = {0.f, 0.f};              // this lane's share of the row sum
  float acc[8][4];
  zero_acc(acc);

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed
    fence_async_proxy();
    __syncthreads();               // and every warp is done with tile it - 1
    if (it + kStages - 1 < tiles)
      load_pair_async(kv_s, (it + kStages - 1) % kStages, kp, sk.n, vp, sv.n,
                      it + kStages - 1, tid);
    cp_async_commit();
    const uint32_t k_s = kv_s + (it % kStages) * 2 * kTileBytes;
    const uint32_t v_s = k_s + kTileBytes;

    float s[8][4];
    zero_acc(s);
    fence_acc(s);
    wgmma_fence();
    wgmma_a_bt(s, qf, k_s);
    wgmma_commit();

    // the mask is made while the tensor cores work on the scores
    uint32_t keep_lo = 0, keep_hi = 0;
    if (kDrop)
      keep_bits_rows(keep_lo, keep_hi, q0 + warp * 16, it * kTile, bh, seed, offset,
                     threshold, lane);
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(acc);

    // Online softmax: lane (g, t) holds rows g (entries 0, 1) and g + 8
    // (entries 2, 3) of each 8-column group; a row is spread over a quad.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(row_max[h], mx[h] * c);
      alpha[h] = fast_exp2(row_max[h] - m_new);  // 0 on the first tile
      row_max[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = fast_exp2(fmaf(s[nt][e], c, -row_max[h]));
        rs[h] += p;  // the undropped sum normalizes
        if (kDrop) {
          const uint32_t bits = h ? keep_hi : keep_lo;
          s[nt][e] = ((bits >> (4 * nt + (e & 1))) & 1u) ? p * inv_keep : 0.f;
        } else {
          s[nt][e] = p;
        }
        acc[nt][e] *= alpha[h];
      }
    row_sum[0] = row_sum[0] * alpha[0] + rs[0];
    row_sum[1] = row_sum[1] * alpha[1] + rs[1];

    uint32_t pf[4][4];
    acc_to_a_frags(pf, s);
    fence_acc(acc);
    wgmma_fence();
    wgmma_a_b(acc, pf, v_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    inv[h] = 1.f / row_sum[h];
  }
  store_acc(head_base(o, so, bh, heads), so.n, q0 + warp * 16, acc, inv[0], inv[1], lane);
  if (lse != nullptr && (lane & 3) == 0) {
    float* l = lse + (size_t)bh * n + q0 + warp * 16 + (lane >> 2);
    l[0] = (row_max[0] + log2f(row_sum[0])) * kLn2;
    l[8] = (row_max[1] + log2f(row_sum[1])) * kLn2;
  }
}

template <bool kDrop>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, const Strides* st, int batch, int heads, int n,
                         float scale, uint32_t seed, uint32_t offset,
                         uint32_t threshold, float inv_keep, cudaStream_t stream) {
  constexpr int kRows = kWarps * 16;
  constexpr int smem = kRows * 128 + kStages * 2 * kTileBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_wgmma_kernel<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n / kRows, batch * heads);
  attention_fwd_wgmma_kernel<kDrop><<<grid, kBlock, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, st[0], st[1], st[2],
      st[3], heads, n, scale, seed, offset, threshold, inv_keep);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- f32

constexpr int kSmemBytes = (3 * kTile * kPad + kTile * kD) * sizeof(float);

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                     Strides so, int heads, int n, float scale, uint32_t seed,
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
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kp = head_base(k, sk, bh, heads);
  const float* vp = head_base(v, sv, bh, heads);

  load_tile(qs, head_base(q, sq, bh, heads) + (long long)q0 * sq.n, sq.n, tid);

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
    load_tile(ks, kp + (long long)k0 * sk.n, sk.n, tid);
    for (int e = tid; e < kTile * kD; e += kThreads)
      vs[e] = vp[(long long)(k0 + e / kD) * sv.n + e % kD];
    if (kDrop)
      fill_keep_tile(ms, seed, offset, bh, q0, k0, threshold, tid);
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

  float* op = head_base(o, so, bh, heads);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float inv = 1.f / row_sum[a];
    float* row = op + (long long)(q0 + ty + 16 * a) * so.n;
#pragma unroll
    for (int b = 0; b < 4; ++b) row[tx + 16 * b] = acc[a][b] * inv;
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * n + q0 + ty + 16 * a] = row_max[a] + logf(row_sum[a]);
  }
}

template <bool kDrop>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Strides* st, int batch, int heads, int n,
                       float scale, uint32_t seed, uint32_t offset,
                       uint32_t threshold, float inv_keep, cudaStream_t stream) {
  constexpr int smem = kSmemBytes + (kDrop ? kMaskBytes : 0);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n / kTile, batch * heads);
  attention_fwd_kernel<kDrop><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, st[0], st[1], st[2],
      st[3], heads, n, scale, seed, offset, threshold, inv_keep);
  return cudaGetLastError();
}

// The keep mask of `count` (batch*head) rows starting at bh0, written with
// the kernels' own device functions: out[(z, row, col)] as bytes. layout 0:
// fill_keep_tile (f32 kernels), 1: keep_bits_rows (bf16 forward and dq
// pass), 2: fill_keep_cols (bf16 dk/dv pass).
__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(uint8_t* __restrict__ out, int n, int bh0, uint32_t seed,
                 uint32_t offset, uint32_t threshold, int layout) {
  __shared__ __align__(4) uint8_t ms[kMaskBytes];
  __shared__ __align__(4) uint16_t flags[4][kTile];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const uint32_t bh = bh0 + blockIdx.z;
  if (layout == 0) {
    fill_keep_tile(ms, seed, offset, bh, row0, col0, threshold, tid);
  } else if (layout == 1 && warp < 4) {  // warp w: rows 16 w .. 16 w + 15
    uint32_t lo, hi;
    keep_bits_rows(lo, hi, row0 + 16 * warp, col0, bh, seed, offset, threshold, lane);
    const int g = lane >> 2, t = lane & 3;
    for (int nt = 0; nt < 8; ++nt)
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + 2 * t + e;
        ms[(16 * warp + g) * kTile + col] = (lo >> (4 * nt + e)) & 1u;
        ms[(16 * warp + g + 8) * kTile + col] = (hi >> (4 * nt + e)) & 1u;
      }
  } else if (layout == 2 && warp < 4) {  // warp w: columns 16 w .. 16 w + 15
    fill_keep_cols(flags[warp], row0, col0 + 16 * warp, bh, seed, offset, threshold, lane);
    __syncwarp();
    const int g = lane >> 2, t = lane & 3;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(flags[warp]);
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t w = words[4 * nt + t];  // rows 8 nt + 2 t and + 1
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * nt + 2 * t + e;
        ms[row * kTile + 16 * warp + g] = (w >> (16 * e + g)) & 1u;
        ms[row * kTile + 16 * warp + g + 8] = (w >> (16 * e + g + 8)) & 1u;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kMaskBytes; e += kThreads) {
    const int r = e / kTile, c = e % kTile;
    out[((size_t)blockIdx.z * n + row0 + r) * n + col0 + c] = ms[e];
  }
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel). q, k,
// v, o: (batch, heads, n, 64) with the element strides strides[4][3] =
// {batch, head, row} of q, k, v, o and a contiguous last dimension; bf16
// rows must be 16-byte aligned. lse: contiguous (batch, heads, n) f32 or
// null. threshold = rate * 2^32 (0: no dropout), inv_keep = 1 / (1 - rate),
// (seed, offset) the Philox key.
extern "C" int corrifnet_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const long long* strides, int batch,
                                       int heads, int n, int dtype, float scale,
                                       unsigned int threshold, float inv_keep,
                                       unsigned int seed, unsigned int offset,
                                       void* stream) {
  const long long bh = (long long)batch * heads;
  if (n <= 0 || n % kTile != 0 || batch <= 0 || heads <= 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const bool drop = threshold != 0;
  cudaError_t err = cudaErrorInvalidValue;
#define CORRIFNET_FWD(fn) \
  fn(q, k, v, o, l, st, batch, heads, n, scale, seed, offset, threshold, inv_keep, s)
  if (dtype == 0) {
    err = drop ? CORRIFNET_FWD(launch_f32<true>) : CORRIFNET_FWD(launch_f32<false>);
  } else if (dtype == 1) {
    err = drop ? CORRIFNET_FWD(launch_wgmma<true>) : CORRIFNET_FWD(launch_wgmma<false>);
  }
#undef CORRIFNET_FWD
  return static_cast<int>(err);
}

// out: (count, n, n) bytes, 1 where the entry is kept; layout as in
// keep_mask_kernel.
extern "C" int corrifnet_attention_keep_mask(void* out, int bh0, int count, int n,
                                             unsigned int threshold,
                                             unsigned int seed,
                                             unsigned int offset, int layout,
                                             void* stream) {
  if (n <= 0 || n % kTile != 0 || count <= 0 || count > 65535 || bh0 < 0 ||
      layout < 0 || layout > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kTile, n / kTile, count);
  keep_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), n, bh0, seed, offset, threshold, layout);
  return static_cast<int>(cudaGetLastError());
}
