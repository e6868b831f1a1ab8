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
// What bounds it on the H100: operations (the (N, N) matrices p, dp and ds
// must never reach device memory, so they are recomputed). The TPU kernel
// walks query blocks on one core with whole-(N, 64) f32 dk/dv sums carried in
// fast memory; blocks on an SM run in parallel and cannot carry sums from
// one to the next. So the work is two passes on one stream, without float
// atomics, and the results are repeatable bit for bit:
//   dq pass:    one block per (bh, query tile) walks the key tiles;
//   dk/dv pass: one block per (bh, key tile) walks the query tiles.
// s and dp are computed in both: seven 64x64x64 products a tile pair.
//
// bfloat16 (attention_bwd_dq_wgmma_kernel, attention_bwd_dkv_wgmma_kernel),
// the model's working type: every product is an asynchronous warpgroup
// product, wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 (HGMMA in
// the SASS), bf16 operands, f32 accumulators. A block is one warpgroup (128
// threads) and owns 64 rows of its own tile, 16 a warp; the grid is (N / 64,
// batch*head) in both passes: 256 blocks for the smallest launch (B = 4,
// N = 512), 1024 for N = 2048, two blocks an SM (registers), so the last
// wave is at most an eighth of the card. The tile a block owns (q and dO, or
// k and v) is read once through shared memory with ldmatrix into A
// fragments that stay in registers; the tiles it walks (k and v, or q and
// dO with their lse and delta) arrive as bf16 in shared memory in the
// 128-byte swizzle by 16-byte cp.async in a ring of three stages, one
// __syncthreads() a tile. Shared memory a block: 64 KB (dq pass), 66 KB
// (dk/dv pass). The dq pass also computes delta for its rows (the delta
// launch is folded in) and stores it for the dk/dv pass. In the dk/dv pass a
// warp computes the transposed tiles s^T = k q^T and dp^T = v dO^T, so that
// p^T and ds^T come out of the accumulators already laid out as the A
// registers of dv += p^T dO and dk += ds^T q; those two and dq += ds k read
// their shared tile through a transposed (MN-major) descriptor. So p and ds
// never touch shared memory in either pass and no tile is transposed in
// memory. p m and ds are rounded to bf16 for those products, as the TPU
// kernel rounds them (attention.py:342, 350, 356-363); scores, p, dp, delta
// and all sums are f32. The keep flags are made between the start of the
// first two products and their wait: keep_bits_rows in the dq pass; in the
// dk/dv pass fill_keep_cols writes 128 bytes a warp (one 16-bit word a
// query row) that each lane reads back as eight words. ptxas, registers a
// thread at rate 0 / with dropout: 158 / 231 (dq pass), 218 / 239 (dk/dv
// pass), no spills.
//
// What it waits on (scripts/bench_torch_attention.py): at rate 0 about 275
// to 285 TFLOP/s of the bound's five products at N = 2048 (385 to 400 of the
// seven executed), with two blocks an SM; with dropout the integer pipe, as
// in the forward, twice (each pass regenerates the mask). An earlier
// version with mma.sync.m16n8k16 and ldmatrix reached 179 to 183 TFLOP/s at
// rate 0; this one replaced it.
//
// float32 (attention_delta_kernel, attention_bwd_dq_kernel,
// attention_bwd_dkv_kernel): plain f32 FMA, a 4x4 register block a thread
// over padded f32 shared tiles, three launches. It is what the f32 model is
// held to the CPU with (2e-5 bounds); it is not on the bf16 model's path.
//
// Operands are (B, H, N, 64) views with element strides for batch, head and
// row and a contiguous last dimension: q, k, v are read in place from the
// (B, N, 3, H, 64) qkv product and dq, dk, dv written into one such buffer.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// last launch (or the first error).

#include <math.h>

#include "attention_common.cuh"

namespace {

using namespace corrifnet;

// ------------------------------------------------------------------ bf16

// Sum of the eight products of two 16-byte vectors of bf16.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

template <bool kDrop>
__global__ void __launch_bounds__(kBlock)
attention_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ o,
                              const bf16* __restrict__ d_o,
                              const float* __restrict__ lse, float* __restrict__ delta,
                              bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                              Strides so, Strides sdo, Strides sdq, int heads, int n,
                              float scale, uint32_t seed, uint32_t offset,
                              uint32_t threshold, float inv_keep) {
  constexpr int kRows = kWarps * 16;
  extern __shared__ __align__(1024) uint8_t smem_wg[];
  const uint32_t q_s = smem_u32(smem_wg);     // [kRows][64] query tile
  const uint32_t do_s = q_s + kRows * 128;    // [kRows][64] dO tile
  const uint32_t kv_s = do_s + kRows * 128;   // kStages x (K tile, V tile)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const bf16* kp = head_base(k, sk, bh, heads);
  const bf16* vp = head_base(v, sv, bh, heads);
  const bf16* dop = head_base(d_o, sdo, bh, heads);
  const int tiles = n / kTile;

  load_rows_async(q_s, head_base(q, sq, bh, heads) + (long long)q0 * sq.n, sq.n, kRows,
                  tid);
  load_rows_async(do_s, dop + (long long)q0 * sdo.n, sdo.n, kRows, tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) load_pair_async(kv_s, st, kp, sk.n, vp, sv.n, st, tid);
    cp_async_commit();
  }

  // delta and lse of rows g and g + 8 of this warp; a row's 64 products are
  // split over the four lanes of a quad, 16 columns each
  const float c = scale * kLog2e;
  float row_lse[2], row_delta[2];
  const bf16* op = head_base(o, so, bh, heads);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    const uint4* po = reinterpret_cast<const uint4*>(op + (long long)row * so.n + 16 * t);
    const uint4* pd = reinterpret_cast<const uint4*>(dop + (long long)row * sdo.n + 16 * t);
    float s = dot8(po[0], pd[0]) + dot8(po[1], pd[1]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    row_delta[h] = s;
    row_lse[h] = lse[(size_t)bh * n + row] * kLog2e;
    if (t == 0) delta[(size_t)bh * n + row] = s;
  }

  cp_async_wait<kStages - 1>();  // the query and dO tiles have landed
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  load_a_frags(qf, q_s, warp * 16, lane);
  load_a_frags(dof, do_s, warp * 16, lane);

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

    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
    wgmma_a_bt(s, qf, k_s);
    wgmma_a_bt(dp, dof, v_s);
    wgmma_commit();
    uint32_t keep_lo = 0, keep_hi = 0;
    if (kDrop)  // made while the tensor cores work
      keep_bits_rows(keep_lo, keep_hi, q0 + warp * 16, it * kTile, bh, seed, offset,
                     threshold, lane);
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    fence_acc(acc);

#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = fast_exp2(fmaf(s[nt][e], c, -row_lse[h]));
        float gr = dp[nt][e];
        if (kDrop) {
          const uint32_t bits = h ? keep_hi : keep_lo;
          gr = ((bits >> (4 * nt + (e & 1))) & 1u) ? gr * inv_keep : 0.f;
        }
        dp[nt][e] = p * (gr - row_delta[h]);
      }

    uint32_t dsf[4][4];
    acc_to_a_frags(dsf, dp);
    fence_acc(acc);
    wgmma_fence();
    wgmma_a_b(acc, dsf, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }

  store_acc(head_base(dq, sdq, bh, heads), sdq.n, q0 + warp * 16, acc, scale, scale,
            lane);
}

template <bool kDrop>
__global__ void __launch_bounds__(kBlock)
attention_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ d_o,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, Strides sq, Strides sk,
                               Strides sv, Strides sdo, Strides sdk, Strides sdv,
                               int heads, int n, float scale, uint32_t seed,
                               uint32_t offset, uint32_t threshold, float inv_keep) {
  constexpr int kRows = kWarps * 16;
  constexpr int kRowBytes = 2 * kTile * (int)sizeof(float);  // 64 lse, 64 delta
  extern __shared__ __align__(1024) uint8_t smem_wg[];
  const uint32_t k_s = smem_u32(smem_wg);     // [kRows][64] key tile
  const uint32_t v_s = k_s + kRows * 128;     // [kRows][64] value tile
  const uint32_t ring_s = v_s + kRows * 128;  // kStages x (query tile, dO tile)
  const uint32_t rows_s = ring_s + kStages * 2 * kTileBytes;  // kStages x (lse, delta)
  uint8_t* rows = smem_wg + 2 * kRows * 128 + kStages * 2 * kTileBytes;
  uint16_t* flags =
      reinterpret_cast<uint16_t*>(rows + kStages * kRowBytes) + (threadIdx.x >> 5) * kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const bf16* qp = head_base(q, sq, bh, heads);
  const bf16* dop = head_base(d_o, sdo, bh, heads);
  const float* lp = lse + (size_t)bh * n;
  const float* dlp = delta + (size_t)bh * n;
  const int tiles = n / kTile;

  auto load_stage = [&](int tile, int st) {
    load_pair_async(ring_s, st, qp, sq.n, dop, sdo.n, tile, tid);
    if (tid < 32) {  // 16 chunks of four lse, 16 of four delta
      const int ch = tid & 15;
      const float* src = (tid < 16 ? lp : dlp) + tile * kTile + 4 * ch;
      cp_async16(rows_s + st * kRowBytes + (tid < 16 ? 0 : kTile * 4) + 16 * ch, src);
    }
  };

  load_rows_async(k_s, head_base(k, sk, bh, heads) + (long long)k0 * sk.n, sk.n, kRows,
                  tid);
  load_rows_async(v_s, head_base(v, sv, bh, heads) + (long long)k0 * sv.n, sv.n, kRows,
                  tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) load_stage(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the key and value tiles have landed
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, k_s, warp * 16, lane);
  load_a_frags(vf, v_s, warp * 16, lane);

  const float c = scale * kLog2e;
  float acc_dk[8][4], acc_dv[8][4];
  zero_acc(acc_dk);
  zero_acc(acc_dv);

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed
    fence_async_proxy();
    __syncthreads();               // and every warp is done with tile it - 1
    if (it + kStages - 1 < tiles)
      load_stage(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const int st = it % kStages;
    const uint32_t q_s = ring_s + st * 2 * kTileBytes, do_s = q_s + kTileBytes;
    const float2* ls = reinterpret_cast<const float2*>(rows + st * kRowBytes);
    const float2* dl = ls + kTile / 2;

    // transposed tiles: rows are this warp's keys, columns the tile's queries
    float st_[8][4], dpt[8][4];
    zero_acc(st_);
    zero_acc(dpt);
    fence_acc(st_);
    fence_acc(dpt);
    wgmma_fence();
    wgmma_a_bt(st_, kf, q_s);
    wgmma_a_bt(dpt, vf, do_s);
    wgmma_commit();
    if (kDrop) {  // made while the tensor cores work
      __syncwarp();  // the last tile's readers of the flags are done
      fill_keep_cols(flags, it * kTile, k0 + warp * 16, bh, seed, offset, threshold, lane);
      __syncwarp();
    }
    wgmma_wait<0>();
    fence_acc(st_);
    fence_acc(dpt);
    fence_acc(acc_dk);
    fence_acc(acc_dv);

#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = ls[4 * nt + t], d2 = dl[4 * nt + t];
      uint32_t w = 0;
      if (kDrop) w = reinterpret_cast<const uint32_t*>(flags)[4 * nt + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e & 1, h = e >> 1;
        const float p = fast_exp2(fmaf(st_[nt][e], c, -(j ? l2.y : l2.x) * kLog2e));
        float gr = dpt[nt][e], pd = p;
        if (kDrop) {
          const bool keep = (w >> (16 * j + 8 * h + g)) & 1u;
          gr = keep ? gr * inv_keep : 0.f;
          pd = keep ? p * inv_keep : 0.f;
        }
        st_[nt][e] = pd;
        dpt[nt][e] = p * (gr - (j ? d2.y : d2.x));
      }
    }

    uint32_t pf[4][4], dsf[4][4];
    acc_to_a_frags(pf, st_);
    acc_to_a_frags(dsf, dpt);
    fence_acc(acc_dk);
    fence_acc(acc_dv);
    wgmma_fence();
    wgmma_a_b(acc_dv, pf, do_s);
    wgmma_a_b(acc_dk, dsf, q_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_dk);
    fence_acc(acc_dv);
  }

  store_acc(head_base(dk, sdk, bh, heads), sdk.n, k0 + warp * 16, acc_dk, scale, scale,
            lane);
  store_acc(head_base(dv, sdv, bh, heads), sdv.n, k0 + warp * 16, acc_dv, 1.f, 1.f,
            lane);
}

template <bool kDrop>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                         const void* d_o, const float* lse, float* delta, void* dq,
                         void* dk, void* dv, const Strides* st, int batch, int heads,
                         int n, float scale, uint32_t seed, uint32_t offset,
                         uint32_t threshold, float inv_keep, cudaStream_t stream) {
  constexpr int kRows = kWarps * 16;
  constexpr int dq_smem = 2 * kRows * 128 + kStages * 2 * kTileBytes;
  constexpr int dkv_smem = 2 * kRows * 128 +
                           kStages * (2 * kTileBytes + 2 * kTile * (int)sizeof(float)) +
                           kWarps * kTile * (int)sizeof(uint16_t);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_wgmma_kernel<kDrop>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_dkv_wgmma_kernel<kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(d_o);
  const dim3 grid(n / kRows, batch * heads);
  attention_bwd_dq_wgmma_kernel<kDrop><<<grid, kBlock, dq_smem, stream>>>(
      qp, kp, vp, static_cast<const bf16*>(o), dop, lse, delta, static_cast<bf16*>(dq),
      st[0], st[1], st[2], st[3], st[4], st[5], heads, n, scale, seed, offset,
      threshold, inv_keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_wgmma_kernel<kDrop><<<grid, kBlock, dkv_smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      st[0], st[1], st[2], st[4], st[6], st[7], heads, n, scale, seed, offset,
      threshold, inv_keep);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- f32

constexpr int kDqSmemBytes = 5 * kTileFloats * sizeof(float) + kMaskBytes;
constexpr int kDkvSmemBytes =
    6 * kTileFloats * sizeof(float) + kMaskBytes + 2 * kTile * sizeof(float);
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
attention_delta_kernel(const float* __restrict__ d_o, const float* __restrict__ o,
                       float* __restrict__ delta, Strides sdo, Strides so, int heads,
                       int n, int rows) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* dr = head_base(d_o, sdo, row / n, heads) + (long long)(row % n) * sdo.n;
  const float* orow = head_base(o, so, row / n, heads) + (long long)(row % n) * so.n;
  float s = dr[lane] * orow[lane] + dr[lane + 32] * orow[lane + 32];
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

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_o,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                        int heads, int n, float scale, uint32_t seed, uint32_t offset,
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
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kp = head_base(k, sk, bh, heads);
  const float* vp = head_base(v, sv, bh, heads);

  load_tile(qs, head_base(q, sq, bh, heads) + (long long)q0 * sq.n, sq.n, tid);
  load_tile(dos, head_base(d_o, sdo, bh, heads) + (long long)q0 * sdo.n, sdo.n, tid);

  float row_lse[4], row_delta[4], acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t r = (size_t)bh * n + q0 + ty + 16 * a;
    row_lse[a] = lse[r];
    row_delta[a] = delta[r];
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous step's readers of ks/vs/dss/ms are done
    load_tile(ks, kp + (long long)k0 * sk.n, sk.n, tid);
    load_tile(vs, vp + (long long)k0 * sv.n, sv.n, tid);
    if (kDrop)
      fill_keep_tile(ms, seed, offset, bh, q0, k0, threshold, tid);
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

  float* dqp = head_base(dq, sdq, bh, heads);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float* row = dqp + (long long)(q0 + ty + 16 * a) * sdq.n;
#pragma unroll
    for (int b = 0; b < 4; ++b) row[tx + 16 * b] = acc[a][b] * scale;
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ d_o,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, int heads, int n,
                         float scale, uint32_t seed, uint32_t offset,
                         uint32_t threshold, float inv_keep) {
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
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const float* qp = head_base(q, sq, bh, heads);
  const float* dop = head_base(d_o, sdo, bh, heads);

  load_tile(ks, head_base(k, sk, bh, heads) + (long long)k0 * sk.n, sk.n, tid);
  load_tile(vs, head_base(v, sv, bh, heads) + (long long)k0 * sv.n, sv.n, tid);

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
    load_tile(qs, qp + (long long)q0 * sq.n, sq.n, tid);
    load_tile(dos, dop + (long long)q0 * sdo.n, sdo.n, tid);
    if (tid < kTile) {
      const size_t r = (size_t)bh * n + q0 + tid;
      ls[tid] = lse[r];
      dl[tid] = delta[r];
    }
    if (kDrop)
      fill_keep_tile(ms, seed, offset, bh, q0, k0, threshold, tid);
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

  float* dkp = head_base(dk, sdk, bh, heads);
  float* dvp = head_base(dv, sdv, bh, heads);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float* krow = dkp + (long long)(k0 + ty + 16 * a) * sdk.n;
    float* vrow = dvp + (long long)(k0 + ty + 16 * a) * sdv.n;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      krow[tx + 16 * b] = acc_dk[a][b] * scale;
      vrow[tx + 16 * b] = acc_dv[a][b];
    }
  }
}

template <bool kDrop>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* d_o, const float* lse, float* delta, void* dq,
                       void* dk, void* dv, const Strides* st, int batch, int heads,
                       int n, float scale, uint32_t seed, uint32_t offset,
                       uint32_t threshold, float inv_keep, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_kernel<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDqSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<kDrop>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(d_o);
  const int rows = batch * heads * n;
  attention_delta_kernel<<<rows / kWarpsPerBlock, kThreads, 0, stream>>>(
      dop, static_cast<const float*>(o), delta, st[4], st[3], heads, n, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kTile, batch * heads);
  attention_bwd_dq_kernel<kDrop><<<grid, kThreads, kDqSmemBytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<float*>(dq), st[0], st[1], st[2], st[4],
      st[5], heads, n, scale, seed, offset, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<kDrop><<<grid, kThreads, kDkvSmemBytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      st[0], st[1], st[2], st[4], st[6], st[7], heads, n, scale, seed, offset,
      threshold, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor-core kernels). q, k,
// v, o, d_o, dq, dk, dv: (batch, heads, n, 64) with the element strides
// strides[8][3] = {batch, head, row} in that order and a contiguous last
// dimension; bf16 rows must be 16-byte aligned. lse: contiguous (batch,
// heads, n) f32 from the forward; delta: the same shape, scratch.
// threshold, inv_keep, seed, offset: as given to the forward.
extern "C" int corrifnet_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* d_o, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv,
                                       const long long* strides, int batch,
                                       int heads, int n, int dtype, float scale,
                                       unsigned int threshold, float inv_keep,
                                       unsigned int seed, unsigned int offset,
                                       void* stream) {
  const long long bh = (long long)batch * heads;
  if (n <= 0 || n % kTile != 0 || batch <= 0 || heads <= 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const bool drop = threshold != 0;
  cudaError_t err = cudaErrorInvalidValue;
#define CORRIFNET_BWD(fn)                                                          \
  fn(q, k, v, o, d_o, l, dl, dq, dk, dv, st, batch, heads, n, scale, seed, offset, \
     threshold, inv_keep, s)
  if (dtype == 0) {
    err = drop ? CORRIFNET_BWD(launch_f32<true>) : CORRIFNET_BWD(launch_f32<false>);
  } else if (dtype == 1) {
    err = drop ? CORRIFNET_BWD(launch_wgmma<true>) : CORRIFNET_BWD(launch_wgmma<false>);
  }
#undef CORRIFNET_BWD
  return static_cast<int>(err);
}
