// Shared by attention_fwd.cu and attention_bwd.cu: the tiling constants, the
// strided operand addressing, the Philox4x32-10 dropout mask, and the tile
// loads and products of the bf16 tensor-core kernels (a cp.async ring of
// 64 x 64 tiles, accumulators as A fragments of the next product).
//
// The dropout mask is a pure function of (seed, offset, batch*head, query
// row, key column): Philox4x32-10 with key (seed, offset) and counter
// (column / 4, row, batch*head, 0) gives four 32-bit words, word j deciding
// column 4*(column/4) + j; an entry is kept when its word >= threshold, with
// threshold = rate * 2^32. Rows and columns are absolute, so the forward and
// both backward passes regenerate the same mask whatever their tiling, and
// no mask ever reaches device memory. ops/attention.py::philox_keep_mask is
// the same function in plain PyTorch. Three device functions lay the flags
// out for their callers: fill_keep_tile (a 64x64 byte tile in shared memory,
// the f32 kernels), keep_bits_rows (a warp's 16 query rows x 64 keys as two
// registers, the bf16 forward and dq pass) and fill_keep_cols (a warp's 16
// keys x 64 query rows as 16-bit words, the bf16 dk/dv pass). The Hopper
// building blocks under them (cp.async, the swizzle, ldmatrix, the wgmma
// descriptor and products) are in hopper_common.cuh, shared with the fused
// convolutions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace corrifnet {

using namespace hopper;

constexpr int kD = 64;         // head_dim
constexpr int kTile = 64;      // rows of a key tile (and of an f32 query tile)
constexpr int kThreads = 256;  // f32 kernels: 16 x 16 threads, each a 4x4 block
constexpr int kPad = kD + 1;   // f32 kernels: padded shared row stride
constexpr int kTileFloats = kTile * kPad;
constexpr int kMaskBytes = kTile * kTile;  // one keep flag per tile entry

// Element strides of batch, head and row of a (B, H, N, 64) operand whose
// last dimension is contiguous.
struct Strides {
  long long b, h, n;
};

template <typename T>
__device__ __forceinline__ T* head_base(T* p, const Strides& s, int bh, int heads) {
  return p + (long long)(bh / heads) * s.b + (long long)(bh % heads) * s.h;
}

// A (kTile, kD) f32 tile with row stride `rs` into padded f32 shared memory.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long rs, int tid) {
  for (int e = tid; e < kTile * kD; e += kThreads)
    dst[(e / kD) * kPad + (e % kD)] = src[(e / kD) * rs + (e % kD)];
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    // one 32 x 32 -> 64 bit multiply gives both halves
    const uint64_t p0 = (uint64_t)0xD2511F53u * c.x, p1 = (uint64_t)0xCD9E8D57u * c.z;
    c = make_uint4((uint32_t)(p1 >> 32) ^ c.y ^ k0, (uint32_t)p1,
                   (uint32_t)(p0 >> 32) ^ c.w ^ k1, (uint32_t)p0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// Keep flags (1 keep, 0 drop) of the tile whose first entry is (row0, col0),
// into ms[r * kTile + c]. All 256 threads call it; each makes 4 Philox calls
// (row tid/16 + 16*i, column group tid%16) and stores 4 flags per call.
__device__ __forceinline__ void fill_keep_tile(uint8_t* ms, uint32_t seed,
                                               uint32_t offset, uint32_t bh,
                                               int row0, int col0,
                                               uint32_t threshold, int tid) {
  const int g = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 4) + 16 * i;
    const uint4 w = philox4x32_10(
        make_uint4((uint32_t)(col0 >> 2) + g, (uint32_t)(row0 + r), bh, 0u), seed,
        offset);
    reinterpret_cast<uchar4*>(ms)[r * (kTile / 4) + g] =
        make_uchar4(w.x >= threshold, w.y >= threshold, w.z >= threshold,
                    w.w >= threshold);
  }
}

// One Philox call as four keep bits: bit j is column 4*group + j of `row`.
__device__ __forceinline__ uint32_t keep_nibble(uint32_t group, uint32_t row,
                                                uint32_t bh, uint32_t seed,
                                                uint32_t offset, uint32_t threshold) {
  const uint4 w = philox4x32_10(make_uint4(group, row, bh, 0u), seed, offset);
  return (uint32_t)(w.x >= threshold) | ((uint32_t)(w.y >= threshold) << 1) |
         ((uint32_t)(w.z >= threshold) << 2) | ((uint32_t)(w.w >= threshold) << 3);
}

// Keep bits of a warp's 16 x 64 score tile (rows row0.., columns col0..) in
// the wgmma accumulator layout: lane (g = lane / 4, t = lane % 4) owns rows g
// and g + 8 and, in each 8-column group nt, columns 8 nt + 2 t + e. On
// return bit 4 nt + e of `lo` is entry (g, 8 nt + 2 t + e) and of `hi` entry
// (g + 8, same column). A lane and its neighbour lane ^ 1 own the two halves
// of the same four-column Philox groups, so the even lane makes the calls of
// row g, the odd lane those of row g + 8, and one shuffle exchanges them:
// eight calls a lane, none made twice.
__device__ __forceinline__ void keep_bits_rows(uint32_t& lo, uint32_t& hi,
                                               uint32_t row0, uint32_t col0,
                                               uint32_t bh, uint32_t seed,
                                               uint32_t offset, uint32_t threshold,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3, odd = t & 1;
  const uint32_t row = row0 + g + (odd << 3);
  const uint32_t group = (col0 >> 2) + (t >> 1);
  uint32_t mine = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    mine |= keep_nibble(group + 2 * nt, row, bh, seed, offset, threshold) << (4 * nt);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  lo = (odd ? other : mine) >> (2 * odd);
  hi = (odd ? mine : other) >> (2 * odd);
}

// Keep bits of a warp's 16 key columns col0.. against the 64 query rows
// row0..: flags[q] bit j is entry (row0 + q, col0 + j). Each lane makes the
// four calls of rows lane and lane + 32. The caller puts __syncwarp() around
// it (before: the last readers are done; after: the flags are visible).
__device__ __forceinline__ void fill_keep_cols(uint16_t* flags, uint32_t row0,
                                               uint32_t col0, uint32_t bh,
                                               uint32_t seed, uint32_t offset,
                                               uint32_t threshold, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = lane + 32 * half;
    uint32_t m = 0;
#pragma unroll
    for (int kg = 0; kg < 4; ++kg)
      m |= keep_nibble((col0 >> 2) + kg, row0 + q, bh, seed, offset, threshold)
           << (4 * kg);
    flags[q] = (uint16_t)m;
  }
}

// ------------------------------------------------ bf16 tensor-core kernels

constexpr int kTileBytes = kTile * kD * 2;  // a 64 x 64 bf16 tile
constexpr int kStages = 3;                  // depth of the cp.async ring
constexpr int kWarps = 4;                   // a block is one warpgroup
constexpr int kBlock = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the special-function unit (ex2.approx: relative error 2^-22, 0 for
// x = -inf), without the range handling of exp2f.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Asynchronous copy of `rows` rows of 64 bf16 (row stride `rs` elements in
// device memory) into a swizzled shared tile, 16 bytes a request.
__device__ __forceinline__ void load_rows_async(uint32_t dst, const bf16* src,
                                                long long rs, int rows, int tid) {
  for (int i = tid; i < rows * 8; i += kBlock) {
    const int r = i >> 3, c = i & 7;
    cp_async16(dst + tile_offset(r, c), src + r * rs + c * 8);
  }
}

// Tile `tile` (64 rows) of two operands that are walked together (k and v,
// or q and dO) into stage `st` of a ring of tile pairs at `ring`.
__device__ __forceinline__ void load_pair_async(uint32_t ring, int st, const bf16* a,
                                                long long sa, const bf16* b,
                                                long long sb, int tile, int tid) {
  const uint32_t dst = ring + st * 2 * kTileBytes;
  load_rows_async(dst, a + (long long)tile * kTile * sa, sa, kTile, tid);
  load_rows_async(dst + kTileBytes, b + (long long)tile * kTile * sb, sb, kTile, tid);
}

// A 16 x 64 f32 accumulator, rounded to bf16, as the A fragments of the next
// product: the accumulator layout of column groups 2 j and 2 j + 1 is the A
// register layout of k-step j, so the values never leave the registers.
__device__ __forceinline__ void acc_to_a_frags(uint32_t (&a)[4][4],
                                               const float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// A warp's 16 x 64 accumulator times `mul`, rounded to bf16, to rows row0 +
// g and row0 + g + 8 of `dst` (row stride `rs`): 4-byte stores.
__device__ __forceinline__ void store_acc(bf16* dst, long long rs, int row0,
                                          const float (&acc)[8][4], float mul_lo,
                                          float mul_hi, int lane) {
  const int g = lane >> 2, t = lane & 3;
  bf16* lo = dst + (long long)(row0 + g) * rs + 2 * t;
  bf16* hi = lo + 8 * rs;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<uint32_t*>(lo + 8 * nt) =
        pack_bf16(acc[nt][0] * mul_lo, acc[nt][1] * mul_lo);
    *reinterpret_cast<uint32_t*>(hi + 8 * nt) =
        pack_bf16(acc[nt][2] * mul_hi, acc[nt][3] * mul_hi);
  }
}

// acc (this warp's 16 of the warpgroup's 64 rows x 64) += a (16 x 64 deep, in
// registers) * tile^T, the tile stored [n][k]: starts the four k-steps; the
// caller fences before and commits and waits after.
__device__ __forceinline__ void wgmma_a_bt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                           uint32_t tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) Wgmma<64>::run<0>(acc, a[ks], wgmma_desc(tile + 32 * ks));
}

// The same with the tile stored [k][n], its 64 rows summed over.
__device__ __forceinline__ void wgmma_a_b(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                          uint32_t tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    Wgmma<64>::run<1>(acc, a[ks], wgmma_desc(tile + 2048 * ks));
}

}  // namespace corrifnet
