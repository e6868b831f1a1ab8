// Shared by attention_fwd.cu and attention_bwd.cu: the tiling constants, the
// f32 <-> storage conversions, and the Philox4x32-10 dropout mask.
//
// The dropout mask is a pure function of (seed, offset, batch*head, query
// row, key column): Philox4x32-10 with key (seed, offset) and counter
// (column / 4, row, batch*head, 0) gives four 32-bit words, word j deciding
// column 4*(column/4) + j; an entry is kept when its word >= threshold, with
// threshold = rate * 2^32. Rows and columns are absolute, so the forward and
// both backward passes regenerate the same mask whatever their tiling, and
// no mask ever reaches device memory. ops/attention.py::philox_keep_mask is
// the same function in plain PyTorch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace corrifnet {

constexpr int kD = 64;         // head_dim
constexpr int kTile = 64;      // rows of a query tile == rows of a key tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4x4 register block
constexpr int kPad = kD + 1;   // padded shared row stride (no bank conflicts)
constexpr int kTileFloats = kTile * kPad;
constexpr int kMaskBytes = kTile * kTile;  // one keep flag per tile entry

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

// A contiguous (kTile, kD) tile of global memory into padded f32 shared memory.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int tid) {
  for (int e = tid; e < kTile * kD; e += kThreads)
    dst[(e / kD) * kPad + (e % kD)] = to_f32(src[e]);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
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

}  // namespace corrifnet
