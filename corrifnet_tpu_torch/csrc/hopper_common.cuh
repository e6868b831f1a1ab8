// The Hopper (sm_90a) building blocks of the port's bf16 tensor-core kernels,
// shared by the attention kernels (attention_common.cuh) and the fused
// bottleneck convolutions (fusedconv_common.cuh): 16-byte cp.async with
// zero fill, bf16 shared tiles of 128-byte rows in the 128-byte swizzle,
// ldmatrix (plain and transposed) for A fragments, bf16 packing, the wgmma
// shared-memory matrix descriptor, and wgmma.mma_async with bf16 operands,
// the A operand in registers and f32 accumulators (m64n64k16, m64n128k16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// The same copy of the first `bytes` (0 or 16) bytes of src, the rest of the
// 16 filled with zeros: `bytes` 0 reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same four 8x8 matrices, each transposed on the way: lane (g, t) gets
// elements (rows 2t, 2t + 1; column g) of the matrix as stored, so a tile
// stored [k][m] gives A fragments (m, k) (the low half the lower k).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two f32 rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte offset of the 16-byte chunk `c` (8 bf16) of row `r` in a shared tile
// of 128-byte rows, 1024-byte aligned. The chunk index is XORed with the row:
// this is the 128-byte swizzle that a wgmma descriptor of layout type 1
// expects, and it spreads the eight rows an ldmatrix reads over all banks.
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// The A fragments (16 rows x 64 deep: four k-steps) of rows row0.. of a
// tile of 128-byte rows: lane (g = lane / 4, t = lane % 4) gets, for k-step
// ks, f[ks][0] = (row g, k 16 ks + 2 t, + 1), f[ks][1] = (row g + 8, same k),
// f[ks][2] = (row g, k 16 ks + 8 + 2 t, + 1), f[ks][3] = (row g + 8, same k).
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4], uint32_t tile,
                                             int row0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(f[ks], tile + tile_offset(row0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// Shared-memory matrix descriptor of a B operand tile of 128-byte rows in the
// 128-byte swizzle (tile_offset's layout, the tile 1024-byte aligned):
// start address, stride 1024 bytes between groups of eight rows, layout
// type 1. It serves both a tile stored [n][k] (K-major, no transpose: a
// k-step of 16 advances the start by 32 bytes) and one stored [k][n]
// (MN-major, transposed: a k-step advances it by 16 rows, 2048 bytes). An
// MN-major operand wider than 64 columns is stored as 64-column panels of
// that layout, `panel_bytes` apart: the leading-dimension byte offset.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr,
                                               uint32_t panel_bytes = 16) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(panel_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving uses of an accumulator across the
// asynchronous products that write it.
template <int kN8>
__device__ __forceinline__ void fence_acc(float (&d)[kN8][4]) {
#pragma unroll
  for (int nt = 0; nt < kN8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[nt][e])::"memory");
}

template <int kN8>
__device__ __forceinline__ void zero_acc(float (&acc)[kN8][4]) {
#pragma unroll
  for (int nt = 0; nt < kN8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// After cp.async.wait_group and before the barrier: the copies went through
// the generic proxy, wgmma reads shared memory through the async proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One asynchronous warpgroup product, Wgmma<N>::run<kTransB>(d, a, desc):
// d (64 x N f32; this warp's 16 rows, lane (g, t) holding d[nt][0..1] =
// row g, columns 8 nt + 2 t, + 1 and d[nt][2..3] = row g + 8, same columns)
// += a (this warp's 16 x 16 bf16 A registers, load_a_frags's layout) * B
// (16 deep x N wide bf16 in shared memory through `desc`; kTransB 1 when
// the tile is stored [k][n]). The caller fences before and commits and
// waits after.
template <int kN>
struct Wgmma;

template <>
struct Wgmma<64> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTransB), "n"(1));
  }
};

template <>
struct Wgmma<128> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[16][4], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTransB), "n"(1));
  }
};

}  // namespace hopper
