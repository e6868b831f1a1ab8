// The bf16 forward of the fused bottleneck convolutions on Hopper's tensor
// cores, shared by fusedconv_pw.cu (K4a, kTaps = 1) and fusedconv_c3.cu (K4c,
// kTaps = 9): one template, conv_wgmma_kernel, for
//     z = relu(round(round(x*a) + b)) (or z = x),  3x3: zero padding on z,
//     y = round(z (*) w)  with f32 accumulation,
//     s = sum_rows y, q = sum_rows y^2  from the f32 accumulator.
// The same template with kBwd true is the dx pass of the bf16 backward (K4b,
// K4d; fusedconv_wgmma_bwd.cuh): the product dz = g (*) w^T with the roles
// swapped, described after the forward below.
//
// The product is implicit over (rows, taps * ci): iteration `it` of the
// contraction is tap it % kTaps of the 64-channel chunk it / kTaps, so the
// nine taps of a chunk follow each other and share its prologue constants.
// A block owns 128 rows of y (two warpgroups of 64 rows, 16 a warp) and kBN
// of its columns (64 or 128). Per iteration:
//   - the weight slice w[tap][k0:k0+64, n0:n0+kBN] and the x rows arrive in
//     shared memory by 16-byte cp.async (zero fill past n, ci and co) in a
//     ring of three stages with one barrier a stage. x comes, for the 3x3
//     conv (kHalo), as one halo tile per chunk, the block's rows and wd + 1
//     rows on either side, loaded with the chunk's first tap and read by
//     the nine taps at their shifted rows (du * wd + dv), so x is read once
//     per chunk and not nine times; for the 1x1 conv, and for images so
//     wide that two halo tiles would leave room for one block an SM (none
//     of the model's), as one 128-row tile per iteration (shifted by the
//     tap). All are bf16 tiles of
//     128-byte rows in the 128-byte swizzle, the weight as 64-column panels
//     read through the MN-major (transposed) descriptor, so neither operand
//     is ever transposed;
//   - each warp takes its 16 x 64 A fragments by ldmatrix and makes z in
//     registers: bf16x2 multiply and add, each rounded to bf16 (mul.rn,
//     add.rn: the same bits as prologue_pre, which rounds the exact f32
//     product and sum), max with 0, then the 3x3 mask per output row and
//     tap (outside the image, which includes the flattened neighbour at
//     w = 0 and w = wd - 1, and rows of another image); z never reaches
//     shared or device memory;
//   - wgmma.mma_async m64n{kBN}k16 (bf16 in, f32 accumulators; HGMMA in the
//     SASS), four k-steps, A from registers, B from shared memory.
// Split-K (the plan's `splits` > 1, for shapes with too few tiles: the last
// stages' few rows): each split writes its f32 partial tile to scratch; the
// last split to arrive at a tile (an integer ticket) adds the partials in
// split order, so the sum and everything after it are the same bits
// whichever block finishes last. The epilogue rounds y once and takes the tile's column sums
// of y and y^2 from the f32 values: over a thread's two rows, over the eight
// row groups of a warp by shuffles, over the eight warps in order through
// shared memory, into one partial per row block. The last row block of a
// column tile (a second ticket) adds those partials in index order into
// (s, q). One launch, no float atomics: two runs give the same bits, and y
// without the statistics is the same bits as y with them (the plan does not
// depend on them). Tickets are counters that start at 0 and are set back
// to 0 by the block that takes the last ticket, so launches that share the
// counter buffer must be ordered: the caller keeps one buffer per stream.
//
// kVec false is the same kernel with element loads and stores, for ci or co
// not a multiple of 8 or operands not 16-byte aligned (no 16-byte copies
// there).
//
// kBwd (the backward's dx pass): rows are pixels, the contraction runs over
// (tap, the model's co), the columns are the model's ci. WgArgs then hold x
// = g (n, co), ci = the model's co, co = the model's ci, y = dx, and xe =
// the model's x; w is the same (taps, ci, co) array, read as B[n = ci][k =
// co] K-major (a k-step advances the descriptor by 32 bytes: no weight is
// transposed), with the tap flipped: iteration tap t reads g at the forward's
// shift of t (the halo tiles and the mask are the forward's) and w[8 - t],
// so dz(p) = sum_t g(p + shift(t)) w[8 - t]^T, the FMA kernel's g at
// p - shift(8 - t). No prologue on A. The epilogue rounds dz, recomputes
// pre = round(round(x*a) + b) from xe, a, b (prologue_pre's bits), writes dx
// = round([pre > 0] dz * a) (with a) or round(dz) (without), and takes the
// column sums (da, db) = (sum [pre > 0] dz x, sum [pre > 0] dz) through the
// same partials and tickets as (s, q). x's tile comes by one batch of
// cp.async into y's staging area, where each thread's dx pair replaces its x
// pair, and a and b of the block's columns wait in shared memory: loaded
// one by one from device memory between the shuffles, they made this
// epilogue cost more than the product at the 64-channel shapes.

#pragma once

#include "fusedconv_common.cuh"
#include "hopper_common.cuh"

namespace corrifnet_fc {

using namespace hopper;

constexpr int kWgRows = 128;     // rows of y per block: two warpgroups
constexpr int kWgThreads = 256;
constexpr int kWgStages = 3;     // depth of the cp.async ring
constexpr int kWgK = 64;         // contraction depth of one stage
constexpr int kATileBytes = kWgRows * 128;
constexpr int kPanelBytes = kWgK * 128;  // 64 k-rows x 64 columns of the weight
constexpr int kMaxSmem = 232448;         // 227 KB, the most a block may have

struct WgArgs {
  const bf16* x;     // (n, ci): pixels x channels
  const bf16* xe;    // kBwd: the model's x (n, co), for the epilogue
  const bf16* w;     // (taps, ci, co)
  const float* a;    // (ci,) prologue scale, or null
  const float* b;    // (ci,) prologue shift, or null
  bf16* y;           // (n, co)
  float* part;       // (col tiles, row blocks, 2, kBN) column partial sums, or null
  float* sq;         // (2, co) = (s, q), or null
  float* scratch;    // (tiles, splits, 128, kBN) split partial products
  int* counters;     // tickets: tiles, then col tiles; 0 on entry and on exit
  int n, ci, co;     // rows, input and output channels
  int h, wd;         // image height and width (kTaps = 9)
  int splits, per_split;  // contraction iterations per split
};

// relu(round(round(x * a) + b)) on two bf16 lanes.
__device__ __forceinline__ uint32_t prologue_bf16x2(uint32_t x, uint32_t a, uint32_t b) {
  uint32_t m, s, z;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(m) : "r"(x), "r"(a));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(s) : "r"(m), "r"(b));
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(z) : "r"(s), "r"(0u));
  return z;
}

__device__ __forceinline__ float4 add4(float4 u, float4 v) {
  return make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
}

// 16 bytes of `src` at element `e` (8 bf16): the ones with `e + i < limit`
// and `ok`, zeros elsewhere; for the element-load instantiation.
__device__ __forceinline__ uint4 gather8(const bf16* src, bool ok, int e, int limit) {
  uint16_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = (ok && e + i < limit) ? __bfloat16_as_ushort(src[i]) : (uint16_t)0;
  return make_uint4(v[0] | (uint32_t)v[1] << 16, v[2] | (uint32_t)v[3] << 16,
                    v[4] | (uint32_t)v[5] << 16, v[6] | (uint32_t)v[7] << 16);
}

// Blocks whose ticket is not the last leave; the last one resets the counter
// and goes on, seeing every earlier block's writes.
__device__ __forceinline__ bool last_to_arrive(int* counter, int arrivals, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == arrivals - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// Rows of the halo tile of a 3x3 conv: the block's 128 rows and wd + 1 on
// either side, a multiple of 8 (so that the second tile is 1024-byte aligned).
__host__ __device__ __forceinline__ int halo_rows(int wd) {
  return (kWgRows + 2 * (wd + 1) + 7) & ~7;
}

template <int kTaps, int kBN, bool kVec, bool kHalo, bool kBwd>
__global__ void __launch_bounds__(kWgThreads, 2)
conv_wgmma_kernel(WgArgs p) {
  constexpr int kN8 = kBN / 8;
  constexpr int kStageBytes = (kHalo ? 0 : kATileBytes) + kBN * 128;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned base (the swizzle and the descriptors assume it):
  // [two halo tiles (kHalo)][kWgStages x (x tile (not kHalo), weight slice)]
  // [a, b as bf16][ticket flag]
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t halo_bytes = kHalo ? halo_rows(p.wd) * 128 : 0;
  const uint32_t ring_off = 2 * halo_bytes;
  const int ci_pad = (p.ci + kWgK - 1) / kWgK * kWgK;
  bf16* ab = reinterpret_cast<bf16*>(gbase + ring_off + kWgStages * kStageBytes);
  int* flag = reinterpret_cast<int*>(ab + 2 * ci_pad);
  // kBwd with the prologue: a and b of the block's kBN columns, rounded
  float* eab = reinterpret_cast<float*>(flag + 4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb = blockIdx.x, ct = blockIdx.y, split = blockIdx.z;
  const int row0 = rb * kWgRows, col0 = ct * kBN;
  const int total = kTaps * (ci_pad / kWgK);
  const int it0 = split * p.per_split;
  const int n_it = min(total, it0 + p.per_split) - it0;
  const bool pro = !kBwd && p.a != nullptr;  // the prologue on A (forward only)

  if (kBwd && p.part != nullptr) {
    for (int k = tid; k < 2 * kBN; k += kWgThreads) {
      const int c = col0 + (k < kBN ? k : k - kBN);
      eab[k] = c < p.co ? round_to<bf16>(k < kBN ? p.a[c] : p.b[c]) : 0.f;
    }
  }
  if (pro) {
    for (int k = tid; k < ci_pad; k += kWgThreads) {
      ab[k] = __float2bfloat16(k < p.ci ? p.a[k] : 0.f);
      ab[ci_pad + k] = __float2bfloat16(k < p.ci ? p.b[k] : 0.f);
    }
  }

  // This thread's two rows of y, 16 warp + g and + 8 of the block, and where
  // they are in their image.
  const int r_lo = row0 + 16 * warp + g;
  int ph[2] = {0, 0}, pw[2] = {0, 0};
  if (kTaps > 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rem = (r_lo + 8 * i) % (p.h * p.wd);
      ph[i] = rem / p.wd;
      pw[i] = rem % p.wd;
    }
  }

  // 16 bytes of x (channels kc.., row src; 0 outside) to shared offset `off`
  auto load_x = [&](uint32_t off, int src, int kc) {
    const bool ok = (unsigned)src < (unsigned)p.n && kc < p.ci;
    const bf16* from = p.x + (ok ? (size_t)src * p.ci + kc : 0);
    if (kVec)
      cp_async16_zfill(base + off, from, ok ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(gbase + off) = gather8(from, ok, kc, p.ci);
  };
  auto load_stage = [&](int st, int it) {
    const int chunk = it / kTaps, tap = it - chunk * kTaps;
    const int k0 = chunk * kWgK;
    const uint32_t a_off = ring_off + st * kStageBytes;
    const uint32_t b_off = a_off + (kHalo ? 0 : kATileBytes);
    if (kHalo) {
      // the chunk's halo tile, once, with its first tap (or the split's
      // first iteration): the nine taps read shifted windows of it
      if (tap == 0 || it == it0) {
        const uint32_t h_off = (chunk & 1) * halo_bytes;
        for (int i = tid; i < (int)(halo_bytes >> 4); i += kWgThreads)
          load_x(h_off + tile_offset(i >> 3, i & 7), row0 - (p.wd + 1) + (i >> 3),
                 k0 + 8 * (i & 7));
      }
    } else {
      // x rows shifted by the tap: chunk c of rows tid / 8 + 32 j
      const int shift = kTaps == 1 ? 0 : (tap / 3 - 1) * p.wd + (tap % 3 - 1);
      const int c = tid & 7;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = (tid >> 3) + 32 * j;
        load_x(a_off + tile_offset(rr, c), row0 + rr + shift, k0 + 8 * c);
      }
    }
    if (kBwd) {
      // w[8 - tap] rows col0.. (the model's ci), k0.. along each row (its co):
      // kBN rows of 128 bytes, K-major
      const int wt = kTaps - 1 - tap;
#pragma unroll
      for (int i = tid; i < kBN * 8; i += kWgThreads) {
        const int n = i >> 3, c = i & 7;
        const int col = col0 + n, k = k0 + 8 * c;
        const bool ok = col < p.co && k < p.ci;
        const bf16* from = p.w + (ok ? ((size_t)wt * p.co + col) * p.ci + k : 0);
        const uint32_t off = b_off + tile_offset(n, c);
        if (kVec)
          cp_async16_zfill(base + off, from, ok ? 16 : 0);
        else
          *reinterpret_cast<uint4*>(gbase + off) = gather8(from, ok, k, p.ci);
      }
      return;
    }
    // weight rows k0.., columns col0..: 64-column panels
    constexpr int kRowChunks = kBN / 8;
#pragma unroll
    for (int i = tid; i < kWgK * kRowChunks; i += kWgThreads) {
      const int kr = i / kRowChunks, cn = i % kRowChunks;
      const int k = k0 + kr, col = col0 + 8 * cn;
      const bool ok = k < p.ci && col < p.co;
      const bf16* from = p.w + (ok ? ((size_t)tap * p.ci + k) * p.co + col : 0);
      const uint32_t off = b_off + (cn >> 3) * kPanelBytes + tile_offset(kr, cn & 7);
      if (kVec)
        cp_async16_zfill(base + off, from, ok ? 16 : 0);
      else
        *reinterpret_cast<uint4*>(gbase + off) = gather8(from, ok, col, p.co);
    }
  };

  float acc[kN8][4];
  zero_acc(acc);
#pragma unroll
  for (int st = 0; st < kWgStages - 1; ++st) {
    if (st < n_it) load_stage(st, it0 + st);
    cp_async_commit();
  }

  const uint32_t* ab32 = reinterpret_cast<const uint32_t*>(ab);
  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<kWgStages - 2>();  // stage i has landed
    fence_async_proxy();
    __syncthreads();  // for every thread, and every warp is done with stage i - 1
    if (i + kWgStages - 1 < n_it)
      load_stage((i + kWgStages - 1) % kWgStages, it0 + i + kWgStages - 1);
    cp_async_commit();

    const int it = it0 + i, chunk = it / kTaps, tap = it - chunk * kTaps;
    const uint32_t a_s = base + ring_off + (i % kWgStages) * kStageBytes;
    uint32_t af[4][4];
    if (kHalo)
      load_a_frags(af, base + (chunk & 1) * halo_bytes,
                   16 * warp + p.wd + 1 + (tap / 3 - 1) * p.wd + (tap % 3 - 1), lane);
    else
      load_a_frags(af, a_s, 16 * warp, lane);
    if (pro) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kp = (chunk * kWgK + 16 * ks + 8 * hf + 2 * t) >> 1;
          const uint32_t sa = ab32[kp], sb = ab32[(ci_pad >> 1) + kp];
          af[ks][2 * hf] = prologue_bf16x2(af[ks][2 * hf], sa, sb);
          af[ks][2 * hf + 1] = prologue_bf16x2(af[ks][2 * hf + 1], sa, sb);
        }
    }
    if (kTaps > 1) {
      // the padding is applied to z: 0 where the tap's pixel is outside the
      // image, and for rows past n
      const int du = tap / 3 - 1, dv = tap % 3 - 1;
      bool live[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        live[j] = r_lo + 8 * j < p.n && (unsigned)(ph[j] + du) < (unsigned)p.h &&
                  (unsigned)(pw[j] + dv) < (unsigned)p.wd;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live[e & 1]) af[ks][e] = 0u;
    }
    fence_acc(acc);
    wgmma_fence();
    const uint32_t b_s = a_s + (kHalo ? 0 : kATileBytes);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (kBwd)
        Wgmma<kBN>::template run<0>(acc, af[ks], wgmma_desc(b_s + 32 * ks));
      else
        Wgmma<kBN>::template run<1>(acc, af[ks],
                                    wgmma_desc(b_s + 2048 * ks, kPanelBytes));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
  cp_async_wait<0>();

  const int tile = rb * gridDim.y + ct;
  const int rl = 16 * warp + g;  // the thread's first row within the block
  if (p.splits > 1) {
    float* mine = p.scratch + ((size_t)tile * p.splits + split) * kWgRows * kBN;
#pragma unroll
    for (int nt = 0; nt < kN8; ++nt) {
      const int cc = 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(mine + rl * kBN + cc) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(mine + (rl + 8) * kBN + cc) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
    if (!last_to_arrive(p.counters + tile, p.splits, flag)) return;
    const float* all = p.scratch + (size_t)tile * p.splits * kWgRows * kBN;
    for (int s = 0; s < p.splits; ++s) {
      const float* part = all + (size_t)s * kWgRows * kBN;
#pragma unroll
      for (int nt = 0; nt < kN8; ++nt) {
        const int cc = 8 * nt + 2 * t;
        const float2 lo = __ldcg(reinterpret_cast<const float2*>(part + rl * kBN + cc));
        const float2 hi = __ldcg(reinterpret_cast<const float2*>(part + (rl + 8) * kBN + cc));
        if (s == 0) {
          acc[nt][0] = lo.x; acc[nt][1] = lo.y; acc[nt][2] = hi.x; acc[nt][3] = hi.y;
        } else {
          acc[nt][0] += lo.x; acc[nt][1] += lo.y; acc[nt][2] += hi.x; acc[nt][3] += hi.y;
        }
      }
    }
  }

  const bool in_lo = r_lo < p.n, in_hi = r_lo + 8 < p.n;
  constexpr int kYStride = kBN * 2 + 16;  // bytes: the pair stores meet no conflict
  // [2][8 warps][kBN] per-warp column sums, after y's staging area; the tiles
  // are free
  float* red = reinterpret_cast<float*>(gbase + kWgRows * kYStride);
  // kBwd with the prologue and 16-byte rows: x's tile of the block's rows
  // and columns arrives in y's staging area, where each thread's dx then
  // replaces its x pair
  const bool staged = kBwd && kVec && p.part != nullptr;
  // the block's column sums, over a thread's two rows, then over the eight
  // row groups of a warp by shuffles, into red: forward (s, q) = (y, y^2)
  // from the f32 values; backward (da, db) = (dpre x, dpre), and acc becomes dx
  auto column_sums = [&]() {
#pragma unroll
    for (int nt = 0; nt < kN8; ++nt) {
      float s[2], q[2];
      if (kBwd) {
        const int cl = 8 * nt + 2 * t;  // the pair's first column in the block
        s[0] = s[1] = q[0] = q[1] = 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const bool row_in = hf ? in_hi : in_lo;
          float xv[2];
          uint32_t* pair =
              reinterpret_cast<uint32_t*>(gbase + (rl + 8 * hf) * kYStride + 2 * cl);
          if (staged) {
            const uint32_t x2 = *pair;
            xv[0] = __uint_as_float(x2 << 16);
            xv[1] = __uint_as_float(x2 & 0xffff0000u);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = row_in && col0 + cl + e < p.co;
            if (!staged) {
              const size_t at = (size_t)(r_lo + 8 * hf) * p.co + col0 + cl + e;
              xv[e] = live ? __bfloat162float(p.xe[at]) : 0.f;
            }
            const float ca = eab[cl + e], cb = eab[kBN + cl + e];
            const float dz = round_to<bf16>(acc[nt][2 * hf + e]);  // rounded before the mask
            const float dpre = live && prologue_pre<bf16>(xv[e], ca, cb) > 0.f ? dz : 0.f;
            acc[nt][2 * hf + e] = __fmul_rn(dpre, ca);  // dx, rounded by the store
            s[e] += dpre * xv[e];
            q[e] += dpre;
          }
          if (staged) *pair = pack_bf16(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lo = in_lo ? acc[nt][e] : 0.f, hi = in_hi ? acc[nt][2 + e] : 0.f;
          s[e] = lo + hi;
          q[e] = lo * lo + hi * hi;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s[e] += __shfl_xor_sync(0xffffffffu, s[e], m);
          q[e] += __shfl_xor_sync(0xffffffffu, q[e], m);
        }
        if (g == 0) {
          red[warp * kBN + 8 * nt + 2 * t + e] = s[e];
          red[(8 + warp) * kBN + 8 * nt + 2 * t + e] = q[e];
        }
      }
    }
  };
  // the backward's sums make dx, so they come before the store; the
  // forward's come after it, so that y's stores drain while they run (not
  // under the ticket's fence)
  if (kBwd && p.part != nullptr) {
    __syncthreads();  // every warp is done with the tiles
    if (staged) {
      constexpr int kRowChunks = kBN / 8;
      for (int i = tid; i < kWgRows * kRowChunks; i += kWgThreads) {
        const int r = i / kRowChunks, c = i % kRowChunks;
        const int row = row0 + r, col = col0 + 8 * c;
        const bool ok = row < p.n && col < p.co;
        cp_async16_zfill(base + r * kYStride + 16 * c,
                         p.xe + (ok ? (size_t)row * p.co + col : 0), ok ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    column_sums();
  }

  // y (dx), rounded once; with 16-byte rows it goes through shared memory
  // (dx is there already when staged) and leaves in 16-byte stores
  if (kVec) {
    constexpr int kRowChunks = kBN / 8;
    __syncthreads();
    if (!staged) {
#pragma unroll
      for (int nt = 0; nt < kN8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(gbase + (rl + 8 * hf) * kYStride + 2 * (8 * nt + 2 * t)) =
              pack_bf16(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      __syncthreads();
    }
    for (int i = tid; i < kWgRows * kRowChunks; i += kWgThreads) {
      const int r = i / kRowChunks, c = i % kRowChunks;
      const int row = row0 + r, col = col0 + 8 * c;
      if (row < p.n && col < p.co)
        *reinterpret_cast<uint4*>(p.y + (size_t)row * p.co + col) =
            *reinterpret_cast<const uint4*>(gbase + r * kYStride + 16 * c);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < kN8; ++nt) {
      const int c = col0 + 8 * nt + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (!(hf ? in_hi : in_lo)) continue;
        bf16* dst = p.y + (size_t)(r_lo + 8 * hf) * p.co + c;
        if (c < p.co) dst[0] = __float2bfloat16(acc[nt][2 * hf]);
        if (c + 1 < p.co) dst[1] = __float2bfloat16(acc[nt][2 * hf + 1]);
      }
    }
  }
  if (p.part == nullptr) return;
  if (!kBwd) {
    __syncthreads();  // every warp is done with the tiles
    column_sums();
  }

  // over the eight warps in order, into the block's partial
  __syncthreads();
  const int row_blocks = gridDim.x;
  float* mine = p.part + ((size_t)ct * row_blocks + rb) * 2 * kBN;
  for (int v = tid; v < 2 * kBN; v += kWgThreads) {
    const int which = v / kBN, c = v % kBN;
    float total = red[(8 * which) * kBN + c];
#pragma unroll
    for (int w8 = 1; w8 < 8; ++w8) total += red[(8 * which + w8) * kBN + c];
    mine[v] = total;
  }
  if (!last_to_arrive(p.counters + gridDim.x * gridDim.y + ct, row_blocks, flag)) return;

  // (s, q) of the column tile: the row blocks' partials in index order, as
  // kSlots strided partial sums of float4 columns, then the slots in order
  constexpr int kCols4 = 2 * kBN / 4;
  constexpr int kSlots = kWgThreads / kCols4;
  float4* red4 = reinterpret_cast<float4*>(red);  // [kSlots][kCols4]
  const int c4 = tid % kCols4, slot = tid / kCols4;
  const float4* src = reinterpret_cast<const float4*>(p.part + (size_t)ct * row_blocks * 2 * kBN);
  float4 sum4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int r = slot; r < row_blocks; r += kSlots)
    sum4 = add4(sum4, __ldcg(src + (size_t)r * kCols4 + c4));
  red4[slot * kCols4 + c4] = sum4;
  __syncthreads();
  if (tid < kCols4) {
    float4 tot = red4[tid];
#pragma unroll
    for (int s = 1; s < kSlots; ++s) tot = add4(tot, red4[s * kCols4 + tid]);
    const float vals[4] = {tot.x, tot.y, tot.z, tot.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = 4 * tid + j, which = v / kBN, col = col0 + v % kBN;
      if (col < p.co) p.sq[which * p.co + col] = vals[j];
    }
  }
}

template <int kTaps, int kBN, bool kVec, bool kHalo, bool kBwd>
cudaError_t launch_wgmma_t(const WgArgs& p, size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_wgmma_kernel<kTaps, kBN, kVec, kHalo, kBwd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(ceil_div(p.n, kWgRows), ceil_div(p.co, kBN), p.splits);
  conv_wgmma_kernel<kTaps, kBN, kVec, kHalo, kBwd><<<grid, kWgThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The 3x3 conv reads x through halo tiles where two of them and the weight
// ring leave room for two blocks an SM, else (images too wide for that:
// more than about 60 pixels at 128 columns, 110 at 64) through a shifted x
// tile per tap; the 1x1 conv through an x tile per iteration.
template <int kTaps, int kBN, bool kVec, bool kBwd>
cudaError_t launch_wgmma_n(const WgArgs& p, cudaStream_t stream) {
  // alignment slack, a and b as bf16 pairs, the ticket flag, kBwd's a and b
  const size_t fixed =
      1024 + 4 * (size_t)ceil_div(p.ci, kWgK) * kWgK + 16 + (kBwd ? 8 * kBN : 0);
  const size_t ring = (size_t)kWgStages * kBN * 128;
  if constexpr (kTaps > 1) {
    const size_t halo = 2 * (size_t)halo_rows(p.wd) * 128 + ring + fixed;
    if (halo <= (size_t)kMaxSmem / 2)
      return launch_wgmma_t<kTaps, kBN, kVec, true, kBwd>(p, halo, stream);
  }
  const size_t smem = (size_t)kWgStages * kATileBytes + ring + fixed;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return launch_wgmma_t<kTaps, kBN, kVec, false, kBwd>(p, smem, stream);
}

// The bf16 forward (or, kBwd, the backward's dx pass): checks the plan
// (block_n columns a block; `splits` splits of `per_split` contraction
// iterations each, every split holding at least one) and picks the
// instantiation.
template <int kTaps, bool kBwd = false>
cudaError_t launch_forward_wgmma(WgArgs p, int block_n, cudaStream_t stream) {
  const long long total = (long long)kTaps * ceil_div(p.ci, kWgK);
  const long long tiles = (long long)ceil_div(p.n, kWgRows) * ceil_div(p.co, block_n);
  if (p.splits < 1 || p.per_split < 1 || p.splits > 65535 ||
      (long long)p.splits * p.per_split < total ||
      (long long)(p.splits - 1) * p.per_split >= total ||
      ceil_div(p.co, block_n) > 65535 || (p.splits > 1 && p.scratch == nullptr) ||
      (p.sq != nullptr && p.part == nullptr) || p.counters == nullptr ||
      tiles * p.splits > (1LL << 31) || (kTaps > 1 && p.a == nullptr) ||
      (kBwd && p.sq != nullptr && (p.a == nullptr || p.xe == nullptr)))
    return cudaErrorInvalidValue;
  const bool vec = p.ci % 8 == 0 && p.co % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.w) |
                     reinterpret_cast<uintptr_t>(p.y) | reinterpret_cast<uintptr_t>(p.xe)) &
                    15) == 0;
  switch (block_n) {
    case 64:
      return vec ? launch_wgmma_n<kTaps, 64, true, kBwd>(p, stream)
                 : launch_wgmma_n<kTaps, 64, false, kBwd>(p, stream);
    case 128:
      return vec ? launch_wgmma_n<kTaps, 128, true, kBwd>(p, stream)
                 : launch_wgmma_n<kTaps, 128, false, kBwd>(p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace corrifnet_fc
