// The bf16 backward of the fused bottleneck convolutions on Hopper's tensor
// cores, shared by fusedconv_pw.cu (K4b, kTaps = 1) and fusedconv_c3.cu (K4d,
// kTaps = 9). From x, w, a, b, y, dy, ds, dq it computes
//     g = round(dy + ds + 2 dq y)                      (out_cotangent's bits)
//     dz = sum_tap g_shift(flipped tap) w[tap]^T       (f32 sums, then rounded)
//     dx = round([pre > 0] dz a), da = sum [pre > 0] dz x, db = sum [pre > 0] dz
//     dw[tap] = z_shift(tap)^T g                       (f32 sums, then cast)
// in three launches, each one pass with its sums folded in by tickets:
//   1. cotangent_kernel writes g once, bf16 (n, co): both products read it
//      (the dx pass at shifted rows through halo tiles, the dw pass per
//      tap), which costs one write and two reads of n * co bf16 against two
//      reads of dy and y for each product when g is made on the load;
//   2. the dx pass: conv_wgmma_kernel with kBwd (fusedconv_wgmma.cuh), the
//      forward's implicit product with the roles swapped, its column sums
//      (da, db) and its split-K partials added by the last block to take a
//      ticket;
//   3. the dw pass: wgrad_wgmma_kernel, a product over the rows (M = ci,
//      N = co, K = pixels), one tap a block (the grid's z runs over taps and
//      splits of the rows).
// No float atomics and no second reduction launch: two runs, and calls on
// two streams (each with its own counters), give the same bits.
//
// The dw pass. A block owns 64 channels of x (rows of dw, one warpgroup of
// four warps, 16 rows a warp) by 64 channels of g, for one tap, over its
// split's stages of 64 pixels (128 channels of g measured slower at every
// shape of the model: scripts/bench_torch_fusedconv.py, PERF.md). Per stage, by 16-byte cp.async
// (zero fill) in a ring of four stages with one barrier a stage:
//   - the x tile [64 pixels][64 channels], the pixels shifted by the tap
//     (0 outside the rows), in the 128-byte swizzle; each warp takes its A
//     fragments zT (16 channels x 16 pixels a k-step) with ldmatrix.trans
//     and applies the prologue in registers: a and b are per channel, so per
//     fragment row, one bf16 pair broadcast to both halves (mul.rn, add.rn,
//     max: prologue_pre's bits);
//   - the g tile [64 pixels][64 channels] read through the MN-major
//     descriptor (as the forward reads a panel of its weight). The 3x3
//     padding is the mask of a pixel p and tap: z(p + shift) counts only
//     where that pixel lies in p's image. It is applied to g, on the load
//     (a zero-filled copy where the tap's pixel is outside p's image, and
//     for rows past n), so x needs no mask: its rows past n or across a seam
//     meet zeros of g. Each thread loads four pixel rows a stage and keeps
//     their (h, w) from stage to stage, without a division.
// Split-K over the rows: each split writes its f32 tile to scratch; the last
// split of a group of `group` splits to take a ticket adds the group's
// partials in index order; with more than one group the last group to take
// a second ticket adds the groups' sums in index order. So the sum is the
// same bits whichever block finishes last, and no block reads more than
// max(group, groups) tiles back. The last writes dw (bf16).
//
// kVec false: the same kernels with element loads and stores, for channels
// that are not a multiple of 8 or operands not 16-byte aligned.

#pragma once

#include "fusedconv_common.cuh"
#include "fusedconv_wgmma.cuh"
#include "hopper_common.cuh"

namespace corrifnet_fc {

constexpr int kDwThreads = 128;  // one warpgroup
constexpr int kDwM = 64;         // channels of x (rows of dw) a block
constexpr int kDwN = 64;         // channels of g (columns of dw) a block
constexpr int kDwK = 64;         // pixels a stage
constexpr int kDwStages = 4;     // depth of the cp.async ring
constexpr int kGThreads = 256;

// g = round(dy + ds + 2 dq y), 8 values a thread (kVec) or one. kTaps only
// names the instantiation, so that a profile tells K4b's pass from K4d's.
template <int kTaps, bool kVec>
__global__ void __launch_bounds__(kGThreads)
cotangent_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ y,
                 const float* __restrict__ ds, const float* __restrict__ dq,
                 bf16* __restrict__ g, long long total, int co) {
  const long long i = (long long)blockIdx.x * kGThreads + threadIdx.x;
  if (kVec) {
    const long long e = 8 * i;
    if (e >= total) return;
    const int c = (int)(e % co);
    const uint4 dv = *reinterpret_cast<const uint4*>(dy + e);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + e);
    const uint32_t d32[4] = {dv.x, dv.y, dv.z, dv.w}, y32[4] = {yv.x, yv.y, yv.z, yv.w};
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = c + 2 * j + h;
        const float dyf = __uint_as_float((h ? d32[j] >> 16 : d32[j] & 0xffffu) << 16);
        const float yf = __uint_as_float((h ? y32[j] >> 16 : y32[j] & 0xffffu) << 16);
        r[h] = out_cotangent<bf16>(dyf, yf, ds[cc], 2.f * dq[cc]);
      }
      out[j] = pack_bf16(r[0], r[1]);  // exact: r is already a bf16 value
    }
    *reinterpret_cast<uint4*>(g + e) = make_uint4(out[0], out[1], out[2], out[3]);
  } else {
    if (i >= total) return;
    const int c = (int)(i % co);
    g[i] = __float2bfloat16(out_cotangent<bf16>(__bfloat162float(dy[i]),
                                                __bfloat162float(y[i]), ds[c], 2.f * dq[c]));
  }
}

struct DwArgs {
  const bf16* x;     // (n, ci)
  const bf16* g;     // (n, co)
  const float* a;    // (ci,) prologue scale, or null
  const float* b;    // (ci,) prologue shift, or null
  bf16* dw;          // (taps, ci, co)
  float* scratch;    // (tiles, splits, 64, 64) then (tiles, groups, 64, 64)
  int* counters;     // tickets: tiles * groups, then tiles; 0 on entry and on exit
  int n, ci, co;     // rows, input and output channels
  int h, wd;         // image height and width (kTaps = 9)
  int splits, per_split, group;  // stages of 64 pixels a split; splits a group
};

template <int kTaps, bool kVec>
__global__ void __launch_bounds__(kDwThreads)
wgrad_wgmma_kernel(DwArgs p) {
  constexpr int kN8 = kDwN / 8;
  constexpr int kXBytes = kDwK * 128;
  constexpr int kStageBytes = 2 * kXBytes;  // the x tile and the g tile
  constexpr int kTile = kDwM * kDwN;  // floats of one partial tile
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned base: [kDwStages x (x tile, g tile)][ticket flag]
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  int* flag = reinterpret_cast<int*>(gbase + kDwStages * kStageBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kDwM, n0 = blockIdx.y * kDwN;
  const int tap = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int du = kTaps == 1 ? 0 : tap / 3 - 1, dv = kTaps == 1 ? 0 : tap % 3 - 1;
  const int shift = du * p.wd + dv;
  const int it0 = split * p.per_split;
  const int n_it = min((p.n + kDwK - 1) / kDwK, it0 + p.per_split) - it0;

  // the prologue constants of this thread's two channels (fragment rows g
  // and g + 8), rounded to bf16 and broadcast to both halves
  const bool pro = p.a != nullptr;
  uint32_t pa[2] = {0u, 0u}, pb[2] = {0u, 0u};
  if (pro) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = m0 + 16 * warp + g + 8 * i;
      const uint32_t ua = __bfloat16_as_ushort(__float2bfloat16(c < p.ci ? p.a[c] : 0.f));
      const uint32_t ub = __bfloat16_as_ushort(__float2bfloat16(c < p.ci ? p.b[c] : 0.f));
      pa[i] = ua | ua << 16;
      pb[i] = ub | ub << 16;
    }
  }

  // this thread's pixel rows of a stage, (tid / 8) + 16 j, and where the
  // next stage's are in their image (kTaps = 9), advanced a stage at a time
  int ph[4] = {0, 0, 0, 0}, pw[4] = {0, 0, 0, 0};
  const int step_h = kDwK / max(p.wd, 1), step_w = kDwK % max(p.wd, 1);
  if (kTaps > 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rem = (it0 * kDwK + (tid >> 3) + 16 * j) % (p.h * p.wd);
      ph[j] = rem / p.wd;
      pw[j] = rem % p.wd;
    }
  }

  auto load16 = [&](uint32_t off, const bf16* src, bool ok, int e, int limit) {
    if (kVec)
      cp_async16_zfill(base + off, src, ok ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(gbase + off) = gather8(src, ok, e, limit);
  };
  auto load_stage = [&](int st, int it) {
    const uint32_t x_off = st * kStageBytes, g_off = x_off + kXBytes;
    const int c = tid & 7;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = (tid >> 3) + 16 * j, pix = it * kDwK + rr;
      // x: the tap's pixel, channels m0 + 8c..
      const int src = pix + shift, xc = m0 + 8 * c;
      const bool okx = (unsigned)src < (unsigned)p.n && xc < p.ci;
      load16(x_off + tile_offset(rr, c), p.x + (okx ? (size_t)src * p.ci + xc : 0), okx,
             xc, p.ci);
      // g: pixel pix, 0 past n and where the tap's pixel is outside pix's image
      bool okg = pix < p.n;
      if (kTaps > 1) {
        okg = okg && (unsigned)(ph[j] + du) < (unsigned)p.h &&
              (unsigned)(pw[j] + dv) < (unsigned)p.wd;
        pw[j] += step_w;
        const int carry = pw[j] >= p.wd;
        pw[j] -= carry ? p.wd : 0;
        ph[j] += step_h + carry;
        while (ph[j] >= p.h) ph[j] -= p.h;
      }
      const int col = n0 + 8 * c;
      const bool ok = okg && col < p.co;
      load16(g_off + tile_offset(rr, c), p.g + (ok ? (size_t)pix * p.co + col : 0), ok, col,
             p.co);
    }
  };

  float acc[kN8][4];
  zero_acc(acc);
#pragma unroll
  for (int st = 0; st < kDwStages - 1; ++st) {
    if (st < n_it) load_stage(st, it0 + st);
    cp_async_commit();
  }
  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<kDwStages - 2>();  // stage i has landed
    fence_async_proxy();
    __syncthreads();  // for every thread, and every warp is done with stage i - 1
    if (i + kDwStages - 1 < n_it)
      load_stage((i + kDwStages - 1) % kDwStages, it0 + i + kDwStages - 1);
    cp_async_commit();

    const uint32_t x_s = base + (i % kDwStages) * kStageBytes;
    // A = z^T: matrix lane / 8 of an ldmatrix.x4 is (channels 8 (lane / 8
    // % 2).., pixels 8 (lane / 16)..) of the warp's 16 channels and the
    // k-step's 16 pixels; lane % 8 gives its row (pixel)
    uint32_t af[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4_trans(af[ks], x_s + tile_offset(16 * ks + (lane & 7) + ((lane >> 4) << 3),
                                                  2 * warp + ((lane >> 3) & 1)));
    if (pro) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[ks][e] = prologue_bf16x2(af[ks][e], pa[e & 1], pb[e & 1]);
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Wgmma<kDwN>::template run<1>(acc, af[ks], wgmma_desc(x_s + kXBytes + 2048 * ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
  cp_async_wait<0>();

  // acc: rows (channels) rl and rl + 8, columns 8 nt + 2 t, + 1
  const int rl = 16 * warp + g;
  if (p.splits > 1) {
    const int tiles = gridDim.x * gridDim.y * kTaps;
    const int tile = (tap * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    const int groups = (p.splits + p.group - 1) / p.group;
    const int grp = split / p.group, first = grp * p.group;
    auto put = [&](float* dst) {
#pragma unroll
      for (int nt = 0; nt < kN8; ++nt) {
        const int cc = 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(dst + rl * kDwN + cc) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(dst + (rl + 8) * kDwN + cc) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    };
    auto sum = [&](const float* src, int count) {  // in index order
      for (int s = 0; s < count; ++s) {
        const float* part = src + (size_t)s * kTile;
#pragma unroll
        for (int nt = 0; nt < kN8; ++nt) {
          const int cc = 8 * nt + 2 * t;
          const float2 lo = __ldcg(reinterpret_cast<const float2*>(part + rl * kDwN + cc));
          const float2 hi = __ldcg(reinterpret_cast<const float2*>(part + (rl + 8) * kDwN + cc));
          if (s == 0) {
            acc[nt][0] = lo.x; acc[nt][1] = lo.y; acc[nt][2] = hi.x; acc[nt][3] = hi.y;
          } else {
            acc[nt][0] += lo.x; acc[nt][1] += lo.y; acc[nt][2] += hi.x; acc[nt][3] += hi.y;
          }
        }
      }
    };
    float* parts = p.scratch + (size_t)tile * p.splits * kTile;
    put(parts + (size_t)split * kTile);
    if (!last_to_arrive(p.counters + tile * groups + grp, min(p.group, p.splits - first),
                        flag))
      return;
    sum(parts + (size_t)first * kTile, min(p.group, p.splits - first));
    if (groups > 1) {
      float* sums = p.scratch + ((size_t)tiles * p.splits + (size_t)tile * groups) * kTile;
      put(sums + (size_t)grp * kTile);
      if (!last_to_arrive(p.counters + tiles * groups + tile, groups, flag)) return;
      sum(sums, groups);
    }
  }

  // dw[tap][m0 + row][n0 + col], rounded once
#pragma unroll
  for (int nt = 0; nt < kN8; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + rl + 8 * hf;
      if (m >= p.ci) continue;
      bf16* dst = p.dw + ((size_t)tap * p.ci + m) * p.co + col;
      if (kVec) {
        if (col < p.co)
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      } else {
        if (col < p.co) dst[0] = __float2bfloat16(acc[nt][2 * hf]);
        if (col + 1 < p.co) dst[1] = __float2bfloat16(acc[nt][2 * hf + 1]);
      }
    }
  }
}

template <int kTaps, bool kVec>
cudaError_t launch_wgrad_t(const DwArgs& p, cudaStream_t stream) {
  const size_t smem = (size_t)kDwStages * 2 * kDwK * 128 + 1024 + 16;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_wgmma_kernel<kTaps, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(ceil_div(p.ci, kDwM), ceil_div(p.co, kDwN), kTaps * p.splits);
  wgrad_wgmma_kernel<kTaps, kVec><<<grid, kDwThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The plan of the bf16 backward (ops/fusedconv.py backward_plan): the dx
// pass's (block_n, splits, per_split) as the forward's, over the swapped
// roles; the dw pass's (splits, stages a split, splits a group).
struct BwdPlan {
  int dx_block_n, dx_splits, dx_per;
  int dw_splits, dw_per, dw_group;
};

// The three launches of the bf16 backward. x (n, ci), w (taps, ci, co), a
// and b (ci,) or null, y and dy (n, co), ds and dq (co,); outputs dx (n, ci),
// dw (taps, ci, co), dab (2, ci) = (da, db) with a prologue. Scratch: gbuf
// (n, co) bf16; part (ceil(ci/dx_block_n), ceil(n/128), 2, dx_block_n) f32
// with a prologue; dx_scratch (ceil(n/128) * ceil(ci/dx_block_n), dx_splits,
// 128, dx_block_n) f32 with dx_splits > 1; dw_scratch (tiles, dw_splits +
// groups, 64, 64) f32 with dw_splits > 1, tiles = ceil(ci/64) * ceil(co/64)
// * taps, groups = ceil(dw_splits / dw_group); counters
// as many ints as the larger pass needs (the dx pass as the forward; the dw
// pass tiles * groups + tiles), 0.
template <int kTaps>
cudaError_t launch_backward_wgmma(const bf16* x, const bf16* w, const float* a,
                                  const float* b, const bf16* y, const bf16* dy,
                                  const float* ds, const float* dq, bf16* dx, bf16* dw,
                                  float* dab, float* part, float* dx_scratch,
                                  float* dw_scratch, bf16* gbuf, int* counters, int n,
                                  int ci, int co, int h, int wd, BwdPlan plan,
                                  cudaStream_t stream) {
  const long long stages = ceil_div(n, kDwK);
  const bool pro = a != nullptr;
  if (gbuf == nullptr || counters == nullptr || (kTaps > 1 && !pro) ||
      (pro && (b == nullptr || dab == nullptr || part == nullptr)) ||
      plan.dw_splits < 1 || plan.dw_per < 1 || plan.dw_group < 1 ||
      (long long)plan.dw_splits * kTaps > 65535 ||
      (long long)plan.dw_splits * plan.dw_per < stages ||
      (long long)(plan.dw_splits - 1) * plan.dw_per >= stages ||
      ceil_div(co, kDwN) > 65535 || (plan.dw_splits > 1 && dw_scratch == nullptr))
    return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(dw) |
                          reinterpret_cast<uintptr_t>(gbuf);
  const bool vec = ci % 8 == 0 && co % 8 == 0 && (align & 15) == 0;

  // 1. g, once
  const long long total = (long long)n * co;
  const long long items = vec ? total / 8 : total;
  if (vec)
    cotangent_kernel<kTaps, true><<<(unsigned)((items + kGThreads - 1) / kGThreads), kGThreads, 0,
                             stream>>>(dy, y, ds, dq, gbuf, total, co);
  else
    cotangent_kernel<kTaps, false><<<(unsigned)((items + kGThreads - 1) / kGThreads), kGThreads, 0,
                              stream>>>(dy, y, ds, dq, gbuf, total, co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 2. dx (and da, db): the forward's template with the roles swapped
  WgArgs px = {};
  px.x = gbuf;
  px.xe = x;
  px.w = w;
  px.a = a;
  px.b = b;
  px.y = dx;
  px.part = pro ? part : nullptr;
  px.sq = pro ? dab : nullptr;
  px.scratch = dx_scratch;
  px.counters = counters;
  px.n = n;
  px.ci = co;
  px.co = ci;
  px.h = h;
  px.wd = wd;
  px.splits = plan.dx_splits;
  px.per_split = plan.dx_per;
  err = launch_forward_wgmma<kTaps, true>(px, plan.dx_block_n, stream);
  if (err != cudaSuccess) return err;

  // 3. dw
  DwArgs pd = {};
  pd.x = x;
  pd.g = gbuf;
  pd.a = a;
  pd.b = b;
  pd.dw = dw;
  pd.scratch = dw_scratch;
  pd.counters = counters;
  pd.n = n;
  pd.ci = ci;
  pd.co = co;
  pd.h = h;
  pd.wd = wd;
  pd.splits = plan.dw_splits;
  pd.per_split = plan.dw_per;
  pd.group = plan.dw_group;
  return vec ? launch_wgrad_t<kTaps, true>(pd, stream) : launch_wgrad_t<kTaps, false>(pd, stream);
}

}  // namespace corrifnet_fc
