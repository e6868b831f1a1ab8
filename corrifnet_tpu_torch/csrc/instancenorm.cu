// Fused ReLU + InstanceNorm for Hopper (sm_90a), forward (K3) and backward
// (K3b), over channels-last volumes (B, N, C), N = D*H*W:
//     y = relu(x);  mean, var = per (sample, channel) over the N positions
//     out = (y - mean) * rstd,  rstd = 1 / sqrt(var + eps)   (biased var)
//     dx = [x > 0] * rstd * (g - sum(g)/N - xhat * sum(g*xhat)/N),
//     xhat = (y - mean) * rstd
//
// K3 replaces the TPU kernel corrifnet_tpu/ops/instancenorm.py::_kernel
// (through _fused_fwd's pl.pallas_call). K3b has no TPU kernel: it stands for
// XLA's fusion of that module's _vjp_bwd, which differentiates
// relu_instancenorm_xla.
//
// What bounds it on the H100: bytes. The op reads x once and writes y once
// (the backward reads x and g and writes dx), 0.34 ms per B=4 training step
// of forwards at 3.35 TB/s, 71% of it the three 128^3 x 8 volumes (134 MB of
// x each at B=4 in bf16, more than the 50 MB L2). What held the Triton K3
// that this replaces back: three launches a call (statistics, a one-warp
// serial merge of up to 256 chunk partials, normalize), 81 a step, most of
// them on volumes under 4 MB where launch latency and the serial merge,
// not bytes, set the time; and two reads of x, because the normalize pass
// read x again from device memory. Its backward was 21 eager tensor ops a
// call, about 130 bytes moved per element against the bound's 6.
//
// The design: one launch a call. The wrapper's plan (ops/instancenorm.py,
// `plan`) cuts every sample into `chunks` row ranges, one block each, and
// takes `per_round` samples at a time. A block loads its rows once
// (16-byte vectors; the rows it keeps by cp.async straight into shared
// memory, in four groups that it reduces as they land; the others through
// registers, kUnroll vectors in flight a thread), reduces them per channel
// and publishes its partials; the blocks of a sample meet; then every block
// merges its sample's partials in chunk order (the same arithmetic in
// every block, so every block holds the same bits) and writes its rows
// from shared memory, refilling each slot at once with the same row of the
// next round's sample, and reading again from device memory (mostly L2)
// only the rows that did not fit. Where the blocks meet is the regime:
//   slab     one chunk a sample: the block alone, an ordinary launch;
//   cluster  a sample fits the shared memory of kMaxCluster blocks (every
//            decoder volume up to 16^3 x 128 in bf16): its chunks are one
//            thread block cluster and meet at the cluster's hardware
//            barrier, all samples in one round;
//   grid     the larger volumes: all blocks of a cooperative launch meet at
//            a grid barrier, a round at a time; in bf16 one sample of the
//            largest volume (33.5 MB) is 86% on chip over 132 blocks of
//            210 KB, so the forward moves about one read and one write per
//            element. The backward keeps x and g (67 MB a sample at 128^3,
//            about 43% of it on chip) and reads the rest again.
//
// Layout: 384 threads; a thread always holds the same 8 channels (one
// 16-byte bf16 vector, two for f32) of rows r, r + R, ... (R = 384 / (C/8)
// rows of threads), so its sums stay in registers until the block
// reduction, and neighbouring threads read neighbouring 16 bytes. C that is
// not a multiple of 8, or rows that are not 16-byte aligned, take the same
// kernel with masked element loads (kVec false).
//
// Statistics: the forward sums y - K and (y - K)^2 per channel with K the
// block's first row (shifted sums: the error of M2 grows with (mean - K)^2 /
// var, which a data point keeps small), turns them into the block's (mean,
// M2), and merges the blocks' pairs with Chan's formula in fixed order:
// the accuracy of the TPU kernel's two passes from one read. The backward
// takes the forward's saved mean and rstd and sums g and g * xhat.
//
// Repeatability: no float atomics; every sum is taken in a fixed order. The
// grid barrier is two words (arrivals, generation) that the wrapper keeps
// per (device, stream); the last block to arrive resets the arrivals to 0,
// so they are 0 on entry and on exit and no memset precedes a launch. The
// grid regime is a cooperative launch, so CUDA guarantees that every block
// is resident (or refuses the launch); a barrier that waits ten seconds
// traps instead of hanging.
//
// C interface (bound with ctypes): each function returns the first
// cudaGetLastError() that is not success. dtype: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace corrifnet_in {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;           // a multiple of every C/8 the decoder has: 1-4, 6, 8, 12, 16, 24
constexpr int kMaxChannels = 1024;      // the reduction scratch holds 3 x max(kThreads, C)
constexpr int kLoadBytes = 128;         // bytes a thread has in flight per operand batch
constexpr int kMergeLoads = 16;         // chunk partials a thread loads before it merges them
constexpr int kStages = 4;              // groups of copies a thread waits for one by one
constexpr int kMaxCluster = 8;          // blocks of a cluster (the portable size)

struct Args {
  const void* x;
  const void* g;      // backward: the output gradient, as x
  void* out;          // forward: y; backward: dx
  float* mean;        // (B, C): written by the forward, read by the backward
  float* rstd;        // (B, C)
  float* partials;    // (B, chunks, 2, C)
  unsigned* barrier;  // 2 words, 0 and anything on entry
  long long n;        // rows (positions) a sample
  int b, c, vecs;     // samples, channels, 8-channel vectors a row
  int chunks, per_round, rounds;
  int cluster;        // 1: the chunks of a sample are one thread block cluster
  int chunk_rows, resident_rows;
  float eps;
};

// 8 channels of one row in the storage type: one 16-byte word for bf16, two for f32
template <typename T>
struct Raw {
  uint4 w[sizeof(T) / 2];
};

__device__ __forceinline__ void unpack(const Raw<bf16>& r, float (&f)[8]) {
  const uint32_t u[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float (&f)[8]) {
  const uint32_t u[8] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w,
                         r.w[1].x, r.w[1].y, r.w[1].z, r.w[1].w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(u[i]);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v)));
}

// 8 channels of the row at `src` (vector v of the row); lanes past C read 0
template <typename T, bool kVec>
__device__ __forceinline__ Raw<T> load8(const T* src, int ch0, int c) {
  Raw<T> r;
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < int(sizeof(T) / 2); ++j) r.w[j] = __ldg(reinterpret_cast<const uint4*>(src) + j);
  } else {
    uint32_t u[sizeof(T) * 2];
    if constexpr (sizeof(T) == 2) {
      const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t lo = ch0 + 2 * i < c ? s16[2 * i] : 0u;
        const uint32_t hi = ch0 + 2 * i + 1 < c ? s16[2 * i + 1] : 0u;
        u[i] = lo | hi << 16;
      }
    } else {
      const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
      for (int i = 0; i < 8; ++i) u[i] = ch0 + i < c ? s32[i] : 0u;
    }
#pragma unroll
    for (int j = 0; j < int(sizeof(T) / 2); ++j)
      r.w[j] = make_uint4(u[4 * j], u[4 * j + 1], u[4 * j + 2], u[4 * j + 3]);
  }
  return r;
}

template <typename T, bool kVec>
__device__ __forceinline__ void store8(T* dst, const float (&f)[8], int ch0, int c) {
  if constexpr (sizeof(T) == 2) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = bf16_bits(f[2 * i]) | bf16_bits(f[2 * i + 1]) << 16;
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (ch0 + i < c) d16[i] = static_cast<uint16_t>(u[i / 2] >> (16 * (i % 2)));
    }
  } else {
    float* d = reinterpret_cast<float*>(dst);
    if constexpr (kVec) {
      reinterpret_cast<float4*>(d)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(d)[1] = make_float4(f[4], f[5], f[6], f[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (ch0 + i < c) d[i] = f[i];
    }
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// 16-byte copies from device to shared memory that bypass the registers;
// the thread that issued them waits for its own before it reads them.
template <typename T>
__device__ __forceinline__ void copy_async(Raw<T>* dst, const T* src) {
#pragma unroll
  for (int j = 0; j < int(sizeof(T) / 2); ++j) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(&dst->w[j]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(reinterpret_cast<const uint4*>(src) + j)
                 : "memory");
  }
}

// Every block of the grid waits here for all the others. barrier[0] counts
// arrivals and is reset to 0 by the last one, which then moves barrier[1]
// (the generation) on; the others wait for that move.
__device__ __forceinline__ void grid_barrier(unsigned* barrier) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned seen = load_acquire(barrier + 1);
    __threadfence();
    if (atomicAdd(barrier, 1u) == gridDim.x - 1) {
      atomicExch(barrier, 0u);
      __threadfence();
      atomicAdd(barrier + 1, 1u);
    } else {
      // a grid whose blocks are not all resident would wait here forever:
      // after about ten seconds the kernel traps, and the launch fails
      for (long long spins = 0; load_acquire(barrier + 1) == seen; ++spins) {
        if (spins > (1ll << 27)) __trap();
        __nanosleep(64);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The blocks of a sample wait for each other's partials: a grid barrier, the
// cluster's hardware barrier, or (one chunk a sample) the block's own.
__device__ __forceinline__ void chunks_meet(const Args& p) {
  if (p.chunks > 1 && !p.cluster) {
    grid_barrier(p.barrier);
  } else {
    __threadfence();
    if (p.chunks > 1) {
      asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
                   ::: "memory");
    } else {
      __syncthreads();
    }
  }
}

// Per-channel totals of one value per (thread, channel): val[k] of the
// thread holding vector v is channel 8 v + k. Rows of threads are added in
// `groups` contiguous runs and the runs in order: the same order every call.
// red: kThreads * 8 floats, runs: max(kThreads, cp) floats, out: cp floats.
__device__ __forceinline__ void block_sum(const float (&val)[8], float* red, float* runs,
                                          float* out, int rows, int active, int cp) {
  const int tid = threadIdx.x;
  if (tid < active) {
#pragma unroll
    for (int k = 0; k < 8; ++k) red[tid * 8 + k] = val[k];  // = red[row * cp + channel]
  }
  __syncthreads();
  const int groups = max(1, min(rows, kThreads / cp));
  for (int i = tid; i < groups * cp; i += kThreads) {
    const int ch = i % cp, grp = i / cp;
    const int r1 = (grp + 1) * rows / groups;
    float s = 0.f;
    for (int r = grp * rows / groups; r < r1; ++r) s += red[r * cp + ch];
    runs[i] = s;
  }
  __syncthreads();
  for (int ch = tid; ch < cp; ch += kThreads) {
    float s = 0.f;
    for (int grp = 0; grp < groups; ++grp) s += runs[grp * cp + ch];
    out[ch] = s;
  }
  __syncthreads();
}

struct Geometry {
  int vecs, cp, rows_t, active, v, r0;  // thread rows, active threads, own vector, own first row
  float* red;
  float* runs;
  float* st;       // 4 x cp floats of per-channel values
  uint4* data;     // resident rows
};

__device__ __forceinline__ Geometry geometry(const Args& p, float* smem) {
  Geometry q;
  q.vecs = p.vecs;
  q.cp = 8 * p.vecs;
  q.rows_t = kThreads / p.vecs;
  q.active = q.rows_t * p.vecs;
  q.v = threadIdx.x % p.vecs;
  q.r0 = threadIdx.x / p.vecs;
  q.red = smem;
  q.runs = q.red + kThreads * 8;
  q.st = q.runs + max(kThreads, q.cp);
  const int fixed = (kThreads * 8 + max(kThreads, q.cp) + 4 * q.cp + 3) / 4 * 4;
  q.data = reinterpret_cast<uint4*>(smem + fixed);
  return q;
}

// The thread's first row (of r0, r0 + R, ...) at or after `from`.
__device__ __forceinline__ int first_row_from(const Geometry& q, int from) {
  return from <= q.r0 ? q.r0 : q.r0 + (from - q.r0 + q.rows_t - 1) / q.rows_t * q.rows_t;
}

__device__ __forceinline__ int chunk_rows_of(const Args& p, int s) {
  return static_cast<int>(min(static_cast<long long>(p.chunk_rows),
                              p.n - static_cast<long long>(s) * p.chunk_rows));
}

// Chan's merge of (n_b, mean_b, M2_b) into (n_a, mean_a, M2_a).
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a, float nb, float mb,
                                           float m2b) {
  const float nn = na + nb, d = mb - ma, w = nb / nn;
  ma = fmaf(d, w, ma);
  m2a += m2b + d * d * na * w;
  na = nn;
}

// Chan's merge of the sample's chunk partials (mean, M2) in chunk order: into
// st[0..c) the mean, st[cp..cp+c) rstd. Channels are merged by `groups`
// contiguous runs of chunks, and the runs in order.
__device__ __forceinline__ void merge_moments(const Args& p, const Geometry& q, int sample) {
  const int tid = threadIdx.x, c = p.c;
  const float* part = p.partials + static_cast<long long>(sample) * p.chunks * 2 * c;
  const int groups = max(1, min(p.chunks, kThreads / c));
  for (int i = tid; i < groups * c; i += kThreads) {
    const int ch = i % c, grp = i / c;
    float na = 0.f, ma = 0.f, m2a = 0.f;
    const int s1 = (grp + 1) * p.chunks / groups;
    for (int s0 = grp * p.chunks / groups; s0 < s1; s0 += kMergeLoads) {
      float mb[kMergeLoads], m2b[kMergeLoads];
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {  // the loads first, all in flight
        if (s0 + u < s1) {
          mb[u] = __ldcg(part + (2 * (s0 + u)) * c + ch);
          m2b[u] = __ldcg(part + (2 * (s0 + u) + 1) * c + ch);
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        if (s0 + u < s1) chan_merge(na, ma, m2a, static_cast<float>(chunk_rows_of(p, s0 + u)),
                                    mb[u], m2b[u]);
      }
    }
    q.red[3 * i] = na;
    q.red[3 * i + 1] = ma;
    q.red[3 * i + 2] = m2a;
  }
  __syncthreads();
  for (int ch = tid; ch < q.cp; ch += kThreads) {
    float na = 0.f, ma = 0.f, m2a = 0.f;
    if (ch < c) {
      for (int grp = 0; grp < groups; ++grp) {
        const int i = grp * c + ch;
        chan_merge(na, ma, m2a, q.red[3 * i], q.red[3 * i + 1], q.red[3 * i + 2]);
      }
    }
    q.st[ch] = ch < c ? ma : 0.f;
    q.st[q.cp + ch] = ch < c ? 1.f / sqrtf(m2a / static_cast<float>(p.n) + p.eps) : 0.f;
  }
  __syncthreads();
}

// The sample's chunk partials (sum g, sum g xhat) added in chunk order, over N:
// into st[2cp..2cp+c) and st[3cp..3cp+c).
__device__ __forceinline__ void merge_sums(const Args& p, const Geometry& q, int sample) {
  const int tid = threadIdx.x, c = p.c;
  const float* part = p.partials + static_cast<long long>(sample) * p.chunks * 2 * c;
  const int groups = max(1, min(p.chunks, kThreads / c));
  for (int i = tid; i < groups * c; i += kThreads) {
    const int ch = i % c, grp = i / c;
    float sg = 0.f, sgx = 0.f;
    const int s1 = (grp + 1) * p.chunks / groups;
    for (int s0 = grp * p.chunks / groups; s0 < s1; s0 += kMergeLoads) {
      float a[kMergeLoads], b[kMergeLoads];
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        if (s0 + u < s1) {
          a[u] = __ldcg(part + (2 * (s0 + u)) * c + ch);
          b[u] = __ldcg(part + (2 * (s0 + u) + 1) * c + ch);
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        if (s0 + u < s1) {
          sg += a[u];
          sgx += b[u];
        }
      }
    }
    q.red[2 * i] = sg;
    q.red[2 * i + 1] = sgx;
  }
  __syncthreads();
  for (int ch = tid; ch < q.cp; ch += kThreads) {
    float sg = 0.f, sgx = 0.f;
    if (ch < c) {
      for (int grp = 0; grp < groups; ++grp) {
        sg += q.red[2 * (grp * c + ch)];
        sgx += q.red[2 * (grp * c + ch) + 1];
      }
    }
    q.st[2 * q.cp + ch] = sg / static_cast<float>(p.n);
    q.st[3 * q.cp + ch] = sgx / static_cast<float>(p.n);
  }
  __syncthreads();
}

// Adds one row's 8 channels of relu(x) - K and its square.
template <typename T>
__device__ __forceinline__ void moments8(const Raw<T>& raw, const float (&shift)[8],
                                         float (&s1)[8], float (&s2)[8]) {
  float f[8];
  unpack(raw, f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float d = fmaxf(f[k], 0.f) - shift[k];
    s1[k] += d;
    s2[k] = fmaf(d, d, s2[k]);
  }
}

// Writes one row's 8 channels of (relu(x) - mean) * rstd.
template <typename T, bool kVec>
__device__ __forceinline__ void normalize8(const Raw<T>& raw, const float (&mean)[8],
                                           const float (&rstd)[8], T* dst, int ch0, int c) {
  float f[8];
  unpack(raw, f);
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = (fmaxf(f[k], 0.f) - mean[k]) * rstd[k];
  store8<T, kVec>(dst, f, ch0, c);
}

// Adds one row's 8 channels of g and of g * xhat.
template <typename T>
__device__ __forceinline__ void grad_sums8(const Raw<T>& rx, const Raw<T>& rg,
                                           const float (&mean)[8], const float (&rstd)[8],
                                           float (&sg)[8], float (&sgx)[8]) {
  float fx[8], fg[8];
  unpack(rx, fx);
  unpack(rg, fg);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float xh = (fmaxf(fx[k], 0.f) - mean[k]) * rstd[k];
    sg[k] += fg[k];
    sgx[k] = fmaf(fg[k], xh, sgx[k]);
  }
}

// The thread's kept rows are r0 + j R for j < m; stage k of kStages holds
// j in [k m / kStages, (k + 1) m / kStages): one commit group of copies.
__device__ __forceinline__ int stage_begin(int m, int k) { return k * m / kStages; }

template <int kPending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for the copies of stage k (of kStages, committed in order).
__device__ __forceinline__ void wait_stage(int k) {
  static_assert(kStages == 4, "wait_stage waits for one of 4 groups");
  switch (k) {
    case 0: copies_wait<3>(); break;
    case 1: copies_wait<2>(); break;
    case 2: copies_wait<1>(); break;
    default: copies_wait<0>(); break;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) relu_in_fwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWords = sizeof(T) / 2;
  constexpr int kUnroll = kLoadBytes / 16 / kWords;
  const Geometry q = geometry(p, smem);
  const int tid = threadIdx.x, c = p.c, ch0 = 8 * q.v;
  const bool on = tid < q.active;
  Raw<T>* keep = reinterpret_cast<Raw<T>*>(q.data);
  const long long round_step = static_cast<long long>(p.per_round) * p.n * c;

  for (int round = 0; round < p.rounds; ++round) {
    const int sample = round * p.per_round + blockIdx.x / p.chunks;
    const int s = blockIdx.x % p.chunks;
    const bool live = sample < p.b;
    const int rows = live ? chunk_rows_of(p, s) : 0;
    const int resident = min(rows, p.resident_rows);
    const int m = resident > q.r0 ? (resident - q.r0 + q.rows_t - 1) / q.rows_t : 0;
    const long long off =
        (static_cast<long long>(sample) * p.n + static_cast<long long>(s) * p.chunk_rows) * c;
    const T* base = static_cast<const T*>(p.x) + off;
    T* obase = static_cast<T*>(p.out) + off;

    if (live) {
      // phase 1: shifted sums of relu(x) - K over the thread's rows, K the chunk's first row
      float shift[8], s1[8], s2[8];
      {
        float f[8];
        unpack(on ? load8<T, kVec>(base + ch0, ch0, c) : Raw<T>{}, f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          shift[k] = fmaxf(f[k], 0.f);
          s1[k] = 0.f;
          s2[k] = 0.f;
        }
      }
      if (on) {
        // with 16-byte loads the rows kept on chip go straight to shared
        // memory, in kStages groups, all in flight at once (after the first
        // round the previous round's phase 3 has issued them already),
        // while the rows read again pass through registers; with element
        // loads every row does
        if constexpr (kVec) {
          if (round == 0) {
            for (int k = 0; k < kStages; ++k) {
              for (int j = stage_begin(m, k); j < stage_begin(m, k + 1); ++j) {
                const int row = q.r0 + j * q.rows_t;
                copy_async(keep + row * q.vecs + q.v, base + static_cast<long long>(row) * c + ch0);
              }
              copies_commit();
            }
          }
        }
        for (int r = kVec ? first_row_from(q, resident) : q.r0; r < rows;
             r += kUnroll * q.rows_t) {
          Raw<T> raw[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int row = r + u * q.rows_t;
            if (row < rows) raw[u] = load8<T, kVec>(base + static_cast<long long>(row) * c + ch0, ch0, c);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int row = r + u * q.rows_t;
            if (row < rows) {
              if (!kVec && row < resident) keep[row * q.vecs + q.v] = raw[u];
              moments8(raw[u], shift, s1, s2);
            }
          }
        }
        if constexpr (kVec) {
#pragma unroll
          for (int k = 0; k < kStages; ++k) {
            wait_stage(k);
#pragma unroll 4
            for (int j = stage_begin(m, k); j < stage_begin(m, k + 1); ++j)
              moments8(keep[(q.r0 + j * q.rows_t) * q.vecs + q.v], shift, s1, s2);
          }
        }
      }
      if (tid < q.vecs) {
#pragma unroll
        for (int k = 0; k < 8; ++k) q.st[ch0 + k] = shift[k];
      }
      float* tot = q.st + 2 * q.cp;  // the sums of d and of d^2, cp each
      block_sum(s1, q.red, q.runs, tot, q.rows_t, q.active, q.cp);
      block_sum(s2, q.red, q.runs, tot + q.cp, q.rows_t, q.active, q.cp);
      // the chunk's mean and M2 from its shifted sums
      float* part = p.partials + (static_cast<long long>(sample) * p.chunks + s) * 2 * c;
      const float nb = static_cast<float>(rows);
      for (int ch = tid; ch < c; ch += kThreads) {
        const float d1 = tot[ch], d2 = tot[q.cp + ch];
        part[ch] = q.st[ch] + d1 / nb;
        part[c + ch] = fmaxf(d2 - d1 * (d1 / nb), 0.f);
      }
    }
    chunks_meet(p);
    if (!live) continue;

    // phase 2: the sample's mean and rstd, the same bits in every block
    merge_moments(p, q, sample);
    float mean[8], rstd[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      mean[k] = q.st[ch0 + k];
      rstd[k] = q.st[q.cp + ch0 + k];
    }
    if (s == 0) {
      for (int ch = tid; ch < c; ch += kThreads) {
        p.mean[static_cast<long long>(sample) * c + ch] = q.st[ch];
        p.rstd[static_cast<long long>(sample) * c + ch] = q.st[q.cp + ch];
      }
    }

    // phase 3: normalize; first the rows read again (most recently read, so
    // mostly in L2), then the rows held in shared memory, each slot refilled
    // at once by a copy of the same row of the next round's sample
    if (on) {
      for (int r = first_row_from(q, resident); r < rows; r += kUnroll * q.rows_t) {
        Raw<T> raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int row = r + u * q.rows_t;
          if (row < rows) raw[u] = load8<T, kVec>(base + static_cast<long long>(row) * c + ch0, ch0, c);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int row = r + u * q.rows_t;
          if (row < rows) normalize8<T, kVec>(raw[u], mean, rstd, obase + static_cast<long long>(row) * c + ch0, ch0, c);
        }
      }
      const bool prefetch = kVec && round + 1 < p.rounds && sample + p.per_round < p.b;
#pragma unroll
      for (int k = 0; k < kStages; ++k) {
#pragma unroll 4
        for (int j = stage_begin(m, k); j < stage_begin(m, k + 1); ++j) {
          const int row = q.r0 + j * q.rows_t;
          Raw<T>* slot = keep + row * q.vecs + q.v;
          normalize8<T, kVec>(*slot, mean, rstd, obase + static_cast<long long>(row) * c + ch0, ch0, c);
          if (prefetch) copy_async(slot, base + round_step + static_cast<long long>(row) * c + ch0);
        }
        if (prefetch) copies_commit();
      }
    }
    __syncthreads();  // st is rewritten by the next round
  }
}

// dx of 8 channels into fx: [x > 0] rstd (g - mean(g) - xhat mean(g xhat))
__device__ __forceinline__ void dx8(float (&fx)[8], const float (&fg)[8], const float (&mean)[8],
                                    const float (&rstd)[8], const float (&mg)[8],
                                    const float (&mgx)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float xh = (fmaxf(fx[k], 0.f) - mean[k]) * rstd[k];
    fx[k] = fx[k] > 0.f ? rstd[k] * (fg[k] - mg[k] - xh * mgx[k]) : 0.f;
  }
}


template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) relu_in_bwd_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWords = sizeof(T) / 2;
  constexpr int kUnroll = kLoadBytes / 16 / kWords / 2;  // x and g: two operands
  const Geometry q = geometry(p, smem);
  const int tid = threadIdx.x, c = p.c, ch0 = 8 * q.v;
  const bool on = tid < q.active;
  Raw<T>* keep_x = reinterpret_cast<Raw<T>*>(q.data);
  Raw<T>* keep_g = keep_x + static_cast<long long>(p.resident_rows) * q.vecs;
  const long long round_step = static_cast<long long>(p.per_round) * p.n * c;

  for (int round = 0; round < p.rounds; ++round) {
    const int sample = round * p.per_round + blockIdx.x / p.chunks;
    const int s = blockIdx.x % p.chunks;
    const bool live = sample < p.b;
    const int rows = live ? chunk_rows_of(p, s) : 0;
    const int resident = min(rows, p.resident_rows);
    const int m = resident > q.r0 ? (resident - q.r0 + q.rows_t - 1) / q.rows_t : 0;
    const long long off =
        (static_cast<long long>(sample) * p.n + static_cast<long long>(s) * p.chunk_rows) * c;
    const T* xb = static_cast<const T*>(p.x) + off;
    const T* gb = static_cast<const T*>(p.g) + off;
    T* db = static_cast<T*>(p.out) + off;
    float mean[8], rstd[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool ok = live && ch0 + k < c;
      mean[k] = ok ? p.mean[static_cast<long long>(sample) * c + ch0 + k] : 0.f;
      rstd[k] = ok ? p.rstd[static_cast<long long>(sample) * c + ch0 + k] : 0.f;
    }

    if (live) {
      // phase 1: sum g and g * xhat over the thread's rows; the kept rows of
      // x and g come as in the forward
      float sg[8], sgx[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) sg[k] = sgx[k] = 0.f;
      if (on) {
        if constexpr (kVec) {
          if (round == 0) {
            for (int k = 0; k < kStages; ++k) {
              for (int j = stage_begin(m, k); j < stage_begin(m, k + 1); ++j) {
                const int row = q.r0 + j * q.rows_t;
                const long long at = static_cast<long long>(row) * c + ch0;
                copy_async(keep_x + row * q.vecs + q.v, xb + at);
                copy_async(keep_g + row * q.vecs + q.v, gb + at);
              }
              copies_commit();
            }
          }
        }
        for (int r = kVec ? first_row_from(q, resident) : q.r0; r < rows;
             r += kUnroll * q.rows_t) {
          Raw<T> rx[kUnroll], rg[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int row = r + u * q.rows_t;
            if (row < rows) {
              rx[u] = load8<T, kVec>(xb + static_cast<long long>(row) * c + ch0, ch0, c);
              rg[u] = load8<T, kVec>(gb + static_cast<long long>(row) * c + ch0, ch0, c);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int row = r + u * q.rows_t;
            if (row < rows) {
              if (!kVec && row < resident) {
                keep_x[row * q.vecs + q.v] = rx[u];
                keep_g[row * q.vecs + q.v] = rg[u];
              }
              grad_sums8(rx[u], rg[u], mean, rstd, sg, sgx);
            }
          }
        }
        if constexpr (kVec) {
#pragma unroll
          for (int k = 0; k < kStages; ++k) {
            wait_stage(k);
#pragma unroll 4
            for (int j = stage_begin(m, k); j < stage_begin(m, k + 1); ++j) {
              const int at = (q.r0 + j * q.rows_t) * q.vecs + q.v;
              grad_sums8(keep_x[at], keep_g[at], mean, rstd, sg, sgx);
            }
          }
        }
      }
      float* tot = q.st;  // the sums of g and of g * xhat, cp each
      block_sum(sg, q.red, q.runs, tot, q.rows_t, q.active, q.cp);
      block_sum(sgx, q.red, q.runs, tot + q.cp, q.rows_t, q.active, q.cp);
      float* part = p.partials + (static_cast<long long>(sample) * p.chunks + s) * 2 * c;
      for (int ch = tid; ch < c; ch += kThreads) {
        part[ch] = tot[ch];
        part[c + ch] = tot[q.cp + ch];
      }
    }
    chunks_meet(p);
    if (!live) continue;

    // phase 2: sum(g) / N and sum(g xhat) / N, the same bits in every block
    merge_sums(p, q, sample);
    float mg[8], mgx[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      mg[k] = q.st[2 * q.cp + ch0 + k];
      mgx[k] = q.st[3 * q.cp + ch0 + k];
    }

    // phase 3: dx; first the rows read again, then the rows held on chip,
    // each slot refilled at once from the next round's sample
    if (on) {
      for (int r = first_row_from(q, resident); r < rows; r += kUnroll * q.rows_t) {
        Raw<T> rx[kUnroll], rg[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int row = r + u * q.rows_t;
          if (row < rows) {
            rx[u] = load8<T, kVec>(xb + static_cast<long long>(row) * c + ch0, ch0, c);
            rg[u] = load8<T, kVec>(gb + static_cast<long long>(row) * c + ch0, ch0, c);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int row = r + u * q.rows_t;
          if (row < rows) {
            float fx[8], fg[8];
            unpack(rx[u], fx);
            unpack(rg[u], fg);
            dx8(fx, fg, mean, rstd, mg, mgx);
            store8<T, kVec>(db + static_cast<long long>(row) * c + ch0, fx, ch0, c);
          }
        }
      }
      const bool prefetch = kVec && round + 1 < p.rounds && sample + p.per_round < p.b;
#pragma unroll
      for (int k = 0; k < kStages; ++k) {
#pragma unroll 4
        for (int j = stage_begin(m, k); j < stage_begin(m, k + 1); ++j) {
          const int row = q.r0 + j * q.rows_t;
          const int at = row * q.vecs + q.v;
          float fx[8], fg[8];
          unpack(keep_x[at], fx);
          unpack(keep_g[at], fg);
          dx8(fx, fg, mean, rstd, mg, mgx);
          store8<T, kVec>(db + static_cast<long long>(row) * c + ch0, fx, ch0, c);
          if (prefetch) {
            const long long next = round_step + static_cast<long long>(row) * c + ch0;
            copy_async(keep_x + at, xb + next);
            copy_async(keep_g + at, gb + next);
          }
        }
        if (prefetch) copies_commit();
      }
    }
    __syncthreads();  // st is rewritten by the next round
  }
}

}  // namespace corrifnet_in

using namespace corrifnet_in;

namespace {

constexpr int kSmemLimit = 232448;  // the most dynamic shared memory a block may have

typedef void (*KernelFn)(Args);

KernelFn pick(int dtype, int vec, int bwd) {
  if (dtype == 1) {
    if (bwd) return vec ? relu_in_bwd_kernel<bf16, true> : relu_in_bwd_kernel<bf16, false>;
    return vec ? relu_in_fwd_kernel<bf16, true> : relu_in_fwd_kernel<bf16, false>;
  }
  if (bwd) return vec ? relu_in_bwd_kernel<float, true> : relu_in_bwd_kernel<float, false>;
  return vec ? relu_in_fwd_kernel<float, true> : relu_in_fwd_kernel<float, false>;
}

int fixed_smem_bytes(int c) {
  const int cp = 8 * ((c + 7) / 8);
  const int cpmax = cp > kThreads ? cp : kThreads;
  return (kThreads * 8 + cpmax + 4 * cp + 3) / 4 * 4 * 4;
}

// Checks the plan against the launch and launches: cooperatively where a
// sample has more than one chunk (the grid barrier needs every block
// resident), else as an ordinary launch.
int launch(Args& p, int dtype, int vec, int bwd, int smem, cudaStream_t stream) {
  const int cp = 8 * p.vecs, itemsize = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || p.b <= 0 || p.n <= 0 || p.c <= 0 || p.c > kMaxChannels ||
      p.vecs != (p.c + 7) / 8 || p.chunks <= 0 || p.per_round <= 0 || p.rounds <= 0 ||
      p.chunk_rows <= 0 || static_cast<long long>(p.chunks) * p.chunk_rows < p.n ||
      static_cast<long long>(p.chunks - 1) * p.chunk_rows >= p.n ||
      static_cast<long long>(p.per_round) * p.rounds < p.b || p.resident_rows < 0 ||
      p.resident_rows > p.chunk_rows || smem > kSmemLimit ||
      smem < fixed_smem_bytes(p.c) + p.resident_rows * cp * itemsize * (bwd ? 2 : 1) ||
      (p.chunks > 1 && !p.cluster && p.barrier == nullptr) ||
      (p.cluster && (p.chunks > kMaxCluster || p.rounds != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = pick(dtype, vec, bwd);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  const dim3 grid(p.per_round * p.chunks), block(kThreads);
  if (p.cluster && p.chunks > 1) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.chunks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = block;
    config.dynamicSmemBytes = static_cast<size_t>(smem);
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(fn), args);
  } else {
    err = p.chunks > 1
            ? cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), grid, block, args,
                                          static_cast<size_t>(smem), stream)
            : cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid, block, args,
                               static_cast<size_t>(smem), stream);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (B, N, C) in the storage type, contiguous; mean, rstd (B, C) f32
// outputs; partials (B, chunks, 2, C) f32 scratch; barrier 2 uint32 words
// whose first is 0 (null when chunks is 1); the plan of ops/instancenorm.py;
// vec 1 for 16-byte loads (C a multiple of 8, x and out 16-byte aligned).
extern "C" int corrifnet_in_fwd(const void* x, void* out, void* mean, void* rstd, void* partials,
                                void* barrier, int b, long long n, int c, int dtype, int vec,
                                int chunks, int per_round, int rounds, int chunk_rows,
                                int resident_rows, int cluster, int smem, float eps,
                                void* stream) {
  Args p = {};
  p.x = x;
  p.out = out;
  p.mean = static_cast<float*>(mean);
  p.rstd = static_cast<float*>(rstd);
  p.partials = static_cast<float*>(partials);
  p.barrier = static_cast<unsigned*>(barrier);
  p.n = n;
  p.b = b;
  p.c = c;
  p.vecs = (c + 7) / 8;
  p.chunks = chunks;
  p.per_round = per_round;
  p.rounds = rounds;
  p.chunk_rows = chunk_rows;
  p.resident_rows = resident_rows;
  p.cluster = cluster;
  p.eps = eps;
  if (x == nullptr || out == nullptr || mean == nullptr || rstd == nullptr || partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, dtype, vec, 0, smem, static_cast<cudaStream_t>(stream));
}

// As the forward, with g (B, N, C) the output gradient and dx (B, N, C) the
// result, both in the storage type; mean and rstd the forward's.
extern "C" int corrifnet_in_bwd(const void* x, const void* g, const void* mean, const void* rstd,
                                void* dx, void* partials, void* barrier, int b, long long n, int c,
                                int dtype, int vec, int chunks, int per_round, int rounds,
                                int chunk_rows, int resident_rows, int cluster, int smem,
                                void* stream) {
  Args p = {};
  p.x = x;
  p.g = g;
  p.out = dx;
  p.mean = static_cast<float*>(const_cast<void*>(mean));
  p.rstd = static_cast<float*>(const_cast<void*>(rstd));
  p.partials = static_cast<float*>(partials);
  p.barrier = static_cast<unsigned*>(barrier);
  p.n = n;
  p.b = b;
  p.c = c;
  p.vecs = (c + 7) / 8;
  p.chunks = chunks;
  p.per_round = per_round;
  p.rounds = rounds;
  p.chunk_rows = chunk_rows;
  p.resident_rows = resident_rows;
  p.cluster = cluster;
  if (x == nullptr || g == nullptr || dx == nullptr || mean == nullptr || rstd == nullptr ||
      partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, dtype, vec, 1, smem, static_cast<cudaStream_t>(stream));
}
