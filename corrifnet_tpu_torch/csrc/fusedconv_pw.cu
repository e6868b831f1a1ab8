// Fused 1x1 bottleneck convolution for Hopper (sm_90a), forward (K4a) and
// backward (K4b), over channels-last rows:
//     z = relu(x*a + b) (or z = x),  y = z @ w,  s = sum_rows y,  q = sum_rows y^2
//     g = dy + ds + 2 dq y;  dw = z^T g;  dz = g w^T;  dx = [pre > 0] dz a;
//     da = sum [pre > 0] dz x;  db = sum [pre > 0] dz
//
// Replaces the TPU kernels corrifnet_tpu/ops/fusedconv.py::_pw_kernel (through
// _pw_pallas's pl.pallas_call) and ::_pw_bwd_kernel (through _pw_bwd_pallas).
//
// What bounds it on the H100: the model's shapes run from (37632, 64 -> 64),
// 2 operations for every byte moved and bound by bytes, to (588, 2048 -> 512),
// bound by operations; most of a step's time is in the shapes between. Every
// design reads x once per block of output columns and writes y once, takes
// the statistics from the accumulator so that y is never read back for
// them, and applies the previous BatchNorm and ReLU on the load so that z
// never reaches device memory. The forward in bf16 is the tensor-core kernel
// of fusedconv_wgmma.cuh (wgmma, one launch with the statistics, split-K for
// the few-row shapes); in f32 it is rows_kernel of fusedconv_common.cuh (f32
// FMA, the statistics added by a second launch). The backward in bf16 is the
// three launches of fusedconv_wgmma_bwd.cuh (g written once; the dx pass on
// the forward's wgmma template with da and db by tickets; the wgmma dw pass,
// split over the rows, its partials added by tickets); in f32 it is the FMA
// kernels, g made on the load in both products, in four launches: dx with
// the da/db partial sums, their reduction, the dw partial products over
// splits of the rows, their reduction.
//
// C interface (bound with ctypes): each function returns the first
// cudaGetLastError() that is not success. dtype: 0 = float32, 1 = bfloat16.

#include "fusedconv_common.cuh"
#include "fusedconv_wgmma.cuh"
#include "fusedconv_wgmma_bwd.cuh"

using namespace corrifnet_fc;

// x (n, ci), w (ci, co), a and b (ci,) f32 or null (relu_fma 0), y (n, co);
// with stats: sq (2, co) f32 = (s, q) and the scratch `part`: f32, for
// float32 (ceil(n/64), 2, co), for bfloat16 (ceil(co/block_n), ceil(n/128),
// 2, block_n). bfloat16 only: the plan (block_n, splits, per_split), with
// splits > 1 the f32 scratch (ceil(n/128) * ceil(co/block_n), splits, 128,
// block_n), and counters: ceil(n/128) * ceil(co/block_n) + ceil(co/block_n)
// ints that are 0 (and are 0 again when the launch has run).
extern "C" int corrifnet_pw_fwd(const void* x, const void* w, const void* a,
                                const void* b, void* y, void* part, void* sq,
                                void* scratch, void* counters, int n, int ci, int co,
                                int dtype, int relu_fma, int stats, int block_n,
                                int splits, int per_split, void* stream) {
  if (n <= 0 || ci <= 0 || co <= 0 || (relu_fma != 0) != (a != nullptr) ||
      (a == nullptr) != (b == nullptr) || (stats != 0) != (sq != nullptr) ||
      (stats != 0 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    WgArgs p = {};
    p.x = static_cast<const bf16*>(x);
    p.w = static_cast<const bf16*>(w);
    p.a = static_cast<const float*>(a);
    p.b = static_cast<const float*>(b);
    p.y = static_cast<bf16*>(y);
    p.part = stats ? static_cast<float*>(part) : nullptr;
    p.sq = static_cast<float*>(sq);
    p.scratch = static_cast<float*>(scratch);
    p.counters = static_cast<int*>(counters);
    p.n = n;
    p.ci = ci;
    p.co = co;
    p.splits = splits;
    p.per_split = per_split;
    return static_cast<int>(launch_forward_wgmma<1>(p, block_n, s));
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args p = {};
  p.x = x;
  p.w = w;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = y;
  p.part = static_cast<float*>(part);
  p.n = n;
  p.ci = ci;
  p.co = co;
  return static_cast<int>(launch_forward<float, 1>(p, static_cast<float*>(sq), s));
}

// As the forward, plus y and dy (n, co), ds and dq (co,) f32; outputs dx
// (n, ci), dw (ci, co) in the storage type, dab (2, ci) f32 = (da, db) with a
// prologue. float32: scratch part (ceil(n/64), 2, ci) f32 with a prologue and
// dw_part (splits, ci, co) f32; splits * chunk >= n; g, scratch, counters
// null. bfloat16: the plan (dx_block_n, dx_splits, dx_per, dw_splits,
// dw_per, dw_group) and the scratch of launch_backward_wgmma
// (fusedconv_wgmma_bwd.cuh): g (n, co) bf16, part, scratch (the dx pass's
// split partials), dw_part (the dw pass's) and counters; splits, chunk 0.
extern "C" int corrifnet_pw_bwd(const void* x, const void* w, const void* a,
                                const void* b, const void* y, const void* dy,
                                const void* ds, const void* dq, void* dx, void* dw,
                                void* dab, void* part, void* dw_part, void* g,
                                void* scratch, void* counters, int n, int ci, int co,
                                int splits, int chunk, int dtype, int relu_fma,
                                int dx_block_n, int dx_splits, int dx_per, int dw_splits,
                                int dw_per, int dw_group, void* stream) {
  if (n <= 0 || ci <= 0 || co <= 0 || (relu_fma != 0) != (a != nullptr) ||
      (a == nullptr) != (b == nullptr) || (a != nullptr) != (dab != nullptr) ||
      (a != nullptr && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const BwdPlan plan = {dx_block_n, dx_splits, dx_per, dw_splits, dw_per, dw_group};
    return static_cast<int>(launch_backward_wgmma<1>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const bf16*>(y), static_cast<const bf16*>(dy),
        static_cast<const float*>(ds), static_cast<const float*>(dq), static_cast<bf16*>(dx),
        static_cast<bf16*>(dw), static_cast<float*>(dab), static_cast<float*>(part),
        static_cast<float*>(scratch), static_cast<float*>(dw_part), static_cast<bf16*>(g),
        static_cast<int*>(counters), n, ci, co, 0, 0, plan, s));
  }
  if (dtype != 0 || dw_part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args p = {};
  p.x = x;
  p.w = w;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.y = y;
  p.dy = dy;
  p.ds = static_cast<const float*>(ds);
  p.dq = static_cast<const float*>(dq);
  p.n = n;
  p.ci = ci;
  p.co = co;
  p.chunk = chunk;
  return static_cast<int>(launch_backward<float, 1>(
      p, dx, dw, static_cast<float*>(dab), static_cast<float*>(part),
      static_cast<float*>(dw_part), splits, s));
}
