// Fused 3x3 stride-1 bottleneck convolution for Hopper (sm_90a), forward (K4c)
// and backward (K4d), over channels-last images (the depth axis folded into
// the batch by the caller):
//     z = relu(x*a + b), zero-padded (1, 1) after the prologue,
//     y = conv3x3(z, w),  s = sum_pixels y,  q = sum_pixels y^2
//     g = dy + ds + 2 dq y;  dw[u, v] = z_shift(u, v)^T g;
//     dz = sum_(u, v) g_shift(2-u, 2-v) w[u, v]^T;  dx, da, db as the 1x1 conv
//
// Replaces the TPU kernels corrifnet_tpu/ops/fusedconv.py::_c3_kernel (through
// _c3_pallas's pl.pallas_call) and ::_c3_bwd_kernel (through _c3_bwd_pallas).
// The TPU kernels stage whole zero-padded images and the whole (3, 3, ci, co)
// weight in fast memory; at 512 channels that weight alone is twenty times a
// block's shared memory, so here the conv is an implicit product of
// (pixels, 9 ci) by (9 ci, co), tiled like the 1x1 conv with the tap loop
// outside the channel loop, each tap reading its shifted pixel or 0 at the
// border (fusedconv_common.cuh). Every stride-1 shape of the model runs it:
// there is no size gate and no switch to another path.
//
// What bounds it on the H100: operations at every shape of the model (18 ci
// operations per output value against 2 + 2 bytes moved per value). The
// forward in bf16 is the tensor-core kernel of fusedconv_wgmma.cuh, the
// same implicit product with x read once per 64-channel chunk through a
// halo tile that the nine taps read at their shifted rows, the padding
// masked on z in registers, one launch with the statistics and split-K
// where the tiles are few (the 14x14 and 7x7 stages); in f32 it is the FMA
// rows_kernel. The backward K4d is built as K4b's (fusedconv_pw.cu): in bf16
// the three wgmma launches of fusedconv_wgmma_bwd.cuh, the dx pass reading g
// through the same halo tiles at the flipped taps and the dw pass one tap a
// block; in f32 the four FMA launches.
//
// C interface (bound with ctypes): each function returns the first
// cudaGetLastError() that is not success. dtype: 0 = float32, 1 = bfloat16.

#include "fusedconv_common.cuh"
#include "fusedconv_wgmma.cuh"
#include "fusedconv_wgmma_bwd.cuh"

using namespace corrifnet_fc;

namespace {

bool bad_shape(int imgs, int h, int wd, int ci, int co) {
  return imgs <= 0 || h <= 0 || wd <= 0 || ci <= 0 || co <= 0 ||
         (long long)imgs * h * wd >= (1LL << 31);
}

}  // namespace

// x (imgs, h, wd, ci), w (3, 3, ci, co), a and b (ci,) f32, y (imgs, h, wd, co);
// with stats sq (2, co) f32 and the scratch `part`; the bfloat16 plan and
// scratch as in corrifnet_pw_fwd, with n = imgs * h * wd.
extern "C" int corrifnet_c3_fwd(const void* x, const void* w, const void* a,
                                const void* b, void* y, void* part, void* sq,
                                void* scratch, void* counters, int imgs, int h, int wd,
                                int ci, int co, int dtype, int stats, int block_n,
                                int splits, int per_split, void* stream) {
  if (bad_shape(imgs, h, wd, ci, co) || a == nullptr || b == nullptr ||
      (stats != 0) != (sq != nullptr) || (stats != 0 && part == nullptr))
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
    p.n = imgs * h * wd;
    p.ci = ci;
    p.co = co;
    p.h = h;
    p.wd = wd;
    p.splits = splits;
    p.per_split = per_split;
    return static_cast<int>(launch_forward_wgmma<9>(p, block_n, s));
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args p = {};
  p.x = x;
  p.w = w;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = y;
  p.part = static_cast<float*>(part);
  p.n = imgs * h * wd;
  p.ci = ci;
  p.co = co;
  p.h = h;
  p.wd = wd;
  return static_cast<int>(launch_forward<float, 9>(p, static_cast<float*>(sq), s));
}

// As the forward, plus y and dy (imgs, h, wd, co), ds and dq (co,) f32; outputs
// dx (imgs, h, wd, ci), dw (3, 3, ci, co) in the storage type, dab (2, ci) f32.
// float32: scratch part (ceil(imgs*h*wd / 64), 2, ci) f32 and dw_part (splits,
// 3, 3, ci, co) f32; splits * chunk >= imgs*h*wd; g, scratch, counters null.
// bfloat16: the plan and scratch as in corrifnet_pw_bwd, n = imgs * h * wd.
extern "C" int corrifnet_c3_bwd(const void* x, const void* w, const void* a,
                                const void* b, const void* y, const void* dy,
                                const void* ds, const void* dq, void* dx, void* dw,
                                void* dab, void* part, void* dw_part, void* g,
                                void* scratch, void* counters, int imgs, int h, int wd,
                                int ci, int co, int splits, int chunk, int dtype,
                                int dx_block_n, int dx_splits, int dx_per, int dw_splits,
                                int dw_per, int dw_group, void* stream) {
  if (bad_shape(imgs, h, wd, ci, co) || a == nullptr || b == nullptr ||
      dab == nullptr || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const BwdPlan plan = {dx_block_n, dx_splits, dx_per, dw_splits, dw_per, dw_group};
    return static_cast<int>(launch_backward_wgmma<9>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const bf16*>(y), static_cast<const bf16*>(dy),
        static_cast<const float*>(ds), static_cast<const float*>(dq), static_cast<bf16*>(dx),
        static_cast<bf16*>(dw), static_cast<float*>(dab), static_cast<float*>(part),
        static_cast<float*>(scratch), static_cast<float*>(dw_part), static_cast<bf16*>(g),
        static_cast<int*>(counters), imgs * h * wd, ci, co, h, wd, plan, s));
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
  p.n = imgs * h * wd;
  p.ci = ci;
  p.co = co;
  p.h = h;
  p.wd = wd;
  p.chunk = chunk;
  return static_cast<int>(launch_backward<float, 9>(
      p, dx, dw, static_cast<float*>(dab), static_cast<float*>(part),
      static_cast<float*>(dw_part), splits, s));
}
