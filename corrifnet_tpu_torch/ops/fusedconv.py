"""Fused bottleneck convolutions: the previous BatchNorm's apply + ReLU on the
input load, the product, and the output's per-channel batch statistics.

Counterpart of ``corrifnet_tpu/ops/fusedconv.py``. Two functions, both
differentiable, both channels-last:

* ``pointwise_conv_stats(x, w, a=None, b=None)``: the bottleneck's 1x1 convs.
  ``z = relu(x * a + b)`` (or ``z = x``), ``y = z @ w``, ``s = sum_rows y``,
  ``q = sum_rows y^2``. ``x`` is ``(..., ci)``, ``w`` ``(ci, co)``, ``a`` and
  ``b`` ``(ci,)`` f32.
* ``conv3x3_fma_relu_stats(x, w, a, b)``: the bottleneck's (1, 3, 3) conv at
  stride 1 with the depth axis folded into the batch. ``x`` is
  ``(B, H, W, ci)``, ``w`` ``(3, 3, ci, co)``; ``z`` is zero-padded (1, 1)
  *after* the prologue, so the border is 0 and not ``relu(b)``.

The rounding points are part of the functions: the prologue multiplies and
adds in the compute dtype; products accumulate in f32; ``s`` and ``q`` come
from the f32 accumulator before ``y`` is rounded. In the backward the
cotangents of ``s`` and ``q`` fold into the output's, ``g = dy + ds + 2 dq y``
rounded to the compute dtype; ``dw`` accumulates in f32 and is then cast;
``dz`` is rounded before the mask ``pre > 0``; ``da`` and ``db`` accumulate
in f32.

Kernels (CUDA C++, ``csrc/fusedconv_pw.cu`` and ``csrc/fusedconv_c3.cu`` over
``csrc/fusedconv_common.cuh``, ``csrc/fusedconv_wgmma.cuh`` and
``csrc/fusedconv_wgmma_bwd.cuh``): K4a replaces ``_pw_kernel``, K4b
``_pw_bwd_kernel``, K4c ``_c3_kernel``, K4d ``_c3_bwd_kernel``
(``corrifnet_tpu/ops/fusedconv.py:142,211,418,514``). The kernel is chosen
by dtype, never by shape: in bfloat16 all four run on the tensor cores
(``wgmma``): a forward is one launch with the statistics, its contraction
split over blocks by ``forward_plan``; a backward is three launches (g
written once, the dx pass with da and db, the dw pass), planned by
``backward_plan``. In float32 all four run the f32 FMA kernels. Channels
that are not a multiple of 8, or operands that are not 16-byte aligned, run
the same bfloat16 kernels with element loads instead of 16-byte copies. The
TPU kernels add into one resident block over a sequential grid; thread
blocks cannot, so every sum across blocks (``s``, ``q``, ``da``, ``db``,
``dw``, the split contraction) is written as per-block partial sums into a
scratch buffer and added in a fixed order: by the last block to arrive (an
integer ticket; the counters are one buffer per CUDA stream, 0 on entry and
left at 0) in bfloat16, by a second pass in float32. No float atomics: two
runs give the same bits. Each wrapper's count goes up by one per call,
whatever the number of passes.

Each wrapper takes its plain version below for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from corrifnet_tpu_torch.ops.build import PLAIN_DEVICES, load_cuda_library

__all__ = [
    "backward_plan",
    "conv3x3_fma_relu_stats",
    "conv3x3_fma_relu_stats_backward_plain",
    "conv3x3_fma_relu_stats_bwd",
    "conv3x3_fma_relu_stats_plain",
    "forward_plan",
    "pointwise_conv_stats",
    "pointwise_conv_stats_backward_plain",
    "pointwise_conv_stats_bwd",
    "pointwise_conv_stats_plain",
]

TILE = 64  # rows and columns of one block's output tile (csrc/fusedconv_common.cuh)
# blocks the weight-gradient pass aims for: four per SM of an H100
_WGRAD_BLOCKS = 528
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the bfloat16 forward (csrc/fusedconv_wgmma.cuh): rows of y a block, the
# contraction depth of one iteration, and the blocks split-K aims for: half
# the SMs of an H100 (scripts/bench_torch_fusedconv.py: splitting further
# cost more than it gave at the model's shapes)
WG_ROWS, WG_DEPTH, WG_BLOCKS = 128, 64, 66
# the bfloat16 backward's dw pass (csrc/fusedconv_wgmma_bwd.cuh): channels
# of x and of g a block (the 64 x 64 tile of dw) and pixels a stage; the
# blocks its split over the rows aims for (two per SM of an H100) and the
# fewest stages a split holds, so that a split's f32 partial tile stays
# small beside what it reads (scripts/bench_torch_fusedconv.py: 8 stages a
# split cost more in partial tiles than the blocks gave at the 1x1 shapes)
DW_TILE, DW_STAGE, DW_BLOCKS, DW_MIN_STAGES = 64, 64, 264, 16


# ------------------------------------------------------------ plain versions


def _prologue(x, a, b):
    """``relu(x * a + b)`` with the multiply and the add in x's dtype."""
    return torch.relu(x * a.to(x.dtype) + b.to(x.dtype))


def _stats(yf, dtype):
    rows = yf.reshape(-1, yf.shape[-1])
    return yf.to(dtype), rows.sum(dim=0), (rows * rows).sum(dim=0)


def pointwise_conv_stats_plain(x, w, a=None, b=None):
    """Plain PyTorch version of K4a (``pointwise_conv_stats_xla``): x
    ``(n, ci)``, returns ``(y, s, q)`` with f32 accumulation and f32 sums."""
    z = _prologue(x, a, b) if a is not None else x
    return _stats(z.float() @ w.float(), x.dtype)


def _shifted(zp, u, v, h, w):
    """The (u, v) tap's window of a (1, 1)-padded image batch, as rows."""
    return zp[:, u:u + h, v:v + w, :].reshape(-1, zp.shape[-1])


def conv3x3_fma_relu_stats_plain(x, w, a, b):
    """Plain PyTorch version of K4c (``conv3x3_fma_relu_stats_xla``), written
    as the nine shifted products the kernels compute."""
    n, h, wd, _ = x.shape
    zp = F.pad(_prologue(x, a, b).float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    yf = sum(_shifted(zp, u, v, h, wd) @ wf[u, v] for u in range(3) for v in range(3))
    return _stats(yf.view(n, h, wd, -1), x.dtype)


def _out_cotangent(y, dy, ds, dq):
    """``g = dy + ds + 2 dq y`` in f32, rounded to y's dtype."""
    return (dy.float() + ds + 2.0 * dq * y.float()).to(y.dtype)


def _prologue_backward(x, a, pre, dz):
    """(dx, da, db) of the prologue from ``dz`` in the compute dtype."""
    dpre = torch.where(pre > 0, dz, torch.zeros_like(dz))
    dpf = dpre.float().reshape(-1, x.shape[-1])
    da = (dpf * x.float().reshape(-1, x.shape[-1])).sum(dim=0)
    return dpre * a.to(x.dtype), da, dpf.sum(dim=0)


def pointwise_conv_stats_backward_plain(x, w, a, b, y, dy, ds, dq):
    """Plain PyTorch version of K4b (``_pw_bwd_math``): ``(dx, dw, da, db)``,
    the last two None without a prologue."""
    dt = x.dtype
    g = _out_cotangent(y, dy, ds, dq)
    pre = x * a.to(dt) + b.to(dt) if a is not None else None
    z = torch.relu(pre) if a is not None else x
    dw = (z.float().t() @ g.float()).to(w.dtype)
    dz = (g.float() @ w.float().t()).to(dt)
    if a is None:
        return dz, dw, None, None
    dx, da, db = _prologue_backward(x, a, pre, dz)
    return dx, dw, da, db


def conv3x3_fma_relu_stats_backward_plain(x, w, a, b, y, dy, ds, dq):
    """Plain PyTorch version of K4d (the composition in ``_c3_bwd``):
    ``dw[u, v] = z_shift(u, v)^T g`` in f32, ``dz = sum g_shift(u, v)
    w[2-u, 2-v]^T``, then the prologue's backward."""
    dt = x.dtype
    n, h, wd, ci = x.shape
    g = _out_cotangent(y, dy, ds, dq)
    pre = x * a.to(dt) + b.to(dt)
    zp = F.pad(torch.relu(pre).float(), (0, 0, 1, 1, 1, 1))
    gp = F.pad(g.float(), (0, 0, 1, 1, 1, 1))
    g2 = g.float().reshape(-1, g.shape[-1])
    wf = w.float()
    dw = torch.stack([
        torch.stack([_shifted(zp, u, v, h, wd).t() @ g2 for v in range(3)])
        for u in range(3)
    ]).to(w.dtype)
    dz = sum(_shifted(gp, u, v, h, wd) @ wf[2 - u, 2 - v].t()
             for u in range(3) for v in range(3))
    dx, da, db = _prologue_backward(x, a, pre, dz.view(n, h, wd, ci).to(dt))
    return dx, dw, da, db


# ------------------------------------------------------------------ kernels


@functools.lru_cache(maxsize=None)
def _pointwise_library():
    lib = load_cuda_library("fusedconv_pw.cu")
    fwd, bwd = lib.corrifnet_pw_fwd, lib.corrifnet_pw_bwd
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _conv3x3_library():
    lib = load_cuda_library("fusedconv_c3.cu")
    fwd, bwd = lib.corrifnet_c3_fwd, lib.corrifnet_c3_bwd
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _library(taps):
    """(forward, backward) launchers of the 1x1 (taps 1) or 3x3 (taps 9) conv."""
    return _pointwise_library() if taps == 1 else _conv3x3_library()


def _check(x, w, a, b, taps, others=()):
    """Raise on what the kernels do not take; returns (rows, ci, co)."""
    if x.dim() != (2 if taps == 1 else 4):
        raise ValueError(f"x must be {'(n, ci)' if taps == 1 else '(B, H, W, ci)'}, "
                         f"got {tuple(x.shape)}")
    ci = x.shape[-1]
    want_w = (ci, w.shape[-1]) if taps == 1 else (3, 3, ci, w.shape[-1])
    if tuple(w.shape) != want_w:
        raise ValueError(f"w must be {want_w}, got {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 x and w of one dtype, "
                         f"got {x.dtype} and {w.dtype}")
    if (a is None) != (b is None) or (taps == 9 and a is None):
        raise ValueError("a and b come together (and the 3x3 conv needs both)")
    for name, vec in (("a", a), ("b", b)):
        if vec is not None and (vec.dtype != torch.float32 or tuple(vec.shape) != (ci,)):
            raise ValueError(f"{name} must be float32 ({ci},), got {vec.dtype} "
                             f"{tuple(vec.shape)}")
    tensors = [x, w, *(t for t in (a, b) if t is not None), *others]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel takes contiguous operands")
    rows = x.numel() // ci
    if rows == 0 or rows * max(ci, w.shape[-1]) >= 2 ** 31:
        raise ValueError(f"kernel takes 1 <= rows * channels < 2^31, got {rows} rows")
    return rows, ci, w.shape[-1]


def _check_cotangents(x, w, y, dy, ds, dq):
    co = w.shape[-1]
    want = (*x.shape[:-1], co)
    for name, t in (("y", y), ("dy", dy)):
        if tuple(t.shape) != want or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {x.dtype} {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("ds", ds), ("dq", dq)):
        if tuple(t.shape) != (co,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({co},), got {t.dtype} "
                             f"{tuple(t.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _f32(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def wgrad_plan(rows, ci, co, taps):
    """(splits, rows per split) of the float32 weight-gradient pass: the
    contraction over the rows is cut so that about ``_WGRAD_BLOCKS`` blocks
    run, each over at least 128 rows; the splits' partial products are added
    in order by the second pass."""
    tiles = -(-ci // TILE) * -(-co // TILE) * taps
    splits = max(1, min(-(-rows // 128), _WGRAD_BLOCKS // tiles))
    chunk = -(-(-(-rows // splits)) // 16) * 16
    return -(-rows // chunk), chunk


def forward_plan(rows, ci, co, taps, block_n=None, blocks=WG_BLOCKS):
    """(block_n, splits, iterations per split) of the bfloat16 forward.

    A block computes 128 rows by ``block_n`` columns of y (64 for co <= 64,
    else 128); its contraction is ``taps * ceil(ci / 64)`` iterations of 64
    channels of one tap. Where the tiles are fewer than ``blocks``, the
    contraction is split over blocks (split-K) until there are at least
    ``blocks`` blocks or one iteration a split; every split holds at least
    one iteration. A function of the shape only: y is the same bits with
    and without the statistics. The wrappers take the defaults;
    ``scripts/bench_torch_fusedconv.py`` times other widths and targets."""
    block_n = block_n or (64 if co <= 64 else 128)
    tiles = -(-rows // WG_ROWS) * -(-co // block_n)
    iters = taps * -(-ci // WG_DEPTH)
    per = iters // max(1, min(iters, -(-blocks // tiles)))
    return block_n, -(-iters // per), per


def backward_plan(rows, ci, co, taps, dx_block_n=None, dx_blocks=WG_BLOCKS,
                  dw_blocks=DW_BLOCKS):
    """The plan of the bfloat16 backward: ``((block_n, splits, per_split)``
    of the dx pass, ``(splits, stages per split, splits per group))`` of the
    dw pass.

    The dx pass is the forward's product with the roles swapped (the
    contraction over ``taps * co``, the columns ``ci``), so its plan is
    ``forward_plan(rows, co, ci, taps, block_n)``, with 128 columns a block
    only where ci > 64 and 128-column tiles number at least ``WG_BLOCKS``
    (fewer and wider tiles split the deep contraction more, which cost more
    than 64-column tiles at the few-row shapes). The dw pass computes a 64 x
    64 tile of dw a block, one tap a block, over stages of 64 pixels; the
    stages are split over blocks until about ``dw_blocks`` blocks run or a
    split would hold fewer than ``DW_MIN_STAGES`` (at least one split, every
    split at least one stage). Its split partials are added by groups of
    about sqrt(splits), then the groups' sums, each in index order. A
    function of the shape only. The wrappers take the defaults;
    ``scripts/bench_torch_fusedconv.py`` times other widths and targets."""
    if dx_block_n is None:
        wide = ci > 64 and -(-rows // WG_ROWS) * -(-ci // 128) >= WG_BLOCKS
        dx_block_n = 128 if wide else 64
    dx = forward_plan(rows, co, ci, taps, dx_block_n, dx_blocks)
    tiles = -(-ci // DW_TILE) * -(-co // DW_TILE) * taps
    stages = -(-rows // DW_STAGE)
    want = max(1, min(-(-dw_blocks // tiles), stages // DW_MIN_STAGES))
    per = -(-stages // want)
    splits = -(-stages // per)
    return dx, (splits, per, math.isqrt(splits - 1) + 1)


_COUNTERS = {}


def _counters(x, size):
    """Ticket counters of the bfloat16 kernels on x's device and current
    stream. The kernel needs them 0 on entry and leaves them 0, so launches
    that share them must run in order: one buffer per stream (two streams
    never share one), kept between calls and grown when a shape needs more;
    made on the stream, so its zeros come before the launch."""
    key = (x.device, _stream(x))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(size, 4096), dtype=torch.int32, device=x.device)
        _COUNTERS[key] = buf
    return buf


def _launch_forward(x, w, a, b, stats, taps):
    rows, ci, co = _check(x, w, a, b, taps)
    launch = _library(taps)[0]
    y = torch.empty((*x.shape[:-1], co), dtype=x.dtype, device=x.device)
    sq = _f32((2, co), x) if stats else None
    part = scratch = counters = None
    block_n = splits = per = 0
    if x.dtype == torch.bfloat16:
        block_n, splits, per = forward_plan(rows, ci, co, taps)
        row_blocks, col_tiles = -(-rows // WG_ROWS), -(-co // block_n)
        if stats:
            part = _f32((col_tiles, row_blocks, 2, block_n), x)
        if splits > 1:
            scratch = _f32((row_blocks * col_tiles, splits, WG_ROWS, block_n), x)
        counters = _counters(x, row_blocks * col_tiles + col_tiles)
    elif stats:
        part = _f32((-(-rows // TILE), 2, co), x)
    dims = (rows, ci, co) if taps == 1 else (*x.shape[:3], ci, co)
    flags = (int(a is not None), int(stats)) if taps == 1 else (int(stats),)
    err = launch(_ptr(x), _ptr(w), _ptr(a), _ptr(b), _ptr(y), _ptr(part), _ptr(sq),
                 _ptr(scratch), _ptr(counters), *dims, _DTYPE_CODES[x.dtype], *flags,
                 block_n, splits, per, _stream(x))
    if err != 0:
        raise RuntimeError(f"fused conv forward ({taps} taps) launch failed: "
                           f"cudaError {err}")
    return (y, sq[0], sq[1]) if stats else (y, None, None)


def _launch_backward(x, w, a, b, y, dy, ds, dq, taps):
    rows, ci, co = _check(x, w, a, b, taps, (y, dy, ds, dq))
    _check_cotangents(x, w, y, dy, ds, dq)
    launch = _library(taps)[1]
    pro = a is not None
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    dab = _f32((2, ci), x) if pro else None
    g = scratch = counters = None
    if x.dtype == torch.bfloat16:
        splits = chunk = 0
        dx_plan, dw_plan = backward_plan(rows, ci, co, taps)
        (dx_n, dx_splits, _), (dw_splits, _, group) = dx_plan, dw_plan
        row_blocks, col_tiles = -(-rows // WG_ROWS), -(-ci // dx_n)
        g = torch.empty((rows, co), dtype=x.dtype, device=x.device)
        part = _f32((col_tiles, row_blocks, 2, dx_n), x) if pro else None
        if dx_splits > 1:
            scratch = _f32((row_blocks * col_tiles, dx_splits, WG_ROWS, dx_n), x)
        tiles = -(-ci // DW_TILE) * -(-co // DW_TILE) * taps
        groups = -(-dw_splits // group)
        dw_part = (_f32((tiles, dw_splits + groups, DW_TILE, DW_TILE), x)
                   if dw_splits > 1 else None)
        counters = _counters(x, max(row_blocks * col_tiles + col_tiles,
                                    tiles * groups + tiles))
        plan = (*dx_plan, *dw_plan)
    else:
        splits, chunk = wgrad_plan(rows, ci, co, taps)
        part = _f32((-(-rows // TILE), 2, ci), x) if pro else None
        dw_part = _f32((splits, *w.shape), x)
        plan = (0,) * 6
    dims = (rows, ci, co) if taps == 1 else (*x.shape[:3], ci, co)
    flags = (int(pro),) if taps == 1 else ()
    err = launch(_ptr(x), _ptr(w), _ptr(a), _ptr(b), _ptr(y), _ptr(dy), _ptr(ds),
                 _ptr(dq), _ptr(dx), _ptr(dw), _ptr(dab), _ptr(part), _ptr(dw_part),
                 _ptr(g), _ptr(scratch), _ptr(counters), *dims, splits, chunk,
                 _DTYPE_CODES[x.dtype], *flags, *plan, _stream(x))
    if err != 0:
        raise RuntimeError(f"fused conv backward ({taps} taps) launch failed: "
                           f"cudaError {err}")
    return (dx, dw, dab[0], dab[1]) if pro else (dx, dw, None, None)


def _on_cpu(x):
    if x.device.type not in (*PLAIN_DEVICES, "cuda"):
        raise ValueError(f"no fused conv kernel for device {x.device}")
    return x.device.type in PLAIN_DEVICES


def _forward(x, w, a, b, stats, taps):
    if _on_cpu(x):
        plain = pointwise_conv_stats_plain if taps == 1 else conv3x3_fma_relu_stats_plain
        y, s, q = plain(x, w, a, b)
        return (y, s, q) if stats else (y, None, None)
    out = _launch_forward(x, w, a, b, stats, taps)
    (pointwise_conv_stats if taps == 1 else conv3x3_fma_relu_stats).launches += 1
    return out


def pointwise_conv_stats_bwd(x, w, a, b, y, dy, ds, dq):
    """``(dx, dw, da, db)`` of ``pointwise_conv_stats`` on rows ``(n, ci)``
    from its inputs, its output ``y`` and the three cotangents. CPU tensors:
    the plain formula. CUDA tensors: kernel K4b (its passes count as one
    launch), or an exception; never the plain version or another kernel."""
    if _on_cpu(x):
        return pointwise_conv_stats_backward_plain(x, w, a, b, y, dy, ds, dq)
    out = _launch_backward(x, w, a, b, y, dy, ds, dq, 1)
    pointwise_conv_stats_bwd.launches += 1
    return out


def conv3x3_fma_relu_stats_bwd(x, w, a, b, y, dy, ds, dq):
    """``(dx, dw, da, db)`` of ``conv3x3_fma_relu_stats``. CPU tensors: the
    plain formula. CUDA tensors: kernel K4d, or an exception."""
    if _on_cpu(x):
        return conv3x3_fma_relu_stats_backward_plain(x, w, a, b, y, dy, ds, dq)
    out = _launch_backward(x, w, a, b, y, dy, ds, dq, 9)
    conv3x3_fma_relu_stats_bwd.launches += 1
    return out


class _FusedConvStats(torch.autograd.Function):
    """K4a or K4c forward (``taps`` 1 or 9), K4b or K4d backward."""

    @staticmethod
    def forward(ctx, x, w, a, b, stats, taps):
        y, s, q = _forward(x, w, a, b, stats, taps)
        ctx.save_for_backward(x, w, a, b, y)
        ctx.taps = taps
        return y, s, q

    @staticmethod
    def backward(ctx, dy, ds, dq):
        x, w, a, b, y = ctx.saved_tensors
        co = w.shape[-1]
        # a cotangent that autograd did not produce is zero
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        ds = _f32((co,), y).zero_() if ds is None else ds.contiguous()
        dq = _f32((co,), y).zero_() if dq is None else dq.contiguous()
        bwd = pointwise_conv_stats_bwd if ctx.taps == 1 else conv3x3_fma_relu_stats_bwd
        dx, dw, da, db = bwd(x, w, a, b, y, dy, ds, dq)
        return dx, dw, da, db, None, None


def _prepare(x, w, a, b, taps):
    """The checks that must raise before autograd is involved."""
    if not _on_cpu(x):
        _check(x, w, a, b, taps)
        _library(taps)  # a failed build raises here


def pointwise_conv_stats(x, w, a=None, b=None, stats=True):
    """Fused 1x1 conv: ``(y (..., co), s (co,), q (co,))``; with ``a`` and
    ``b`` the previous BatchNorm's fold and a ReLU run on the input load.
    ``stats=False`` (evaluation) skips the statistics and returns None for
    them; ``y`` is the same bits. CPU tensors: the plain version. CUDA
    tensors: kernel K4a, and K4b in the backward, or an exception."""
    lead, ci = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, ci).contiguous()
    _prepare(x2, w, a, b, 1)
    y, s, q = _FusedConvStats.apply(x2, w, a, b, bool(stats), 1)
    return y.view(*lead, w.shape[-1]), s, q


def conv3x3_fma_relu_stats(x, w, a, b, stats=True):
    """Fused 3x3 stride-1 conv over ``(B, H, W, ci)`` images with the
    previous BatchNorm's fold and a ReLU on the input load, zero padding
    after them: ``(y (B, H, W, co), s, q)``. CPU tensors: the plain version.
    CUDA tensors: kernel K4c, and K4d in the backward, or an exception."""
    _prepare(x, w, a, b, 9)
    return _FusedConvStats.apply(x, w, a, b, bool(stats), 9)


pointwise_conv_stats.launches = 0
pointwise_conv_stats_bwd.launches = 0
conv3x3_fma_relu_stats.launches = 0
conv3x3_fma_relu_stats_bwd.launches = 0
