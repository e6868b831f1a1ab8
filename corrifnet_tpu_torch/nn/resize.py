"""Resizing and pooling with the reference's semantics, NCDHW (or NCHW).

Counterpart of ``corrifnet_tpu/nn/resize.py``. The reference mixes two
interpolation flavours: (bi/tri)linear (``align_corners=True`` in the
encoder's x6 pyramid, the decoder's up-sampling, ``up_to_224`` and RFNet's
cascade; ``False`` in RobustMseg's 2-D decoders) and bare
``F.interpolate(x, size)``, whose default mode is nearest (the decoder's
skip resizes). Every op here has a backward that runs in a fixed order, so
that training repeats its bits on the card (``utils/determinism.py``):

  * the linear resize is the JAX package's form: one product with the
    (dst, src) interpolation matrix per resized axis (``_linear_matrix``,
    built in float64 and cast), in f32, or, for the depth-fused decoder's
    H/W-only resize, in the compute dtype; its backward is the transposed
    product (PyTorch's ``upsample_{bi,tri}linear`` backwards add with
    atomics);
  * the nearest resize's backward is one product with the transposed
    one-hot matrix per axis, because PyTorch's CUDA kernel for it
    (``upsample_nearest3d_backward``) takes its source ranges from ``ceil(i
    * dst / src)`` in float32 and is off by one where ``dst / src`` is not a
    binary fraction (56 -> 64 at i = 21, 49; 28 -> 32; 56 -> 128): the
    decoder's skip gradients at three of its five levels came out 10 to 40
    percent wrong on the card and right on the CPU;
  * max pooling's backward adds each window's gradient at its argmax, one
    strided add per window tap in a fixed order (PyTorch's scatters with
    atomics where windows overlap, as the MMVit4 stem's do). 2-D pooling
    (MultiSenseSeg's AMM and decode gate, UNetV2's down paths) runs on a
    depth-1 view of the input, so it keeps that backward and its rule for
    ties: the pooled inputs there follow a ReLU, and windows of zeros are
    common;
  * ``adaptive_max_pool`` is the JAX package's: one ``amax`` per output
    cell over its slice, whose gradient is spread evenly over tied entries
    as ``jnp.max``'s is (PyTorch's ``adaptive_max_pool2d`` backward has no
    deterministic CUDA implementation);
  * ``max_pool_argmax`` (ENet's down-sampling bottlenecks) is the JAX
    package's too: the k*k strided tap slices of the input padded with
    f32's lowest value, ``amax`` over them for the values (its gradient
    spread evenly over tied entries, as ``jnp.max``'s is, where ``max_pool``
    gives a tie to one entry, as the JAX ``max_pool`` does) and ``argmax``
    for the flat indices (the first largest entry, in window order).
    ``F.max_pool2d(return_indices=True)`` would give a tie to one entry and
    scatter its gradient with atomics;
  * the depth-prefix resizes of the depth-pruned decoder
    (``resize_linear_depth_prefix``, ``resize_nearest_depth_prefix``)
    compute only the leading depth rows of a resize: a product with the
    first rows of the interpolation matrix (or of the one-hot nearest
    matrix), so their backwards are transposed products too (a row
    selection by ``index_select`` would add its gradient with a scatter);
  * ``max_unpool`` places each value at its index, the last writer in
    row-major pooled order winning where indices repeat (the JAX package's
    scatter on the CPU), through a reduction of each target to its largest
    writer rank and a gather; its backward gives every writer the gradient
    at its index, as the reference's ``MaxUnpool2d`` and the JAX custom VJP
    do. ``F.max_unpool2d`` has no deterministic CUDA implementation.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["adaptive_max_pool", "avg_pool", "max_pool", "max_pool_argmax", "max_unpool",
           "resize_linear", "resize_linear_depth_prefix", "resize_nearest",
           "resize_nearest_depth_prefix"]


@functools.lru_cache(maxsize=None)
def _linear_matrix(src: int, dst: int, align_corners: bool = True) -> np.ndarray:
    """(dst, src) linear interpolation matrix, float64 (the JAX package's
    ``_linear_matrix(src, dst, align_corners)``)."""
    w = np.zeros((dst, src), dtype=np.float64)
    for i in range(dst):
        if align_corners:
            x = i * (src - 1) / (dst - 1) if dst > 1 else 0.0
        else:
            x = max((i + 0.5) * src / dst - 0.5, 0.0)
        lo = min(int(np.floor(x)), src - 1)
        hi = min(lo + 1, src - 1)
        frac = x - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


@functools.lru_cache(maxsize=None)
def _linear_tensor(src, dst, align_corners, dtype, device):
    return torch.from_numpy(_linear_matrix(src, dst, align_corners)).to(
        device=device, dtype=dtype)


def _resize_axis(x, dst, dtype):
    """x (N, src, M) -> (N, dst, M): the interpolation matrix times each
    x[n] in ``dtype`` (f32 accumulation, one rounding)."""
    m = _linear_tensor(x.shape[1], dst, True, dtype, x.device)
    return torch.bmm(m.expand(x.shape[0], -1, -1), x)


def _resize_dim(x, dim, dst, align_corners):
    """x resized along ``dim`` to ``dst`` by one product with the
    interpolation matrix, in x's dtype."""
    src = x.shape[dim]
    if src == dst:
        return x
    m = _linear_tensor(src, dst, align_corners, x.dtype, x.device)
    if dim == x.dim() - 1:
        return torch.matmul(x, m.t())
    lead, trail = x.shape[:dim], x.shape[dim + 1:]
    y = torch.matmul(m, x.reshape(-1, src, math.prod(trail)))
    return y.view(*lead, dst, *trail)


def resize_linear(x, size: Sequence[int], align_corners: bool = True,
                  compute_dtype=None):
    """(Bi/tri)linear resize of the spatial axes of x (B, C, *spatial) to
    ``size``, interpolated in f32, axis by axis in order, and returned in x's
    dtype. With ``compute_dtype`` and the depth unchanged (the depth-fused
    decoder's up2, align_corners=True) it is JAX's form of that resize
    instead: W, then H, each a product with the interpolation matrix in
    ``compute_dtype``, on x's channels-last memory, returned channels-last."""
    size = tuple(size)
    if tuple(x.shape[2:]) == size:
        return x
    if compute_dtype is None:
        y = x.float()
        for i, dst in enumerate(size):
            y = _resize_dim(y, 2 + i, dst, align_corners)
        return y.to(x.dtype)
    b, c, d, h, w = x.shape
    if size[0] != d or not align_corners:
        raise ValueError(f"a resize in {compute_dtype} keeps the depth and aligns the "
                         f"corners: {x.shape} -> {size}")
    _, dh, dw = size
    t = x.permute(0, 2, 3, 4, 1).to(compute_dtype).reshape(b * d * h, w, c)
    t = _resize_axis(t, dw, compute_dtype).view(b * d, h, dw * c)
    t = _resize_axis(t, dh, compute_dtype)
    return t.view(b, d, dh, dw, c).permute(0, 4, 1, 2, 3).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _nearest_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) one-hot nearest matrix, source index
    ``min(floor(j * (src / dst)), src - 1)`` in float64 (the JAX package's
    rule). PyTorch's float32 rule gives the same rows wherever src / dst is
    exact in float32, as for every skip depth the decoders give it: 3 (all of
    MMVit4's skips, MMVit2's x1), 2 (MMVit2's x2) and 1 (its x3, x4) to
    16..128."""
    idx = np.minimum(np.floor(np.arange(dst) * (src / dst)).astype(np.int64), src - 1)
    w = np.zeros((dst, src), dtype=np.float64)
    w[np.arange(dst), idx] = 1.0
    return w


@functools.lru_cache(maxsize=None)
def _nearest_one_hot(src: int, dst: int, dtype, device):
    """(dst, src) matrix with a single 1 per row at the source index of
    PyTorch's nearest resize, ``min(floor(j * (src / dst)), src - 1)`` in
    float32 as its kernels compute it."""
    scale = torch.tensor(src, dtype=torch.float32) / dst
    index = (torch.arange(dst, dtype=torch.float32) * scale).floor().long()
    index = index.clamp_max(src - 1)
    return F.one_hot(index, src).to(dtype=dtype, device=device)


class _ResizeNearest(torch.autograd.Function):
    """``F.interpolate(x, size)`` forward; the backward sums, for every
    source voxel, the gradients of the voxels copied from it: one product
    with the transposed one-hot matrix per axis (exact selections, f32
    accumulation, no atomics)."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.src = tuple(x.shape[2:])
        return F.interpolate(x, size=size, mode="nearest")

    @staticmethod
    def backward(ctx, g):
        for axis, out in (("w", "bcdhw,wk->bcdhk"), ("h", "bcdhw,hk->bcdkw"),
                          ("d", "bcdhw,dk->bckhw")):
            i = "dhw".index(axis)
            src, dst = ctx.src[i], g.shape[2 + i]
            if src != dst:
                g = torch.einsum(out, g, _nearest_one_hot(src, dst, g.dtype, g.device))
        return g, None


def resize_nearest(x, size: Sequence[int]):
    """PyTorch's default (nearest) resize of NCDHW (or NCHW) input: source
    index floor(dst * src / dst). NCHW runs on a depth-1 view, so that it
    keeps the backward above (DeepLabv3_plus's image pool, Segformer's
    debug fusion)."""
    size = tuple(size)
    if tuple(x.shape[2:]) == size:
        return x
    if x.dim() == 4:
        return _ResizeNearest.apply(x.unsqueeze(2), (1, *size)).squeeze(2)
    return _ResizeNearest.apply(x, size)


def _depth_rows(x, m):
    """x (B, C, D, H, W) -> (B, C, P, H, W): output row p is
    ``sum_d m[p, d] x[:, :, d]``, one product (its backward the transposed
    product)."""
    return torch.einsum("pd,bcdhw->bcphw", m, x)


def resize_linear_depth_prefix(x, src_d_full: int, dst_d_full: int, d_prefix: int,
                               hw_size, align_corners: bool = True):
    """The first ``d_prefix`` depth rows of the trilinear resize of a
    ``src_d_full``-deep volume to ``(dst_d_full, *hw_size)``
    (``corrifnet_tpu/nn/resize.py:175-196``): the same interpolation weights
    as the whole resize, only fewer output rows. x is (B, C, D', H, W) where
    D' may already be a prefix of ``src_d_full``; it must hold every source
    row the output rows read (``ValueError`` otherwise). The depth product
    runs in f32, then the H/W resize in f32, and the result is cast back to
    x's dtype, as the JAX package's."""
    w = _linear_matrix(src_d_full, dst_d_full, align_corners)[:d_prefix]
    needed = int(np.nonzero(np.any(w != 0, axis=0))[0].max()) + 1
    if needed > x.shape[2]:
        raise ValueError(f"depth prefix {x.shape[2]} too small: need {needed} source slices")
    xf = x.float()
    m = torch.from_numpy(np.ascontiguousarray(w[:, :x.shape[2]])).to(
        device=x.device, dtype=xf.dtype)
    y = resize_linear(_depth_rows(xf, m), (d_prefix, *hw_size), align_corners)
    return y.to(x.dtype)


def resize_nearest_depth_prefix(x, dst_d_full: int, d_prefix: int, hw_size):
    """The first ``d_prefix`` depth rows of the nearest resize of x (B, C,
    D, H, W) to ``(dst_d_full, *hw_size)`` (``corrifnet_tpu/nn/
    resize.py:199-206``): the depth rows selected by a product with the
    one-hot rows of the JAX package's rule (exact in any dtype, one 1 per
    row), then ``resize_nearest`` in H and W."""
    m = _nearest_matrix(x.shape[2], dst_d_full)[:d_prefix]
    m = torch.from_numpy(np.ascontiguousarray(m)).to(device=x.device, dtype=x.dtype)
    return resize_nearest(_depth_rows(x, m), (d_prefix, *hw_size))


class _MaxPool(torch.autograd.Function):
    """``F.max_pool3d`` forward; the backward adds each output's gradient
    at its window's argmax (the first largest entry in window order, as
    PyTorch's forward and XLA's ``select_and_scatter_add`` under the JAX
    package's ``reduce_window`` max both choose), tap by tap in window order,
    accumulated in f32 (f64 for f64)."""

    @staticmethod
    def forward(ctx, x, window, strides, padding):
        y, index = F.max_pool3d(x, window, strides, padding, return_indices=True)
        ctx.save_for_backward(index)
        ctx.shape, ctx.window, ctx.strides, ctx.padding = x.shape, window, strides, padding
        return y

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        spatial = ctx.shape[2:]
        tap = torch.zeros_like(index)
        rest = index
        for axis in reversed(range(3)):
            n, k, s, p = spatial[axis], ctx.window[axis], ctx.strides[axis], ctx.padding[axis]
            start = torch.arange(g.shape[2 + axis], device=g.device) * s - p
            shape = [1, 1, 1, 1, 1]
            shape[2 + axis] = -1
            offset = rest % n - start.view(shape)  # the argmax's place in its window
            rest = rest // n
            stride = math.prod(ctx.window[axis + 1:])
            tap = tap + offset * stride
        gf = g.to(torch.promote_types(g.dtype, torch.float32))
        padded = [n + 2 * p for n, p in zip(spatial, ctx.padding)]
        gx = gf.new_zeros((*ctx.shape[:2], *padded))
        out = g.shape[2:]
        for t, (a, b, c) in enumerate(itertools.product(*(range(k) for k in ctx.window))):
            view = gx[:, :, a:a + ctx.strides[0] * (out[0] - 1) + 1:ctx.strides[0],
                      b:b + ctx.strides[1] * (out[1] - 1) + 1:ctx.strides[1],
                      c:c + ctx.strides[2] * (out[2] - 1) + 1:ctx.strides[2]]
            view.add_(torch.where(tap == t, gf, 0.0))
        pd, ph, pw = ctx.padding
        core = gx[:, :, pd:pd + spatial[0], ph:ph + spatial[1], pw:pw + spatial[2]]
        return core.to(g.dtype), None, None, None


def max_pool(x, window, strides=None, padding=None):
    """Max pooling of NCDHW (3-D window) or NCHW (2-D window) input, padded
    with -inf (the MMVit4 stem's MaxPool3d; MaxPool2d); ``strides``
    defaults to the window and ``padding`` to 0, as in the JAX package."""
    window = tuple(window)
    strides = tuple(strides) if strides is not None else window
    padding = tuple(padding) if padding is not None else (0,) * len(window)
    if len(window) == 3:
        return _MaxPool.apply(x, window, strides, padding)
    y = _MaxPool.apply(x.unsqueeze(2), (1, *window), (1, *strides), (0, *padding))
    return y.squeeze(2)


def adaptive_max_pool(x, out_hw):
    """PyTorch's AdaptiveMaxPool2d on NCHW input: output cell (i, j) is the
    max over rows [floor(i*H/oh), ceil((i+1)*H/oh)) and columns
    [floor(j*W/ow), ceil((j+1)*W/ow)) (``corrifnet_tpu/nn/resize.py:213``)."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    rows = []
    for i in range(oh):
        r0, r1 = (i * h) // oh, -(-((i + 1) * h) // oh)
        cols = [x[:, :, r0:r1, (j * w) // ow:-(-((j + 1) * w) // ow)].amax(dim=(2, 3))
                for j in range(ow)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)  # (B, C, oh, ow)


def avg_pool(x, window, strides=None, padding=None, count_include_pad=True):
    """2-D average pooling of NCHW input (``corrifnet_tpu/nn/resize.py:156``):
    summed in f32 and returned in x's dtype; the divisor counts padded zeros
    unless ``count_include_pad`` is False, as PyTorch's default does."""
    y = F.avg_pool2d(x.float(), tuple(window), tuple(strides or window),
                     tuple(padding or (0,) * len(window)),
                     count_include_pad=count_include_pad)
    return y.to(x.dtype)


def max_pool_argmax(x, k: int, stride: int, padding: int):
    """(values, flat indices) of a k x k max pool of NCHW input, PyTorch's
    ``MaxPool2d(return_indices=True)`` semantics (``corrifnet_tpu/nn/
    resize.py:246``): each index is the row-major position in the unpadded
    H*W plane of its (sample, channel). Ties: see the module docstring."""
    h, w = x.shape[2:]
    xp = F.pad(x.float(), (padding,) * 4, value=torch.finfo(torch.float32).min)
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    taps = torch.stack([xp[:, :, i:i + stride * (ho - 1) + 1:stride,
                           j:j + stride * (wo - 1) + 1:stride]
                        for i in range(k) for j in range(k)])
    arg = taps.argmax(dim=0)
    rows = torch.arange(ho, device=x.device).view(-1, 1) * stride - padding + arg // k
    cols = torch.arange(wo, device=x.device) * stride - padding + arg % k
    return taps.amax(dim=0).to(x.dtype), rows * w + cols


class _MaxUnpool(torch.autograd.Function):
    """The forward and backward of ``max_unpool`` (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, indices, out_hw):
        b, c, h, w = x.shape
        idx = indices.reshape(b * c, h * w)
        rank = torch.arange(h * w, device=x.device).expand(b * c, -1).contiguous()
        last = torch.full((b * c, out_hw[0] * out_hw[1]), -1, dtype=torch.long,
                          device=x.device)
        last.scatter_reduce_(1, idx, rank, reduce="amax")
        placed = x.reshape(b * c, h * w).gather(1, last.clamp_min(0))
        ctx.save_for_backward(indices)
        return torch.where(last >= 0, placed, 0.0).to(x.dtype).view(b, c, *out_hw)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        b, c, h, w = indices.shape
        gx = g.reshape(b * c, -1).gather(1, indices.reshape(b * c, h * w))
        return gx.view(b, c, h, w), None, None


def max_unpool(x, indices, out_hw):
    """PyTorch's ``MaxUnpool2d`` of NCHW input: x's values at their flat
    ``indices`` (from ``max_pool_argmax``) in a zero plane of ``out_hw``
    (``corrifnet_tpu/nn/resize.py:283-323``)."""
    return _MaxUnpool.apply(x, indices, tuple(out_hw))
