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
    atomics where windows overlap, as the MMVit4 stem's do).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_linear", "resize_nearest", "max_pool"]


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
    """PyTorch's default (nearest) resize: source index floor(dst * src / dst)."""
    size = tuple(size)
    if tuple(x.shape[2:]) == size:
        return x
    return _ResizeNearest.apply(x, size)


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


def max_pool(x, window, strides, padding):
    """3-D max pooling, padded with -inf (the MMVit4 stem's MaxPool3d)."""
    return _MaxPool.apply(x, tuple(window), tuple(strides), tuple(padding))
