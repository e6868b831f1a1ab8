"""Resizing and pooling with the reference's semantics, NCDHW.

Counterpart of ``corrifnet_tpu/nn/resize.py``. The reference mixes two
interpolation flavours: trilinear with ``align_corners=True`` (the encoder's
x6 pyramid, the decoder's up-sampling and ``up_to_224``) and bare
``F.interpolate(x, size)``, whose default mode is nearest (the decoder's
skip resizes). Both are PyTorch's own ops here, as in the reference, with
two exceptions. The depth-fused decoder's H/W-only resize in the compute
dtype is the JAX package's form: one product with the (dst, src)
interpolation matrix per axis (``_linear_matrix``, built in float64 and
cast), each rounded to the compute dtype, whose backward is the transposed
product (no atomics). And the backward of the nearest resize is computed
here, because
PyTorch's CUDA kernel for it (``upsample_nearest3d_backward``) takes its
source ranges from ``ceil(i * dst / src)`` in float32 and is off by one
where ``dst / src`` is not a binary fraction (56 -> 64 at i = 21, 49; 28 ->
32; 56 -> 128): the decoder's skip gradients at three of its five levels
came out 10 to 40 percent wrong on the card and right on the CPU.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_linear", "resize_nearest", "max_pool"]


@functools.lru_cache(maxsize=None)
def _linear_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) align-corners linear interpolation matrix, float64 (the
    JAX package's ``_linear_matrix(src, dst, True)``)."""
    w = np.zeros((dst, src), dtype=np.float64)
    for i in range(dst):
        x = i * (src - 1) / (dst - 1) if dst > 1 else 0.0
        lo = min(int(np.floor(x)), src - 1)
        hi = min(lo + 1, src - 1)
        frac = x - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


@functools.lru_cache(maxsize=None)
def _linear_tensor(src, dst, dtype, device):
    return torch.from_numpy(_linear_matrix(src, dst)).to(device=device, dtype=dtype)


def _resize_axis(x, dst, dtype):
    """x (N, src, M) -> (N, dst, M): the interpolation matrix times each
    x[n] in ``dtype`` (f32 accumulation, one rounding)."""
    m = _linear_tensor(x.shape[1], dst, dtype, x.device)
    return torch.bmm(m.expand(x.shape[0], -1, -1), x)


def resize_linear(x, size: Sequence[int], compute_dtype=None):
    """Trilinear resize of (D, H, W) to ``size`` with align_corners=True,
    interpolated in f32 and returned in x's dtype. With ``compute_dtype``
    and the depth unchanged (the depth-fused decoder's up2) it is JAX's form
    instead: W, then H, each a product with the interpolation matrix in
    ``compute_dtype``, on x's channels-last memory, returned channels-last."""
    size = tuple(size)
    if tuple(x.shape[2:]) == size:
        return x
    if compute_dtype is None:
        y = F.interpolate(x.float(), size=size, mode="trilinear", align_corners=True)
        return y.to(x.dtype)
    b, c, d, h, w = x.shape
    if size[0] != d:
        raise ValueError(f"a resize in {compute_dtype} keeps the depth: {x.shape} -> {size}")
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


def max_pool(x, window, strides, padding):
    """3-D max pooling, padded with -inf (the MMVit4 stem's MaxPool3d)."""
    return F.max_pool3d(x, window, strides, padding)
