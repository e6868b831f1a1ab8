"""Resizing and pooling with the reference's semantics, NCDHW.

Counterpart of ``corrifnet_tpu/nn/resize.py``. The reference mixes two
interpolation flavours: trilinear with ``align_corners=True`` (the encoder's
x6 pyramid, the decoder's up-sampling and ``up_to_224``) and bare
``F.interpolate(x, size)``, whose default mode is nearest (the decoder's
skip resizes). Both are PyTorch's own ops here, as in the reference, with
one exception: the backward of the nearest resize is computed here, because
PyTorch's CUDA kernel for it (``upsample_nearest3d_backward``) takes its
source ranges from ``ceil(i * dst / src)`` in float32 and is off by one
where ``dst / src`` is not a binary fraction (56 -> 64 at i = 21, 49; 28 ->
32; 56 -> 128): the decoder's skip gradients at three of its five levels
came out 10 to 40 percent wrong on the card and right on the CPU.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["resize_linear", "resize_nearest", "max_pool"]


def resize_linear(x, size: Sequence[int]):
    """Trilinear resize of (D, H, W) to ``size`` with align_corners=True,
    interpolated in f32 and returned in x's dtype."""
    size = tuple(size)
    if tuple(x.shape[2:]) == size:
        return x
    y = F.interpolate(x.float(), size=size, mode="trilinear", align_corners=True)
    return y.to(x.dtype)


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
