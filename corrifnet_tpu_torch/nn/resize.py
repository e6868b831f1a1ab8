"""Resizing and pooling with the reference's semantics, NCDHW.

Counterpart of ``corrifnet_tpu/nn/resize.py``. The reference mixes two
interpolation flavours: trilinear with ``align_corners=True`` (the encoder's
x6 pyramid, the decoder's up-sampling and ``up_to_224``) and bare
``F.interpolate(x, size)``, whose default mode is nearest (the decoder's
skip resizes). Both are PyTorch's own ops here, as in the reference.
"""

from __future__ import annotations

from typing import Sequence

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


def resize_nearest(x, size: Sequence[int]):
    """PyTorch's default (nearest) resize: source index floor(dst * src / dst)."""
    size = tuple(size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="nearest")


def max_pool(x, window, strides, padding):
    """3-D max pooling, padded with -inf (the MMVit4 stem's MaxPool3d)."""
    return F.max_pool3d(x, window, strides, padding)
