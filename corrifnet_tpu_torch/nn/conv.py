"""Convolution building blocks of MMVit4, NCDHW.

Counterpart of ``corrifnet_tpu/nn/conv.py``: ``Conv``, ``Dense``,
``GeneralConv3d``, ``FusionPrenorm`` and ``EarlyFusionBlock``. Parameters
are f32 in PyTorch layout and cast to the input's dtype per call (bf16
compute over f32 parameters). Module and parameter names are the
reference's, so a ``state_dict`` converts to JAX variables with
``corrifnet_tpu.models.torch_import``.

``Conv`` takes the JAX module's ``depth_fuse`` argument (the full-depth
decoder's resize-then-conv pairs contracted into one conv at the coarse
depth, ``nn/depthfuse.py``). The block-diagonal ``modalities`` packing, a
TPU layout device with identical math, is not ported: three modalities run
as three modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.nn.depthfuse import coarse_input, expand_conv
from corrifnet_tpu_torch.nn.init import fan_in, kaiming_normal_, torch_default_
from corrifnet_tpu_torch.nn.norm import InstanceNorm
from corrifnet_tpu_torch.nn.pad import replicate_pad
from corrifnet_tpu_torch.ops import relu_instancenorm

__all__ = ["Conv", "Dense", "GeneralConv3d", "FusionPrenorm", "EarlyFusionBlock"]


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


_KERNEL_INITS = ("kaiming_normal", "torch_default")


class Conv(nn.Module):
    """Conv3d (``dims=3``) or Conv2d (``dims=2``, the JAX ``Conv`` being
    rank-generic) with PyTorch's default bias. ``kernel_init``:
    'kaiming_normal' (MMVit4 re-initializes every Conv3d,
    mmvit4.py:437-439, and RFNet's convs are built so) or 'torch_default',
    U(+-1/sqrt(fan_in)) (RobustMseg's). ``padding_mode`` is 'zeros' or
    'replicate'."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, padding_mode="zeros", dims=3,
                 kernel_init="kaiming_normal"):
        super().__init__()
        if padding_mode not in ("zeros", "replicate"):
            raise ValueError(f"padding_mode {padding_mode!r}")
        if dims not in (2, 3) or kernel_init not in _KERNEL_INITS:
            raise ValueError(f"dims {dims!r}, kernel_init {kernel_init!r}")
        self.stride = _tuple(stride, dims)
        self.padding = _tuple(padding, dims)
        self.padding_mode = padding_mode
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *_tuple(kernel_size, dims))
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator):
        if self.kernel_init == "kaiming_normal":
            kaiming_normal_(self.weight, generator)
        else:
            torch_default_(self.weight, fan_in(self.weight), generator)
        if self.bias is not None:
            torch_default_(self.bias, fan_in(self.weight), generator)

    def _bias(self, dtype):
        return None if self.bias is None else self.bias.to(dtype)

    def forward(self, x, depth_fuse=None):
        """``depth_fuse`` (the full-depth decoder's fused path, counterpart
        of ``Conv.__call__(x, depth_fuse)`` in the JAX package):
        ``("linear", dst_d)``: x is the depth-COARSE volume, the result is
        conv3d(depth_linear_resize(x, dst_d)); ``("nearest", dst_d)``: x is a
        ``(skip, run)`` pair, the result is conv3d(concat(nearest depth
        resize of skip to dst_d, run)). Same parameters either way."""
        return self.convolve(self.prepare(x, depth_fuse), depth_fuse)

    def prepare(self, x, depth_fuse=None):
        """The tensors the convolutions of ``forward(x, depth_fuse)`` read,
        padded and laid out (the lean decoder rebuilds these in the
        backward instead of storing them), and the batch size."""
        if depth_fuse is None:
            if self.padding_mode == "replicate":
                x = replicate_pad(x, [(p, p) for p in self.padding])
            return (x,), x.shape[0]
        if (self.weight.shape[2] != 3 or self.padding[0] != 1
                or self.stride != (1, 1, 1)):
            raise ValueError("depth fusion needs a stride-1 conv with 3 depth "
                             f"taps and depth padding 1, not {tuple(self.weight.shape)}")
        parts = x if depth_fuse[0] == "nearest" else (x,)
        return (tuple(coarse_input(p, self.padding, self.padding_mode) for p in parts),
                parts[-1].shape[0])

    def convolve(self, prepared, depth_fuse=None):
        """``forward`` from what ``prepare`` returned."""
        parts, batch = prepared
        dt = parts[0].dtype
        w, bias = self.weight.to(dt), self._bias(dt)
        if depth_fuse is None:
            padding = 0 if self.padding_mode == "replicate" else self.padding
            conv = F.conv3d if w.dim() == 5 else F.conv2d
            return conv(parts[0], w, bias, self.stride, padding)
        kind, dst_d = depth_fuse
        if kind == "linear":
            return expand_conv(parts, [w], ["linear"], batch, dst_d,
                               self.padding_mode, self.padding, bias)
        # the skip block's taps expanded from its coarse rows; the run block,
        # an ordinary 3^3 conv at the fine depth, as a 2-D conv whose taps
        # are shift-added by the same product (its table: the identity
        # resize, JAX's _depth3_shift_add)
        cs = parts[0].shape[1]
        return expand_conv(parts, [w[:, :cs], w[:, cs:]], ["nearest", "linear"], batch,
                           dst_d, self.padding_mode, self.padding, bias)

    def pointwise(self, tokens):
        """The 1x1x1 conv applied to channels-last ``(..., in)`` tokens: the
        same math as ``forward`` on the token grid, as one matmul."""
        w = self.weight.flatten(1).to(tokens.dtype)
        return F.linear(tokens, w, self._bias(tokens.dtype))


class Dense(nn.Module):
    """Linear layer (reference ``nn.Linear``) with PyTorch's default init."""

    def __init__(self, in_features, out_features, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator):
        torch_default_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            torch_default_(self.bias, self.weight.shape[1], generator)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class GeneralConv3d(nn.Module):
    """conv3d, activation and InstanceNorm, as the JAX module orders them:
    ``order='act_norm'`` with ``act='relu'`` is general_conv3d_prenorm
    (activation before norm, mmvit4.py:29-45), whose epilogue is kernel K3;
    ``order='norm_act'`` with ``act='lrelu'`` is RFNet's general_conv3d (the
    plain InstanceNorm, then LeakyReLU(0.2), RFNet.py:18-33)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, padding_mode="zeros", order="act_norm", act="relu"):
        super().__init__()
        if order not in ("act_norm", "norm_act") or act not in ("relu", "lrelu"):
            raise ValueError(f"order {order!r}, act {act!r}")
        self.order, self.act = order, act
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         padding, padding_mode=padding_mode)
        self.norm = InstanceNorm()

    def _activation(self, y):
        return torch.relu(y) if self.act == "relu" else F.leaky_relu(y, 0.2)

    def forward(self, x, depth_fuse=None):
        y = self.conv(x, depth_fuse)
        if self.order == "norm_act":
            return self._activation(self.norm(y))
        if self.act == "lrelu":
            return self.norm(self._activation(y))
        y = y.permute(0, 2, 3, 4, 1).contiguous()  # channels-last
        return relu_instancenorm(y).permute(0, 4, 1, 2, 3)


class FusionPrenorm(nn.Module):
    """RFM block: 1x1 -> 3x3 -> 1x1 GeneralConv3d stack (mmvit4.py:47-56)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.fusion_layer = nn.Sequential(
            GeneralConv3d(c, c, 1, 1, 0),
            GeneralConv3d(c, c, 3, 1, 1),
            GeneralConv3d(c, c, 1, 1, 0),
        )

    def forward(self, x):
        return self.fusion_layer(x)


class EarlyFusionBlock(nn.Module):
    """concat(modalities) -> 1x1 conv -> ReLU -> InstanceNorm (mmvit4.py:64-81),
    with the plain InstanceNorm, as the JAX package composes it."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 1)
        self.norm = InstanceNorm()

    def forward(self, x_rgb, x_nir, x_swir):
        x = self.conv(torch.cat([x_rgb, x_nir, x_swir], dim=1))
        return self.norm(torch.relu(x))
