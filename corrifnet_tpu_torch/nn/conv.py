"""Convolution building blocks of MMVit4, NCDHW.

Counterpart of ``corrifnet_tpu/nn/conv.py``: ``Conv``, ``Dense``,
``GeneralConv3d``, ``FusionPrenorm`` and ``EarlyFusionBlock``. Parameters
are f32 in PyTorch layout and cast to the input's dtype per call (bf16
compute over f32 parameters). Module and parameter names are the
reference's, so a ``state_dict`` converts to JAX variables with
``corrifnet_tpu.models.torch_import``.

The JAX package's layout devices for the TPU (the block-diagonal
``modalities`` packing and the ``depth_fuse`` contraction) have identical
math and are not ported: here three modalities run as three modules and a
depth resize is a resize followed by the conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from corrifnet_tpu_torch.nn.init import fan_in, kaiming_normal_, torch_default_
from corrifnet_tpu_torch.nn.norm import InstanceNorm
from corrifnet_tpu_torch.ops import relu_instancenorm

__all__ = ["Conv", "Dense", "GeneralConv3d", "FusionPrenorm", "EarlyFusionBlock"]


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


class Conv(nn.Module):
    """Conv3d, kaiming-normal weights (MMVit4 re-initializes every Conv3d,
    mmvit4.py:437-439) and PyTorch's default bias. ``padding_mode`` is
    'zeros' or 'replicate'."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, padding_mode="zeros"):
        super().__init__()
        if padding_mode not in ("zeros", "replicate"):
            raise ValueError(f"padding_mode {padding_mode!r}")
        self.stride = _triple(stride)
        self.padding = _triple(padding)
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *_triple(kernel_size))
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator):
        kaiming_normal_(self.weight, generator)
        if self.bias is not None:
            torch_default_(self.bias, fan_in(self.weight), generator)

    def _bias(self, dtype):
        return None if self.bias is None else self.bias.to(dtype)

    def forward(self, x):
        w = self.weight.to(x.dtype)
        padding = self.padding
        if self.padding_mode == "replicate" and any(padding):
            pd, ph, pw = padding
            x = F.pad(x, (pw, pw, ph, ph, pd, pd), mode="replicate")
            padding = 0
        return F.conv3d(x, w, self._bias(x.dtype), self.stride, padding)

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
    """conv3d -> ReLU -> InstanceNorm (general_conv3d_prenorm, activation
    before norm, mmvit4.py:29-45). The epilogue is kernel K3."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, padding_mode="zeros"):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         padding, padding_mode=padding_mode)

    def forward(self, x):
        y = self.conv(x).permute(0, 2, 3, 4, 1).contiguous()  # channels-last
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
