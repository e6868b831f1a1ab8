"""Inflated ResNet50 3-D encoder, one per modality (reference mmvit4.py:83-212).

Counterpart of ``ResNet3DEncoder`` and ``Bottleneck3D`` in
``corrifnet_tpu/models/resnet3d.py``, NCDHW. Input is one modality's
``(B, 1, D=3, H, W)`` volume (its three bands on the depth axis). Kept
quirks: the stem runs conv -> ReLU -> BatchNorm (mmvit4.py:170-174), and
every conv is kaiming-normal. BatchNorm follows ``module.training``.

The JAX package's ``PackedStage1`` (three modalities packed into channels
to fill the TPU's 128 lanes) is a layout device with the same math; the
port runs the three encoders as three modules.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn import BatchNorm, Conv, max_pool, resize_linear

__all__ = ["BASIC_DIMS", "Bottleneck3D", "ResNet3DEncoder"]

BASIC_DIMS = 8  # mmvit4.py:10
LAYERS = ((3, 64), (4, 128), (6, 256), (3, 512))  # torchvision resnet50
EXPANSION = 4


class Bottleneck3D(nn.Module):
    """1x1 reduce -> (1,3,3) spatial -> 1x1 expand, residual (mmvit4.py:196-212)."""

    def __init__(self, in_channels, width, stride=1, has_downsample=False):
        super().__init__()
        out = width * EXPANSION
        self.conv1 = Conv(in_channels, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv(width, width, (1, 3, 3), (1, stride, stride),
                          (0, 1, 1), bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv(width, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                Conv(in_channels, out, 1, (1, stride, stride), bias=False),
                BatchNorm(out),
            )

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResNet3DEncoder(nn.Module):
    """Returns the adapted levels a1..a5 (8/16/32/64/64 channels) and the
    64-channel x6 bottleneck at 8^3 (mmvit4.py:159-194)."""

    def __init__(self):
        super().__init__()
        bd = BASIC_DIMS
        self.e1_c1 = Conv(1, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False)
        self.e1_bn = BatchNorm(64)
        cin = 64
        for li, (blocks, width) in enumerate(LAYERS):
            stride = 1 if li == 0 else 2
            layer = [Bottleneck3D(cin, width, stride, has_downsample=True)]
            cin = width * EXPANSION
            layer += [Bottleneck3D(cin, width) for _ in range(blocks - 1)]
            setattr(self, f"e{li + 2}", nn.Sequential(*layer))
        level_in = (64, 256, 512, 1024, 2048)
        level_out = (bd, bd * 2, bd * 4, bd * 8, bd * 8)
        for i, (ci, co) in enumerate(zip(level_in, level_out)):
            setattr(self, f"adapt{i + 1}", Conv(ci, co, 1))
        self.conv6 = Conv(sum(level_out), bd * 8, 1)

    def forward(self, x):
        y = self.e1_bn(torch.relu(self.e1_c1(x)))
        feats = [max_pool(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))]
        for li in range(len(LAYERS)):
            feats.append(getattr(self, f"e{li + 2}")(feats[-1]))
        adapted = [getattr(self, f"adapt{i + 1}")(f) for i, f in enumerate(feats)]
        # x6: every level trilinear-resized to 8^3, concatenated, 1x1 conv
        pooled = torch.cat([resize_linear(a, (8, 8, 8)) for a in adapted], dim=1)
        return (*adapted, self.conv6(pooled))
