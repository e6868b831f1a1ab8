"""Decoder_fuse, the full-depth multiscale decoder (reference mmvit4.py:222-292).

Counterpart of ``DecoderFuse`` in ``corrifnet_tpu/models/decoder.py``: its
standard full-depth chain (``depth_mode='full'``), written in the plain
resize-then-conv form, which is the JAX module's ``fuse_depth=False`` path
and equal to its fused one within f32 reassociation. At each level an RFM
block refines the early-fused skip; the running state is up-sampled x2
(trilinear, align_corners=True) into a replicate-padded 3^3 conv; the skip
is resized to the running grid with nearest interpolation, concatenated
and convolved, then a 1^3 conv. Depth grows 8 -> 16 -> 32 -> 64 -> 128.
The head keeps depth slice 0 only (``up_to_224`` with align_corners=True
and output depth 1 samples source depth 0, mmvit4.py:263).

All 27 conv blocks (15 in the RFMs, 12 in the chain) end in kernel K3, in
training too: this is the JAX module's standard chain (``lean=False``).
The lean chain (``nn/leandec.py``) changes only what the backward stores
and is still to be ported (see ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn import Conv, FusionPrenorm, GeneralConv3d
from corrifnet_tpu_torch.nn import resize_linear, resize_nearest

__all__ = ["DecoderFuse"]

BD = 8  # basic_dims (mmvit4.py:10)


def _chain_conv(cin, cout, k):
    return GeneralConv3d(cin, cout, k, 1, 1 if k == 3 else 0,
                         padding_mode="replicate")


class DecoderFuse(nn.Module):
    """Takes the early-fused skips x1..x4 ((B, 24/48/96/192, 3, H, W) at
    H = W = 56/56/28/14) and the bottleneck x5 ((B, 192, 8, 8, 8)); returns
    sigmoid probabilities (B, 3, 1, 224, 224)."""

    def __init__(self):
        super().__init__()
        self.RFM5 = FusionPrenorm(BD * 8 * 3)
        self.RFM5_reduce = Conv(BD * 8 * 3, BD * 16, 1)
        self.d4_c1 = _chain_conv(BD * 16, BD * 16, 3)
        self.RFM4 = FusionPrenorm(BD * 8 * 3)
        self.d4_c2 = _chain_conv(BD * 8 * 3 + BD * 16, BD * 8, 3)
        self.d4_out = _chain_conv(BD * 8, BD * 8, 1)
        self.d3_c1 = _chain_conv(BD * 8, BD * 4, 3)
        self.RFM3 = FusionPrenorm(BD * 4 * 3)
        self.d3_c2 = _chain_conv(BD * 4 * 3 + BD * 4, BD * 4, 3)
        self.d3_out = _chain_conv(BD * 4, BD * 4, 1)
        self.d2_c1 = _chain_conv(BD * 4, BD * 2, 3)
        self.RFM2 = FusionPrenorm(BD * 2 * 3)
        self.d2_c2 = _chain_conv(BD * 2 * 3 + BD * 2, BD * 2, 3)
        self.d2_out = _chain_conv(BD * 2, BD * 2, 1)
        self.d1_c1 = _chain_conv(BD * 2, BD, 3)
        self.RFM1 = FusionPrenorm(BD * 3)
        self.d1_c2 = _chain_conv(BD * 3 + BD, BD, 3)
        self.d1_out = _chain_conv(BD, BD, 1)
        self.final_conv = Conv(BD, 3, 1)

    def forward(self, x1, x2, x3, x4, x5):
        run = self.d4_c1(resize_linear(self.RFM5_reduce(self.RFM5(x5)), (16,) * 3))
        levels = (
            (x4, self.RFM4, self.d4_c2, self.d4_out, self.d3_c1, 16),
            (x3, self.RFM3, self.d3_c2, self.d3_out, self.d2_c1, 32),
            (x2, self.RFM2, self.d2_c2, self.d2_out, self.d1_c1, 64),
            (x1, self.RFM1, self.d1_c2, self.d1_out, None, 128),
        )
        for skip, rfm, c2, out, next_c1, size in levels:
            skip = resize_nearest(rfm(skip), (size,) * 3)
            run = out(c2(torch.cat([skip, run], dim=1)))
            if next_c1 is not None:
                run = next_c1(resize_linear(run, (size * 2,) * 3))
        head = resize_linear(run[:, :, :1], (1, 224, 224))
        return torch.sigmoid(self.final_conv(head).float())
