"""Inflated ResNet50 3-D encoder, one per modality (reference mmvit4.py:83-212).

Counterpart of ``ResNet3DEncoder`` and ``Bottleneck3D`` in
``corrifnet_tpu/models/resnet3d.py``, NCDHW. Input is one modality's
``(B, 1, D=3, H, W)`` volume (its three bands on the depth axis). Kept
quirks: the stem runs conv -> ReLU -> BatchNorm (mmvit4.py:170-174), and
every conv is kaiming-normal. BatchNorm follows ``module.training``.

The JAX package's ``PackedStage1`` (three modalities packed into channels
to fill the TPU's 128 lanes) is a layout device with the same math; the
port runs the three encoders as three modules.

``fuse_expand_bn=True`` folds ``bn3`` into ``conv3``, and ``downsample``'s
BatchNorm into its conv where it expands the channels 4x or more (layer 1's
first block), with the statistics taken from the conv's input
(``nn/fusedbn.py``; ``corrifnet_tpu/models/resnet3d.py:95-130``). With
``pallas_fused=True`` it has no effect, as in the JAX package, whose
``_fused`` returns first.

``pallas_fused=True`` sends every bottleneck through the fused convolution
kernels (``ops/fusedconv.py``), the counterpart of ``Bottleneck3D._fused``
(``corrifnet_tpu/models/resnet3d.py:136-243``). Parameters, buffers and
``state_dict`` keys are the same with the flag on or off. The kernels are
channels-last, so a fused bottleneck lays its input out channels-last
(a copy only for the first block of an encoder: every later block finds it
so) and returns an NCDHW view of channels-last memory.

``remat_mode`` rematerializes the tail blocks (blocks 1..n-1 of each layer,
never block 0 or the stem) in the backward, as the JAX package's
``_BottleneckTail`` and ``PackedStage1`` do
(``corrifnet_tpu/models/resnet3d.py:266-311,376-381``), through
``torch.utils.checkpoint`` and only where autograd records (training mode
with gradients on). ``tail_remat`` maps the mode and the layer to what a
tail block does: ``"none"`` nothing; ``"all"`` every tail block, storing its
input alone; ``"early"`` the tails of width <= 128 (layers 1 and 2);
``"mid"`` every tail block, storing its two mid activations too;
``"mid1"`` ``"mid"`` for layer 1 and ``"all"`` for layers 2-4, MMVit4's
split between ``PackedStage1`` and the encoders (``corrifnet_tpu/models/
mmvit4.py:127-172``). The mid activations are JAX's ``mid_acts``: the two
post-ReLU ones, and under ``pallas_fused`` the outputs of conv1 and conv2
(K4a and K4c), so that only conv3 runs again. A BatchNorm in a
rematerialized region updates its running statistics once, and the
recompute folds the first forward's statistics (``nn.BatchStatsTape``,
the counterpart of JAX's saved ``bn_stats``). Remat changes no bit of a
step's loss, gradients or running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from corrifnet_tpu_torch.nn import BatchNorm, BatchStatsTape, Conv, max_pool, resize_linear
from corrifnet_tpu_torch.nn.fusedbn import fused_pointwise_conv_bn
from corrifnet_tpu_torch.ops import conv3x3_fma_relu_stats, pointwise_conv_stats

__all__ = ["BASIC_DIMS", "Bottleneck3D", "REMAT_MODES", "ResNet3DEncoder", "tail_remat"]

BASIC_DIMS = 8  # mmvit4.py:10
LAYERS = ((3, 64), (4, 128), (6, 256), (3, 512))  # torchvision resnet50
EXPANSION = 4
REMAT_MODES = ("none", "all", "early", "mid", "mid1")


def tail_remat(mode: str, layer: int):
    """What the tail blocks of ``layer`` (0-3) do under ``remat_mode``:
    None (store every activation), ``"all"`` or ``"mid"`` (see the module
    docstring)."""
    if mode not in REMAT_MODES:
        raise ValueError(f"remat_mode {mode!r} is not one of {REMAT_MODES}")
    if mode == "mid1":
        return "mid" if layer == 0 else "all"
    if mode == "early":
        return "all" if LAYERS[layer][1] <= 128 else None
    return None if mode == "none" else mode


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward; the
    BatchNorms in it record their statistics on the first run and replay
    them in the recompute."""
    tape = BatchStatsTape()

    def run(*inputs):
        with tape.active():
            return fn(*inputs)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=False)


class Bottleneck3D(nn.Module):
    """1x1 reduce -> (1,3,3) spatial -> 1x1 expand, residual (mmvit4.py:196-212)."""

    def __init__(self, in_channels, width, stride=1, has_downsample=False,
                 pallas_fused=False, fuse_expand_bn=False, remat=None):
        super().__init__()
        self.stride = stride
        self.pallas_fused = pallas_fused
        self.fuse_expand_bn = fuse_expand_bn
        self.remat = remat  # None, "all" or "mid" (tail_remat)
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
        remat = self.remat if self.training and torch.is_grad_enabled() else None
        if self.pallas_fused:
            return self._fused(x, remat)
        if remat == "all":
            return _remat(self._plain, x)
        if remat == "mid":  # the two post-ReLU mid activations stored
            y = _remat(self._reduce, x)
            return _remat(self._expand, _remat(self._spatial, y), x)
        return self._plain(x)

    def _plain(self, x):
        return self._expand(self._spatial(self._reduce(x)), x)

    def _reduce(self, x):
        return torch.relu(self.bn1(self.conv1(x)))

    def _spatial(self, y):
        return torch.relu(self.bn2(self.conv2(y)))

    def _expand(self, y, x):
        if self.fuse_expand_bn:
            y = fused_pointwise_conv_bn(y, self.conv3, self.bn3)
        else:
            y = self.bn3(self.conv3(y))
        if self.downsample is None:
            identity = x
        elif self.fuse_expand_bn and self.conv3.weight.shape[0] >= 4 * x.shape[1]:
            identity = fused_pointwise_conv_bn(x, self.downsample[0], self.downsample[1],
                                               self.stride)
        else:
            identity = self.downsample(x)
        return torch.relu(y + identity)

    def _fused(self, x, remat=None):
        """Every conv carries the previous BatchNorm's apply + ReLU in its
        input prologue and gives its own batch statistics from its
        accumulator (kernels K4a-K4d), step by step as
        ``corrifnet_tpu/models/resnet3d.py:136-243``. The stride-2 conv2 of
        layers 2-4's first block is the library conv behind a tensor-op
        prologue, as there. In eval mode the statistics are not computed:
        the running ones are folded. Under ``remat`` "mid" the outputs of
        conv1 and conv2 are stored and the rest runs again."""
        x = x.permute(0, 2, 3, 4, 1).contiguous()  # channels-last (B, D, H, W, C)
        if remat == "all":
            out = _remat(self._fused_chain, x)
        elif remat == "mid":
            out = _remat(self._fused_expand, x, *self._fused_spatial(*self._fused_reduce(x)))
        else:
            out = self._fused_chain(x)
        return out.permute(0, 4, 1, 2, 3)

    def _fused_chain(self, x):
        return self._fused_expand(x, *self._fused_spatial(*self._fused_reduce(x)))

    @staticmethod
    def _pointwise(conv, dt):
        """(ci, co) kernel of a 1x1 conv in the compute dtype; the gradient
        reaches the f32 parameter through the cast."""
        return conv.weight.to(dt).flatten(1).t().contiguous()

    def _fused_reduce(self, x):
        """conv1 (K4a) and bn1's fold: (y1, a1, b1)."""
        nel = x.numel() // x.shape[-1]
        y1, s1, q1 = pointwise_conv_stats(x, self._pointwise(self.conv1, x.dtype),
                                          stats=self.training)
        return (y1, *self.bn1.fold_sums(s1, q1, nel))

    def _fused_spatial(self, y1, a1, b1):
        """conv2 (K4c at stride 1) behind bn1's apply + ReLU, and bn2's
        fold: (y2, a2, b2)."""
        dt, train, stride = y1.dtype, self.training, self.stride
        bb, dd, hh, ww, _ = y1.shape
        w2 = self.conv2.weight.to(dt)[:, :, 0]  # (co, ci, 3, 3)
        if stride == 1:
            y2, s2, q2 = conv3x3_fma_relu_stats(
                y1.view(bb * dd, hh, ww, -1), w2.permute(2, 3, 1, 0).contiguous(),
                a1, b1, stats=train)
        else:
            z1 = torch.relu(y1 * a1.to(dt) + b1.to(dt)).view(bb * dd, hh, ww, -1)
            y2 = F.conv2d(z1.permute(0, 3, 1, 2), w2, None, stride, 1)
            y2 = y2.permute(0, 2, 3, 1).contiguous()
            s2 = q2 = None
            if train:
                # statistics of the rounded output, as the standard path's
                yf = y2.float().flatten(0, 2)
                s2, q2 = yf.sum(dim=0), (yf * yf).sum(dim=0)
        y2 = y2.view(bb, dd, *y2.shape[1:])
        # the JAX count, nel1 // stride^2 (resnet3d.py:218)
        nel2 = bb * dd * hh * ww // (stride * stride)
        return (y2, *self.bn2.fold_sums(s2, q2, nel2))

    def _fused_expand(self, x, y2, a2, b2):
        """conv3 (K4a) behind bn2's apply + ReLU, the projection (K4a) or the
        identity, bn3's apply, the residual add and the ReLU."""
        dt, train, stride = x.dtype, self.training, self.stride
        nel = x.numel() // x.shape[-1] // (stride * stride)
        y3, s3, q3 = pointwise_conv_stats(y2, self._pointwise(self.conv3, dt), a2, b2,
                                          stats=train)
        a3, b3 = self.bn3.fold_sums(s3, q3, nel)

        if self.downsample is None:
            identity = x
        else:
            xd = x if stride == 1 else x[:, :, ::stride, ::stride]
            yd, sd, qd = pointwise_conv_stats(xd, self._pointwise(self.downsample[0], dt),
                                              stats=train)
            ad, bd = self.downsample[1].fold_sums(sd, qd, nel)
            identity = yd * ad.to(dt) + bd.to(dt)
        return torch.relu(y3 * a3.to(dt) + b3.to(dt) + identity)


class ResNet3DEncoder(nn.Module):
    """Returns the adapted levels a1..a5 (8/16/32/64/64 channels) and the
    64-channel x6 bottleneck at 8^3 (mmvit4.py:159-194). ``remat_mode``
    (JAX's default ``"all"``) rematerializes the tail blocks in training
    (``tail_remat``)."""

    def __init__(self, pallas_fused=False, fuse_expand_bn=False, remat_mode="all"):
        super().__init__()
        bd = BASIC_DIMS
        self.e1_c1 = Conv(1, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False)
        self.e1_bn = BatchNorm(64)
        cin = 64
        for li, (blocks, width) in enumerate(LAYERS):
            stride = 1 if li == 0 else 2
            layer = [Bottleneck3D(cin, width, stride, True, pallas_fused, fuse_expand_bn)]
            cin = width * EXPANSION
            layer += [Bottleneck3D(cin, width, pallas_fused=pallas_fused,
                                   fuse_expand_bn=fuse_expand_bn)
                      for _ in range(blocks - 1)]
            setattr(self, f"e{li + 2}", nn.Sequential(*layer))
        level_in = (64, 256, 512, 1024, 2048)
        level_out = (bd, bd * 2, bd * 4, bd * 8, bd * 8)
        for i, (ci, co) in enumerate(zip(level_in, level_out)):
            setattr(self, f"adapt{i + 1}", Conv(ci, co, 1))
        self.conv6 = Conv(sum(level_out), bd * 8, 1)
        self.set_remat_mode(remat_mode)

    def set_remat_mode(self, mode: str):
        """Rematerialize the tail blocks as ``mode`` says (``tail_remat``)."""
        for li, (blocks, _) in enumerate(LAYERS):
            remat = tail_remat(mode, li)
            for block in list(getattr(self, f"e{li + 2}"))[1:]:
                block.remat = remat
        self.remat_mode = mode
        return self

    def forward(self, x):
        y = self.e1_bn(torch.relu(self.e1_c1(x)))
        feats = [max_pool(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))]
        for li in range(len(LAYERS)):
            feats.append(getattr(self, f"e{li + 2}")(feats[-1]))
        # a fused stage returns channels-last memory: the narrow adapted
        # levels go back to NCDHW here, at the encoder's edge, so everything
        # downstream sees the layout it sees with the flag off
        adapted = [getattr(self, f"adapt{i + 1}")(f).contiguous()
                   for i, f in enumerate(feats)]
        # x6: every level trilinear-resized to 8^3, concatenated, 1x1 conv
        pooled = torch.cat([resize_linear(a, (8, 8, 8)) for a in adapted], dim=1)
        return (*adapted, self.conv6(pooled))
