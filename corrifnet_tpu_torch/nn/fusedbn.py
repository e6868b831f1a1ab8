"""A 1x1 conv and its BatchNorm folded into one product, with the batch
statistics taken from the conv's input.

Counterpart of ``fused_pointwise_conv_bn`` (``corrifnet_tpu/nn/fusedbn.py:
118-187``). For a 1x1 conv ``y = x @ W`` the per-channel statistics of y
are functions of x:

    mean_c = (colsum(x) @ W)_c / n,    E[y^2]_c = (W^T G W)_cc / n,

with ``G = x^T x`` the (ci, ci) Gram matrix of the input. So the normalized
output is ``x @ (W * a) + b`` with ``(a, b)`` the BatchNorm's fold, and the
unnormalized y is never made. The bottleneck's expanding convs (``conv3``
and a 4x ``downsample``) take this form under ``fuse_expand_bn``.

Numerics, as the JAX package's: the column sums and the Gram are
accumulated in f32 from the input in the compute dtype (a bf16 input is
widened, never a bf16-rounded Gram), the variance is ``E[y^2] - mean^2``
clamped at 0, and the fold is applied to the f32 weight before it is cast
to the compute dtype. In f32 the result differs from conv-then-BatchNorm by
reassociation only.

The weight and the statistics belong to the port's own ``Conv`` and
``BatchNorm`` modules, so the ``state_dict`` keys are the unfused pair's,
and the running statistics update as ``BatchNorm`` updates them (momentum
0.1, the unbiased variance into ``running_var``). A strided conv subsamples
H and W first, then takes the product: the statistics are those of the
subsampled input. The JAX package's ``modalities`` packing (block-diagonal
weights) is not ported: the port runs one encoder per modality.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fused_pointwise_conv_bn"]


def _input_side_stats(xt, wf):
    """Per-channel (mean, biased var) of ``xt.T @ wf`` from the input side:
    xt (ci, n) in f32, wf (ci, co) f32 (JAX ``_input_side_stats``)."""
    n = xt.shape[1]
    gram = xt @ xt.t()
    mean = (xt.sum(dim=1) @ wf) / n
    ey2 = torch.einsum("ij,jc,ic->c", gram, wf, wf) / n
    return mean, torch.clamp(ey2 - mean * mean, min=0.0)


def fused_pointwise_conv_bn(x, conv, bn, stride: int = 1):
    """``bn(conv(x))`` for a bias-free 1x1x1 ``conv`` of stride (1, s, s)
    and a ``BatchNorm`` ``bn``, as one product with the folded weight. x is
    (B, ci, D, H, W) in the compute dtype; returns (B, co, D, H/s, W/s) in
    it. Train mode (``bn.training``): the batch statistics from the input
    side, with the running update; eval: the running statistics."""
    if stride != 1:
        x = x[:, :, :, ::stride, ::stride]
    co, ci = conv.weight.shape[:2]
    wf = conv.weight.reshape(co, ci).t().float()  # (ci, co)
    mean = var = n = None
    if bn.training:
        xt = x.transpose(0, 1).reshape(ci, -1).float()
        n = xt.shape[1]
        mean, var = _input_side_stats(xt, wf)
    a, b = bn.fold(mean, var, n)
    w = (wf * a).t().to(x.dtype).reshape(co, ci, 1, 1, 1)
    return F.conv3d(x, w) + b.to(x.dtype).view(1, co, 1, 1, 1)
