"""Normalization layers, composed as ``corrifnet_tpu/nn/norm.py`` composes them.

Statistics are taken in f32 whatever the compute dtype and folded into a
per-channel ``x * a + b`` applied in the compute dtype, as the JAX package
does. Activations are NCDHW here (channels on dim 1), except ``LayerNorm``,
which normalizes the last dim of token tensors.

State-dict names follow the reference modules: ``weight``, ``bias``,
``running_mean``, ``running_var``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["BatchNorm", "InstanceNorm", "LayerNorm"]


def _apply(x, a, b):
    return x * a.to(x.dtype) + b.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over all dims but the channel one, eps 1e-5, affine,
    driven by ``module.training`` (``corrifnet_tpu/nn/norm.py:59-64,81-112``).

    Eval: the running statistics. Train: the batch mean and *biased*
    variance in f32 (single pass, E[x^2] - E[x]^2, clamped at 0), with
    gradients through both, and the running update of PyTorch's BatchNorm:
    momentum 0.1 and the *unbiased* batch variance, made in place."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return _apply(x, a.view(shape), b.view(shape))


class InstanceNorm(nn.Module):
    """InstanceNorm3d defaults: per (sample, channel) over the spatial dims,
    no affine, biased variance; single-pass E[x], E[x^2] statistics."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        axes = tuple(range(2, x.dim()))
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        sq = (xf * xf).mean(dim=axes, keepdim=True)
        var = torch.clamp(sq - mean * mean, min=0.0)
        a = torch.rsqrt(var + self.eps)
        return _apply(x, a, -mean * a)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, eps 1e-5, elementwise affine."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        sq = (xf * xf).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(torch.clamp(sq - mean * mean, min=0.0) + self.eps)
        return _apply(x, self.weight * inv, self.bias - mean * inv * self.weight)
