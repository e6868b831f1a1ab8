"""Normalization layers, composed as ``corrifnet_tpu/nn/norm.py`` composes them.

Statistics are taken in f32 whatever the compute dtype and folded into a
per-channel ``x * a + b`` applied in the compute dtype, as the JAX package
does. Activations are NCDHW here (channels on dim 1), except ``LayerNorm``,
which normalizes the last dim of token tensors.

State-dict names follow the reference modules: ``weight``, ``bias``,
``running_mean``, ``running_var``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

__all__ = ["BatchNorm", "BatchStatsTape", "InstanceNorm", "LayerNorm", "bn_fold",
           "bn_update_running"]

_TAPE = threading.local()


def _apply(x, a, b):
    return x * a.to(x.dtype) + b.to(x.dtype)


def bn_fold(scale, bias, mean, var, eps):
    """Fold BN statistics and affine into the per-channel ``y = x * a + b``
    vectors (``corrifnet_tpu/nn/norm.py:49-56``). Shared by ``BatchNorm`` and
    the fused bottleneck, so the quirks live in one place."""
    a = scale * torch.rsqrt(var + eps)
    return a, bias - mean * a


def bn_update_running(running_mean, running_var, mean, var, n, momentum):
    """PyTorch's running update, in place (``corrifnet_tpu/nn/norm.py:59-64``):
    ``running_var`` takes the *unbiased* batch variance while normalization
    uses the biased one."""
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var * (n / max(n - 1, 1)), alpha=momentum)


class BatchStatsTape:
    """The batch statistics of the BatchNorms of one rematerialized region,
    the counterpart of the JAX package's ``bn_stats`` remat policy
    (``corrifnet_tpu/models/resnet3d.py:46-48,286-291``).

    A region's function runs inside ``active()`` each time it runs: the
    first forward records the mean and variance each training-mode
    ``BatchNorm.fold`` takes, in call order, and updates the running
    statistics; every later run (the recompute in the backward) folds the
    recorded statistics in that order and leaves the running statistics
    alone. So a step updates them once, and the recompute normalizes with
    the first forward's statistics. The recompute still takes the same
    reductions (they keep its saved tensors in the order autograd expects),
    but its folds read the recorded values, with the ``requires_grad`` of
    the ones they stand for."""

    def __init__(self):
        self.saved = []
        self.replay = False
        self.at = 0

    @contextlib.contextmanager
    def active(self):
        before = getattr(_TAPE, "tape", None)
        _TAPE.tape, self.at = self, 0
        try:
            yield self
        finally:
            _TAPE.tape = before
            self.replay = True

    def take(self, mean, var):
        """The statistics a fold uses: recorded on the first run, replayed
        after it."""
        if not self.replay:
            self.saved.append((mean.detach(), var.detach()))
            return mean, var
        m, v = self.saved[self.at]
        self.at += 1
        return (m.detach().requires_grad_(mean.requires_grad),
                v.detach().requires_grad_(var.requires_grad))


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

    def fold(self, mean=None, var=None, n=None):
        """The ``(a, b)`` of ``y = x * a + b`` from statistics computed
        outside the module, the counterpart of ``_BNParams``
        (``corrifnet_tpu/nn/fusedbn.py:83-108``). Train: ``mean`` and the
        biased ``var`` of a batch of ``n`` values per channel update the
        running statistics and are folded. Eval: the running statistics are
        folded and the arguments are not read. Inside a ``BatchStatsTape``'s
        region the training-mode statistics are recorded, then replayed."""
        if self.training:
            tape = getattr(_TAPE, "tape", None)
            replay = tape is not None and tape.replay
            if tape is not None:
                mean, var = tape.take(mean, var)
            if not replay:
                bn_update_running(self.running_mean, self.running_var, mean, var, n,
                                  self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        return bn_fold(self.weight, self.bias, mean, var, self.eps)

    def fold_sums(self, s, q, n):
        """``fold`` from the per-channel sum ``s`` and sum of squares ``q``
        of ``n`` values (``corrifnet_tpu/models/resnet3d.py:170-175``); in
        eval mode ``s`` and ``q`` may be None."""
        if not self.training:
            return self.fold()
        mean = s / n
        return self.fold(mean, torch.clamp(q / n - mean * mean, min=0.0), n)

    def forward(self, x, dtype=None):
        """``dtype`` (x's by default) is the JAX module's: the statistics
        are taken of x, then x is cast to it and normalized in it (ELANet's
        f32 residual stream enters its BatchNorms so under bf16)."""
        mean = var = n = None
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            n = x.numel() // x.shape[1]
        a, b = self.fold(mean, var, n)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return _apply(x if dtype is None else x.to(dtype), a.view(shape), b.view(shape))


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
