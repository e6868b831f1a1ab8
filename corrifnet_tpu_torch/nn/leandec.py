"""Lean-residual decoder stages: one stored volume per conv/ReLU/IN stage.

Counterpart of ``corrifnet_tpu/nn/leandec.py`` and of ``relu_in_stats``
(``corrifnet_tpu/ops/instancenorm.py:174-226``). The standard decoder stage
(conv -> K3) keeps two volumes per stage for the backward: the conv's output
(K3's input) and the normalized output (the next conv's input). A lean stage
keeps one:

  * ``relu_in_stats`` ends each stage: it returns ``y = relu(x)`` and the
    InstanceNorm scalars ``(a, b)`` (so that the normalized output is
    ``y * a + b``) and saves only ``y`` and per-(sample, channel) f32
    scalars (the mean, ``a`` and the slope of ``a`` in the variance, which
    is 0 where the variance is clamped); its backward recovers the ReLU mask
    from ``y > 0`` and is derived by hand, as the JAX package's
    ``_ris_bwd``.
  * ``LeanGeneralConv3d`` takes the previous stage's ``LeanHandoff(y, a,
    b)``, applies the fma (and the H/W resize where ``pre_resize`` asks),
    and convolves. The conv's input is never saved: a
    ``saved_tensors_hooks`` pair keeps, in place of each tensor the
    convolutions save that ``Conv.prepare`` made, a token, and the backward
    rebuilds them from the handoff in one fma (and resize) pass. The conv's
    forward is not run again (JAX's ``fnn.remat`` drops it by partial
    evaluation; ``torch.utils.checkpoint`` would rerun it).
  * ``lean_head`` closes the chain: the head keeps depth slice 0 only, so
    the fma runs on that slice.
  * ``depth_chunks`` (the decoder's ``decoder_chunk``; JAX
    ``_chunked_nearest_conv`` and ``_chunked_pointwise_conv``,
    ``corrifnet_tpu/nn/leandec.py:113-225``): a skip-concat stage or a 1x1
    stage that takes a handoff runs its conv and ReLU one depth chunk at a
    time, each chunk under ``torch.utils.checkpoint``, so the backward's
    transients are one chunk's. A chunk rebuilds its rows of the run volume
    from the handoff ``(y, a, b)`` with a one-row halo (replicate-padded at
    the volume's edges); the skip block's coarse conv is computed once. The
    stage then ends in ``relu_in_stats`` of its ReLU output (the identity
    on it, and JAX ``_in_stats_of_act``'s statistics, with the hand-derived
    backward that saves no f32 copy). Equal to the unchunked stage up to
    f32 reassociation.

The forward is the standard stage's up to the statistics: K3 computes the
variance in two passes, ``relu_in_stats`` as E[y^2] - E[y]^2 in f32, as the
JAX package's lean and XLA paths do. ``relu_in_stats`` is plain PyTorch on
every device: it is XLA, not Pallas, in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from corrifnet_tpu_torch.nn.conv import Conv
from corrifnet_tpu_torch.nn.depthfuse import (
    coarse_input,
    expand_rows,
    table_columns,
    tap_expand_table,
    tap_major,
)
from corrifnet_tpu_torch.nn.pad import replicate_pad
from corrifnet_tpu_torch.nn.resize import resize_linear

__all__ = ["LeanGeneralConv3d", "LeanHandoff", "lean_head", "relu_in_stats"]


class _ReluInStats(torch.autograd.Function):
    """relu, then the InstanceNorm scalars of the relu output, per (sample,
    channel) over the spatial axes of an NCDHW tensor."""

    @staticmethod
    def forward(ctx, x, eps):
        axes = tuple(range(2, x.dim()))
        y = torch.relu(x)
        yf = y.float()
        mean = yf.mean(axes, keepdim=True)
        sq = (yf * yf).mean(axes, keepdim=True)
        del yf
        var = torch.addcmul(sq, mean, mean, value=-1).clamp_min_(0.0)
        a = (var + eps).rsqrt_()
        # d a / d var where the clamp lets the variance through
        slope = torch.where(var > 0, a.pow(3).mul_(-0.5), 0.0)
        ctx.save_for_backward(y, mean, a, slope)
        return y, a.to(x.dtype), (-mean * a).to(x.dtype)

    @staticmethod
    def backward(ctx, gy, ga, gb):
        # the JAX package's _ris_bwd; the a/b cotangents come from the
        # consumer's fma: sum g*y and sum g
        y, mean, a, slope = ctx.saved_tensors
        n = y[0, 0].numel()
        db = gb.to(a.dtype)
        dvar = torch.addcmul(ga.to(a.dtype), mean, db, value=-1).mul_(slope)
        dmean = torch.addcmul(a * db, mean, dvar, value=2).neg_()
        dyf = torch.addcmul(dmean / n, y, dvar * (2.0 / n))
        dy = gy + dyf.to(y.dtype)
        return dy.masked_fill_(y <= 0, 0), None


def relu_in_stats(x, eps: float = 1e-5):
    """``(y, a, b)``: ``y = relu(x)`` and the scalars with which
    ``y * a + b`` is ``relu_instancenorm(x)`` (single-pass f32 statistics;
    ``a``, ``b`` in x's dtype, shape (B, C, 1, 1, 1))."""
    return _ReluInStats.apply(x, eps)


class LeanHandoff(NamedTuple):
    """A lean stage's output: the relu volume and the InstanceNorm scalars.
    The consumer applies ``y * a + b`` itself."""

    y: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor


def _expand(x, pre_resize):
    """The conv's input from a handoff or a plain tensor: the fma, then the
    H/W-only resize in the compute dtype where ``pre_resize`` asks."""
    if isinstance(x, LeanHandoff):
        x = x.y * x.a + x.b
    if pre_resize:
        x = resize_linear(x, pre_resize, compute_dtype=x.dtype)
    return x


def _nearest_chunk(start, rows, y, a, b, us, w_run, bias, table):
    """Depth rows ``start .. start+rows`` of relu(skip-concat conv): the run
    block's rows rebuilt from the handoff with a one-row halo, convolved as
    ``expand_conv`` convolves them, and expanded with the skip block's
    coarse taps ``us`` in one product."""
    depth, batch = y.shape[2], y.shape[0]
    lo, hi = max(start - 1, 0), min(start + rows + 1, depth)
    x = y[:, :, lo:hi] * a + b
    x = replicate_pad(x, [(int(start == 0), int(start + rows == depth)), (1, 1), (1, 1)])
    _, c, _, hp, wp = x.shape
    x2 = x.transpose(1, 2).reshape(batch * (rows + 2), c, hp, wp)
    z = F.conv2d(x2.contiguous(memory_format=torch.channels_last), w_run)
    shift = np.zeros((rows, 3, rows + 2))
    shift[np.arange(rows)[:, None], np.arange(3), np.arange(rows)[:, None] + np.arange(3)] = 1
    m = np.concatenate([table_columns(table[start:start + rows]), table_columns(shift)], axis=1)
    m = torch.from_numpy(m).to(device=z.device, dtype=z.dtype)
    return torch.relu(expand_rows([us, z], m, batch, bias))


def _chunked_nearest_conv(conv, skip, h, dst_d, chunks):
    """relu(conv((skip, h), ("nearest", dst_d))) one depth chunk at a time
    (JAX ``_chunked_nearest_conv``): skip (B, CS, S, H, W) at its coarse
    rows, h the run's handoff at ``dst_d`` rows."""
    if dst_d % chunks:
        raise ValueError(f"{dst_d} depth rows do not split into {chunks} chunks")
    rows = dst_d // chunks
    dt = h.y.dtype
    w, bias = conv.weight.to(dt), conv._bias(dt)
    cs = skip.shape[1]
    images = coarse_input(skip.to(dt), conv.padding, conv.padding_mode)
    us = F.conv2d(images, tap_major(w[:, :cs]))
    table = tap_expand_table("nearest", skip.shape[2], dst_d, conv.padding_mode)
    w_run = tap_major(w[:, cs:])
    parts = [torch.utils.checkpoint.checkpoint(
        _nearest_chunk, i * rows, rows, h.y, h.a, h.b, us, w_run, bias, table,
        use_reentrant=False) for i in range(chunks)]
    return torch.cat(parts, dim=2)


def _pointwise_chunk(start, rows, y, a, b, w, bias):
    return torch.relu(F.conv3d(y[:, :, start:start + rows] * a + b, w, bias))


def _chunked_pointwise_conv(conv, h, chunks):
    """relu(conv(y * a + b)) of a 1x1 stage one depth chunk at a time (JAX
    ``_chunked_pointwise_conv``)."""
    depth = h.y.shape[2]
    if depth % chunks:
        raise ValueError(f"{depth} depth rows do not split into {chunks} chunks")
    rows = depth // chunks
    dt = h.y.dtype
    w, bias = conv.weight.to(dt), conv._bias(dt)
    parts = [torch.utils.checkpoint.checkpoint(
        _pointwise_chunk, i * rows, rows, h.y, h.a, h.b, w, bias,
        use_reentrant=False) for i in range(chunks)]
    return torch.cat(parts, dim=2)


class _Rebuilt:
    """Token saved in place of a tensor that ``Conv.prepare`` made."""

    def __init__(self, index, rebuild):
        self.index, self.rebuild = index, rebuild


class LeanGeneralConv3d(nn.Module):
    """conv -> relu -> InstanceNorm as ``GeneralConv3d`` (same parameters,
    ``conv.weight`` and ``conv.bias``), with the lean calling convention:
    takes a plain tensor, a ``LeanHandoff`` or ``(skip, handoff)``, and
    returns a ``LeanHandoff``. ``pre_resize``: the (D, H, W) size of the
    H/W-only resize before the conv (the fused up2). ``depth_chunks`` > 0:
    a skip-concat call (``(skip, handoff)`` with ``("nearest", D)``) or a
    1x1 call on a handoff runs depth-chunked (module docstring)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, padding_mode="zeros", pre_resize=(), depth_chunks=0):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         padding, padding_mode=padding_mode)
        self.pre_resize = tuple(pre_resize)
        self.depth_chunks = depth_chunks

    @classmethod
    def sharing(cls, stage, pre_resize=(), depth_chunks=0):
        """The lean twin of the ``GeneralConv3d`` ``stage``, on its conv
        (the same parameter tensors)."""
        lean = cls.__new__(cls)
        nn.Module.__init__(lean)
        lean.conv, lean.pre_resize = stage.conv, tuple(pre_resize)
        lean.depth_chunks = depth_chunks
        return lean

    def _chunked(self, x, depth_fuse):
        """The relu output of a depth-chunked call, or None where the call
        is not one that chunks (JAX ``LeanGeneralConv3d.__call__``)."""
        if not self.depth_chunks:
            return None
        if (depth_fuse is not None and depth_fuse[0] == "nearest" and isinstance(x, tuple)
                and not isinstance(x, LeanHandoff) and isinstance(x[1], LeanHandoff)):
            return _chunked_nearest_conv(self.conv, x[0], x[1], depth_fuse[1],
                                         self.depth_chunks)
        if (depth_fuse is None and isinstance(x, LeanHandoff)
                and tuple(self.conv.weight.shape[2:]) == (1, 1, 1)):
            return _chunked_pointwise_conv(self.conv, x, self.depth_chunks)
        return None

    def _prepare(self, x, depth_fuse):
        if isinstance(x, tuple) and not isinstance(x, LeanHandoff):
            skip, h = x
            x = (skip, _expand(h, self.pre_resize))
        else:
            x = _expand(x, self.pre_resize)
        return self.conv.prepare(x, depth_fuse)

    def forward(self, x, depth_fuse=None) -> LeanHandoff:
        y = self._chunked(x, depth_fuse)
        if y is not None:
            # y is a ReLU output already: relu_in_stats keeps it as it is and
            # takes JAX's _in_stats_of_act statistics, saving y and scalars
            # only (plain autograd through them would save an f32 copy)
            return LeanHandoff(*relu_in_stats(y))
        prepared = self._prepare(x, depth_fuse)
        if not torch.is_grad_enabled():
            return self._epilogue(self.conv.convolve(prepared, depth_fuse))
        # every tensor prepare made but the skip's images (small: the skip's
        # own rows) is rebuilt in the backward instead of saved
        pair = isinstance(x, tuple) and not isinstance(x, LeanHandoff)
        parts = prepared[0]
        keys = {(t.data_ptr(), t.shape, t.stride()): i
                for i, t in enumerate(parts) if i or not pair}

        def rebuild(index):
            with torch.no_grad():
                return self._prepare(x, depth_fuse)[0][index]

        def pack(t):
            index = keys.get((t.data_ptr(), t.shape, t.stride()))
            return t if index is None else _Rebuilt(index, rebuild)

        def unpack(t):
            return t.rebuild(t.index) if isinstance(t, _Rebuilt) else t

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            out = self.conv.convolve(prepared, depth_fuse)
        del prepared, parts
        return self._epilogue(out)

    @staticmethod
    def _epilogue(out):
        # channels-last, as GeneralConv3d hands the conv's output to K3
        out = out.contiguous(memory_format=torch.channels_last_3d)
        return LeanHandoff(*relu_in_stats(out))


def lean_head(h: LeanHandoff):
    """The normalized depth slice 0 of the last stage (the only slice the
    head reads, mmvit4.py:263): the fma on that slice alone."""
    return h.y[:, :, :1] * h.a + h.b
