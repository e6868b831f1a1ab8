"""Replicate padding with a backward in a fixed order.

PyTorch's CUDA backward of replicate padding
(``replication_pad{2,3}d_backward``) adds each border gradient into its
edge with atomics, so its bits change from run to run. With deterministic
algorithms on, ``F.pad`` runs a decomposition instead (a gather whose
backward is a sorted ``index_put``): deterministic, but its gather forward
alone took 6.5 ms of the MMVit2 family's B=4 step on the card, where the
padding kernels took 5.0 forward and backward. The JAX package pads with
``jnp.pad(..., mode="edge")``, which concatenates the repeated edge slice
axis by axis (D, then H, then W); its transpose folds the border rows back
into the edge rows in the reverse order. ``replicate_pad`` is that: the
forward is PyTorch's padding kernel (the aten op, which has no such
switch), the backward a sum of each border and one add into its edge row,
last axis first.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["replicate_pad"]


# PyTorch's replicate padding kernels by input rank (batch and channel axes,
# then one to three padded axes)
_PAD = {3: torch.ops.aten.replication_pad1d, 4: torch.ops.aten.replication_pad2d,
        5: torch.ops.aten.replication_pad3d}


def _memory_format(x):
    if x.dim() == 5 and x.is_contiguous(memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class _ReplicatePad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, pads):
        ctx.pads = pads
        ctx.memory_format = _memory_format(x)
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return _PAD[x.dim()](x, flat)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        core = g
        for axis in reversed(range(len(ctx.pads))):
            lo, hi = ctx.pads[axis]
            dim = 2 + axis
            n = g.shape[dim] - lo - hi
            if lo:
                g.narrow(dim, lo, 1).add_(g.narrow(dim, 0, lo).sum(dim, keepdim=True))
            if hi:
                g.narrow(dim, lo + n - 1, 1).add_(
                    g.narrow(dim, lo + n, hi).sum(dim, keepdim=True))
            core = core.narrow(dim, lo, n)
        return core.contiguous(memory_format=ctx.memory_format), None


def replicate_pad(x, pads: Sequence[Tuple[int, int]]):
    """x (B, C, *spatial) padded by ``pads``, one (before, after) pair per
    spatial axis, with copies of the edge rows (``F.pad(mode="replicate")``,
    ``jnp.pad(mode="edge")``)."""
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    if len(pads) != x.dim() - 2:
        raise ValueError(f"{len(pads)} padding pairs for a tensor of shape {tuple(x.shape)}")
    if not any(lo or hi for lo, hi in pads):
        return x
    return _ReplicatePad.apply(x, pads)
