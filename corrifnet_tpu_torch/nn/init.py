"""Weight initializers of the reference, driven by an explicit generator.

Counterpart of ``corrifnet_tpu/nn/init.py``. MMVit4 re-initializes every
Conv3d with ``kaiming_normal_`` (fan_in, gain sqrt(2)); Linear layers and
conv biases keep PyTorch's defaults, U(+-1/sqrt(fan_in)). Tensors are in
PyTorch layout, ``(out, in, *kernel)``. The generator is always explicit,
so a model's weights are a function of its seed alone.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fan_in", "kaiming_normal_", "torch_default_"]


def fan_in(weight: torch.Tensor) -> int:
    """fan_in of a ``(out, in, *kernel)`` weight."""
    return weight.shape[1] * math.prod(weight.shape[2:])


@torch.no_grad()
def kaiming_normal_(weight: torch.Tensor, generator: torch.Generator):
    """``torch.nn.init.kaiming_normal_`` defaults: N(0, 2 / fan_in)."""
    return weight.normal_(0.0, math.sqrt(2.0 / fan_in(weight)),
                          generator=generator)


@torch.no_grad()
def torch_default_(tensor: torch.Tensor, fan: int, generator: torch.Generator):
    """PyTorch's Conv/Linear default for weights and biases: U(+-1/sqrt(fan))."""
    bound = 1.0 / math.sqrt(fan) if fan > 0 else 0.0
    return tensor.uniform_(-bound, bound, generator=generator)
