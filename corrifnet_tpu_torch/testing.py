"""Helpers for checking the port's numerics; no model or entry point uses them.

``calibrate_batchnorm`` gives a freshly initialized model the O(1)
activations that trained BatchNorm statistics keep, so that comparisons
of two implementations on random weights measure rounding, not the
amplification of it. The CPU tests and ``chip_smoke.py`` call it.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn.norm import BatchNorm

__all__ = ["calibrate_batchnorm"]


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, *inputs):
    """Set every ``BatchNorm``'s running statistics from one forward of
    ``inputs``: mean 0, and as variance the mean square of its input over
    all elements (one value per layer), so each BatchNorm scales its input
    to unit RMS and activations stay O(1), as trained statistics keep them.
    Freshly initialized weights with identity statistics let the encoder's
    activations grow to ~1e3, where the correlation softmax saturates and
    f32 rounding decides its winners. Per-channel batch statistics would
    instead divide nearly constant channels by tiny deviations and amplify
    rounding the same way."""

    def take_stats(mod, args):
        mod.running_mean.zero_()
        mod.running_var.fill_(args[0].float().square().mean().item())

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return model
