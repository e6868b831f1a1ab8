"""Loss functions (reference: F4_TRAIN.py:58-60, F7_TEST2.py:167-168).

Counterpart of ``corrifnet_tpu/metrics/losses.py``. The reference applies
``nn.BCEWithLogitsLoss`` to model outputs that already went through a
sigmoid head (mmvit4.py:291): a *double sigmoid*. The quirk is kept, since
the committed losses (~0.60-0.66) depend on it: the training loss takes the
model's sigmoid output as its "logits".
"""

from __future__ import annotations

import torch

__all__ = ["bce_with_logits", "bce_with_logits_per_element", "reference_bce_loss"]


def bce_with_logits_per_element(logits, targets):
    """The stable form ``max(x, 0) - x*y + log(1 + exp(-|x|))``."""
    x, y = logits, targets
    return torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))


def bce_with_logits(logits, targets):
    """Mean BCE-with-logits, as ``nn.BCEWithLogitsLoss`` (mean reduction)."""
    return bce_with_logits_per_element(logits, targets).mean()


def reference_bce_loss(model_out, targets):
    """The reference's training and evaluation loss: BCE-with-logits on the
    model head's sigmoid probabilities (F4_TRAIN.py:58-60)."""
    return bce_with_logits(model_out, targets)
