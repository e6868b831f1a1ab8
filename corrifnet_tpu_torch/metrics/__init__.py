"""Metrics of the port (counterpart of ``corrifnet_tpu.metrics``)."""

from corrifnet_tpu_torch.metrics.jaccard import (
    jaccard2,
    jaccard2_masked,
    jaccard_f1_pair,
)
from corrifnet_tpu_torch.metrics.losses import bce_with_logits, reference_bce_loss

__all__ = ["bce_with_logits", "jaccard2", "jaccard2_masked", "jaccard_f1_pair",
           "reference_bce_loss"]
