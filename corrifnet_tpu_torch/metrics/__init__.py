"""Metrics of the port (counterpart of ``corrifnet_tpu.metrics``)."""

from corrifnet_tpu_torch.metrics.jaccard import jaccard2, jaccard_f1_pair

__all__ = ["jaccard2", "jaccard_f1_pair"]
