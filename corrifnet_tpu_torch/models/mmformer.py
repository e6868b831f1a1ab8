"""mmformer, re-exported from ``models.mmvit2`` (as in the JAX package: the
reference files mmformer.py and mmmvit2.py are byte-identical apart from the
correlation stage)."""

from corrifnet_tpu_torch.models.mmvit2 import MMFormer

__all__ = ["MMFormer"]
