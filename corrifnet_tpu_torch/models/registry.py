"""Model registry of the port, keyed by the reference's ``modeltype`` strings.

Only MMVit4 (CorrIFNet) is ported; every other model of the JAX package's
zoo is still to be ported (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from corrifnet_tpu_torch.models.mmvit4 import MMVit4

__all__ = ["create_model"]


def create_model(name: str, dtype=torch.float32, device="cpu", seed: int = 0,
                 transformer_dropout: float = 0.1):
    """Build ``name`` in eval mode with f32 parameters drawn from ``seed``
    (on the CPU, so weights do not depend on the device), compute dtype
    ``dtype``, on ``device``. ``transformer_dropout`` acts in training mode."""
    if name != "MMVit4":
        raise NotImplementedError(
            f"modeltype {name!r} is not ported to PyTorch yet; see ROADMAP.md"
        )
    model = MMVit4(dtype=dtype, transformer_dropout=transformer_dropout)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
