"""Model registry of the port, keyed by the reference's ``modeltype`` strings.

Counterpart of ``corrifnet_tpu/models/registry.py``: a table of specs (name,
factory, input kind). Only MMVit4 (CorrIFNet) is ported; every other model
of the JAX package's zoo is still to be ported (see ROADMAP.md). A factory
takes the compute ``dtype`` and the MMVit4 options as keywords and returns a
module with ``compute_dtype``, ``reset_parameters(generator)`` and
``set_dropout_rng(rng)``, as ``MMVit4`` has.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn

from corrifnet_tpu_torch.models.mmvit4 import MMVit4

__all__ = ["ModelSpec", "create_model", "get_spec"]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    factory: Callable[..., nn.Module]
    input_kind: str  # '5d': (B, 3 modalities, 3 bands, H, W)


_REGISTRY: Dict[str, ModelSpec] = {"MMVit4": ModelSpec("MMVit4", MMVit4, "5d")}


def get_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"modeltype {name!r} is not ported to PyTorch yet; see ROADMAP.md"
        )
    return _REGISTRY[name]


def create_model(name: str, dtype=torch.float32, device="cpu", seed: int = 0,
                 transformer_dropout: float = 0.1,
                 pallas_fused_blocks: bool = False,
                 decoder_lean: "bool | None" = None):
    """Build ``name`` in eval mode with f32 parameters drawn from ``seed``
    (on the CPU, so weights do not depend on the device), compute dtype
    ``dtype``, on ``device``. ``transformer_dropout`` acts in training mode;
    ``pallas_fused_blocks`` runs the encoder bottlenecks through the fused
    convolution kernels (same parameters, same ``state_dict``);
    ``decoder_lean`` chooses the decoder's lean backward (None: at batch <=
    4, the JAX package's rule)."""
    model = get_spec(name).factory(
        dtype=dtype, transformer_dropout=transformer_dropout,
        pallas_fused_blocks=pallas_fused_blocks, decoder_lean=decoder_lean)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
