"""Layers of the port (counterpart of ``corrifnet_tpu.nn``)."""

from corrifnet_tpu_torch.nn.conv import (
    Conv,
    Dense,
    EarlyFusionBlock,
    FusionPrenorm,
    GeneralConv3d,
)
from corrifnet_tpu_torch.nn.norm import BatchNorm, InstanceNorm, LayerNorm
from corrifnet_tpu_torch.nn.resize import (
    adaptive_max_pool,
    max_pool,
    resize_linear,
    resize_nearest,
)
from corrifnet_tpu_torch.nn.transformer import DropoutRng, Transformer

__all__ = [
    "BatchNorm",
    "Conv",
    "Dense",
    "DropoutRng",
    "EarlyFusionBlock",
    "FusionPrenorm",
    "GeneralConv3d",
    "InstanceNorm",
    "LayerNorm",
    "Transformer",
    "adaptive_max_pool",
    "max_pool",
    "resize_linear",
    "resize_nearest",
]
