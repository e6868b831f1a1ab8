"""Layers of the port (counterpart of ``corrifnet_tpu.nn``)."""

from corrifnet_tpu_torch.nn.conv import (
    Conv,
    ConvTranspose,
    Dense,
    EarlyFusionBlock,
    FusionPrenorm,
    GeneralConv3d,
    PReLU,
)
from corrifnet_tpu_torch.nn.norm import BatchNorm, BatchStatsTape, InstanceNorm, LayerNorm
from corrifnet_tpu_torch.nn.resize import (
    adaptive_max_pool,
    avg_pool,
    max_pool,
    max_pool_argmax,
    max_unpool,
    resize_linear,
    resize_nearest,
)
from corrifnet_tpu_torch.nn.transformer import DropoutRng, Transformer

__all__ = [
    "BatchNorm",
    "BatchStatsTape",
    "Conv",
    "ConvTranspose",
    "Dense",
    "DropoutRng",
    "EarlyFusionBlock",
    "FusionPrenorm",
    "GeneralConv3d",
    "InstanceNorm",
    "LayerNorm",
    "PReLU",
    "Transformer",
    "adaptive_max_pool",
    "avg_pool",
    "max_pool",
    "max_pool_argmax",
    "max_unpool",
    "resize_linear",
    "resize_nearest",
]
