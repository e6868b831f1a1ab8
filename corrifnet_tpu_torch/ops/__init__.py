"""The port's kernels, each beside its plain PyTorch version.

K1f/K1b ``correlation_fusion`` and its backward (Triton), K2f/K2b
``fused_attention`` and its backward (CUDA C++), K3 ``relu_instancenorm``
(Triton; its backward is the plain formula, as in the JAX package), K4a/K4b
``pointwise_conv_stats`` and K4c/K4d ``conv3x3_fma_relu_stats`` with their
backwards (CUDA C++; the fused bottleneck convolutions, run by
``pallas_fused_blocks``). Each
wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and counts its launches in
``<wrapper>.launches``.
"""

from corrifnet_tpu_torch.ops.attention import (
    attention_backward_plain,
    attention_plain,
    fused_attention,
    fused_attention_bwd,
    fused_attention_qkv,
    philox_keep_mask,
)
from corrifnet_tpu_torch.ops.correlation import (
    correlation_fusion,
    correlation_fusion_backward_plain,
    correlation_fusion_bwd,
    correlation_fusion_plain,
)
from corrifnet_tpu_torch.ops.fusedconv import (
    conv3x3_fma_relu_stats,
    conv3x3_fma_relu_stats_backward_plain,
    conv3x3_fma_relu_stats_bwd,
    conv3x3_fma_relu_stats_plain,
    pointwise_conv_stats,
    pointwise_conv_stats_backward_plain,
    pointwise_conv_stats_bwd,
    pointwise_conv_stats_plain,
)
from corrifnet_tpu_torch.ops.instancenorm import (
    relu_instancenorm,
    relu_instancenorm_backward_plain,
    relu_instancenorm_plain,
)

__all__ = [
    "KERNELS",
    "attention_backward_plain",
    "attention_plain",
    "conv3x3_fma_relu_stats",
    "conv3x3_fma_relu_stats_backward_plain",
    "conv3x3_fma_relu_stats_bwd",
    "conv3x3_fma_relu_stats_plain",
    "correlation_fusion",
    "correlation_fusion_backward_plain",
    "correlation_fusion_bwd",
    "correlation_fusion_plain",
    "fused_attention",
    "fused_attention_bwd",
    "fused_attention_qkv",
    "philox_keep_mask",
    "pointwise_conv_stats",
    "pointwise_conv_stats_backward_plain",
    "pointwise_conv_stats_bwd",
    "pointwise_conv_stats_plain",
    "relu_instancenorm",
    "relu_instancenorm_backward_plain",
    "relu_instancenorm_plain",
]

# The kernel wrappers on the training path, by kernel name; the last four
# run when the model is built with ``pallas_fused_blocks``.
KERNELS = {
    "correlation_fusion": correlation_fusion,
    "correlation_fusion_bwd": correlation_fusion_bwd,
    "fused_attention": fused_attention,
    "fused_attention_bwd": fused_attention_bwd,
    "relu_instancenorm": relu_instancenorm,
    "pointwise_conv_stats": pointwise_conv_stats,
    "pointwise_conv_stats_bwd": pointwise_conv_stats_bwd,
    "conv3x3_fma_relu_stats": conv3x3_fma_relu_stats,
    "conv3x3_fma_relu_stats_bwd": conv3x3_fma_relu_stats_bwd,
}
