"""The port's kernels, each beside its plain PyTorch version.

K1f/K1b ``correlation_fusion`` and its backward (Triton), K2f/K2b
``fused_attention`` and its backward (CUDA C++), K3 ``relu_instancenorm``
(Triton; its backward is the plain formula, as in the JAX package). Each
wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and counts its launches in
``<wrapper>.launches``.
"""

from corrifnet_tpu_torch.ops.attention import (
    attention_plain,
    fused_attention,
    fused_attention_bwd,
    philox_keep_mask,
)
from corrifnet_tpu_torch.ops.correlation import (
    correlation_fusion,
    correlation_fusion_backward_plain,
    correlation_fusion_bwd,
    correlation_fusion_plain,
)
from corrifnet_tpu_torch.ops.instancenorm import (
    relu_instancenorm,
    relu_instancenorm_backward_plain,
    relu_instancenorm_plain,
)

__all__ = [
    "KERNELS",
    "attention_plain",
    "correlation_fusion",
    "correlation_fusion_backward_plain",
    "correlation_fusion_bwd",
    "correlation_fusion_plain",
    "fused_attention",
    "fused_attention_bwd",
    "philox_keep_mask",
    "relu_instancenorm",
    "relu_instancenorm_backward_plain",
    "relu_instancenorm_plain",
]

# The kernel wrappers on the training path, by kernel name.
KERNELS = {
    "correlation_fusion": correlation_fusion,
    "correlation_fusion_bwd": correlation_fusion_bwd,
    "fused_attention": fused_attention,
    "fused_attention_bwd": fused_attention_bwd,
    "relu_instancenorm": relu_instancenorm,
}
