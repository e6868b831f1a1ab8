"""The port's kernels, each beside its plain PyTorch version.

K1 ``correlation_fusion`` (Triton), K2 ``fused_attention`` (CUDA C++),
K3 ``relu_instancenorm`` (Triton). Each wrapper runs its plain version for
CPU tensors only; for CUDA tensors it launches its kernel or raises, and
counts its launches in ``<wrapper>.launches``.
"""

from corrifnet_tpu_torch.ops.attention import attention_plain, fused_attention
from corrifnet_tpu_torch.ops.correlation import (
    correlation_fusion,
    correlation_fusion_plain,
)
from corrifnet_tpu_torch.ops.instancenorm import (
    relu_instancenorm,
    relu_instancenorm_plain,
)

__all__ = [
    "KERNELS",
    "attention_plain",
    "correlation_fusion",
    "correlation_fusion_plain",
    "fused_attention",
    "relu_instancenorm",
    "relu_instancenorm_plain",
]

# The kernel wrappers on the evaluation path, by kernel name.
KERNELS = {
    "correlation_fusion": correlation_fusion,
    "fused_attention": fused_attention,
    "relu_instancenorm": relu_instancenorm,
}
