"""Weight initializers of the reference, driven by an explicit generator.

Counterpart of ``corrifnet_tpu/nn/init.py``. MMVit4 re-initializes every
Conv3d with ``kaiming_normal_`` (fan_in, gain sqrt(2)); Linear layers and
conv biases keep PyTorch's defaults, U(+-1/sqrt(fan_in)). Tensors are in
PyTorch layout, ``(out, in, *kernel)``. The generator is always explicit,
so a model's weights are a function of its seed alone.

``apply_reference_init_scheme`` is the ``transfertype='notr'``
re-initialization (F2_MAIN.py:134-157): the configured scheme on the 2-D
conv kernels, the biases beside them zeroed. It re-initializes the tensors
the JAX package's does: kernels of exactly 4 axes in its parameter tree,
which leaves out the per-modality modules it stacks on a leading modality
axis (a model names those in ``JAX_STACKED``), though the reference
re-initializes every Conv2d. Each kernel is drawn in the layout its
``Conv.kernel()`` gives, whose fans are the JAX kernel's: Segformer's
patch embeds, kept as the reference's ``(O, I*k*k, 1, 1)`` 1x1 weights,
draw as the ``(O, I, k, k)`` convs that the JAX package holds. ENet's
transposed convs (``ConvTranspose``, 4-axis kernels in the JAX tree) are
re-initialized too, as the JAX package's are, though the reference's
Conv2d-only dispatch leaves them as built (ROADMAP.md, "Not faults").
"""

from __future__ import annotations

import math

import torch

__all__ = ["REFERENCE_INIT_SCHEMES", "apply_reference_init_scheme", "fans", "fan_in",
           "kaiming_normal_", "kaiming_uniform_", "torch_default_", "xavier_normal_",
           "xavier_uniform_"]


def fan_in(weight: torch.Tensor) -> int:
    """fan_in of a ``(out, in, *kernel)`` weight."""
    return weight.shape[1] * math.prod(weight.shape[2:])


@torch.no_grad()
def torch_default_(tensor: torch.Tensor, fan: int, generator: torch.Generator):
    """PyTorch's Conv/Linear default for weights and biases: U(+-1/sqrt(fan))."""
    bound = 1.0 / math.sqrt(fan) if fan > 0 else 0.0
    return tensor.uniform_(-bound, bound, generator=generator)


def fans(weight: torch.Tensor):
    """(fan_in, fan_out) of a ``(out, in, *kernel)`` weight (the JAX
    package's ``compute_fans`` on its ``(*kernel, in, out)`` layout)."""
    receptive = math.prod(weight.shape[2:])
    return weight.shape[1] * receptive, weight.shape[0] * receptive


def _normal_(weight, std, generator):
    """N(0, std^2) drawn on the CPU from ``generator``, copied into weight."""
    weight.copy_(torch.empty(weight.shape).normal_(0.0, std, generator=generator))
    return weight


def _uniform_(weight, bound, generator):
    weight.copy_(torch.empty(weight.shape).uniform_(-bound, bound, generator=generator))
    return weight


@torch.no_grad()
def kaiming_uniform_(weight, generator):
    """``torch.nn.init.kaiming_uniform_`` defaults: U(+-sqrt(6 / fan_in))."""
    return _uniform_(weight, math.sqrt(6.0 / fans(weight)[0]), generator)


@torch.no_grad()
def xavier_normal_(weight, generator):
    fi, fo = fans(weight)
    return _normal_(weight, math.sqrt(2.0 / (fi + fo)), generator)


@torch.no_grad()
def xavier_uniform_(weight, generator):
    fi, fo = fans(weight)
    return _uniform_(weight, math.sqrt(6.0 / (fi + fo)), generator)


@torch.no_grad()
def kaiming_normal_(weight: torch.Tensor, generator: torch.Generator):
    """``torch.nn.init.kaiming_normal_`` defaults: N(0, 2 / fan_in)."""
    return _normal_(weight, math.sqrt(2.0 / fan_in(weight)), generator)


# F2_MAIN.py:134-157's init_weights dispatch (the config's initialization line)
REFERENCE_INIT_SCHEMES = {
    "xavier_uniform_": xavier_uniform_,
    "xavier_normal_": xavier_normal_,
    "kaiming_uniform_": kaiming_uniform_,
    "kaiming_normal_": kaiming_normal_,
}


@torch.no_grad()
def apply_reference_init_scheme(model, scheme: str, generator: torch.Generator):
    """Re-initialize ``model``'s 2-D conv and transposed-conv kernels with
    ``scheme`` from ``generator`` (drawn on the CPU, in module order) and
    zero their biases, skipping the modules under the model's
    ``JAX_STACKED`` prefixes. An unknown scheme is a no-op, as the
    reference's dispatch is. Returns the names of the kernels
    re-initialized."""
    from corrifnet_tpu_torch.nn.conv import Conv, ConvTranspose

    init = REFERENCE_INIT_SCHEMES.get(scheme)
    if init is None:
        return []
    stacked = tuple(getattr(model, "JAX_STACKED", ()))
    names = []
    for name, module in model.named_modules():
        if (isinstance(module, (Conv, ConvTranspose)) and module.weight.dim() == 4
                and not (name + ".").startswith(stacked)):
            init(module.kernel(), generator)
            if module.bias is not None:
                module.bias.zero_()
            names.append(f"{name}.weight")
    return names
