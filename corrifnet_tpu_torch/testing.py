"""Helpers for checking the port's numerics; no model or entry point uses them.

``calibrate_batchnorm`` gives a freshly initialized model the O(1)
activations that trained BatchNorm statistics keep, so that comparisons
of two implementations on random weights measure rounding, not the
amplification of it. The CPU tests and ``chip_smoke.py`` call it.
``block_train_step`` and ``well_conditioned_block`` serve the checks of a
fused bottleneck on the card against the CPU. ``zero_gradients`` names the
parameters whose gradient is 0 but for rounding in training mode.
"""

from __future__ import annotations

import torch
from torch import nn

from corrifnet_tpu_torch.nn.norm import BatchNorm

__all__ = ["block_train_step", "calibrate_batchnorm", "rel_max",
           "well_conditioned_block", "zero_gradients"]


def zero_gradients(model: nn.Module, batch: int = 1):
    """The names of the parameters whose gradient in a training-mode step at
    ``batch`` is 0 but for rounding, to be held by size and not by relative
    error: with batch statistics a ``BatchNorm`` takes out again what adds a
    constant to each of its channels. These are the conv biases that feed a
    BatchNorm directly (the next module of the same Sequential:
    MultiSenseSeg's seven, each of UNetV2's, DeepLabv3_plus's ``fc1.0``,
    ``reduce_conv2.0``, ``last_conv.0`` and ``last_conv.4``); in
    DeepLabv3_plus:

      * the ASPP convs' biases (each feeds its ``batch_norm``, an attribute
        pair), and the ASPP BatchNorms' own biases: the branches reach fc1's
        BatchNorm through the 1x1 ``fc1.0`` alone, so a constant added to one
        of their channels adds a constant to fc1's channels;
      * ``image_pool.1.bias``, for the same reason; at batch 1
        ``image_pool.1.weight`` too, the pooled branch being then one
        constant per channel (``fc1.0.weight``'s pooled columns are 0 but for
        rounding as well, inside a live tensor);

    and in MultiSenseSeg:

      * with the Swin backbone, the LayerNorm biases of the stages whose
        output reaches a BatchNorm through a 1x1 conv alone (the FPN's
        laterals: every stage but the last); the ``use_faster`` CNN
        backbone's convs are bias-free and its stages end in a ReLU, so it
        adds none;
      * ``smooth``'s BatchNorm bias: its ReLU'd output reaches the model
        only through MaxPool(4) and a 1x1 conv before a BatchNorm, so where
        each window holds a positive entry the bias shifts a channel by a
        constant;
      * at batch 1, the decode gate's SE weights: the SE averages each
        channel of a training-mode BatchNorm's output over the image, which
        is then that norm's bias, 0 as initialized, and both weights'
        gradients are products with it;

    and in ELANet the decoder's two 1x1 convs with bias that feed a
    BNPReLU (``decode.Xd1.1``, ``decode.Xd2_1.1``). FASSDNet's and ENet's
    convs are bias-free but their last, and their BatchNorm biases all reach
    a nonlinearity: they have none. (A gradient that is exactly 0, on both
    sides, because a ReLU is dead for the data, as an ELANet CCA's can be,
    is not listed: it depends on the weights.)"""
    from corrifnet_tpu_torch.models.deeplabv3p import ASPP_RATES, DeepLabV3Plus
    from corrifnet_tpu_torch.models.elanet import ELANet
    from corrifnet_tpu_torch.models.multisenseseg import MultiSenseSeg, SwinBackbone
    from corrifnet_tpu_torch.nn.conv import Conv

    names = []
    if isinstance(model, ELANet):
        names += [f"decode.{seq}.1.bias" for seq in ("Xd1", "Xd2_1")]
    if isinstance(model, MultiSenseSeg) and isinstance(model.build_pipeline, SwinBackbone):
        names += [f"build_pipeline.norm{i}.bias"
                  for i in range(len(model.build_pipeline.depths) - 1)]
    if isinstance(model, MultiSenseSeg):
        names.append("build_MSEs_AMM.smooth.1.bias")
        if batch == 1:
            names += ["build_decode_head.chan_attn.attn.1.weight",
                      "build_decode_head.chan_attn.attn.3.weight"]
    if isinstance(model, DeepLabV3Plus):
        names += [f"aspp{i + 1}.{m}.bias" for i in range(len(ASPP_RATES))
                  for m in ("atrous_convolution", "batch_norm")]
        names += ["image_pool.1.bias"] + (["image_pool.1.weight"] if batch == 1 else [])
    for prefix, module in model.named_modules():
        if not isinstance(module, nn.Sequential):
            continue
        mods = list(module)
        for i, (a, b) in enumerate(zip(mods, mods[1:])):
            if isinstance(a, Conv) and a.bias is not None and isinstance(b, BatchNorm):
                names.append(f"{prefix}.{i}.bias")
    return names


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, *inputs):
    """Set every ``BatchNorm``'s running statistics from one forward of
    ``inputs``: mean 0, and as variance the mean square of its input over
    all elements (one value per layer), so each BatchNorm scales its input
    to unit RMS and activations stay O(1), as trained statistics keep them.
    Freshly initialized weights with identity statistics let the encoder's
    activations grow to ~1e3, where the correlation softmax saturates and
    f32 rounding decides its winners. Per-channel batch statistics would
    instead divide nearly constant channels by tiny deviations and amplify
    rounding the same way."""

    def take_stats(mod, args):
        mod.running_mean.zero_()
        mod.running_var.fill_(args[0].float().square().mean().item())

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return model


def rel_max(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def block_train_step(block, x):
    """One train-mode step of ``block`` on ``x`` (on the block's device) under
    the loss ``sum(y * cos(index))``: the output, the gradients of the input
    (``dx``) and of every parameter (``d <name>``), and the running
    statistics after the step, all on the CPU."""
    dev = next(block.parameters()).device
    leaf = x.to(dev).requires_grad_()
    y = block.train()(leaf)
    weights = torch.cos(torch.arange(y.numel(), device=dev).float()).view(y.shape)
    names, params = zip(*block.named_parameters())
    grads = torch.autograd.grad((y * weights).sum(), [leaf, *params])
    out = {"y": y.detach().cpu(), "dx": grads[0].cpu()}
    out.update({"d " + n: g.cpu() for n, g in zip(names, grads[1:])})
    out.update({k: v.detach().cpu().clone() for k, v in block.state_dict().items()
                if "running_" in k})
    return out


def well_conditioned_block(make_block, x_shape, seeds=range(8), tol=1e-5):
    """``(block, x, results, seed)`` on the CPU for the first seed whose
    ``block_train_step`` results move by no more than ``tol`` (``rel_max``)
    when the input is scaled by 1 + 1e-6.

    A ReLU whose input lies within rounding of 0 flips under any change of
    the order of sums, and one flip moves a gradient tensor by percents of
    its largest entry; on such data two correct implementations disagree.
    This picks data on which a comparison to 1e-4 is meaningful."""
    import copy

    for seed in seeds:
        gen = torch.Generator().manual_seed(seed)
        block = make_block()
        for m in block.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        x = torch.randn(x_shape, generator=gen)
        results = block_train_step(copy.deepcopy(block), x)
        moved = block_train_step(copy.deepcopy(block), x * (1 + 1e-6))
        if max(rel_max(moved[k], v) for k, v in results.items()) <= tol:
            return block, x, results, seed
    raise RuntimeError(f"no seed in {list(seeds)} gives a well-conditioned case")
