#!/usr/bin/env python3
"""How far are the port's f32 training gradients from the true ones, on the
card and on the CPU? And is the nearest-resize backward right on the card?

    python3 scripts/check_torch_gradients.py

On one NVIDIA GPU, MMVit4 at 224x224, B=1, dropout 0, BatchNorm on batch
statistics, the weights, input and masks of ``chip_smoke.py`` phase 7:

1. the nearest resize alone at the decoder's four skip shapes: the
   backward of ``nn.resize_nearest`` and of ``F.interpolate`` on the card
   against ``F.interpolate``'s on the CPU, f32, and both timed in bf16 at
   the largest shape of a B=4 step;
2. the reference gradient: the port in float64 on the card, its three
   kernels replaced by their plain versions and every ``.float()`` made
   ``.double()`` (cuDNN convolves in f64);
3. against it, per gradient tensor, ||g - reference|| / ||reference|| of:
   the card in f32 with the kernels, the card in f32 with the plain
   versions, and the CPU in f32: median, worst tensor, whole gradient.

It is the evidence behind the bound of ``chip_smoke.py`` phase 7. Fails
without a GPU.
"""

from __future__ import annotations

import copy
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

import corrifnet_tpu_torch.models.mmvit4 as mmvit4  # noqa: E402
import corrifnet_tpu_torch.nn.conv as conv  # noqa: E402
import corrifnet_tpu_torch.nn.transformer as transformer  # noqa: E402
from corrifnet_tpu_torch import ops  # noqa: E402
from corrifnet_tpu_torch.models import create_model  # noqa: E402
from corrifnet_tpu_torch.nn import resize_nearest  # noqa: E402
from corrifnet_tpu_torch.testing import calibrate_batchnorm  # noqa: E402
from corrifnet_tpu_torch.train import masked_loss_and_jaccard  # noqa: E402


def check_resize():
    gen = torch.Generator().manual_seed(0)
    for src, dst in [((3, 14, 14), 16), ((3, 28, 28), 32), ((3, 56, 56), 64),
                     ((3, 56, 56), 128)]:
        x = torch.randn((1, 4, *src), generator=gen)
        g = torch.randn((1, 4, dst, dst, dst), generator=gen)

        def grad(fn, dev):
            leaf = x.to(dev).requires_grad_()
            return torch.autograd.grad(fn(leaf), leaf, g.to(dev))[0].cpu()

        def library(t):
            return F.interpolate(t, size=(dst,) * 3, mode="nearest")

        def own(t):
            return resize_nearest(t, (dst,) * 3)

        ref = grad(library, "cpu")
        print(f"  {src} -> {dst}^3 backward, max |card - CPU|: F.interpolate "
              f"{(grad(library, 'cuda') - ref).abs().max().item():.3e}, resize_nearest "
              f"{(grad(own, 'cuda') - ref).abs().max().item():.3e}; largest gradient "
              f"{ref.abs().max().item():.3e}", flush=True)
    x = torch.randn((4, 24, 3, 56, 56), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    g = torch.randn((4, 24, 128, 128, 128), device="cuda", dtype=torch.bfloat16)
    for name, fn in (("F.interpolate", lambda t: F.interpolate(t, size=(128,) * 3)),
                     ("resize_nearest", lambda t: resize_nearest(t, (128,) * 3))):
        y = fn(x)
        ms = chip_smoke.median_ms(lambda: torch.autograd.grad(y, x, g, retain_graph=True))
        print(f"  {name} backward at (4, 24, 3, 56, 56) -> 128^3, bf16: {ms:.4f} ms",
              flush=True)


def with_plain_versions(fn):
    """Run ``fn`` with the model's three kernel wrappers replaced by their
    plain versions (dropout is 0 here)."""
    saved = conv.relu_instancenorm, transformer.fused_attention_qkv, mmvit4.correlation_fusion
    conv.relu_instancenorm = ops.relu_instancenorm_plain
    transformer.fused_attention_qkv = (
        lambda qkv, scale, rate=0.0, philox=None: ops.attention_plain(
            *qkv.permute(2, 0, 3, 1, 4).unbind(0), scale))
    mmvit4.correlation_fusion = ops.correlation_fusion_plain
    try:
        return fn()
    finally:
        conv.relu_instancenorm, transformer.fused_attention_qkv, mmvit4.correlation_fusion = saved


def reference_gradients(model, x, masks, valid):
    """The step in float64 on the card with the plain versions."""
    m64 = create_model("MMVit4", dtype=torch.float64, device="cpu", seed=0,
                       transformer_dropout=0.0)
    m64.load_state_dict(model.state_dict())
    m64 = m64.double().to("cuda").train()
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        out = with_plain_versions(lambda: m64(x.double().cuda()))
        loss, _, _ = masked_loss_and_jaccard(out, masks.double().cuda(),
                                             valid.double().cuda())
        loss.backward()
    finally:
        torch.Tensor.float = to_float
    return loss.item(), {n: p.grad.cpu() for n, p in m64.named_parameters()
                         if p.grad is not None}


def main():
    if not torch.cuda.is_available():
        print("check_torch_gradients: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line())
    print(f"torch {torch.__version__}")
    print("nearest resize, backward:")
    check_resize()

    x = chip_smoke.seeded_image()
    gen = torch.Generator().manual_seed(1)
    masks = (torch.rand((1, 3, 1, 224, 224), generator=gen) > 0.5).float()
    valid = torch.ones(1)
    cpu = create_model("MMVit4", dtype=torch.float32, device="cpu", seed=0,
                       transformer_dropout=0.0)
    calibrate_batchnorm(cpu, x)
    step = chip_smoke.step_gradients
    loss64, ref = reference_gradients(cpu, x, masks, valid)
    runs = {
        "card f32, kernels": step(copy.deepcopy(cpu).to("cuda"), x, masks, valid),
        "card f32, plain versions": with_plain_versions(
            lambda: step(copy.deepcopy(cpu).to("cuda"), x, masks, valid)),
        "CPU f32": step(copy.deepcopy(cpu), x, masks, valid),
    }
    print(f"one training step, B=1, 224x224; reference: f64 on the card, loss {loss64:.12f}")
    for name, (loss, grads) in runs.items():
        diff = sum((grads[n].double() - ref[n]).square().sum().item() for n in ref)
        norm = sum(ref[n].square().sum().item() for n in ref)
        l2 = [(((grads[n].double() - ref[n]).norm() / ref[n].norm()).item(), n) for n in ref]
        print(f"  {name}: loss {loss:.8f}; ||g - reference|| / ||reference|| over "
              f"{len(l2)} tensors: median {statistics.median(v for v, _ in l2):.3e}, worst "
              f"{max(l2)[0]:.3e} at {max(l2)[1]}, whole gradient {(diff / norm) ** 0.5:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
