"""``fuse_expand_bn`` against the JAX package, on the CPU.

* ``fused_pointwise_conv_bn`` against JAX's, train and eval, stride 1 and
  2: the output, the running statistics and the gradients;
* in bf16, the statistics taken from the bf16 input in f32 (the Gram is
  never rounded to bf16);
* ``Bottleneck3D(fuse_expand_bn=True)`` for one training step at a small
  width against JAX's, and the flag's ``state_dict`` keys (the unfused
  pair's);
* the whole MMVit4 at B=1 in f32 with ``depth_mode='pruned'`` and
  ``fuse_expand_bn=True`` against JAX's with the same flags, its weights
  brought across by ``models.jax_import`` and loaded strictly.

Inputs are made from a numpy seed and fed to both sides. The port is NCDHW,
the JAX package channels-last. Each test states its tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from corrifnet_tpu.models.torch_import import _bottleneck
from corrifnet_tpu.nn import init as jinit
from corrifnet_tpu.nn.fusedbn import fused_pointwise_conv_bn as jax_fused
from corrifnet_tpu_torch.models import create_model, mmvit4_state_dict_from_variables
from corrifnet_tpu_torch.models.resnet3d import Bottleneck3D
from corrifnet_tpu_torch.nn import BatchNorm, Conv
from corrifnet_tpu_torch.nn.fusedbn import fused_pointwise_conv_bn
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

F32_REL = 1e-5     # f32 sums of the Gram and the products in another order
STATS_REL = 1e-6   # the bf16 input's statistics in f32 against float64
MODEL_ATOL = 5e-5  # the f32 whole-model forward (ROADMAP Queue 3)


def _normal(shape, seed, scale=1.0, shift=0.0):
    return np.random.default_rng(seed).normal(shift, scale, shape).astype(np.float32)


def _cl(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def _nc(x):
    return np.moveaxis(np.asarray(x), -1, 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class _JaxPair(fnn.Module):
    """The JAX fused conv + BatchNorm under the unfused pair's names."""

    features: int
    stride: int
    train: bool

    @fnn.compact
    def __call__(self, x):
        return jax_fused(x, self.features, conv_name="conv", bn_name="bn", train=self.train,
                         strides=(1, self.stride, self.stride),
                         kernel_init=jinit.kaiming_normal)


def _pair(ci, co, stride, seed):
    conv = Conv(ci, co, 1, (1, stride, stride), bias=False)
    conv.reset_parameters(torch.Generator().manual_seed(seed))
    bn = BatchNorm(co)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, co).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.5, co).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, co).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, co).astype(np.float32)))
    return conv, bn


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_pointwise_conv_bn_matches_jax(stride, train):
    """An expanding 1x1 conv (8 -> 32 channels) with its BatchNorm, from the
    same weights, statistics and input: the output, the updated running
    statistics (train) and the gradients of the input, the kernel and the
    BatchNorm's scale and bias under a random cotangent, each within 1e-5 of
    its largest entry (f32 reassociation)."""
    ci, co = 8, 32
    conv, bn = _pair(ci, co, stride, seed=3 + stride)
    bn.train(train)
    x = _normal((2, ci, 3, 8, 8), 4)
    cot = _normal((2, co, 3, 8 // stride, 8 // stride), 5)

    params = {"conv": {"kernel": jnp.asarray(conv.weight.detach().permute(2, 3, 4, 1, 0).numpy())},
              "bn": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                     "bias": jnp.asarray(bn.bias.detach().numpy())}}
    stats = {"bn": {"mean": jnp.asarray(bn.running_mean.numpy().copy()),
                    "var": jnp.asarray(bn.running_var.numpy().copy())}}
    xt = torch.from_numpy(x).requires_grad_()
    out = fused_pointwise_conv_bn(xt, conv, bn, stride)
    leaves = [xt, conv.weight, bn.weight, bn.bias]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    jm = _JaxPair(co, stride, train)

    def loss(p, xx):
        y, upd = jm.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return (y * jnp.asarray(_cl(cot))).sum(), (y, upd)

    (_, (want, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(_cl(x)))
    assert out.shape == (2, co, 3, 8 // stride, 8 // stride)
    assert _rel(out.detach().numpy(), _nc(want)) <= F32_REL
    if train:
        assert _rel(bn.running_mean.numpy(), upd["batch_stats"]["bn"]["mean"]) <= F32_REL
        assert _rel(bn.running_var.numpy(), upd["batch_stats"]["bn"]["var"]) <= F32_REL
    want_g = [_nc(gx), np.asarray(gp["conv"]["kernel"]).transpose(4, 3, 0, 1, 2),
              gp["bn"]["scale"], gp["bn"]["bias"]]
    for name, g, w in zip(("x", "kernel", "scale", "bias"), grads, want_g):
        assert _rel(g.numpy(), w) <= F32_REL, name


def test_bf16_statistics_come_from_the_bf16_input_in_f32():
    """In bf16 the batch statistics are those of the f32 products of the
    bf16 input and the f32 weight (the JAX package's ``preferred_element_
    type`` accumulation): the running mean and variance after one update
    within 1e-6 of float64's from the same bf16 input, where the statistics
    of the bf16-rounded conv output are further off."""
    ci, co = 16, 64
    conv, bn = _pair(ci, co, 1, seed=7)
    before_mean, before_var = bn.running_mean.clone(), bn.running_var.clone()
    bn.train()
    x = torch.from_numpy(_normal((2, ci, 3, 8, 8), 8, scale=2.0, shift=0.5)).bfloat16()
    with torch.no_grad():
        fused_pointwise_conv_bn(x, conv, bn)
        y64 = torch.nn.functional.conv3d(x.double(), conv.weight.double())
        y16 = torch.nn.functional.conv3d(x, conv.weight.bfloat16()).double()

    def updated(y):
        n = y.numel() // co
        mean = y.mean((0, 2, 3, 4))
        var = (y * y).mean((0, 2, 3, 4)) - mean * mean
        return (0.9 * before_mean.double() + 0.1 * mean,
                0.9 * before_var.double() + 0.1 * var * n / (n - 1))

    want_mean, want_var = updated(y64)
    rounded_mean, rounded_var = updated(y16)
    assert _rel(bn.running_mean, want_mean) <= STATS_REL
    assert _rel(bn.running_var, want_var) <= STATS_REL
    assert _rel(rounded_var, want_var) > 10 * _rel(bn.running_var, want_var)


def _block(fuse, width=8, cin=8):
    block = Bottleneck3D(cin, width, 1, True, fuse_expand_bn=fuse)
    g = torch.Generator().manual_seed(11)
    for m in block.modules():
        if m is not block and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return block.train()


def test_bottleneck_step_matches_jax_and_keeps_its_keys():
    """``Bottleneck3D(fuse_expand_bn=True)`` at width 8 from 8 channels
    (``conv3`` and the 4x ``downsample`` both fused) in training mode
    against JAX's with the flag, from the same weights: the output, the
    four updated BatchNorm statistics and every parameter's and the input's
    gradient under a random cotangent, each within 1e-5 of its largest
    entry. Its ``state_dict`` keys, and its values before the step, are the
    unfused block's."""
    from corrifnet_tpu.models.resnet3d import Bottleneck3D as JaxBottleneck

    fused, plain = _block(True), _block(False)
    assert list(fused.state_dict()) == list(plain.state_dict())
    assert all(torch.equal(v, plain.state_dict()[k]) for k, v in fused.state_dict().items())
    sd = {f"b.{k}": v.clone() for k, v in fused.state_dict().items()}  # not aliased
    params, stats = _bottleneck(sd, "b", True)

    x = _normal((2, 8, 3, 8, 8), 12)
    cot = _normal((2, 32, 3, 8, 8), 13)
    xt = torch.from_numpy(x).requires_grad_()
    out = fused(xt)
    names = [n for n, _ in fused.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [xt, *fused.parameters()])

    jm = JaxBottleneck(width=8, stride=1, has_downsample=True, fuse_expand_bn=True)

    def loss(p, xx):
        y, upd = jm.apply({"params": p, "batch_stats": stats}, xx, True,
                          mutable=["batch_stats"])
        return (y * jnp.asarray(_cl(cot))).sum(), (y, upd)

    (_, (want, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(_cl(x)))
    assert _rel(out.detach().numpy(), _nc(want)) <= F32_REL
    after = {f"b.{k}": v for k, v in fused.state_dict().items()}
    _, got_stats = _bottleneck(after, "b", True)
    for bn_name, s in upd["batch_stats"].items():
        for k in ("mean", "var"):
            assert _rel(got_stats[bn_name][k], s[k]) <= F32_REL, (bn_name, k)
    assert _rel(grads[0].numpy(), _nc(gx)) <= F32_REL
    for name, g in zip(names, grads[1:]):
        module, leaf = name.rsplit(".", 1)
        key = {"downsample.0": "down_conv", "downsample.1": "down_bn"}.get(module, module)
        jleaf = {"weight": "kernel" if "conv" in key else "scale"}.get(leaf, leaf)
        w = np.asarray(gp[key][jleaf])
        w = w.transpose(4, 3, 0, 1, 2) if w.ndim == 5 else w
        assert _rel(g.numpy(), w) <= F32_REL, name


# ---------------------------------------------------------------- the model


def _port_f64(model, x, monkeypatch):
    """The training-mode forward of ``model`` in float64 (every ``.float()``
    a ``.double()``) and its BatchNorm buffers after it."""
    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.double())
        model.double().compute_dtype = torch.float64
        with torch.no_grad():
            out = model.train()(torch.from_numpy(x).double()).numpy()
    return out, {k: v.numpy() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}


def test_mmvit4_pruned_and_fused_bn_matches_jax(monkeypatch):
    """MMVit4 at B=1 (64x64) in f32 with ``depth_mode='pruned'`` and
    ``fuse_expand_bn=True``, no dropout. Weights: a seeded port model with
    BatchNorm statistics calibrated on the input (``testing.
    calibrate_batchnorm``, on the unfused model, whose BatchNorms it hooks),
    taken to JAX variables by ``torch_import`` and brought back by
    ``mmvit4_state_dict_from_variables``, loaded strictly into the flagged
    model. The evaluation-mode forward (the folded running statistics)
    within 5e-5 of JAX's with the same flags (the whole-model bound). In
    training mode (batch statistics, the expanding convs' from the
    input-side Gram) the model in float64 against the same weights without
    ``fuse_expand_bn``: the output and every running statistic the forward
    updated within 1e-9 of its largest entry, the same function (in f32
    either package's training-mode forward at B=1 drifts 1-3e-3 from
    float64, with or without the flag)."""
    from corrifnet_tpu.models.mmvit4 import MMVit4 as JaxMMVit4
    from corrifnet_tpu.models.torch_import import mmvit4_variables_from_state_dict
    from corrifnet_tpu_torch.testing import calibrate_batchnorm

    flags = {"depth_mode": "pruned", "fuse_expand_bn": True}
    x = _normal((1, 3, 3, 64, 64), 14)
    base = create_model("MMVit4", seed=0, transformer_dropout=0.0, depth_mode="pruned")
    rng = np.random.default_rng(15)
    with torch.no_grad():
        for name, p in base.named_parameters():
            if name.endswith("_pos"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
        calibrate_batchnorm(base, torch.from_numpy(x))
    variables = mmvit4_variables_from_state_dict(base.state_dict(), pack_stage1=True)
    model = create_model("MMVit4", transformer_dropout=0.0, **flags)
    model.load_state_dict(mmvit4_state_dict_from_variables(variables), strict=True)
    assert model.decoder_fuse.pruned and model.RGB_encoder.e2[0].fuse_expand_bn

    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jm = JaxMMVit4(dtype=jnp.float32, transformer_dropout=0.0, **flags)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False))(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        jnp.asarray(x)))
    assert got.shape == want.shape == (1, 3, 1, 224, 224)
    assert np.abs(got - want).max() <= MODEL_ATOL

    out, stats = _port_f64(model, x, monkeypatch)
    out0, stats0 = _port_f64(base, x, monkeypatch)
    assert _rel(out, out0) <= 1e-9
    assert sorted(stats) == sorted(stats0)
    worst = max((_rel(stats[k], stats0[k]), k) for k in stats0)
    assert worst[0] <= 1e-9, worst
