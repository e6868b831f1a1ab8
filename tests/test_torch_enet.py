"""The port's ENet against the JAX package, on the CPU in f32.

ENet is on the 4-D input path: one modality, (B, 3, H, W) with H and W
multiples of 8; output (B, 1, H, W). The model checks are
``tests/torch_zoo_model.py``'s:

* primitives: ``ConvTranspose`` (stride 2, ``output_padding`` 1) against the
  JAX ``ConvTranspose``; ``max_pool_argmax`` on a plane of ties, its values,
  indices and gradient (spread evenly over tied entries, as JAX's is), and
  on random data; ``max_unpool`` with indices that repeat (the last writer
  in row-major pooled order wins; every writer gets its gradient) against
  the JAX ``max_unpool``; the down- and up-sampling bottlenecks in train
  mode;
* the shared activation: one PReLU slope per encoder bottleneck, one
  parameter for the optimizer and a ``state_dict`` entry under each of the
  reference's keys;
* the whole forward at B=1 in eval mode, 64x64 and 224x224, on the
  BatchNorm statistics as built (the output spreads over 0.45 to 0.55);
* one training step at B=2 and at B=1, 64x64, every bottleneck's Dropout2d
  given the same (sample, channel) masks on both sides (27 sites);
* the ``state_dict`` both ways, bit for bit, 355,398 parameters; ``notr``
  re-initializes the JAX package's 89 kernels, the two transposed ones
  among them, as the JAX package does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import enet as jen
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu.nn import ConvTranspose as JConvTranspose
from corrifnet_tpu.nn import max_pool_argmax as jax_max_pool_argmax
from corrifnet_tpu.nn import max_unpool as jax_max_unpool
from corrifnet_tpu_torch.models import create_model, enet_state_dict_from_variables
from corrifnet_tpu_torch.models import enet as pen
from corrifnet_tpu_torch.nn import ConvTranspose, PReLU, max_pool_argmax, max_unpool
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_model import (
    F32,
    Zoo,
    check_notr,
    check_round_trip,
    check_train_step,
    check_whole_model,
    nchw,
    nhwc,
)
from torch_zoo_step import CallOrderMasks, SCHEMES

ENET = Zoo("ENet", lambda dt: jen.ENet(dtype=dt), ti.enet_variables_from_state_dict,
           enet_state_dict_from_variables, calibrate=False)
ENET_PARAMS = 355_398  # the JAX init tree's (jax.eval_shape)
NOTR_KERNELS = 89  # the JAX tree's 4-axis kernels, the two transposed ones included
PRIMITIVE_ATOL = 2e-5


def _reset(module, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters(gen)
    return module


# ------------------------------------------------------------------ primitives


@pytest.mark.parametrize("k,s,p,op,bias", [(3, 2, 1, 1, False), (3, 2, 1, 1, True),
                                           (2, 2, 0, 0, True)])
def test_conv_transpose_matches_jax(k, s, p, op, bias):
    """``ConvTranspose`` ((in, out, k, k) weight) against the JAX
    ``ConvTranspose`` with the kernel ``torch_import`` converts: ENet's
    3x3 stride-2 with ``output_padding`` 1 doubles the size."""
    conv = ConvTranspose(6, 4, k, s, p, op, bias=bias)
    conv.reset_parameters(torch.Generator().manual_seed(k + op))
    x = torch.randn((2, 6, 7, 5), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = conv(x).numpy()
    params = ti._convtranspose2d({f"c.{n}": v for n, v in conv.state_dict().items()}, "c")
    want = nchw(JConvTranspose(4, k, strides=s, padding=p, output_padding=op,
                               use_bias=bias, dtype=F32).apply({"params": params}, nhwc(x)))
    assert got.shape == want.shape == (2, 4, (7 - 1) * s - 2 * p + k + op,
                                       (5 - 1) * s - 2 * p + k + op)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRIMITIVE_ATOL)


def _pool_pair(x, g, k=3, s=2, p=1):
    """(port values, indices, input gradient) and JAX's, of the pool of x
    under the loss sum(values * g)."""
    leaf = x.clone().requires_grad_()
    vals, idx = max_pool_argmax(leaf, k, s, p)
    (dx,) = torch.autograd.grad((vals * g).sum(), [leaf])

    def f(xx):
        v, i = jax_max_pool_argmax(xx, k, s, p)
        return (v * nhwc(g)).sum(), (v, i)

    (_, (jv, ji)), jdx = jax.value_and_grad(f, has_aux=True)(nhwc(x))
    return (vals.detach().numpy(), idx.numpy(), dx.numpy()), (nchw(jv), nchw(ji), nchw(jdx))


def test_max_pool_argmax_spreads_ties_as_jax():
    """A 4x4 plane of zeros, k=3, s=2, p=1: every window is a tie. The
    indices are the first zero of each window in window order, as JAX's
    argmax; the gradient is spread evenly over each window's tied entries
    (JAX's ``jnp.max``) and not given to one of them (``max_pool``'s rule, PyTorch's
    ``max_pool2d`` and the JAX ``max_pool``)."""
    x = torch.zeros((1, 1, 4, 4))
    (vals, idx, dx), (jv, ji, jdx) = _pool_pair(x, torch.ones((1, 1, 2, 2)))
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(idx, ji)
    assert idx.tolist() == [[[[0, 1], [4, 5]]]]
    np.testing.assert_allclose(dx, jdx, rtol=1e-6, atol=1e-7)
    # window (i, j) holds rows (and columns) {0, 1} for i = 0, {1, 2, 3} for
    # i = 1: 4, 6, 6 and 9 tied entries, each given 1 / count
    share = {(0, 0): 1 / 4, (0, 1): 1 / 6, (1, 0): 1 / 6, (1, 1): 1 / 9}
    rows = {0: (0,), 1: (0, 1), 2: (1,), 3: (1,)}
    want = [[sum(share[i, j] for i in rows[r] for j in rows[c]) for c in range(4)]
            for r in range(4)]
    np.testing.assert_allclose(dx[0, 0], want, rtol=1e-6)
    np.testing.assert_allclose(dx.sum(), 4.0, rtol=1e-6)
    assert (dx > 0).sum() == 16


@pytest.mark.parametrize("seed", [0, 1])
def test_max_pool_argmax_matches_jax(seed):
    """Random data (and at seed 1 a map of rounded values, with ties): the
    values, indices and gradient against JAX's, with a random gradient."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 3, 9, 8), generator=gen)
    if seed:
        x = torch.round(x)
    (vals, idx, dx), (jv, ji, jdx) = _pool_pair(x, torch.randn((2, 3, 5, 4), generator=gen))
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(dx, jdx, rtol=1e-6, atol=1e-6)


def test_max_unpool_keeps_jaxs_last_writer_and_feeds_every_writer():
    """Four pooled entries of each plane point at one place: the fourth
    writer's value lands there, as the JAX package's scatter gives on the
    CPU; the other places hold their own writers or 0. The gradient of
    every writer is the output's gradient at its index, as the JAX custom
    VJP (and the reference's MaxUnpool2d) gives: the four duplicates each
    get the gradient of the place they share."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 3, 3, 3), generator=gen)
    idx = torch.randint(0, 36, (2, 3, 3, 3), generator=gen)
    idx[:, :, 0, 0] = idx[:, :, 1, 1] = idx[:, :, 2, 0] = idx[:, :, 2, 2] = 7
    g = torch.randn((2, 3, 6, 6), generator=gen)
    leaf = x.clone().requires_grad_()
    out = max_unpool(leaf, idx, (6, 6))
    (dx,) = torch.autograd.grad((out * g).sum(), [leaf])

    def f(xx):
        o = jax_max_unpool(xx, nhwc(idx).astype(jnp.int32), (6, 6))
        return (o * nhwc(g)).sum(), o

    (_, jo), jdx = jax.value_and_grad(f, has_aux=True)(nhwc(x))
    np.testing.assert_array_equal(out.detach().numpy(), nchw(jo))
    np.testing.assert_array_equal(out.detach().numpy()[:, :, 1, 1], x.numpy()[:, :, 2, 2])
    np.testing.assert_array_equal(dx.numpy(), nchw(jdx))
    for i, j in ((0, 0), (1, 1), (2, 0), (2, 2)):
        np.testing.assert_array_equal(dx.numpy()[:, :, i, j], g.numpy()[:, :, 1, 1])


def test_bottlenecks_match_jax_in_train_mode():
    """The down-sampling bottleneck (pool indices and output) and then the
    up-sampling one at its indices, in train mode with dropout off, against
    the JAX modules with the parameters ``torch_import`` reads."""
    down = _reset(pen.DownsamplingBottleneck(16, 64, padding=1, relu=False), 1)
    up = _reset(pen.UpsamplingBottleneck(64, 16, padding=1, relu=True), 2)
    x = torch.randn((2, 16, 12, 12), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        y, idx = down.train()(x)
        z = up.train()(y, idx, (12, 12))
    sd = {f"d.{k}": v for k, v in down.state_dict().items()}
    sd.update({f"u.{k}": v for k, v in up.state_dict().items()})
    jd = jen.DownsamplingBottleneck(64, padding=1, relu=False, dtype=F32)
    ju = jen.UpsamplingBottleneck(16, padding=1, relu=True, dtype=F32)
    dp, ds = _enet_block(sd, "d", down=True)
    up_p, up_s = _enet_block(sd, "u", down=False)
    (jy, jidx), _ = jd.apply({"params": dp, "batch_stats": ds}, nhwc(x), True,
                             mutable=["batch_stats"])
    jz, _ = ju.apply({"params": up_p, "batch_stats": up_s}, jy, jidx, (12, 12), True,
                     mutable=["batch_stats"])
    np.testing.assert_array_equal(idx.numpy(), nchw(jidx))
    np.testing.assert_allclose(y.numpy(), nchw(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), nchw(jz), rtol=0, atol=1e-5)


def _enet_block(sd, key, down):
    """The JAX params and stats of a port bottleneck's state_dict under
    ``key``, read as ``torch_import`` reads the reference's."""
    params, stats = {}, {}
    for i in (1, 2, 3):
        if i == 2 and not down:
            params["c2"] = ti._convtranspose2d(sd, f"{key}.ext_conv2.0")
        else:
            params[f"c{i}"] = ti._conv2d(sd, f"{key}.ext_conv{i}.0")
        params[f"bn{i}"], stats[f"bn{i}"] = ti._bn(sd, f"{key}.ext_conv{i}.1")
    if not down:
        params["main_c1"] = ti._conv2d(sd, f"{key}.main_conv1.0")
        params["main_bn"], stats["main_bn"] = ti._bn(sd, f"{key}.main_conv1.1")
    if f"{key}.out_prelu.weight" in sd:
        params["act"] = ti._prelu(sd, f"{key}.out_prelu")
    return params, stats


def test_one_prelu_slope_per_encoder_bottleneck():
    """An encoder bottleneck's activation is one PReLU module: one parameter
    under ``named_parameters`` (``ext_conv1.2.weight``) and in the
    optimizer's view, and a ``state_dict`` entry under each of the
    reference's keys (``ext_conv{1,2,3}.2``, ``ext_conv2.5`` in an
    asymmetric one, ``out_prelu``), all one tensor; the decoder's are
    ReLUs, with none. The initial block has its own."""
    model = create_model("ENet")
    sd = model.state_dict()
    names = dict(model.named_parameters())
    prelus = [n for n in names if n.endswith(".2.weight") or n.endswith("out_prelu.weight")]
    assert len(prelus) == 1 + 2 + 4 + 16 == sum(isinstance(m, PReLU) for m in model.modules())
    asym = model.asymmetric2_3
    assert asym.ext_conv1[2] is asym.ext_conv2[2] is asym.ext_conv2[5] is asym.out_prelu
    for place in ("ext_conv1.2", "ext_conv2.2", "ext_conv2.5", "ext_conv3.2", "out_prelu"):
        assert sd[f"asymmetric2_3.{place}.weight"].data_ptr() == asym.out_prelu.weight.data_ptr()
    assert "asymmetric2_3.ext_conv1.2.weight" in names
    assert "asymmetric2_3.out_prelu.weight" not in names
    assert not any(k.startswith(("upsample", "regular4", "regular5")) and "prelu" in k
                   for k in sd)
    assert "initial_block.out_prelu.weight" in names


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("hw", [64, 224])
def test_whole_model_matches_jax(hw):
    """B=1, f32, eval mode, identity BatchNorm statistics: the probabilities
    within 5e-5, or twice the port's own change under a 1e-6 change of the
    input."""
    check_whole_model(ENET, hw)


@pytest.mark.parametrize("b", [2, 1])
def test_train_step_with_injected_dropout_matches_jax(b, monkeypatch):
    """One training-mode step at 64x64, f32, BatchNorm on batch statistics,
    every bottleneck's Dropout2d on (stage 1 at 0.01, the others at 0.1)
    with the same (sample, channel) masks on both sides in call order: the
    loss within 1e-5 and the gradients to ``hold_step``'s bounds; no
    gradient is 0 but for rounding."""
    calls = check_train_step(ENET, monkeypatch, seed=5, b=b)
    assert len(calls) == 27
    assert calls[0] == ((b, 1, 1, 64), 0.99) and calls[-1] == ((b, 1, 1, 16), 0.9)
    assert [p for _, p in calls].count(0.99) == 5


def test_dropout2d_drops_whole_channels():
    """A bottleneck's Dropout2d zeroes whole (sample, channel) maps and
    scales the rest by 1 / (1 - rate)."""
    block = _reset(pen.RegularBottleneck(16, padding=1, dropout_prob=0.5), 0).train()
    table = CallOrderMasks(3)
    block.ext_regul.rng = table
    x = torch.randn((2, 16, 6, 6), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ext = block.ext_regul(torch.ones_like(x))
    assert table.calls == [((2, 16, 1, 1), 0.5)]
    per_map = ext.flatten(2)
    assert ((per_map == 0).all(-1) | (per_map == 2).all(-1)).all()
    assert 0 < (per_map == 0).all(-1).sum() < 32


def test_state_dict_round_trip_is_exact():
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit, under the
    reference's keys, the shared slopes under each of them."""
    sd = check_round_trip(ENET, ENET_PARAMS)
    for key in ("initial_block.main_branch.weight", "initial_block.out_prelu.weight",
                "downsample1_0.ext_conv1.0.weight", "downsample2_0.out_prelu.weight",
                "asymmetric3_6.ext_conv2.3.weight", "asymmetric3_6.ext_conv2.5.weight",
                "dilated2_8.ext_conv2.1.running_var", "upsample4_0.main_conv1.1.bias",
                "upsample5_0.ext_conv2.0.weight", "regular5_1.ext_conv3.0.weight",
                "transposed_conv.weight"):
        assert key in sd, key
    assert sd["upsample4_0.ext_conv2.0.weight"].shape == (32, 32, 3, 3)
    assert sd["transposed_conv.weight"].shape == (16, 1, 3, 3)
    assert not any(k.startswith("project_layer") for k in sd)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_notr_reinitializes_what_jax_does(scheme):
    """The 89 kernels of the JAX tree (every conv and both transposed
    convs, which the reference's Conv2d-only dispatch would leave as
    built), the BatchNorms and PReLU slopes as built."""
    names = check_notr(ENET, scheme, NOTR_KERNELS)
    assert {"upsample4_0.ext_conv2.0.weight", "upsample5_0.ext_conv2.0.weight",
            "transposed_conv.weight"} <= set(names)
