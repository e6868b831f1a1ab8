"""The port's DeepLabv3_plus against the JAX package, on the CPU in f32.

The JAX side gets the port's weights through
``corrifnet_tpu.models.torch_import.deeplab_variables_from_state_dict``;
its abstract shapes come from ``jax.eval_shape``. DeepLabv3_plus is on the
4-D input path: one modality, (B, 3, H, W), H and W multiples of 16 (the
head concatenates the stride-16 map resized x4 with the stride-4 low-level
map); output (B, 1, H, W).

* Primitives: the dilated conv (``Conv(dilation)``), the separable conv
  with TF's fixed padding at stride 2 and rate 2, Xception blocks of each
  kind (the in-place ReLU quirk on the skip, identity and conv skips,
  grow last, bare trailing convs) in train mode, and their ``rep.{pos}``
  key layout;
* the whole forward at B=1 in eval mode, 64x64 and 224x224 (the entry
  points' width), the BatchNorms calibrated to O(1) activations
  (``testing.calibrate_batchnorm``: with identity statistics the sigmoid
  saturates and the comparison would be empty);
* one training step at B=2, 64x64, BatchNorm on batch statistics, the four
  dropout sites on at 0.5 with the same masks on both sides in call order:
  the loss within 1e-5, the gradients to ``torch_zoo_step.hold_step``'s
  bounds, the gradients that a BatchNorm makes 0 but for rounding
  (``testing.zero_gradients``) held by size, on both sides; at B=1 the
  image pool's weight joins them;
* the ``state_dict`` both ways through the JAX converter, bit for bit;
  ``notr`` re-initializes the JAX package's 142 kernels; each initializer
  draws with its deviation.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corrifnet_tpu.models import deeplabv3p as jd
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu.nn import Conv as JConv
from corrifnet_tpu_torch.models import (
    create_model,
    deeplab_named_gradients,
    deeplab_state_dict_from_variables,
)
from corrifnet_tpu_torch.models import deeplabv3p as pd
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.nn import BatchNorm, Conv
from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
from corrifnet_tpu_torch.testing import calibrate_batchnorm, zero_gradients
from corrifnet_tpu_torch.train import masked_loss_and_jaccard
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_step import (
    SCHEMES,
    ZERO_NOISE,
    CallOrderMasks,
    hold_scheme_std,
    hold_step,
    jax_reinitialized,
)

F32 = jnp.float32
DEEPLAB_PARAMS = 58_803_409  # the JAX init tree's (jax.eval_shape)
JAX_PARAM_LEAVES = 298
JAX_STATS_LEAVES = 146
BATCHNORM_STATISTICS = 96_224
NOTR_KERNELS = 142  # the JAX tree's 4-axis kernels: every conv
MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
PRIMITIVE_ATOL = 2e-5


def _jax_model():
    return jd.DeepLabV3Plus(dtype=F32)


@pytest.fixture(scope="module")
def jax_shapes():
    return jax.eval_shape(lambda: _jax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64), F32)))


def _nhwc(t):
    return jnp.asarray(np.moveaxis(np.asarray(t), 1, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _reset(module, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters(gen)
    return module


# ------------------------------------------------------------------ primitives


@pytest.mark.parametrize("rate", [2, 6, 18])
def test_dilated_conv_matches_jax(rate):
    """``Conv(dilation=rate)`` against JAX's ``Conv(dilation=rate)``: the
    ASPP's 3x3 with padding = rate on a 4x4 map (at rate 6 and 18 every
    tap but the centre on padding)."""
    gen = torch.Generator().manual_seed(rate)
    conv = Conv(16, 8, 3, 1, rate, dims=2, kernel_init="torch_default", dilation=rate)
    conv.reset_parameters(gen)
    x = torch.randn((2, 16, 4, 4), generator=gen)
    with torch.no_grad():
        got = conv(x).numpy()
    params = ti._conv2d({f"c.{k}": v for k, v in conv.state_dict().items()}, "c")
    want = _nchw(JConv(8, 3, padding=rate, dilation=rate, dtype=F32).apply(
        {"params": params}, _nhwc(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=PRIMITIVE_ATOL)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_separable_conv_matches_jax(stride, dilation):
    """Depthwise 3x3 with TF's fixed padding (JAX pads explicitly, the port
    with the conv's own symmetric padding), then the 1x1, bias-free, on an
    odd-sized map."""
    sep = _reset(pd.SeparableConvSame(24, 40, stride, dilation), stride + 3 * dilation)
    x = torch.randn((2, 24, 11, 9), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = sep(x).numpy()
    params = ti._sepconv_same({f"s.{k}": v for k, v in sep.state_dict().items()}, "s")
    want = _nchw(jd.SeparableConvSame(40, stride, dilation, dtype=F32).apply(
        {"params": params}, _nhwc(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PRIMITIVE_ATOL)


# (cin, planes, reps, stride, start_with_relu, grow_first, is_last): block1,
# block3, a middle block, block20
BLOCKS = [(64, 128, 2, 2, False, True, False), (256, 728, 2, 2, True, True, True),
          (728, 728, 3, 1, True, True, False), (728, 1024, 2, 1, True, False, True)]


@pytest.mark.parametrize("cin,planes,reps,stride,swr,grow,last", BLOCKS)
def test_xblock_matches_jax_in_train_mode(cin, planes, reps, stride, swr, grow, last):
    """An Xception block in train mode (batch statistics; output and running
    statistics), converted by JAX's ``_xblock`` from the ``rep.{pos}``
    layout. The skip reads ``relu(inp)`` where the rep starts with a ReLU
    (the in-place quirk), so such a block gives x and relu(x) the same
    output, bit for bit; block1 (no leading ReLU) does not."""
    block = _reset(pd.XBlock(cin, planes, reps, stride, swr, grow, last), reps + stride)
    x = torch.randn((2, cin, 8, 8), generator=torch.Generator().manual_seed(cin))
    sd = {f"b.{k}": v.clone() for k, v in block.state_dict().items()}
    params, stats = ti._xblock(sd, "b", reps, stride, swr, grow, last)
    with torch.no_grad():
        got = block.train()(x).numpy()
        relu_fed = _reset(pd.XBlock(cin, planes, reps, stride, swr, grow, last),
                          reps + stride).train()(torch.relu(x)).numpy()
    assert np.array_equal(got, relu_fed) == swr
    assert len(params) == sum(k != "relu" for k in block.kinds) + 2 * (block.skip is not None)
    want, new = jd.XBlock(planes, reps, stride, start_with_relu=swr, grow_first=grow,
                          is_last=last, dtype=F32).apply(
        {"params": params, "batch_stats": stats}, _nhwc(x), True, mutable=["batch_stats"])
    np.testing.assert_allclose(got, _nchw(want), rtol=0, atol=1e-4 * np.abs(want).max())
    back = ti._xblock({f"b.{k}": v for k, v in block.state_dict().items()}, "b", reps,
                      stride, swr, grow, last)[1]
    for name, tree in new["batch_stats"].items():
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(back[name][leaf], tree[leaf], rtol=1e-5, atol=1e-6)


def test_rep_layout_matches_the_reference_indexing():
    """``rep_layout`` gives the positions JAX's converter computes: block1
    (no leading ReLU) sep at 0, 3 and a bare one at 5; a middle block at 1,
    4, 7; block20 (grow last, is_last) at 1, 4 and the bare one at 6."""
    seps = {name: [i for i, k in enumerate(pd.rep_layout(*spec[1:])) if k == "sep"]
            for name, spec in pd.XCEPTION_BLOCKS.items()}
    assert seps["block1"] == [0, 3, 5]
    assert seps["block2"] == [1, 4, 6]
    assert seps["block3"] == [1, 4, 6]
    assert seps["block4"] == [1, 4, 7]
    assert seps["block20"] == [1, 4, 6]


# ------------------------------------------------------------------ the model


def _inputs(seed, b=1, hw=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, 3, hw, hw)).astype(np.float32)
    masks = (rng.random((b, 1, hw, hw)) > 0.7).astype(np.float32)
    return x, masks, np.ones(b, np.float32)


@pytest.mark.parametrize("hw", [64, 224])
def test_whole_model_matches_jax(hw):
    """B=1, f32, eval mode, BatchNorms calibrated on the input: the
    probabilities within MODEL_ATOL, or twice the port's own change under a
    1e-6 change of the input, and not saturated. Measured: 3.6e-7 at 64x64."""
    model = create_model("DeepLabv3_plus", seed=0)
    x, _, _ = _inputs(11, hw=hw)
    calibrate_batchnorm(model, torch.from_numpy(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        witness = np.abs(model(torch.from_numpy(x * np.float32(1 + 1e-6))).numpy()
                         - got).max()
    want = np.asarray(jax.jit(lambda v, xx: _jax_model().apply(v, xx, False))(
        ti.deeplab_variables_from_state_dict(model.state_dict()), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 1, hw, hw) and np.isfinite(got).all()
    assert 0.05 < got.min() and got.max() < 0.95
    err = np.abs(got - want).max()
    print(f"DeepLabv3_plus {hw}x{hw} forward against JAX:", err, "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)


def _step(model, masks, valid, seed):
    def port_step(xx):
        model.set_dropout_rng(CallOrderMasks(seed, channels_last=True))
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(torch.from_numpy(xx)).float()
        loss, _, _ = masked_loss_and_jaccard(out, torch.from_numpy(masks).to(out.dtype),
                                             torch.from_numpy(valid).to(out.dtype))
        loss.backward()
        return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                             if p.grad is not None}

    return port_step


def _jax_step(model, x, masks, valid, seed, monkeypatch):
    """JAX's loss and gradients (as port names) of the step, the dropout
    masks answered from ``CallOrderMasks(seed)``, and the table."""
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard

    variables = ti.deeplab_variables_from_state_dict(model.state_dict())
    jm = _jax_model()

    def loss_fn(params, stats, xx):
        out, _ = jm.apply({"params": params, "batch_stats": stats}, xx, True,
                          rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return _masked_loss_and_jaccard(out.astype(F32), jnp.asarray(masks),
                                        jnp.asarray(valid))[0]

    table = CallOrderMasks(seed, channels_last=True)
    with monkeypatch.context() as patch:
        patch.setattr(jax.random, "bernoulli", table.bernoulli)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"], variables["batch_stats"], jnp.asarray(x))
    return float(loss), {k: v.numpy() for k, v in deeplab_named_gradients(
        jax.tree.map(np.asarray, grads)).items()}, table


def test_train_step_with_injected_dropout_matches_jax(monkeypatch):
    """One training-mode step at B=2, 64x64, f32, BatchNorm on batch
    statistics, the four dropout sites on at 0.5 with the same masks in
    call order on both sides (fc1, reduce, last0, last1; drawn in JAX's
    channels-last layout): the same mask shapes, the loss within 1e-5 and
    the gradients to ``hold_step``'s bounds. ``testing.zero_gradients`` at
    B=2 names 13 tensors, held by size on both sides: the conv biases that
    feed a BatchNorm (ASPP's four, ``fc1.0``, ``reduce_conv2.0``,
    ``last_conv.0`` and ``.4``), the ASPP BatchNorms' biases and
    ``image_pool.1.bias``, whose constants fc1's BatchNorm takes out; no
    other tensor of JAX's gradient is that small."""
    model = create_model("DeepLabv3_plus", seed=2)
    x, masks, valid = _inputs(131, b=2)
    loss_j, want, table_j = _jax_step(model, x, masks, valid, 5, monkeypatch)
    port_step = _step(model, masks, valid, 5)
    loss, got = port_step(x)
    assert model.rng.calls == table_j.calls
    assert [s for s, _ in table_j.calls] == [(2, 4, 4, 256), (2, 16, 16, 48),
                                             (2, 16, 16, 256), (2, 16, 16, 256)]
    assert all(p == 0.5 for _, p in table_j.calls)
    _, moved = port_step(x * np.float32(1 + 1e-6))
    assert sorted(got) == sorted(want) == sorted(n for n, _ in model.named_parameters())
    assert abs(loss - float(loss_j)) <= 1e-5, (loss, float(loss_j))
    zero = zero_gradients(model, batch=2)
    assert sorted(zero) == sorted(
        [f"aspp{i}.{m}.bias" for i in range(1, 5) for m in ("atrous_convolution", "batch_norm")]
        + ["image_pool.1.bias", "fc1.0.bias", "reduce_conv2.0.bias", "last_conv.0.bias",
           "last_conv.4.bias"])
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert {n for n, v in want.items() if float(np.abs(v).max()) <= ZERO_NOISE * scale} == set(zero)
    hold_step("DeepLabv3_plus", model, port_step, x, got, want, moved, monkeypatch, zero)


def test_zero_gradients_at_batch_one_are_jaxs(monkeypatch):
    """At B=1 the pooled branch is one constant per channel, which fc1's
    BatchNorm takes out: ``image_pool.1.weight`` joins the list, and in
    JAX's gradient tree it and every other name of the list are 0 but for
    rounding (2e-4 of the largest entry, the bound ``hold_step`` holds
    them to), as are ``fc1.0.weight``'s pooled columns; no other tensor
    is."""
    model = create_model("DeepLabv3_plus", seed=3)
    x, masks, valid = _inputs(7, b=1)
    _, want, _ = _jax_step(model, x, masks, valid, 6, monkeypatch)
    zero = zero_gradients(model, batch=1)
    assert set(zero) == set(zero_gradients(model, batch=2)) | {"image_pool.1.weight"}
    scale = max(float(np.abs(v).max()) for v in want.values())
    small = {n for n, v in want.items() if float(np.abs(v).max()) <= ZERO_NOISE * scale}
    assert small == set(zero), sorted(small ^ set(zero))
    assert float(np.abs(want["fc1.0.weight"][:, 1024:]).max()) <= ZERO_NOISE * scale
    assert float(np.abs(want["fc1.0.weight"][:, :1024]).max()) > 100 * ZERO_NOISE * scale


def test_state_dict_round_trip_is_exact(jax_shapes):
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit: the port's
    state_dict converts into a tree of exactly the JAX init tree's structure
    (298 parameter and 146 statistics leaves; 58,803,409 parameters and
    96,224 BatchNorm statistics), under the reference's keys, and back."""
    model = create_model("DeepLabv3_plus", seed=1)
    assert sum(p.numel() for p in model.parameters()) == DEEPLAB_PARAMS
    sd = model.state_dict()
    for key in ("xception_features.block1.rep.0.conv1.weight",
                "xception_features.block1.rep.5.pointwise.weight",
                "xception_features.block4.rep.7.conv1.weight",
                "xception_features.block20.rep.6.pointwise.weight",
                "xception_features.block20.skipbn.running_var",
                "aspp4.atrous_convolution.bias", "aspp1.batch_norm.weight",
                "image_pool.1.weight", "fc1.1.running_mean", "reduce_conv2.0.weight",
                "last_conv.5.bias", "last_conv.8.weight"):
        assert key in sd, key
    assert "xception_features.block4.skip.weight" not in sd
    want_shapes = {k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(jax_shapes))).items()}
    variables = ti.deeplab_variables_from_state_dict(sd)
    assert {k: v.shape for k, v in flatten_variables(variables).items()} == want_shapes
    assert sum(k.startswith("params/") for k in want_shapes) == JAX_PARAM_LEAVES
    assert sum(k.startswith("batch_stats/") for k in want_shapes) == JAX_STATS_LEAVES
    assert len(sd) == JAX_PARAM_LEAVES + JAX_STATS_LEAVES
    assert sum(math.prod(s) for k, s in want_shapes.items()
               if k.startswith("params/")) == DEEPLAB_PARAMS
    assert sum(math.prod(s) for k, s in want_shapes.items()
               if k.startswith("batch_stats/")) == BATCHNORM_STATISTICS
    back = deeplab_state_dict_from_variables(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())

    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32),
                        dict(jax_shapes))
    model.load_state_dict(deeplab_state_dict_from_variables(tree), strict=True)
    want, got = flatten_variables(tree), flatten_variables(
        ti.deeplab_variables_from_state_dict(model.state_dict()))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_notr_reinitializes_what_jax_does(scheme, jax_shapes):
    """``apply_reference_init_scheme`` re-initializes exactly the 142
    kernels that the JAX package's does (every conv: the backbone's
    depthwise, pointwise and skip convs and the head's) and zeroes the
    biases beside them, leaves the BatchNorms as built, and draws with the
    scheme's standard deviation."""
    model = create_model("DeepLabv3_plus", seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = apply_reference_init_scheme(model, scheme, torch.Generator().manual_seed(3))
    want = jax_reinitialized(jax_shapes["params"], deeplab_state_dict_from_variables)
    assert len(names) == NOTR_KERNELS and set(names) == {n for n in want
                                                          if n.endswith(".weight")}
    params = dict(model.named_parameters())
    for n in before:
        assert torch.equal(params[n], before[n]) == (n not in want), n
    assert all(not params[n].any() for n in want if n.endswith(".bias"))
    hold_scheme_std(scheme, [params[n] for n in names])


def test_initializers_draw_with_their_deviations():
    """The model's own initializers: the backbone's convs kaiming-normal
    (fan-in; the mean of (w / std)^2 over all of them 1 within five standard
    errors), the head's PyTorch's U(+-1/sqrt(fan_in)) (std = bound /
    sqrt(3)), BatchNorm ones and zeros."""
    model = create_model("DeepLabv3_plus", seed=5)
    sums = {"kaiming_normal": [0.0, 0], "torch_default": [0.0, 0]}
    for module in model.modules():
        if isinstance(module, Conv):
            w = module.weight.detach().double()
            fan = w[0].numel()
            std = math.sqrt(2.0 / fan) if module.kernel_init == "kaiming_normal" else (
                1 / math.sqrt(3 * fan))
            sums[module.kernel_init][0] += float((w / std).square().sum())
            sums[module.kernel_init][1] += w.numel()
        elif isinstance(module, BatchNorm):
            assert bool((module.weight == 1).all()) and not module.bias.any()
    backbone = [n for n, m in model.named_modules() if isinstance(m, Conv)
                and m.kernel_init == "kaiming_normal"]
    assert all(n.startswith("xception_features.") for n in backbone) and len(backbone) == 132
    for kind, var in (("kaiming_normal", 2.0), ("torch_default", 0.8)):
        sq, count = sums[kind]
        assert abs(sq / count - 1) <= 5 * math.sqrt(var / count), (kind, sq / count, count)
