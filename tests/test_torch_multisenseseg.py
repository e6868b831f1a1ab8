"""The port's MultiSenseSeg and its new primitives against the JAX package,
on the CPU in f32.

The JAX side gets the port's weights through
``corrifnet_tpu.models.torch_import.multisenseseg_variables_from_state_dict``;
its abstract shapes come from ``jax.eval_shape`` (never an eager ``init``).

* Primitives: grouped and unpadded depthwise 2-D convs; 2-D max pooling on
  tied windows (forward and gradient, against JAX's ``reduce_window`` and
  PyTorch's op); ``adaptive_max_pool`` (forward and gradient, ties spread);
  BatchNorm on (B, L, C) tokens in train mode (output and running
  statistics); the aligned 2-D linear resize at PPM's, FPN's, the decode
  gate's and UNetV2's scales; the Swin tables, equal as arrays; window
  attention with and without the shift mask; CNNMlp's scramble; AMM;
  PatchMerging on odd sizes; CBAM.
* The whole forward at B=1, 64x64, full width, eval mode (the Swin stages at
  16, 8, 4 -> 8 and 2 -> 8: padding to the window and both shift settings).
* One training step at full width and depth with dropout off and BatchNorm
  on batch statistics (the JAX suite's interceptor); one at
  ``depths=(2, 2, 2, 2)`` with every dropout and DropPath site on, the same
  masks on both sides in call order: the loss within 1e-5 and the gradients
  to ``torch_zoo_step.hold_step``'s bounds.
* The ``state_dict`` both ways through the JAX converter, bit for bit, with
  the leaf and parameter counts; ``notr`` re-initializes exactly what the
  JAX package does; each initializer draws with its standard deviation.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from corrifnet_tpu.models import multisenseseg as jm
from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu.nn import BatchNorm as JBatchNorm
from corrifnet_tpu.nn import Conv as JConv
from corrifnet_tpu.nn import resize as jresize
from corrifnet_tpu_torch.models import (
    create_model,
    multisenseseg_named_gradients,
    multisenseseg_state_dict_from_variables,
)
from corrifnet_tpu_torch.models import multisenseseg as pm
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.nn import BatchNorm, Conv, adaptive_max_pool, max_pool, resize_linear
from corrifnet_tpu_torch.nn.init import apply_reference_init_scheme
from corrifnet_tpu_torch.testing import zero_gradients
from corrifnet_tpu_torch.train import masked_loss_and_jaccard
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)
from torch_zoo_step import (
    SCHEMES,
    CallOrderMasks,
    hold_scheme_std,
    hold_step,
    jax_reinitialized,
)

MSS_PARAMS = 57_838_030  # the JAX init tree's (jax.eval_shape)
JAX_PARAM_LEAVES = 358
JAX_STATS_LEAVES = 96
NOTR_KERNELS = 91  # the JAX tree's 4-axis kernels: every 2-D conv
MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound
REL = 2e-6  # f32 reassociation of a primitive
F32 = jnp.float32


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_vjp(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    return y.detach().numpy(), gx.numpy()


def _jax_vjp(fn, x, g):
    def value_and_vjp(xx, gg):
        y, vjp = jax.vjp(fn, xx)
        return y, vjp(gg)[0]

    y, gx = jax.jit(value_and_vjp)(jnp.asarray(x), jnp.asarray(g))
    return np.asarray(y), np.asarray(gx)


def _nhwc(fn):
    """A JAX function on channels-last arrays as one on NCHW arrays."""
    return lambda t: jnp.moveaxis(fn(jnp.moveaxis(t, 1, -1)), -1, 1)


def _jax_model(depths=(2, 2, 8, 2)):
    return jm.MultiSenseSeg(depths=depths, dtype=F32)


@pytest.fixture(scope="module")
def model_and_variables():
    """The port's full-width model (seed 0) and its JAX variables."""
    model = create_model("MultiSenseSeg", seed=0)
    return model, ti.multisenseseg_variables_from_state_dict(model.state_dict())


@pytest.fixture(scope="module")
def jax_shapes():
    return jax.eval_shape(lambda: _jax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 64, 64), F32)))


# ------------------------------------------------------------------ primitives


@pytest.mark.parametrize("cin,cout,kernel,stride,padding,groups,hw", [
    (96, 96, 1, 1, 0, 3, 16),     # AMM's q, k, v
    (16, 16, 3, 1, 1, 2, 16),     # MSE's conv3_dw
    (96, 96, 3, 1, 0, 96, 8),     # AMM's unpadded depthwise q_proj (8 -> 6)
    (96, 96, 4, 4, 0, 96, 16),    # AMM's v_proj
    (384, 384, 3, 1, 1, 384, 8),  # CNNMlp's depthwise conv
])
def test_grouped_and_depthwise_conv_match_jax(cin, cout, kernel, stride, padding, groups, hw):
    """The port's ``Conv(groups=...)`` against the JAX ``Conv(groups=...)``
    on the same weights: output and the input's gradient."""
    conv = Conv(cin, cout, kernel, stride, padding, dims=2, kernel_init="torch_default",
                groups=groups)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    params = {"kernel": conv.weight.detach().numpy().transpose(2, 3, 1, 0),
              "bias": conv.bias.detach().numpy()}
    x = _normal((2, cin, hw, hw), 1)
    out = (hw + 2 * padding - kernel) // stride + 1
    g = _normal((2, cout, out, out), 2)
    jconv = JConv(cout, kernel, strides=stride, padding=padding, groups=groups, dtype=F32)
    y, gx = _port_vjp(conv, x, g)
    yj, gj = _jax_vjp(_nhwc(lambda t: jconv.apply({"params": params}, t)), x, g)
    assert y.shape == yj.shape == g.shape
    assert _rel(y, yj) <= 1e-5 and _rel(gx, gj) <= 1e-5, (_rel(y, yj), _rel(gx, gj))


@pytest.mark.parametrize("kind", ["ties", "constant", "relu"])
@pytest.mark.parametrize("window", [2, 4, 8])
def test_max_pool_2d_ties_match_jax_and_torch(kind, window):
    """2-D windows full of equal entries (integers 0-2, one constant, or a
    ReLU's zeros, as DecodeGate and UNetV2 pool them): the gradient goes to
    the first largest entry of each window in window order, in the port, in
    JAX's ``reduce_window`` max and in PyTorch's ``max_pool2d``."""
    rng = np.random.default_rng(window)
    shape = (2, 3, 4 * window, 2 * window)
    if kind == "ties":
        x = rng.integers(0, 3, shape).astype(np.float32)
    elif kind == "constant":
        x = np.full(shape, 0.5, np.float32)
    else:
        x = np.maximum(rng.normal(-0.5, 1.0, shape), 0.0).astype(np.float32)
    g = _normal((2, 3, 4, 2), 5)
    w = (window, window)
    y, gx = _port_vjp(lambda t: max_pool(t, w), x, g)
    yj, gj = _jax_vjp(_nhwc(lambda t: jresize.max_pool(t, w, w)), x, g)
    yt, gt = _port_vjp(lambda t: F.max_pool2d(t, w, w), x, g)
    assert np.array_equal(y, yj) and np.array_equal(y, yt)
    assert np.array_equal(gx, gj) and np.array_equal(gx, gt)


@pytest.mark.parametrize("size,out", [(7, 1), (7, 2), (7, 3), (7, 6), (14, 6), (5, 3)])
def test_adaptive_max_pool_matches_jax(size, out):
    """``adaptive_max_pool`` against the JAX package's on ReLU'd integer
    data (many ties): the same values, and the gradient spread evenly over a
    window's tied maxima as ``jnp.max``'s is; the values also equal
    PyTorch's ``adaptive_max_pool2d``."""
    x = np.maximum(np.random.default_rng(size * out).integers(-2, 3, (2, 4, size, size)),
                   0).astype(np.float32)
    g = _normal((2, 4, out, out), 3)
    y, gx = _port_vjp(lambda t: adaptive_max_pool(t, (out, out)), x, g)
    yj, gj = _jax_vjp(_nhwc(lambda t: jresize.adaptive_max_pool(t, (out, out))), x, g)
    assert np.array_equal(y, yj)
    assert np.array_equal(y, F.adaptive_max_pool2d(torch.from_numpy(x), out).numpy())
    assert _rel(gx, gj) <= REL, _rel(gx, gj)


def test_token_batchnorm_in_train_mode_matches_jax():
    """BatchNorm on (B, L, C) tokens, statistics per channel over B and L,
    in train mode: the port's ``BatchNorm`` on the (B, C, L) view (which is
    also what the block hands CNNMlp) against the JAX ``BatchNorm`` on
    (B, L, C): the output and the running statistics."""
    bn = BatchNorm(96)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(_normal((96,), 1)))
        bn.bias.copy_(torch.from_numpy(_normal((96,), 2)))
    bn.train()
    x = _normal((2, 64, 96), 3) * 2.0 + 0.5
    got = bn(torch.from_numpy(x).transpose(1, 2)).detach().numpy()
    params = {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()}
    stats = {"mean": np.zeros(96, np.float32), "var": np.ones(96, np.float32)}
    want, new = JBatchNorm(dtype=F32).apply({"params": params, "batch_stats": stats},
                                            jnp.asarray(x), False, mutable=["batch_stats"])
    assert got.shape == (2, 96, 64)
    assert _rel(got, np.asarray(want).transpose(0, 2, 1)) <= 1e-5
    np.testing.assert_allclose(bn.running_mean.numpy(), new["batch_stats"]["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["batch_stats"]["var"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((1, 1), (7, 7)), ((2, 2), (7, 7)), ((3, 3), (7, 7)),
                                     ((6, 6), (7, 7)), ((7, 7), (14, 14)),
                                     ((16, 16), (64, 64)), ((8, 5), (16, 10))])
def test_aligned_2d_resize_matches_jax(src, dst):
    """``resize_linear(align_corners=True)`` in 2-D at PPM's (1, 2, 3, 6 ->
    7), FPN's x2, the decode gate's x4 and UNetV2's x2 (odd widths too):
    output and gradient against the JAX package's."""
    x = _normal((2, 3, *src), 4)
    g = _normal((2, 3, *dst), 5)
    y, gx = _port_vjp(lambda t: resize_linear(t, dst, align_corners=True), x, g)
    yj, gj = _jax_vjp(_nhwc(lambda t: jresize.resize_linear(t, dst, align_corners=True)),
                      x, g)
    assert _rel(y, yj) <= REL and _rel(gx, gj) <= REL, (_rel(y, yj), _rel(gx, gj))


@pytest.mark.parametrize("hp,wp,window,shift", [(64, 64, 8, 4), (32, 32, 8, 4),
                                                (16, 16, 8, 4), (8, 8, 8, 4), (24, 16, 8, 4)])
def test_swin_tables_equal_jax(hp, wp, window, shift):
    """``_relative_position_index`` and ``_swin_attn_mask`` are the JAX
    module's, equal as arrays (the port keeps its own copy)."""
    assert np.array_equal(pm._relative_position_index(window, window),
                          jm._relative_position_index(window, window))
    assert np.array_equal(pm._swin_attn_mask(hp, wp, window, shift),
                          jm._swin_attn_mask(hp, wp, window, shift))
    assert np.array_equal(pm._amm_relative_bias(96), jm._amm_relative_bias(96))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage", [0, 2])
def test_window_attention_matches_jax(model_and_variables, stage, shifted):
    """One block's window attention (stage 0: 96 wide, 3 heads, q and k 63
    wide; stage 2: 384, 12 heads) on 2 images of 2x2 windows, with the
    shifted windows' mask and without: output and input gradient."""
    model, variables = model_and_variables
    i = int(shifted)
    attn = model.build_pipeline.layers[stage].long_blocks[i].attn
    d, nh = attn.dim, attn.n_heads
    assert attn.qkv_dim == {0: 222, 2: 888}[stage]
    x = _normal((8, 64, d), 6)
    g = _normal((8, 64, d), 7)
    mask = jm._swin_attn_mask(16, 16, 8, 4) if shifted else None
    jattn = jm.WindowAttention(d, (8, 8), nh, True, 1.5, 0.1, 0.1, dtype=F32)
    params = variables["params"]["backbone"][f"stage{stage}_block{i}"]["attn"]
    np.testing.assert_array_equal(params["qkv"]["kernel"], attn.qkv.weight.detach().numpy().T)
    params = jax.tree.map(jnp.asarray, params)  # the table is gathered from under jit
    tmask = None if mask is None else torch.from_numpy(mask)
    attn.eval()
    y, gx = _port_vjp(lambda t: attn(t, tmask), x, g)
    yj, gj = _jax_vjp(lambda t: jattn.apply({"params": params}, t,
                                            None if mask is None else jnp.asarray(mask)), x, g)
    assert _rel(y, yj) <= 1e-5 and _rel(gx, gj) <= 1e-5, (_rel(y, yj), _rel(gx, gj))


def test_cnnmlp_scramble_matches_jax(model_and_variables):
    """CNNMlp of the first block (96 -> 384 in 12 groups, depthwise 3x3,
    exact GELU) in eval mode on a (B, C, L) input read row-major as
    (B, L, C): output and input gradient against JAX's; without the
    scramble (reading (B, C, L) as (B, C, H, W)) the output differs."""
    model, variables = model_and_variables
    mlp = model.build_pipeline.layers[0].long_blocks[0].mlp.eval()
    with torch.no_grad():  # running statistics off their init
        bn = mlp.dw_conv[1]
        bn.running_mean.copy_(torch.from_numpy(_normal((384,), 1) * 0.1))
        bn.running_var.copy_(torch.from_numpy(np.abs(_normal((384,), 2)) + 0.5))
    block = variables["params"]["backbone"]["stage0_block0"]["mlp"]
    stats = {"dw": {"bn": {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}}}
    x = _normal((2, 96, 64), 8)
    g = _normal((2, 64, 96), 9)
    jmlp = jm.CNNMlp(96, 384, 12, 0.1, dtype=F32)
    y, gx = _port_vjp(lambda t: mlp(t, 8, 8), x, g)
    yj, gj = _jax_vjp(lambda t: jmlp.apply({"params": block, "batch_stats": stats}, t, 8, 8,
                                           False), x, g)
    assert _rel(y, yj) <= 1e-5 and _rel(gx, gj) <= 1e-5, (_rel(y, yj), _rel(gx, gj))
    unscrambled = jmlp.apply({"params": block, "batch_stats": stats},
                             jnp.asarray(x.reshape(2, 64, 96).transpose(0, 2, 1)), 8, 8, False)
    assert _rel(y, unscrambled) > 1e-2


def test_amm_matches_jax(model_and_variables):
    """AMM (96 channels of three branches, 4 heads over the flattened
    spatial axis, MaxPool(8) and the unpadded depthwise conv: 64 -> 8 -> 6)
    in eval mode at 64x64: both outputs and the input gradient."""
    model, variables = model_and_variables
    amm = model.build_MSEs_AMM.fuse_proj.eval()
    x = _normal((1, 96, 64, 64), 10)
    g = _normal((1, 96, 16, 16), 11)
    jamm = jm.AMM(96, 96, 3, 8, 4, 4, 0.1, True, dtype=F32)
    y, gx = _port_vjp(lambda t: amm(t)[0], x, g)
    yj, gj = _jax_vjp(lambda t: jamm.apply({"params": variables["params"]["AMM"]}, t,
                                           False)[0], x, g)
    assert y.shape == (1, 96, 16, 16)
    assert _rel(y, yj) <= 1e-5 and _rel(gx, gj) <= 1e-5, (_rel(y, yj), _rel(gx, gj))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        assert amm(xt)[1] is xt


@pytest.mark.parametrize("h,w", [(7, 7), (5, 6), (8, 8)])
def test_patch_merging_matches_jax(model_and_variables, h, w):
    """PatchMerging (96 -> 192) on odd and even sizes: zero padding of an
    odd side, the 2x2 neighbours' order, LayerNorm, the reduction."""
    model, variables = model_and_variables
    merge = model.build_pipeline.layers[0].downsample
    x = _normal((2, h * w, 96), 12)
    g = _normal((2, ((h + 1) // 2) * ((w + 1) // 2), 192), 13)
    jmerge = jm.PatchMerging(192, dtype=F32)
    y, gx = _port_vjp(lambda t: merge(t, h, w), x, g)
    yj, gj = _jax_vjp(lambda t: jmerge.apply(
        {"params": variables["params"]["backbone"]["merge0"]}, t, h, w), x, g)
    assert _rel(y, yj) <= 1e-5 and _rel(gx, gj) <= 1e-5, (_rel(y, yj), _rel(gx, gj))


def test_cbam_matches_jax():
    """CBAMAttention (the JAX module's other channel attention) on the same
    weights: output and input gradient."""
    cbam = pm.CBAMAttention(32, 4)
    for conv in (cbam.conv1, cbam.conv2):
        conv.reset_parameters(torch.Generator().manual_seed(conv.weight.shape[0]))
    params = {name: {"conv": {"kernel": conv.weight.detach().numpy().transpose(2, 3, 1, 0)}}
              for name, conv in (("conv1", cbam.conv1), ("conv2", cbam.conv2))}
    x = _normal((2, 32, 9, 9), 14)
    g = _normal((2, 32, 9, 9), 15)
    y, gx = _port_vjp(cbam, x, g)
    yj, gj = _jax_vjp(lambda t: jm.CBAMAttention(32, 4, dtype=F32).apply({"params": params}, t),
                      x, g)
    assert _rel(y, yj) <= 1e-5 and _rel(gx, gj) <= 1e-5, (_rel(y, yj), _rel(gx, gj))


# ------------------------------------------------------------------ the model


def _inputs(seed, b=1, hw=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, 3, 3, hw, hw)).astype(np.float32)
    masks = (rng.random((b, 3, 1, hw, hw)) > 0.7).astype(np.float32)
    return x, masks, np.ones(b, np.float32)


def test_whole_model_matches_jax(model_and_variables):
    """B=1, 64x64, f32, full width, eval mode: the probabilities within
    MODEL_ATOL, or twice the port's own change under a 1e-6 change of the
    input. Measured: 1.2e-7."""
    model, variables = model_and_variables
    model.eval()
    x, _, _ = _inputs(11)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        witness = np.abs(model(torch.from_numpy(x * np.float32(1 + 1e-6))).numpy()
                         - got).max()
    jmod = _jax_model()
    want = np.asarray(jax.jit(lambda v, xx: jmod.apply(v, xx, False))(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (1, 3, 1, 64, 64) and np.isfinite(got).all()
    assert np.array_equal(got[:, 0], got[:, 2])
    err = np.abs(got - want).max()
    print("MultiSenseSeg forward against JAX:", err, "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)


def _port_step(model, masks, valid, mode):
    """port_step(x) -> (loss, gradients) of one training-mode step:
    ``mode`` 'bn' (everything in eval but BatchNorm, dropout off) or
    'train'."""

    def step(x):
        model.train()
        if mode == "bn":
            model.eval()
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.train()
        model.zero_grad(set_to_none=True)
        out = model(torch.from_numpy(x)).float()
        loss, _, _ = masked_loss_and_jaccard(out, torch.from_numpy(masks).to(out.dtype),
                                             torch.from_numpy(valid).to(out.dtype))
        loss.backward()
        return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                             if p.grad is not None}

    return step


def _jax_loss(jmod, masks, valid):
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard

    def loss_fn(params, stats, xx):
        out, _ = jmod.apply({"params": params, "batch_stats": stats}, xx, True,
                            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return _masked_loss_and_jaccard(out.astype(F32), jnp.asarray(masks),
                                        jnp.asarray(valid))[0]

    return loss_fn


def test_train_step_dropout_off_matches_jax(monkeypatch):
    """One step at full width and depth, B=1, 64x64, f32, dropout and
    DropPath off while every BatchNorm takes batch statistics (JAX: the JAX
    suite's interceptor, ``tests/test_train_dynamics_zoo.py``): the loss
    within 1e-5, the gradients to ``hold_step``'s bounds, and every
    parameter has a gradient on both sides. Thirteen tensors have a
    gradient of 0 but for rounding (measured: at most 6e-8 of the largest
    entry), and are held by size (``testing.zero_gradients``: the seven conv
    biases that feed a BatchNorm, the first three stages' output LayerNorm
    biases, ``smooth``'s BatchNorm bias and, at batch 1, the decode gate's SE
    weights)."""
    from test_train_dynamics_zoo import _dropout_forced_off

    model = create_model("MultiSenseSeg", seed=3)
    x, masks, valid = _inputs(21)
    variables = ti.multisenseseg_variables_from_state_dict(model.state_dict())
    with _dropout_forced_off():
        loss_j, grads_j = jax.jit(jax.value_and_grad(_jax_loss(_jax_model(), masks, valid)))(
            variables["params"], variables["batch_stats"], jnp.asarray(x))
    port_step = _port_step(model, masks, valid, "bn")
    loss, got = port_step(x)
    _, moved = port_step(x * np.float32(1 + 1e-6))
    want = {k: v.numpy() for k, v in multisenseseg_named_gradients(
        jax.tree.map(np.asarray, grads_j)).items()}
    assert sorted(got) == sorted(want) == sorted(n for n, _ in model.named_parameters())
    assert abs(loss - float(loss_j)) <= 1e-5, (loss, float(loss_j))
    zero = zero_gradients(model)
    assert len(zero) == 13
    hold_step("MultiSenseSeg", model, port_step, x, got, want, moved, monkeypatch, zero)


def test_train_step_with_injected_dropout_matches_jax(monkeypatch):
    """One training-mode step at ``depths=(2, 2, 2, 2)`` (each stage still a
    shifted and an unshifted block), B=1, 64x64, f32, with every dropout
    site (pos_drop, AMM's two, each block's attn_drop and proj_drop,
    CNNMlp's three) and DropPath on: the same masks in call order on both
    sides (``jax.random.bernoulli`` answered from the table), the same
    sequence of mask shapes and keep probabilities, the loss within 1e-5 and
    the gradients to ``hold_step``'s bounds."""
    depths = (2, 2, 2, 2)
    x, masks, valid = _inputs(31)
    model = pm.MultiSenseSeg(depths=depths).reset_parameters(torch.Generator().manual_seed(4))
    variables = ti.multisenseseg_variables_from_state_dict(model.state_dict(), depths=depths)
    table_j = CallOrderMasks(9)
    with monkeypatch.context() as patch:
        patch.setattr(jax.random, "bernoulli", table_j.bernoulli)
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            _jax_loss(_jax_model(depths), masks, valid)))(
            variables["params"], variables["batch_stats"], jnp.asarray(x))

    step = _port_step(model, masks, valid, "train")

    def port_step(xx):  # the same masks at every call
        model.set_dropout_rng(CallOrderMasks(9))
        return step(xx)

    table_p = CallOrderMasks(9)
    model.set_dropout_rng(table_p)
    loss, got = step(x)
    # pos_drop, AMM 2, per block 5 and DropPath 2 (1 where its rate is 0)
    assert table_p.calls == table_j.calls and len(table_p.calls) == 3 + 8 * 5 + 2 * 7
    _, moved = port_step(x * np.float32(1 + 1e-6))
    want = {k: v.numpy() for k, v in multisenseseg_named_gradients(
        jax.tree.map(np.asarray, grads_j), depths).items()}
    assert sorted(got) == sorted(want)
    assert abs(loss - float(loss_j)) <= 1e-5, (loss, float(loss_j))
    hold_step("MultiSenseSeg (dropout)", model, port_step, x, got, want, moved, monkeypatch,
              zero_gradients(model))


def test_state_dict_round_trip_is_exact(jax_shapes):
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit: the port's
    state_dict converts into a tree of exactly the JAX init tree's
    structure (358 parameter and 96 statistics leaves; 57,838,030
    parameters in the port's 454 tensors), and back."""
    model = create_model("MultiSenseSeg", seed=1)
    assert sum(p.numel() for p in model.parameters()) == MSS_PARAMS
    sd = model.state_dict()
    want_shapes = {k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(jax_shapes))).items()}
    variables = ti.multisenseseg_variables_from_state_dict(sd)
    got_shapes = {k: v.shape for k, v in flatten_variables(variables).items()}
    assert got_shapes == want_shapes
    assert sum(k.startswith("params/") for k in want_shapes) == JAX_PARAM_LEAVES
    assert sum(k.startswith("batch_stats/") for k in want_shapes) == JAX_STATS_LEAVES
    assert len(sd) == JAX_PARAM_LEAVES + JAX_STATS_LEAVES
    assert sum(math.prod(s) for k, s in want_shapes.items()
               if k.startswith("params/")) == MSS_PARAMS
    back = multisenseseg_state_dict_from_variables(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())

    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32),
                        dict(jax_shapes))
    model.load_state_dict(multisenseseg_state_dict_from_variables(tree), strict=True)
    want, got = flatten_variables(tree), flatten_variables(
        ti.multisenseseg_variables_from_state_dict(model.state_dict()))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_notr_reinitializes_what_jax_does(scheme, jax_shapes):
    """``apply_reference_init_scheme`` re-initializes exactly the 91 kernels
    that the JAX package's does (every 2-D conv: nothing is stacked on a
    modality axis) and zeroes the biases beside them, leaves everything else
    as built, and draws with the scheme's standard deviation."""
    model = create_model("MultiSenseSeg", seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = apply_reference_init_scheme(model, scheme, torch.Generator().manual_seed(3))
    want = jax_reinitialized(jax_shapes["params"], multisenseseg_state_dict_from_variables)
    assert len(names) == NOTR_KERNELS and set(names) == {n for n in want
                                                          if n.endswith(".weight")}
    params = dict(model.named_parameters())
    for n in before:
        assert torch.equal(params[n], before[n]) == (n not in want), n
    assert all(not params[n].any() for n in want if n.endswith(".bias"))
    hold_scheme_std(scheme, [params[n] for n in names])


def test_initializers_draw_with_their_deviations():
    """The model's own initializers: the bias tables N(0, 0.02), AMM's
    ``logit_scale`` log 10, LayerNorm and BatchNorm ones and zeros, the convs
    and Linear layers PyTorch's U(+-1/sqrt(fan_in)) (mean of (w / std)^2
    over all of them 1 within five standard errors, std = bound / sqrt(3))."""
    model = create_model("MultiSenseSeg", seed=5)
    sd = dict(model.named_parameters())
    tables = [v for k, v in sd.items() if k.endswith("relative_position_bias_table")]
    assert len(tables) == 14
    t = torch.cat([v.detach().flatten() for v in tables]).double()
    assert abs(float((t / 0.02).square().mean()) - 1) <= 5 * math.sqrt(2 / t.numel())
    assert torch.equal(sd["build_MSEs_AMM.fuse_proj.logit_scale"],
                       torch.full((4, 1, 1), math.log(10.0)))
    sq, count = 0.0, 0
    for module in model.modules():
        if isinstance(module, Conv) or type(module).__name__ == "Dense":
            w = module.weight.detach().double()
            fan = w[0].numel()
            sq += float((w * math.sqrt(3 * fan)).square().sum())
            count += w.numel()
        elif isinstance(module, BatchNorm) or type(module).__name__ == "LayerNorm":
            assert bool((module.weight == 1).all()) and not module.bias.any()
    assert abs(sq / count - 1) <= 5 * math.sqrt(0.8 / count), (sq / count, count)
