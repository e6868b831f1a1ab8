"""The port's UNetV2 against the JAX package, on the CPU in f32.

The JAX side gets the port's weights through
``corrifnet_tpu.models.torch_import.unetv2_variables_from_state_dict``; its
abstract shapes come from ``jax.eval_shape``. UNetV2 is the port's first
model on the 4-D input path: one modality, (B, 3, H, W), output
(B, 1, H, W).

* the whole forward at B=1, 64x64, and at 40x40, where the down paths'
  pools floor (40 -> 20 -> 10 -> 5 -> 2) and the up path pads to the
  skip's size;
* one training step with the eight dropout sites on, the same masks on both
  sides in call order: the loss within 1e-5 and the gradients to
  ``torch_zoo_step.hold_step``'s bounds;
* the ``state_dict`` both ways through the JAX converter, bit for bit, with
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

from corrifnet_tpu.models import torch_import as ti
from corrifnet_tpu_torch.models import (
    create_model,
    unetv2_named_gradients,
    unetv2_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.jax_import import flatten_variables
from corrifnet_tpu_torch.nn import BatchNorm, Conv
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

UNET_PARAMS = 13_395_329  # the JAX init tree's (jax.eval_shape)
JAX_PARAM_LEAVES = 74
JAX_STATS_LEAVES = 36
NOTR_KERNELS = 19  # the JAX tree's 4-axis kernels: every conv
MODEL_ATOL = 5e-5  # ROADMAP Queue 3: the f32 whole-model forward bound


def _jax_model():
    from corrifnet_tpu.models.unet import UNetV2

    return UNetV2(dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_shapes():
    return jax.eval_shape(lambda: _jax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64), jnp.float32)))


def _inputs(seed, hw=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, 3, hw, hw)).astype(np.float32)
    masks = (rng.random((1, 1, hw, hw)) > 0.7).astype(np.float32)
    return x, masks, np.ones(1, np.float32)


@pytest.mark.parametrize("hw", [64, 40])
def test_whole_model_matches_jax(hw):
    """B=1, f32, eval mode: the probabilities within MODEL_ATOL, or twice
    the port's own change under a 1e-6 change of the input. Measured:
    6e-8."""
    model = create_model("UNetV2", seed=0)
    x, _, _ = _inputs(11, hw)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        witness = np.abs(model(torch.from_numpy(x * np.float32(1 + 1e-6))).numpy()
                         - got).max()
    want = np.asarray(jax.jit(lambda v, xx: _jax_model().apply(v, xx, False))(
        ti.unetv2_variables_from_state_dict(model.state_dict()), jnp.asarray(x)))
    assert got.shape == want.shape == (1, 1, hw, hw) and np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"UNetV2 {hw}x{hw} forward against JAX:", err, "witness:", witness)
    assert err <= max(MODEL_ATOL, 2 * witness), (err, witness)


@pytest.mark.parametrize("hw", [64, 40])
def test_train_step_with_injected_dropout_matches_jax(hw, monkeypatch):
    """One training-mode step at B=1, f32, BatchNorm on batch statistics,
    the eight dropout sites on at 0.5 with the same masks in call order on
    both sides (JAX's ``jax.random.bernoulli`` answered from the table, the
    port's drawn in JAX's channels-last layout and moved back): the
    same sequence of mask shapes, the loss within 1e-5 and the gradients to
    ``hold_step``'s bounds. Every conv bias feeds a BatchNorm but ``outc``'s:
    those 18 have a gradient of 0 but for rounding and are held by size."""
    from corrifnet_tpu.train.state import _masked_loss_and_jaccard

    model = create_model("UNetV2", seed=2)
    x, masks, valid = _inputs(131, hw)
    variables = ti.unetv2_variables_from_state_dict(model.state_dict())
    jm = _jax_model()

    def loss_fn(params, stats, xx):
        out, _ = jm.apply({"params": params, "batch_stats": stats}, xx, True,
                          rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return _masked_loss_and_jaccard(out.astype(jnp.float32), jnp.asarray(masks),
                                        jnp.asarray(valid))[0]

    table_j = CallOrderMasks(5, channels_last=True)
    with monkeypatch.context() as patch:
        patch.setattr(jax.random, "bernoulli", table_j.bernoulli)
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
            variables["params"], variables["batch_stats"], jnp.asarray(x))

    def port_step(xx):
        model.set_dropout_rng(CallOrderMasks(5, channels_last=True))
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(torch.from_numpy(xx)).float()
        loss, _, _ = masked_loss_and_jaccard(out, torch.from_numpy(masks).to(out.dtype),
                                             torch.from_numpy(valid).to(out.dtype))
        loss.backward()
        return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                             if p.grad is not None}

    loss, got = port_step(x)
    assert model.rng.calls == table_j.calls and len(table_j.calls) == 8
    assert all(p == 0.5 for _, p in table_j.calls)
    _, moved = port_step(x * np.float32(1 + 1e-6))
    want = {k: v.numpy() for k, v in unetv2_named_gradients(
        jax.tree.map(np.asarray, grads_j)).items()}
    assert sorted(got) == sorted(want)
    assert abs(loss - float(loss_j)) <= 1e-5, (loss, float(loss_j))
    zero = zero_gradients(model)
    assert len(zero) == 18
    hold_step("UNetV2", model, port_step, x, got, want, moved, monkeypatch, zero)


def test_state_dict_round_trip_is_exact(jax_shapes):
    """Port -> JAX -> port and JAX -> port -> JAX, bit for bit: the port's
    state_dict converts into a tree of exactly the JAX init tree's structure
    (74 parameter and 36 statistics leaves; 13,395,329 parameters in the
    port's 110 tensors), and back."""
    model = create_model("UNetV2", seed=1)
    assert sum(p.numel() for p in model.parameters()) == UNET_PARAMS
    sd = model.state_dict()
    want_shapes = {k: v.shape for k, v in flatten_variables(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(jax_shapes))).items()}
    variables = ti.unetv2_variables_from_state_dict(sd)
    assert {k: v.shape for k, v in flatten_variables(variables).items()} == want_shapes
    assert sum(k.startswith("params/") for k in want_shapes) == JAX_PARAM_LEAVES
    assert sum(k.startswith("batch_stats/") for k in want_shapes) == JAX_STATS_LEAVES
    assert len(sd) == JAX_PARAM_LEAVES + JAX_STATS_LEAVES
    assert sum(math.prod(s) for k, s in want_shapes.items()
               if k.startswith("params/")) == UNET_PARAMS
    back = unetv2_state_dict_from_variables(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())

    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda s: rng.normal(0, 1, s.shape).astype(np.float32),
                        dict(jax_shapes))
    model.load_state_dict(unetv2_state_dict_from_variables(tree), strict=True)
    want, got = flatten_variables(tree), flatten_variables(
        ti.unetv2_variables_from_state_dict(model.state_dict()))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_notr_reinitializes_what_jax_does(scheme, jax_shapes):
    """``apply_reference_init_scheme`` re-initializes exactly the 19 kernels
    that the JAX package's does (every conv) and zeroes their biases, leaves
    the BatchNorms as built, and draws with the scheme's standard
    deviation."""
    model = create_model("UNetV2", seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    names = apply_reference_init_scheme(model, scheme, torch.Generator().manual_seed(3))
    want = jax_reinitialized(jax_shapes["params"], unetv2_state_dict_from_variables)
    assert len(names) == NOTR_KERNELS and set(names) == {n for n in want
                                                          if n.endswith(".weight")}
    params = dict(model.named_parameters())
    for n in before:
        assert torch.equal(params[n], before[n]) == (n not in want), n
    assert all(not params[n].any() for n in want if n.endswith(".bias"))
    hold_scheme_std(scheme, [params[n] for n in names])


def test_initializers_draw_with_their_deviations():
    """The model's own initializers: the convs PyTorch's U(+-1/sqrt(fan_in))
    (mean of (w / std)^2 over all of them 1 within five standard errors,
    std = bound / sqrt(3)), BatchNorm ones and zeros."""
    model = create_model("UNetV2", seed=5)
    sq, count = 0.0, 0
    for module in model.modules():
        if isinstance(module, Conv):
            w = module.weight.detach().double()
            sq += float((w * math.sqrt(3 * w[0].numel())).square().sum())
            count += w.numel()
        elif isinstance(module, BatchNorm):
            assert bool((module.weight == 1).all()) and not module.bias.any()
    assert abs(sq / count - 1) <= 5 * math.sqrt(0.8 / count), (sq / count, count)
